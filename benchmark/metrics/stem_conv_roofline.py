"""The stem kernel's (K2, `csrc/stem_conv.cu`) share of its roofline in the
train step, %: its bound from the published shape (`counting.stem_work`:
input and weight read once, output written once; the larger of bytes over
the card's bandwidth and FLOPs over its peak) over its mean launch time."""

from benchmark.counting import stem_work


def read(records):
    prof, peaks = records.get("profile"), records.get("peaks")
    if not prof or not peaks:
        return None
    launches = [(n, s) for name, (n, s) in prof["kernels"].items()
                if "stem_conv" in name.lower()]
    count = sum(n for n, _ in launches)
    if not count:
        return None
    model = records["model"]
    flops, nbytes = stem_work(model, records["views_a_step"])
    bound = max(flops / peaks[model["compute_dtype"]],
                nbytes / peaks["bytes"])
    return 100.0 * bound / (sum(s for _, s in launches) / count)
