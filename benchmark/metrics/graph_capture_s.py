"""Seconds the program spent warming up and capturing its CUDA graphs:
the self time of every `graph.warmup` and `graph.capture` span of the run
(a kernel library's build or load inside one, `kernels.build`, is left
out).  Read from the program's span store after the run."""

from gvcnn_tf_tpu_torch.utils import profiling


def read(records):
    snapshot = getattr(profiling, "snapshot", None)
    if records.get("kind") not in ("train_stream", "eval_pass") or (
            snapshot is None):
        return None
    spans = snapshot()["spans"]
    found = [spans[n] for n in ("graph.warmup", "graph.capture") if n in spans]
    return sum(s["self_ns"] for s in found) / 1e9 if found else None
