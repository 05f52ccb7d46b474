"""Run one backbone segment and list its ops, with the relayout and cast
traffic (counterpart of `gvcnn_tf_tpu/tools/dump_hlo.py`).

    python -m gvcnn_tf_tpu_torch.tools.dump_ops --endpoint Mixed_3b \\
        --batch 384 --mode train [--full-ops ops.txt]
    python -m gvcnn_tf_tpu_torch.tools.dump_ops --device cpu --batch 2 \\
        --height 64 --width 64

The JAX tool compiles a segment and reads its optimized HLO.  The port runs
eagerly, so this tool runs the segment once (bf16, channels-last on a card,
as `bench_layers` runs its towers) under `bench_layers.WorkCounter`, which
sees every aten op and its unfused bytes, and reports:

  * the op histogram (the counter's own calls by op);
  * every copy (`copy_`, a `_to_copy` that keeps the dtype), cast (a
    `_to_copy` that changes it), `clone` (how `.contiguous()` and a layout
    change copy), permute/transpose (views: 0 bytes) and `cat`, with its
    output shape, dtype and bytes (inputs read once, output written once):
    the port's relayout and cast traffic;
  * the concatenations with their operand shapes.

The segment is `InceptionV1Base(start_endpoint=--start)` through
`--endpoint` (the whole tower from the input where `--start` is ""), its
input the prefix's output at `--batch` images; `--mode train` takes the
gradients of a sum of its features with respect to its parameters and its
input, as the JAX tool does, `fwd` runs it in eval mode without gradients.
`--merge` is accepted and logged: the port runs the branches unmerged.  The
default device is the card (`--device cuda`; without one it raises).
"""

from __future__ import annotations

import argparse
import collections
import json
from typing import List, Optional

import torch

from gvcnn_tf_tpu_torch.metrics import log
from gvcnn_tf_tpu_torch.models.backbones import get_backbone
from gvcnn_tf_tpu_torch.tools.bench_layers import (
    WorkCounter,
    _input,
    _loss,
    _tensors,
    _tower,
)
from gvcnn_tf_tpu_torch.utils import resolve_device

_VIEWS = {"aten::permute": "permute", "aten::transpose": "transpose",
          "aten::t": "transpose"}


def _shape(t) -> list:
    return list(t.shape)


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


class OpRecorder(WorkCounter):
    """A `WorkCounter` that also keeps one record a op: its name, output
    and input shapes and dtypes, FLOPs and bytes (the counter's)."""

    def __init__(self):
        super().__init__()
        self.records: List[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        flops, nbytes = self.flops, self.bytes
        out = super().__torch_dispatch__(func, types, args, kwargs)
        outs = [t for t in _tensors(out)]
        self.records.append({
            "op": func._schema.name,
            "shapes": [_shape(t) for t in outs],
            "dtypes": [_dtype(t) for t in outs],
            "in_shapes": [_shape(t) for t in _tensors(args)],
            "in_dtypes": [_dtype(t) for t in _tensors(args)],
            "flops": self.flops - flops,
            "bytes": self.bytes - nbytes,
        })
        return out


def _kind(r: dict) -> Optional[str]:
    """The relayout kind of a record, or None."""
    op = r["op"]
    if op == "aten::_to_copy":
        return "cast" if r["dtypes"] != r["in_dtypes"][:1] else "copy"
    if op == "aten::copy_":
        return "cast" if r["in_dtypes"][1] != r["in_dtypes"][0] else "copy"
    if op == "aten::clone":
        return "clone"
    if op == "aten::cat":
        return "cat"
    return _VIEWS.get(op)


def segment_ops(backbone: str, endpoint: str, start: str, *, batch: int,
                height: int, width: int, mode: str,
                device="cuda") -> OpRecorder:
    """The segment (start, endpoint] run once under an `OpRecorder` (see
    the module docstring)."""
    dev = resolve_device(device)
    train = mode == "train"
    x = _input(batch, height, width, "bfloat16", dev)
    if start:
        prefix = _tower(backbone, start, "", False, dev)
        with torch.no_grad():
            z = prefix.train(train)(x)[0]
        del prefix
    else:
        z = x
    seg = _tower(backbone, endpoint, start, False, dev, seed=1).train(train)
    z = z.detach().requires_grad_(train)
    params = list(seg.parameters())

    def call():
        if not train:
            with torch.no_grad():
                return seg(z)[0]
        return torch.autograd.grad(_loss(seg(z)[0]), params + [z])

    with OpRecorder() as rec:
        call()
    return rec


def summarize(rec: OpRecorder, top: int = 15) -> dict:
    """The report of an `OpRecorder`'s run."""
    hist = collections.Counter(r["op"] for r in rec.records)
    relayout, concats = [], []
    for r in rec.records:
        kind = _kind(r)
        if kind is None:
            continue
        relayout.append({"op": r["op"], "kind": kind,
                         "shape": r["shapes"][0], "dtype": r["dtypes"][0],
                         "from_dtype": r["in_dtypes"][0],
                         "mbytes": round(r["bytes"] / 1e6, 1)})
        if kind == "cat":
            concats.append({"shape": r["shapes"][0], "dtype": r["dtypes"][0],
                            "operands": r["in_shapes"],
                            "mbytes": round(r["bytes"] / 1e6, 1)})
    relayout.sort(key=lambda r: -r["mbytes"])
    totals = collections.defaultdict(float)
    for r in relayout:
        totals[r["kind"]] += r["mbytes"]
    ranked = sorted(rec.records, key=lambda r: -r["bytes"])[:top]
    return {
        "op_histogram": dict(hist.most_common()),
        "ops": len(rec.records),
        # Every copy, cast, clone, permute/transpose and cat: the port's
        # relayout and cast traffic.
        "relayout": relayout,
        "relayout_mbytes_by_kind": {k: round(v, 1)
                                    for k, v in sorted(totals.items())},
        "concatenates": concats,
        "total_gflops": round(rec.flops / 1e9, 3),
        "total_gbytes": round(rec.bytes / 1e9, 4),
        "top_by_bytes": [{"op": r["op"], "shapes": r["shapes"],
                          "dtypes": r["dtypes"],
                          "mbytes": round(r["bytes"] / 1e6, 1)}
                         for r in ranked],
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--backbone", default="inception_v1")
    p.add_argument("--endpoint", default="Mixed_3b")
    p.add_argument("--start", default=None,
                   help="start endpoint (default: the one before "
                        "--endpoint)")
    p.add_argument("--batch", type=int, default=384)
    p.add_argument("--height", type=int, default=224)
    p.add_argument("--width", type=int, default=224)
    p.add_argument("--mode", default="train", choices=["train", "fwd"])
    p.add_argument("--merge", default="none",
                   choices=["none", "1x1", "full"],
                   help="accepted and logged: the port runs the branches "
                        "unmerged")
    p.add_argument("--full-ops", default=None,
                   help="write every op here, one a line")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if args.merge != "none":
        log(f"merge={args.merge!r}: same math and parameters as unmerged; "
            "the port runs the branches unmerged")
    if args.start is None:
        eps = list(get_backbone(args.backbone).ENDPOINTS)
        i = eps.index(args.endpoint)
        args.start = eps[i - 1] if i > 0 else ""
    rec = segment_ops(args.backbone, args.endpoint, args.start,
                      batch=args.batch, height=args.height, width=args.width,
                      mode=args.mode, device=dev)
    if args.full_ops:
        with open(args.full_ops, "w") as f:
            for r in rec.records:
                f.write(f"{r['op']} {r['shapes']} {r['dtypes']} <- "
                        f"{r['in_shapes']} {r['in_dtypes']} flops="
                        f"{r['flops']} bytes={r['bytes']}\n")
    out = {"segment": [args.start, args.endpoint], "mode": args.mode,
           "batch": args.batch, "height": args.height, "width": args.width,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           **summarize(rec)}
    print(json.dumps(out, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
