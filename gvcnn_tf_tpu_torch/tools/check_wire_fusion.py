"""Does the uint8 wire's normalization on the device materialize its own
views-sized buffers?  (Counterpart of
`gvcnn_tf_tpu/tools/check_wire_fusion.py`.)

    python -m gvcnn_tf_tpu_torch.tools.check_wire_fusion --batch 32
    python -m gvcnn_tf_tpu_torch.tools.check_wire_fusion --device cpu \\
        --batch 2 --height 64 --views 4

`transfer_dtype="uint8"` ships raw bytes and `train_step` normalizes them
on the device (`utils.normalize_views`: to fp32, / 255, x 2, - 1; then the
model casts to its compute dtype).  The JAX tool reads XLA's optimized
program; the port runs eagerly, so this tool runs the train step and
counts what it writes:

  1. one `train.train_step` of the config at `--batch` with the uint8 wire,
     and one with the `--ref` wire (bf16 by default), each under a
     `profile_step.LayerTracker`;
  2. every op output that is a new floating buffer of views size (elements
     within [1.0, 2.2] x B*V*H*W*3, the JAX rule: wide enough for a padded
     stem input, narrow enough to leave out the 5.3x larger stem output);
     a view or an in-place op's output writes no new buffer and does not
     count;
  3. verdict: the uint8 wire is fused iff it materializes no more such
     buffers than the reference wire.

Both tables name each buffer's op, dtype, elements, MB and layer (the
profile_step path of the op).  The port's expected answer is "not fused":
eager PyTorch runs each op of `normalize_views` as its own kernel, and the
extra buffers are its four fp32 outputs and the model's cast.  The default
device is the card (`--device cuda`; without one it raises); on the CPU
(`--device cpu`) the same ops run, so the tables are the card's at the same
shapes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional

import torch

from gvcnn_tf_tpu_torch.configs import get_config
from gvcnn_tf_tpu_torch.tools.bench_layers import _tensors
from gvcnn_tf_tpu_torch.tools.measure import card_line
from gvcnn_tf_tpu_torch.tools.profile_step import (
    LayerTracker,
    classify,
    make_step,
)
from gvcnn_tf_tpu_torch.utils import resolve_device


def step_materializations(cfg, wire: str, batch: int, lo: int, hi: int,
                          device="cuda",
                          channels_last: Optional[bool] = None
                          ) -> List[dict]:
    """The new floating buffers with lo..hi elements that one train step
    of `cfg` at `batch` shapes writes, its views on the `wire` dtype; a row
    per buffer, in the order the ops ran.  `channels_last`: as
    `profile_step.make_step` takes it."""
    dev = resolve_device(device)
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, batch_size=batch, transfer_dtype=wire))
    fn, model, data = make_step(cfg, "train", dev, channels_last)
    rows = []

    def on_op(name, func, args, kwargs, out):
        if func.is_view:
            return
        inputs = {t.untyped_storage().data_ptr()
                  for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            n = t.numel()
            if (t.is_floating_point() and lo <= n <= hi
                    and t.untyped_storage().data_ptr() not in inputs):
                rows.append({
                    "name": name,
                    "op": func._schema.name,
                    "dtype": str(t.dtype).replace("torch.", ""),
                    "elements": n,
                    "bytes": n * t.element_size(),
                    "mb": round(n * t.element_size() / 1e6, 1),
                    "layer": classify(name)[0],
                })

    with LayerTracker(model, exclude=data, on_op=on_op):
        fn()
    return rows


def run(cfg, batch: int = 32, ref: str = "bfloat16", device="cuda",
        channels_last: Optional[bool] = None) -> dict:
    """-> the report (see the module docstring); prints it."""
    dev = resolve_device(device)
    d = cfg.data
    full = batch * d.num_views * d.height * d.width * 3
    lo, hi = full, int(2.2 * full)
    report = {"backend": dev.type,
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "card": card_line() if dev.type == "cuda" else None,
              "config": cfg.name, "batch": batch,
              "shape": [d.num_views, d.height, d.width],
              "views_elements": full, "window": [lo, hi]}
    tables = {}
    for wire in (ref, "uint8"):
        tables[wire] = step_materializations(cfg, wire, batch, lo, hi, dev,
                                             channels_last)
        report[f"wire_{wire}"] = tables[wire]
    extra = len(tables["uint8"]) - len(tables[ref])
    report["uint8_extra_materializations"] = extra
    report["uint8_extra_bytes"] = (sum(r["bytes"] for r in tables["uint8"])
                                   - sum(r["bytes"] for r in tables[ref]))
    report["uint8_extra_mbytes"] = round(report["uint8_extra_bytes"] / 1e6,
                                         1)
    report["verdict"] = (
        "FUSED: the uint8 wire materializes no extra views-sized float "
        "buffer" if extra <= 0 else
        f"NOT FUSED: uint8 wire materializes {extra} extra views-sized "
        f"float buffer(s), {report['uint8_extra_mbytes']} MB written a "
        "step: normalize_views and the model's cast run as passes of "
        "their own")
    print(json.dumps(report, indent=1), flush=True)
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="mn40_12view")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--ref", default="bfloat16",
                   help="float wire to compare against (production: bf16)")
    p.add_argument("--merge", default="1x1",
                   help="merge_inception_branches (accepted and logged: "
                        "the port runs the branches unmerged)")
    p.add_argument("--height", type=int, default=None,
                   help="override geometry (tests; production = config's)")
    p.add_argument("--views", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.config).replace(
        merge_inception_branches=args.merge)
    if args.height or args.views:
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data,
            height=args.height or cfg.data.height,
            width=args.height or cfg.data.width,
            num_views=args.views or cfg.data.num_views))
    return run(cfg, args.batch, args.ref, dev)


if __name__ == "__main__":
    main()
