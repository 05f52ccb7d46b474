"""Sweep the backend's settings over the train step on one NVIDIA GPU
(counterpart of `gvcnn_tf_tpu/tools/bench_xla_flags.py`).

    python -m gvcnn_tf_tpu_torch.tools.bench_backend_flags --batch 32
    python -m gvcnn_tf_tpu_torch.tools.bench_backend_flags --device cpu \\
        --batch 2 --iters 3

The JAX tool recompiles the step under XLA:TPU's compiler options.  Those
do not exist here; the settings of the port's backend that can move an
eager step are PyTorch's `torch.backends` switches, so `SETTINGS` holds
those, as {dotted attribute of `torch.backends`: value}:

  default              PyTorch's defaults, as the port runs;
  cudnn_benchmark      cuDNN times its algorithms for each new shape and
                       keeps the fastest (the first step pays for it);
  cudnn_deterministic  deterministic cuDNN algorithms only;
  tf32                 (fp32 configs only) cuDNN convs and CUDA matmuls in
                       TF32; not the same math as the default, so its row
                       is marked `"exact": false`.

Each setting is timed on the real step (`train.train_step`, one train state
for all) in turn: CUDA events around chunks of 10 steps, the median of
max(iters // 10, 3) chunks after 3 warm steps (the host clock on the CPU,
where the cuDNN switches do nothing).  Every attribute a setting touches is
restored afterwards, also when it raised.  A setting that names an unknown
attribute, or an unknown setting named in `--settings`, is an error row, as
the JAX tool records the options its compiler rejects.  The default device
is the card (`--device cuda`; without one it raises); `--device cpu` runs
the config at 64x64, fp32.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
from typing import Dict, List, Optional

import torch

from gvcnn_tf_tpu_torch.tools.bench_variants import (
    base_config,
    step_seconds,
    wire_batch,
)
from gvcnn_tf_tpu_torch.tools.measure import card_line
from gvcnn_tf_tpu_torch.train import create_train_state, train_step
from gvcnn_tf_tpu_torch.utils import resolve_device

# (name, {attribute of torch.backends: value}, exact) — {} is the control.
SETTINGS = [
    ("default", {}, True),
    ("cudnn_benchmark", {"cudnn.benchmark": True}, True),
    ("cudnn_deterministic", {"cudnn.deterministic": True}, True),
]
# fp32 configs only.
FP32_SETTINGS = [
    ("tf32", {"cudnn.allow_tf32": True, "cuda.matmul.allow_tf32": True},
     False),
]


def settings_for(cfg) -> List[tuple]:
    """The settings that apply to `cfg` (the tf32 row for fp32 only)."""
    return SETTINGS + (FP32_SETTINGS if cfg.compute_dtype == "float32"
                       else [])


def _owner(path: str):
    """(object, attribute) of a dotted path under torch.backends."""
    *parents, attr = path.split(".")
    obj = torch.backends
    for p in parents:
        obj = getattr(obj, p)
    if not hasattr(obj, attr):
        raise AttributeError(f"torch.backends.{path} does not exist")
    return obj, attr


@contextlib.contextmanager
def applied(options: Dict[str, object]):
    """Inside: every option set; after, every one set before restored,
    also when setting a later one or the body raised."""
    saved = []
    try:
        for path, value in options.items():
            obj, attr = _owner(path)
            saved.append((obj, attr, getattr(obj, attr)))
            setattr(obj, attr, value)
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def run(cfg, batch: int = 32, iters: int = 30, names=None,
        out: Optional[str] = None, device="cuda", chunk: int = 10):
    """-> rows (see the module docstring); prints a JSON line each."""
    dev = resolve_device(device)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=batch))
    table = settings_for(cfg)
    known = {name for name, _, _ in table}
    wanted = list(names) if names else [name for name, _, _ in table]
    state = create_train_state(cfg, dev)
    data = wire_batch(cfg, dev)

    def step():
        return train_step(state, data, cfg)

    rows, base_ms = [], None
    for name in wanted:
        if name not in known:
            r = {"name": name, "error": f"unknown setting {name!r} (known: "
                                        f"{sorted(known)})"}
            rows.append(r)
            print(json.dumps(r), flush=True)
            continue
        _, opts, exact = next(s for s in table if s[0] == name)
        try:
            with applied(opts):
                dt = step_seconds(step, max(iters, 3 * chunk), dev, chunk)
            r = {"name": name, "options": opts, "exact": exact,
                 "step_ms": round(dt * 1e3, 2)}
            if name == "default":
                base_ms = r["step_ms"]
            if base_ms:
                r["vs_default"] = round(r["step_ms"] / base_ms, 4)
        except (AttributeError, RuntimeError, TypeError) as e:
            r = {"name": name, "options": opts, "exact": exact,
                 "error": f"{type(e).__name__}: {e}"[:300]}
        print(json.dumps(r), flush=True)
        rows.append(r)

    if out:
        where = card_line() if dev.type == "cuda" else "cpu, host clock"
        lines = ["", f"## Backend-setting sweep ({cfg.name} train step, "
                     f"batch {batch}, {where})",
                 "", "| setting | options | exact | step ms | vs default |",
                 "|---|---|---|---|---|"]
        for r in rows:
            lines.append(
                f"| {r['name']} | `{r.get('options') or '(default)'}` | "
                f"{r.get('exact', '')} | "
                f"{r.get('step_ms', r.get('error', '?'))} | "
                f"{r.get('vs_default', '')} |")
        with open(out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="mn40_12view")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--settings", default=None,
                   help="comma-separated subset of setting names")
    p.add_argument("--out", default=None, help="append markdown table here")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    return run(base_config(args.config, dev), args.batch, args.iters,
               args.settings.split(",") if args.settings else None,
               args.out, dev)


if __name__ == "__main__":
    main()
