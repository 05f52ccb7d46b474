"""Time the stem kernel (K2) against cuDNN's conv, and its worth to the
train step, on one NVIDIA GPU (counterpart of
`gvcnn_tf_tpu/tools/bench_stem.py`).

    python -m gvcnn_tf_tpu_torch.tools.bench_stem --batch 384 --height 224
    python -m gvcnn_tf_tpu_torch.tools.bench_stem --train
    python -m gvcnn_tf_tpu_torch.tools.bench_stem --device cpu --batch 2 \\
        --height 32 --iters 2

One JSON line a dtype: the bf16 kernel (`stem_conv7x7s2_bf16`) and the fp32
one (`stem_conv7x7s2_f32`, 3xTF32), each through its wrapper
`ops.stem_kernel.stem_conv` (`kernel_ms`), against `F.conv2d` on the
TF-'SAME'-padded NCHW view of the same input (`library_ms`: cuDNN, with
PyTorch's defaults, so fp32 in TF32 where `cudnn.allow_tf32`), and
`speedup` = library / kernel.  `max_abs_dev` and `rel_dev` (over
max|library|) hold the kernel against the library's output: for fp32 the
library run again with TF32 off, the exact reference.  (The JAX tool's
`xla_ms` / `pallas_ms` are this tool's `library_ms` / `kernel_ms`.)

Time: CUDA events around chunks of 5 calls, the median chunk, after 3
warm calls (the host clock on the CPU, where the wrapper runs the kernel's
plain version, which is `F.conv2d` itself).

`--train`: the mn40_12view train step at `--batch` / 12 shapes
(`bench_variants.time_variant`), as it runs (the kernel) and with the
stem's conv routed through cuDNN (`cudnn_stem`, a context manager of this
tool that points the wrapper at the plain version for the call; the main
path has no such switch): the end-to-end worth of K2 to a trainer.  The
default device is the card (`--device cuda`; without one it raises).
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch
import torch.nn.functional as F

from gvcnn_tf_tpu_torch.configs import get_config
from gvcnn_tf_tpu_torch.ops import launched, stem_kernel
from gvcnn_tf_tpu_torch.ops.pool import same_pads
from gvcnn_tf_tpu_torch.tools.bench_variants import (
    step_seconds,
    time_variant,
)
from gvcnn_tf_tpu_torch.tools.measure import card_line
from gvcnn_tf_tpu_torch.utils import resolve_device

CHUNK = 5


@contextlib.contextmanager
def cudnn_stem():
    """Inside: the stem wrapper runs its plain version (`F.conv2d`, cuDNN
    on a card) in place of the kernel, in the forward and in a remat
    recompute alike."""
    kernel = stem_kernel._stem_forward
    stem_kernel._stem_forward = stem_kernel.stem_conv_plain
    try:
        yield
    finally:
        stem_kernel._stem_forward = kernel


@contextlib.contextmanager
def _tf32(on: bool):
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _ms(f, dev: torch.device, iters: int) -> float:
    """Median ms of one f() call (`bench_variants.step_seconds`: chunks of
    CHUNK calls after 3 warm ones)."""
    return step_seconds(f, iters, dev, CHUNK) * 1e3


def bench_dtype(x: torch.Tensor, w: torch.Tensor, iters: int) -> dict:
    """One line: the wrapper against `F.conv2d` on x's dtype."""
    dev = x.device
    ph, pw = same_pads(x.shape[1], 7, 2), same_pads(x.shape[2], 7, 2)
    with torch.inference_mode():
        xn = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
        before = launched("stem_conv7x7s2")
        t_ker = _ms(lambda: stem_kernel.stem_conv(x, w), dev, iters)
        launches = launched("stem_conv7x7s2") - before
        t_lib = _ms(lambda: F.conv2d(xn, w, stride=2), dev, iters)
        got = stem_kernel.stem_conv(x, w).float()
        with _tf32(False):
            ref = F.conv2d(xn, w, stride=2).permute(0, 2, 3, 1).float()
    dev_abs = float((ref - got).abs().max())
    scale = float(ref.abs().max()) + 1e-9
    return {
        "op": "stem7x7s2", "dtype": str(x.dtype).replace("torch.", ""),
        "kernel": stem_kernel.kernel_name(x.dtype),
        "batch": x.shape[0], "height": x.shape[1],
        "kernel_ms": round(t_ker, 4), "library_ms": round(t_lib, 4),
        "speedup": round(t_lib / t_ker, 3),
        "max_abs_dev": dev_abs, "rel_dev": dev_abs / scale,
        "library_tf32": (x.dtype == torch.float32
                         and torch.backends.cudnn.allow_tf32),
        "kernel_launches": launches,
    }


def run(batch: int = 384, height: int = 224, iters: int = 20,
        train: bool = False, device="cuda"):
    """-> the lines (see the module docstring); prints each."""
    dev = resolve_device(device)
    where = ({"device": torch.cuda.get_device_name(dev), "card": card_line()}
             if dev.type == "cuda" else {"device": "cpu", "card": None})
    r = np.random.RandomState(0)
    x = torch.from_numpy(r.rand(batch, height, height, 3).astype(np.float32))
    w = torch.from_numpy((r.randn(64, 3, 7, 7) * 0.05).astype(np.float32))
    lines = []
    for dtype in (torch.bfloat16, torch.float32):
        line = {**bench_dtype(x.to(dev, dtype), w.to(dev, dtype), iters),
                **where}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if train:
        cfg = get_config("mn40_12view")
        shapes = max(batch // cfg.data.num_views, 1)
        steps = {}
        for name, route in (("stem_kernel", contextlib.nullcontext),
                            ("stem_cudnn", cudnn_stem)):
            before = launched("stem_conv7x7s2")
            with route():
                dt, _, loss = time_variant(cfg, shapes, iters=iters,
                                           device=dev)
            steps[name] = dt
            line = {"variant": name, "batch_shapes": shapes,
                    "step_ms": round(dt * 1e3, 2),
                    "views_per_sec": round(
                        shapes * cfg.data.num_views / dt, 1),
                    "first_loss": loss,
                    "stem_launches": launched("stem_conv7x7s2") - before,
                    **where}
            lines.append(line)
            print(json.dumps(line), flush=True)
        line = {"k2_worth_ms": round(
            (steps["stem_cudnn"] - steps["stem_kernel"]) * 1e3, 3),
            "batch_shapes": shapes, **where}
        lines.append(line)
        print(json.dumps(line), flush=True)
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--batch", type=int, default=384)
    p.add_argument("--height", type=int, default=224)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--train", action="store_true",
                   help="also time the mn40_12view train step with the "
                        "kernel and with the stem through cuDNN")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    return run(args.batch, args.height, args.iters, args.train, args.device)


if __name__ == "__main__":
    main()
