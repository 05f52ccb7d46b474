"""Measured phase split of the train step on one NVIDIA GPU (counterpart
of `gvcnn_tf_tpu/tools/bench_phases.py`).

    python -m gvcnn_tf_tpu_torch.tools.bench_phases --batch 32 --iters 30
    python -m gvcnn_tf_tpu_torch.tools.bench_phases --device cpu --iters 3

Three variants at the config's shapes and options, each timed alone:

  fwd   the forward in train mode (batch-statistics BatchNorm, dropout) and
        the cross-entropy, without gradients;
  grad  the same and `backward()`: gradients computed, no optimizer;
  full  `train.train_step`: the same, plus the L2 term, clipping and the
        `_foreach_` optimizer update,

so bwd ~ grad - fwd and optimizer + state ~ full - grad.  Each variant is
its own sequence of launches: the forward inside `grad` also saves the
activations that `fwd` drops, so the differences carry that; all three
absolutes are printed beside them.

Time: CUDA events around each call on the card, the median of `--iters`
calls after 3 warm ones (the host clock on the CPU).  The card is the
default (`--device cuda`; raises without one); `--device cpu` shrinks to
64x64, B = 2, fp32, as the JAX tool does off the TPU.

State: the JAX variants are pure functions that drop BatchNorm's updated
statistics.  Here every call updates them in place, and `full` also the
parameters and the optimizer's state; each variant starts from a copy of
the state taken before the first (model and optimizer state dicts and the
step count), restored after every variant, so no variant's runs change the
state another sees.  A call's cost does not depend on those values: the
batch is the same and every op's shape is fixed.

On the card `mn40_12view` launches the bf16 stem kernel (K2) and the
grouping kernel (K1) once in every call of each variant, `mn10_single_view`
the fp32 stem kernel; `launches_per_call` gives each variant's launches of
every hand-written kernel by its entry point's name (`ops.launches`).
"""

from __future__ import annotations

import argparse
import collections
import copy
import dataclasses
import json
import statistics
import time
from typing import Callable, Dict

import numpy as np
import torch

from gvcnn_tf_tpu_torch.configs import get_config, resolve_transfer_dtype
from gvcnn_tf_tpu_torch.ops import launches
from gvcnn_tf_tpu_torch.tools.measure import card_line, cuda_ms
from gvcnn_tf_tpu_torch.train import (
    create_train_state,
    cross_entropy,
    dropout_seed,
    train_step,
)
from gvcnn_tf_tpu_torch.utils import normalize_views, resolve_device

WARMUP = 3


def median_ms(fn: Callable[[], object], iters: int, dev: torch.device,
              warmup: int = WARMUP) -> float:
    """Median ms of one fn() call: CUDA events around each call on the
    card (`measure.cuda_ms`), the host clock on the CPU."""
    if dev.type == "cuda":
        return cuda_ms(fn, runs=iters, warmup=warmup)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_config(config: str, batch: int, dev: torch.device):
    """The config at the tool's shapes: `batch` shapes on the card; 64x64,
    B = 2, fp32 on the CPU."""
    cfg = get_config(config)
    if dev.type == "cpu":
        cfg = cfg.replace(compute_dtype="float32")
        return cfg.replace(data=dataclasses.replace(
            cfg.data, height=64, width=64, batch_size=2))
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=batch))


def make_batch(cfg, dev: torch.device,
               seed: int = 0) -> Dict[str, torch.Tensor]:
    """A fixed batch as the prefetcher hands it to the step: views (B, V,
    H, W, 3) uniform in [0, 1) in the transfer dtype (fp32 where there is
    none), labels."""
    d = cfg.data
    rs = np.random.RandomState(seed)
    views = torch.from_numpy(rs.rand(
        d.batch_size, d.num_views, d.height, d.width, 3).astype(np.float32))
    dtype = getattr(torch, resolve_transfer_dtype(cfg) or "float32")
    return {"views": views.to(dev, dtype),
            "label": torch.from_numpy(
                rs.randint(0, d.num_classes, d.batch_size)).to(dev)}


def run(config: str = "mn40_12view", batch: int = 32, iters: int = 30,
        device="cuda") -> dict:
    """-> the JSON line's dict (see the module docstring)."""
    dev = resolve_device(device)
    cfg = phase_config(config, batch, dev)
    d, tc = cfg.data, cfg.train
    state = create_train_state(cfg, dev)
    model = state.model
    b = make_batch(cfg, dev)

    def forward_loss():
        gen = None
        if cfg.dropout_keep_prob < 1.0:
            gen = state.generators[0]
            gen.manual_seed(dropout_seed(tc.seed, state.step, 0))
        logits, _ = model(normalize_views(b["views"]), generator=gen)
        return cross_entropy(logits, b["label"], tc.label_smoothing)

    def fwd():
        with torch.no_grad():
            return forward_loss()

    def grad():
        for p in state.optimizer.params:
            p.grad = None
        loss = forward_loss()
        loss.backward()
        return loss

    def full():
        return train_step(state, b, cfg)

    saved = (copy.deepcopy(model.state_dict()),
             copy.deepcopy(state.optimizer.state_dict()), state.step)
    times, per_call = {}, {}
    for name, fn in (("fwd", fwd), ("grad", grad), ("full", full)):
        before = collections.Counter(launches)
        fn()
        per_call[name] = dict(launches - before)
        times[name] = median_ms(fn, iters, dev)
        model.load_state_dict(saved[0])
        state.optimizer.load_state_dict(saved[1])
        state.step = saved[2]
    if dev.type == "cuda":
        kind, card = torch.cuda.get_device_name(dev), card_line()
    else:
        kind, card = "cpu", None
    out = {
        "config": cfg.name,
        "batch_shapes": d.batch_size,
        "fwd_ms": round(times["fwd"], 3),
        "grad_ms": round(times["grad"], 3),
        "full_ms": round(times["full"], 3),
        "bwd_minus_fwd_ms": round(times["grad"] - times["fwd"], 3),
        "optimizer_state_ms": round(times["full"] - times["grad"], 3),
        "device": kind,
        "weight_decay_in_full_only": tc.weight_decay > 0,
        "card": card,
        "shape": [d.num_views, d.height, d.width],
        "compute_dtype": cfg.compute_dtype,
        "iters": iters,
        "launches_per_call": per_call,
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="mn40_12view")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    return run(args.config, args.batch, args.iters, args.device)


if __name__ == "__main__":
    main()
