"""The program under test, built from the benchmark's weights: the only
module of the benchmark that imports `gvcnn_tf_tpu_torch`, apart from the
traffic drivers that drive its entry points."""

from __future__ import annotations

import gc
from typing import Dict

import torch

from benchmark.reference import gvcnn as ref_gvcnn
from benchmark.weights import make_weights
from benchmark.inputs import seed_of


def weights(ctx) -> Dict[str, torch.Tensor]:
    """The run's weights, float32 on the device (`weights.make_weights`)."""
    return make_weights(ref_gvcnn.param_spec(ctx.model),
                        seed_of(ctx.seed, "weights"), ctx.device)


def train_state(cfg, device, w: Dict[str, torch.Tensor]):
    """The program's `TrainState` for `cfg` on `device`, holding `w`."""
    from gvcnn_tf_tpu_torch.train import create_train_state

    state = create_train_state(cfg, device)
    state.model.load_state_dict(w, strict=True)
    return state


def free(device):
    """Return the program's freed memory to the card before the
    reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
