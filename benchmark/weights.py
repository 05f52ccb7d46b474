"""The weights of a run, made from its seed on the device.

One normal draw for every parameter and statistic together, clipped at two
standard deviations, then scaled and shifted per tensor by its role:
convs He-normal (std sqrt(2 / fan_in), so activations keep their scale
through eval-mode layers), the linear head lecun-normal, the score conv
wide enough that the views' scores spread over several groups, BatchNorm
biases, means and scales near 0, 0 and 1, variances exp(N(0, 0.25^2)).
The same tensors go to the program and to the reference."""

from __future__ import annotations

import math
from typing import Dict

import torch

# std and shift of each role; bn_var is exp(std * z).
_ROLE = {"conv": None, "linear": None, "score_logit": (0.5, 0.0),
         "bias": (0.1, 0.0), "bn_scale": (0.1, 1.0), "bn_bias": (0.1, 0.0),
         "bn_mean": (0.1, 0.0), "bn_var": (0.25, 0.0)}


def _std_shift(shape, role):
    if role == "conv":
        return math.sqrt(2.0 / math.prod(shape[1:])), 0.0
    if role == "linear":
        return math.sqrt(1.0 / shape[1]), 0.0
    return _ROLE[role]


def make_weights(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for a `reference.gvcnn.param_spec`
    from `seed` (a torch.Generator on the device)."""
    names = list(spec)
    sizes = [math.prod(spec[n][0]) for n in names]
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(sum(sizes), generator=g, device=device).clamp_(-2.0, 2.0)
    std, shift = zip(*(_std_shift(*spec[n]) for n in names))
    counts = torch.tensor(sizes, device=device)
    z.mul_(torch.repeat_interleave(torch.tensor(std, device=device), counts))
    z.add_(torch.repeat_interleave(torch.tensor(shift, device=device),
                                   counts))
    out = {}
    for n, t in zip(names, torch.split(z, sizes)):
        t = t.view(spec[n][0])
        out[n] = t.exp() if spec[n][1] == "bn_var" else t
    return out
