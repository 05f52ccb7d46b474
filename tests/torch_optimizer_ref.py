"""The optimizer's update as it was made with Python floats, before its
scalars moved into device tensors: the reference the device-scalar
`Optimizer` is held to bit for bit (`tests/test_torch_graphs.py` on the
CPU, `tests/test_torch_cuda_kernels.py` on the card).  Imports no JAX."""

import numpy as np
import torch


def python_float_update(opt, grads, count):
    """The update as the optimizer made it before its scalars moved to the
    device: -lr and Adam's corrections as Python floats."""
    grads = list(grads)
    if opt.clip > 0:
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        scaled = torch._foreach_div(grads, norm)
        torch._foreach_mul_(scaled, opt.clip)
        keep = norm < opt.clip
        grads = [torch.where(keep, g, s) for g, s in zip(grads, scaled)]
    lr = opt.schedule(count)
    if opt.kind == "momentum":
        trace = opt.slots["trace"]
        torch._foreach_mul_(trace, opt.momentum)
        torch._foreach_add_(trace, grads)
        updates = torch._foreach_mul(trace, -lr)
    elif opt.kind == "sgd":
        updates = torch._foreach_mul(grads, -lr)
    else:
        mu, nu = opt.slots["mu"], opt.slots["nu"]
        torch._foreach_mul_(mu, opt.B1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - opt.B1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - opt.B2)
        torch._foreach_mul_(nu, opt.B2)
        torch._foreach_add_(nu, sq)
        t = np.float32(count + 1)
        bc1 = float(np.float32(1.0) - np.float32(opt.B1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(opt.B2) ** t)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, opt.EPS)
        updates = torch._foreach_div(mu, bc1)
        torch._foreach_div_(updates, den)
        torch._foreach_mul_(updates, -lr)
    torch._foreach_add_(opt.params, updates)
