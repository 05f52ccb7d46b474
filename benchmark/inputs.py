"""Views and labels made from a seed on the device, in bulk.

Each view is uint8 noise over a level and a contrast of its own, so that
the views of one shape differ in their statistics and the grouping head
sees scores that spread over its groups."""

from __future__ import annotations

import numpy as np
import torch


def seed_of(seed: int, *tags) -> int:
    """A 63-bit seed derived from the run's seed and tags (strings or
    ints)."""
    words = [seed] + [t if isinstance(t, int) else int.from_bytes(
        t.encode(), "little") for t in tags]
    w = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(w[0]) << 31) | (int(w[1]) >> 1)


def make_views(gen: torch.Generator, shape, device) -> torch.Tensor:
    """uint8 views of `shape` (N, V, H, W, 3) on `device`."""
    n, v = shape[:2]
    level = torch.rand((n, v, 1, 1, 1), generator=gen, device=device) * 160
    contrast = 32 + torch.rand((n, v, 1, 1, 1), generator=gen,
                               device=device) * 96
    u = torch.rand(shape, generator=gen, device=device)
    return u.mul_(contrast).add_(level).clamp_(0, 255).to(torch.uint8)


def host_views(seed: int, tag: str, shape, chunks: int, device) -> np.ndarray:
    """`make_views` of `shape`, made on the device in `chunks` parts along
    the first axis (to bound the device memory it takes) and copied into
    one host array."""
    out = np.empty(shape, np.uint8)
    g = torch.Generator(device=device).manual_seed(seed_of(seed, tag))
    step = -(-shape[0] // chunks)
    for i in range(0, shape[0], step):
        part = (min(step, shape[0] - i),) + tuple(shape[1:])
        out[i:i + part[0]] = make_views(g, part, device).cpu().numpy()
    return out


def labels(seed: int, tag: str, n: int, num_classes: int) -> np.ndarray:
    """n labels uniform over the classes, int64."""
    rng = np.random.default_rng(seed_of(seed, tag))
    return rng.integers(0, num_classes, n).astype(np.int64)
