"""Image normalization on the device for raw-uint8 requests
(counterpart of `gvcnn_tf_tpu/utils/images.py`)."""

from __future__ import annotations

import torch


def normalize_views(views: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1]; float inputs pass through.

    The op sequence `float32 / 255 * 2 - 1` is the host iterator's and the
    JAX package's, so both packages see the same floats.
    """
    if views.dtype == torch.uint8:
        return views.to(torch.float32) / 255.0 * 2.0 - 1.0
    return views


def device_flip(views: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, V, H, W, 3) views with each (shape, view) where `mask` (B, V) is
    true mirrored along W: the JAX train step's `jnp.where(flip,
    views[:, :, :, ::-1, :], views)`, on whatever device the views are."""
    return torch.where(mask[:, :, None, None, None], views.flip(3), views)
