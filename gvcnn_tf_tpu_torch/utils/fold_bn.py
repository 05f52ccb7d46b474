"""BatchNorm folding for inference (counterpart of
`gvcnn_tf_tpu/utils/fold_bn.py:44-114`).

For every module that holds a `BatchNorm` beside the conv it follows (a
`conv`: ConvBN, Stem; or a `pointwise` projection: Inception-v2's
SeparableConvBNReLU, the JAX package's `_KERNEL_KEYS`), with
s = gamma / sqrt(var + eps) per output channel (gamma = 1 where the
BatchNorm has no scale):

    W'     = W * s
    bias'  = bias - mean * s
    mean'  = 0,  var' = 1 - eps,  scale' = 1     (so BN(x) == x + bias')

computed in fp32, as the JAX package computes it.  eps is the module's own
(1e-3 for the Inception scopes and the scoring FCN, 1e-5 for ResNet's),
which is the eps the JAX package picks by scope name.  The port updates the
model in place: the unfolded weights are not needed at inference, and
serving holds one copy.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gvcnn_tf_tpu_torch.models.backbones.layers import BatchNorm

# The conv a BatchNorm sibling folds into, in priority order.
_CONV_KEYS = ("conv", "pointwise")


@torch.no_grad()
def fold_batch_norm(model: nn.Module) -> nn.Module:
    """In place: fold every conv+BatchNorm pair of `model`; returns it."""
    for m in model.modules():
        bn = getattr(m, "BatchNorm", None)
        conv = next((c for c in (getattr(m, k, None) for k in _CONV_KEYS)
                     if isinstance(c, nn.Conv2d)), None)
        if not isinstance(bn, BatchNorm) or conv is None:
            continue
        mean = bn.running_mean.float()
        gamma = 1.0 if bn.scale is None else bn.scale.float()
        s = gamma / torch.sqrt(bn.running_var.float() + bn.eps)
        if bn.scale is not None:
            bn.scale.fill_(1.0)
        w = conv.weight
        w.copy_((w.float() * s.view(-1, 1, 1, 1)).to(w.dtype))
        bn.bias.copy_(bn.bias.float() - mean * s)
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0 - bn.eps)
    return model
