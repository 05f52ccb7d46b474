"""BatchNorm folding for inference (counterpart of
`gvcnn_tf_tpu/utils/fold_bn.py:44-114`).

For every module that holds a `conv` and a `BatchNorm` (ConvBNReLU, Stem),
with s = 1 / sqrt(var + eps) per output channel (there is no BN scale):

    W'    = W * s
    bias' = bias - mean * s
    mean' = 0,  var' = 1 - eps        (so BN(x) == x + bias')

computed in fp32, as the JAX package computes it.  eps is the module's own
(1e-3 for the inception scopes).  The port updates the model in place: the
unfolded weights are not needed at inference, and serving holds one copy.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from gvcnn_tf_tpu_torch.models.backbones.inception_v1 import BatchNorm


@torch.no_grad()
def fold_batch_norm(model: nn.Module) -> nn.Module:
    """In place: fold every conv+BatchNorm pair of `model`; returns it."""
    for m in model.modules():
        conv, bn = getattr(m, "conv", None), getattr(m, "BatchNorm", None)
        if not (isinstance(conv, nn.Conv2d) and isinstance(bn, BatchNorm)):
            continue
        mean = bn.running_mean.float()
        s = 1.0 / torch.sqrt(bn.running_var.float() + bn.eps)
        w = conv.weight
        w.copy_((w.float() * s.view(-1, 1, 1, 1)).to(w.dtype))
        bn.bias.copy_(bn.bias.float() - mean * s)
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0 - bn.eps)
    return model
