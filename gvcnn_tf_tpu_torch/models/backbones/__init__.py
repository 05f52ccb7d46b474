"""Backbone registry (counterpart of `gvcnn_tf_tpu/models/backbones`).

Only Inception-v1 is ported; the others come later (ROADMAP §1 item 13).
"""

from gvcnn_tf_tpu_torch.models.backbones.inception_v1 import InceptionV1Base

_PORTED = {"inception_v1": InceptionV1Base}
_NOT_PORTED = ("inception_v2", "inception_v3", "inception_v4", "resnet50")


def get_backbone(name: str):
    if name in _PORTED:
        return _PORTED[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"backbone {name!r} is not ported to PyTorch yet (ROADMAP §1 "
            "item 13, other backbones); only 'inception_v1' is")
    raise KeyError(f"unknown backbone {name!r}")
