"""Backbone registry (counterpart of `gvcnn_tf_tpu/models/backbones`), under
the JAX package's names, and one the JAX package lacks,
`inception_resnet_v2`.

Each backbone class takes NHWC input (N, H, W, 3), returns (features,
{endpoint: tensor}) in NCHW, and carries `NAME` (its Flax scope, and so the
first part of its state_dict keys), `ENDPOINTS`, `ENDPOINT_CHANNELS`,
`DEFAULT_RAW_ENDPOINT`, `DEFAULT_FINAL_ENDPOINT`, `DESCRIPTOR_DIM` and
`KERNEL_INIT` (the JAX family's conv initializer).
"""

from gvcnn_tf_tpu_torch.models.backbones.inception_resnet_v2 import (
    InceptionResNetV2Base,
)
from gvcnn_tf_tpu_torch.models.backbones.inception_v1 import InceptionV1Base
from gvcnn_tf_tpu_torch.models.backbones.inception_v2 import InceptionV2Base
from gvcnn_tf_tpu_torch.models.backbones.inception_v3 import InceptionV3Base
from gvcnn_tf_tpu_torch.models.backbones.inception_v4 import InceptionV4Base
from gvcnn_tf_tpu_torch.models.backbones.resnet import ResNet50Base

BACKBONES = {
    "inception_v1": InceptionV1Base,
    "inception_v2": InceptionV2Base,
    "inception_v3": InceptionV3Base,
    "inception_v4": InceptionV4Base,
    "inception_resnet_v2": InceptionResNetV2Base,
    "resnet50": ResNet50Base,
}


def get_backbone(name: str):
    if name not in BACKBONES:
        raise KeyError(f"unknown backbone {name!r}; have {sorted(BACKBONES)}")
    return BACKBONES[name]
