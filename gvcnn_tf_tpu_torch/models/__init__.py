"""Model assembly of the port (counterpart of `gvcnn_tf_tpu/models`)."""

from gvcnn_tf_tpu_torch.models.gvcnn import (  # noqa: F401
    GVCNN,
    build_model,
    init_weights,
    to_device,
)
