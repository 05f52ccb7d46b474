"""Model assembly of the port (counterpart of `gvcnn_tf_tpu/models`)."""

from gvcnn_tf_tpu_torch.models.gvcnn import (  # noqa: F401
    GVCNN,
    MVCNN,
    SingleViewClassifier,
    ViewModel,
    build_model,
    init_weights,
    to_device,
)
