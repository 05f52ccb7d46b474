"""Utilities of the port: image normalization and the on-card flip,
BatchNorm folding, the entry points' device, and tracing and timing."""

from gvcnn_tf_tpu_torch.utils.fold_bn import fold_batch_norm  # noqa: F401
from gvcnn_tf_tpu_torch.utils.images import (  # noqa: F401
    device_flip,
    normalize_views,
)
from gvcnn_tf_tpu_torch.utils.device import resolve_device  # noqa: F401
from gvcnn_tf_tpu_torch.utils.profiling import (  # noqa: F401
    profile_trace,
    timed_steps,
)
