"""Utilities of the port: image normalization, BatchNorm folding and the
entry points' device."""

from gvcnn_tf_tpu_torch.utils.fold_bn import fold_batch_norm  # noqa: F401
from gvcnn_tf_tpu_torch.utils.images import normalize_views  # noqa: F401
from gvcnn_tf_tpu_torch.utils.device import resolve_device  # noqa: F401
