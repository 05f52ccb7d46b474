"""Utilities of the port: image normalization and BatchNorm folding."""

from gvcnn_tf_tpu_torch.utils.fold_bn import fold_batch_norm  # noqa: F401
from gvcnn_tf_tpu_torch.utils.images import normalize_views  # noqa: F401
