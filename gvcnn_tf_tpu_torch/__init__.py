"""gvcnn_tf_tpu_torch — GVCNN on PyTorch and CUDA, ported from the JAX
package `gvcnn_tf_tpu`, which stays in the repository as the reference.

This package imports `torch` and never JAX or `gvcnn_tf_tpu`.  It mirrors
the JAX package's module names.  Ported so far: the serving path of the
GVCNN/Inception-v1 configs (`serve.py::InferenceEngine`) and their training
path (`train.py`: train-mode layers, the train step, the training loop
with its own checkpoints, on the synthetic stream), with the stem conv and the
grouping head as hand-written CUDA kernels (`csrc/`) and their gradients as
autograd Functions.

    from gvcnn_tf_tpu_torch import InferenceEngine, get_config
    engine = InferenceEngine(get_config("mn40_12view"), device="cuda")

    python -m gvcnn_tf_tpu_torch.train --config mn40_12view
"""

__version__ = "0.1.0"

from gvcnn_tf_tpu_torch.configs import (  # noqa: F401
    CONFIGS,
    DataConfig,
    GVCNNConfig,
    TrainConfig,
    get_config,
)
from gvcnn_tf_tpu_torch.serve import InferenceEngine  # noqa: F401,E402
