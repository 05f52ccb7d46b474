"""gvcnn_tf_tpu_torch — GVCNN on PyTorch and CUDA, ported from the JAX
package `gvcnn_tf_tpu`, which stays in the repository as the reference.

This package imports `torch` and never JAX or `gvcnn_tf_tpu`.  It mirrors
the JAX package's module names.  Ported so far, for the GVCNN/Inception-v1
configs: serving (`serve.py::InferenceEngine`), training (`train.py`: the
train-mode layers, the train step, the training loop with its own
checkpoints and `--eval_every`), evaluation (`eval.py`) and prediction
(`predict.py`), on the synthetic stream and the procedural split, with the
stem conv and the grouping head as hand-written CUDA kernels (`csrc/`) and
their gradients as autograd Functions.

    from gvcnn_tf_tpu_torch import InferenceEngine, get_config
    engine = InferenceEngine(get_config("mn40_12view"), device="cuda")

    python -m gvcnn_tf_tpu_torch.train --config mn40_12view ...
    python -m gvcnn_tf_tpu_torch.eval --config mn40_12view ...

As in the JAX package, `gvcnn_tf_tpu_torch.train` and `.predict` are the
functions exported here; import the modules with `importlib`.
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
from gvcnn_tf_tpu_torch.train import train  # noqa: F401,E402
from gvcnn_tf_tpu_torch.eval import evaluate  # noqa: F401,E402
from gvcnn_tf_tpu_torch.predict import predict  # noqa: F401,E402
