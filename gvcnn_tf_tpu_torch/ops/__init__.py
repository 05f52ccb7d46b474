"""Ops of the port: the grouping head and TF-'SAME' pooling in plain
PyTorch, and the hand-written CUDA kernels with their wrappers
(stem_kernel.py, grouping_kernel.py, pool_kernel.py, batch_norm_kernel.py),
built by _build.py.

Each kernel is reached through a `torch.library` op (`torch.ops.gvcnn.*`)
with its fake and its autograd registered (train-mode BatchNorm's
statistics op, which mutates the running statistics, takes no gradient);
the op's implementation runs the plain version on the CPU and the kernel on
a card.  The ops are made with
`torch.library.define` and `impl`, not `torch.library.custom_op`, whose
wrapper imports `torch._dynamo` at an op's first call: seconds of every
process's set-up, for a compiler the port does not use.  Importing this
package registers every op.  `launches` counts each entry point's launches
by name (`_build.launch`); `launched(prefix)` sums those whose names start
with `prefix`."""

import torch

from gvcnn_tf_tpu_torch.ops._build import launched, launches  # noqa: F401


def capturing() -> bool:
    """Whether the current stream is being captured into a CUDA graph
    (`utils/graphs.py`): the kernels' host-side caches then compute instead
    of looking up, so that the graph reads the weights themselves."""
    return torch.cuda.is_available() and (
        torch.cuda.is_current_stream_capturing())


# Registers the ops; after `capturing`, which the modules import.
from gvcnn_tf_tpu_torch.ops import (  # noqa: E402,F401
    batch_norm_kernel,
    grouping_kernel,
    pool_kernel,
    stem_kernel,
)
