"""Ops of the port: the grouping head and TF-'SAME' pooling in plain
PyTorch, and the hand-written CUDA kernels with their wrappers
(stem_kernel.py, grouping_kernel.py, pool_kernel.py), built by _build.py."""

import torch


def as_operator() -> bool:
    """Whether a kernel wrapper should call its `torch.library` op rather
    than its forward directly: while tracing (`torch.export`: a traced
    tensor has no data pointer to launch with) and under a Python dispatch
    mode (the work counter of `tools/bench_layers.py`), which then sees the
    kernel as one operator, whichever implementation runs under it."""
    return (torch.compiler.is_compiling()
            or torch._C._len_torch_dispatch_stack() > 0)


def capturing() -> bool:
    """Whether the current stream is being captured into a CUDA graph
    (`utils/graphs.py`): the kernels' host-side caches then compute instead
    of looking up, so that the graph reads the weights themselves."""
    return torch.cuda.is_available() and (
        torch.cuda.is_current_stream_capturing())
