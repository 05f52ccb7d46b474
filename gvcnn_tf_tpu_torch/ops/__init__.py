"""Ops of the port: the grouping head and TF-'SAME' pooling in plain
PyTorch, and the two hand-written CUDA kernels with their wrappers
(stem_kernel.py, grouping_kernel.py), built by _build.py."""
