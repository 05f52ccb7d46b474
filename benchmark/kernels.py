"""Kernel classes by name, for the per-layer readers: a frozen copy of the
program's `tools/measure.py::kernel_class` table with BatchNorm's kernels
given a class of their own (the program's table files them under other
classes)."""

_CLASSES = (
    ("stem_conv", ("stem_conv",)),
    ("group_and_fuse", ("group_and_fuse",)),
    ("max_pool", ("max_pool",)),
    ("batch_norm", ("batch_norm", "batchnorm")),
    ("optimizer", ("foreach", "multi_tensor")),
    ("conv", ("conv", "cudnn", "xmma", "dgrad", "wgrad", "fprop",
              "implicit", "sm90_", "nhwc")),
    ("gemm", ("gemm", "cutlass", "ampere", "sm80")),
    ("concat", ("cat",)),
    ("reduce", ("reduce",)),
    ("copy", ("copy", "memcpy")),
    ("elementwise", ("elementwise", "where", "fill")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, parts in _CLASSES:
        if any(p in low for p in parts):
            return cls
    return "other"


def class_seconds(kernels: dict, cls: str) -> float:
    """Total device seconds of the kernels of class `cls` in a profiled
    window's {name: (launches, seconds)}."""
    return sum(s for name, (_, s) in kernels.items()
               if kernel_class(name) == cls)
