"""Device ms a train step of the BatchNorm kernels, forward and backward
(kernels named *batch_norm*)."""

from benchmark.metrics._read import class_ms_per_step


def read(records):
    return class_ms_per_step(records, "batch_norm")
