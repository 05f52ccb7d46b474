"""Device ms a train step of the max-pool kernels, forward and backward
(kernels named *max_pool*; the -inf pads before the asymmetric pools run
as generic fill and copy kernels and are not in it)."""

from benchmark.metrics._read import class_ms_per_step


def read(records):
    return class_ms_per_step(records, "max_pool")
