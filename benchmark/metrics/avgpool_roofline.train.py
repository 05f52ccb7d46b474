"""The average pools' share of their roofline in the train step, %: their
bound over their device time a step (`avgpool_ms_per_step.train`'s:
kernels whose name holds `avg_pool`, forward and backward).  The bound counts the published pools of the
configuration's backbone (its reference module's `pool_shapes`) at the
cell's sizes: forward input read once and output written once, backward
dy read once and dx written once, in the compute dtype, at the card's
bandwidth; whatever implements the pools later, the work counted stays."""

from benchmark import harness
from benchmark.counting import DTYPE_BYTES
from benchmark.reference import gvcnn


def pool_bytes(model: dict, images: int) -> int:
    """Bytes a train step of the average pools moves at least; 0 where
    the backbone lists no pools."""
    bb = gvcnn.backbone(model["backbone"])
    if not hasattr(bb, "pool_shapes"):
        return 0
    elems = sum(p.channels * (p.inp[0] * p.inp[1] + p.out[0] * p.out[1])
                for p in bb.pool_shapes(model["final_endpoint"],
                                        model["height"], model["width"])
                if p.kind == "avg")
    return 2 * images * elems * DTYPE_BYTES[model["compute_dtype"]]


def read(records):
    ms = harness.reader("avgpool_ms_per_step.train").read(records)
    peaks = records.get("peaks")
    if ms is None or not peaks:
        return None
    nbytes = pool_bytes(records["model"], records["views_a_step"])
    if not nbytes:
        return None
    return 100.0 * nbytes / peaks["bytes"] / (ms * 1e-3)
