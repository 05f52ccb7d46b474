"""The residual joins' share of their roofline in the train step, %: their
bound over their device time a step (`join_ms_per_step.train`'s: kernels
whose name holds `residual_join`, forward and backward).  The bound counts
the published joins of the configuration's backbone (its reference
module's `join_shapes`) at the cell's sizes, whatever implements them: six
passes over each join's elements in the compute dtype (forward x and u read
and y written, backward dy read and dx and du written) at the card's
bandwidth.  The ReLU's mask and the bias are left out, so no
implementation can read above 100%."""

from benchmark import harness
from benchmark.counting import DTYPE_BYTES
from benchmark.reference import gvcnn

PASSES = 6


def join_bytes(model: dict, images: int) -> int:
    """Bytes a train step of the joins moves at least; 0 where the backbone
    lists no joins."""
    bb = gvcnn.backbone(model["backbone"])
    if not hasattr(bb, "join_shapes"):
        return 0
    elems = sum(j.channels * j.hw[0] * j.hw[1]
                for j in bb.join_shapes(model["final_endpoint"],
                                        model["height"], model["width"]))
    return PASSES * images * elems * DTYPE_BYTES[model["compute_dtype"]]


def read(records):
    ms = harness.reader("join_ms_per_step.train").read(records)
    peaks = records.get("peaks")
    if ms is None or not peaks:
        return None
    nbytes = join_bytes(records["model"], records["views_a_step"])
    if not nbytes:
        return None
    return 100.0 * nbytes / peaks["bytes"] / (ms * 1e-3)
