"""Median set-up of an `evaluate()` pass, ms: the program's `eval.setup`
span, from the call to its first forward's launch (the scoring model, the
prefetcher's start, the first batch into pinned memory and onto the card),
over the run's passes.  Read from the program's span store after the
run."""

import statistics

from gvcnn_tf_tpu_torch.utils import profiling


def read(records):
    snapshot = getattr(profiling, "snapshot", None)
    if records.get("kind") != "eval_pass" or snapshot is None:
        return None
    recs = snapshot()["spans"].get("eval.setup", {}).get("records")
    if not recs:
        return None
    return statistics.median(r["end_ns"] - r["start_ns"] for r in recs) / 1e6
