"""Median host work of the program's `DevicePrefetcher` producer for one
batch (into pinned memory), ms: its `prefetch.produce` spans.  Read from
the program's span store after the run."""

import statistics

from gvcnn_tf_tpu_torch.utils import profiling


def read(records):
    snapshot = getattr(profiling, "snapshot", None)
    if records.get("kind") != "train_stream" or snapshot is None:
        return None
    recs = snapshot()["spans"].get("prefetch.produce", {}).get("records")
    if not recs:
        return None
    return statistics.median(r["end_ns"] - r["start_ns"] for r in recs) / 1e6
