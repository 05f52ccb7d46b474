"""Median host work of the compiled step's call over its replayed calls,
ms: the program's `train.step` span less its `graph.launch` child (the
replay's launch, which blocks while the device's launch queue is full),
i.e. the span's self time; the calls that warmed up or captured the graph
are left out.  Read from the program's span store after the run."""

import statistics

from gvcnn_tf_tpu_torch.utils import profiling


def read(records):
    snapshot = getattr(profiling, "snapshot", None)
    if records.get("kind") != "train_stream" or snapshot is None:
        return None
    spans = snapshot()["spans"]

    def parents(name):
        return {r["parent"] for r in spans.get(name, {}).get("records", ())}

    launched = parents("graph.launch")
    set_up = parents("graph.warmup") | parents("graph.capture")
    own = [r["self_ns"] for r in spans.get("train.step", {}).get("records", ())
           if r["id"] in launched and r["id"] not in set_up]
    return statistics.median(own) / 1e6 if own else None
