"""Time the consumer of the program's `DevicePrefetcher` waited for a
batch its producer had not made yet, ms a batch handed out: the total of
the `prefetch.blocked` spans over the `prefetch.next` calls, both counted
from the start of the first `train.step` that set nothing up on (one with
no `graph.warmup` or `graph.capture` child: on the card the first replay),
so that the set-up's waits for its first batches are left out.  Read from
the program's span store after the run."""

from gvcnn_tf_tpu_torch.utils import profiling


def read(records):
    snapshot = getattr(profiling, "snapshot", None)
    if records.get("kind") != "train_stream" or snapshot is None:
        return None
    spans = snapshot()["spans"]

    def recs(name):
        return spans.get(name, {}).get("records", ())

    set_up = {r["parent"] for name in ("graph.warmup", "graph.capture")
              for r in recs(name)}
    steady = [r["start_ns"] for r in recs("train.step")
              if r["id"] not in set_up]
    if not steady:
        return None
    since = min(steady)
    batches = sum(r["start_ns"] >= since for r in recs("prefetch.next"))
    if not batches:
        return None
    blocked = sum(r["end_ns"] - r["start_ns"] for r in recs("prefetch.blocked")
                  if r["start_ns"] >= since)
    return blocked / batches / 1e6
