"""Seconds the program spent building its train state (the model on the
CPU, initialized and moved to the card, the optimizer and generators):
the program's `train.create_state` spans.  Read from the program's span
store after the run."""

from gvcnn_tf_tpu_torch.utils import profiling


def read(records):
    snapshot = getattr(profiling, "snapshot", None)
    if records.get("kind") not in ("train_stream", "eval_pass") or (
            snapshot is None):
        return None
    span = snapshot()["spans"].get("train.create_state")
    return span["total_ns"] / 1e9 if span else None
