"""Share of the profiled sub-window of a `train_stream` cell in which no
operation ran on the card (torch.profiler), %."""

from benchmark.metrics._read import idle_pct


def read(records):
    return idle_pct(records, "train_stream")
