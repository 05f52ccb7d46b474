"""Share of the profiled sub-window of a `eval_pass` cell in which no
operation ran on the card (torch.profiler), %."""

from benchmark.metrics._read import idle_pct


def read(records):
    return idle_pct(records, "eval_pass")
