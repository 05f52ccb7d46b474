"""The train step's counted work (`counting.py`: 3x the forward's conv
and matmul FLOPs) over its mean time before the profiled sub-window,
against the card's data-sheet peak for the compute dtype, %."""

from benchmark.counting import train_step_flops


def read(records):
    steady, peaks = records.get("steady"), records.get("peaks")
    if not steady or not steady[0] or not peaks:
        return None
    steps, seconds = steady
    model = records["model"]
    flops = train_step_flops(model, records["shapes_a_step"])
    return 100.0 * flops * steps / seconds / peaks[model["compute_dtype"]]
