"""Device ms a train step of the average-pool kernels, forward and
backward: every kernel whose name holds `avg_pool` (PyTorch's
`avg_pool2d_*` kernels, which `benchmark/kernels.py` files under `conv`
for their `nhwc`), matched here by name."""


def read(records):
    prof = records.get("profile")
    if not prof or not prof.get("steps"):
        return None
    s = sum(sec for name, (_, sec) in prof["kernels"].items()
            if "avg_pool" in name.lower())
    return s / prof["steps"] * 1e3 if s > 0 else None
