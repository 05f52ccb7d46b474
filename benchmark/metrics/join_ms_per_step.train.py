"""Device ms a train step of the residual joins, forward and backward:
every kernel whose name holds `residual_join` (the port's
`residual_join_fwd`, `residual_join_bwd` and the bias gradient's
`residual_join_bias_grad_kernel`, which `benchmark/kernels.py` files under
`other`), matched here by name."""


def read(records):
    prof = records.get("profile")
    if not prof or not prof.get("steps"):
        return None
    s = sum(sec for name, (_, sec) in prof["kernels"].items()
            if "residual_join" in name.lower())
    return s / prof["steps"] * 1e3 if s > 0 else None
