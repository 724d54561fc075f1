"""Kernels: the least time of the traced steps' bias-attention backwards,
from their (B, T, H, d), over the device time of the kernels that ran them
(dq with dbias, dk with dv, and the dbias sum), in %."""
from port_bench.roofline import attention_bwd_bound_s

KERNELS = ("bwd_dq_", "bwd_dkv_", "dbias_sum")


def read(ctx):
    if "trace" not in ctx:
        return None
    spent = ctx["trace"].kernel_s(KERNELS)
    if spent <= 0 or not ctx["attn_calls"]:
        return None
    return 100.0 * sum(attention_bwd_bound_s(c, ctx["sfu_per_s"])
                       for c in ctx["attn_calls"]) / spent
