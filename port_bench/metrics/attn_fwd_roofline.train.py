"""Kernels: the least time of the traced steps' trainable bias-attention
forwards, from their (B, T, H, d) (bf16 qkv, fp32 bias, the fp32 row
statistic written), over the device time of the kernels that ran them, in %."""
from port_bench.roofline import attention_fwd_bound_s

KERNELS = ("train_fwd_wgmma", "train_fwd_mma", "train_fwd_simt")


def read(ctx):
    if "trace" not in ctx:
        return None
    spent = ctx["trace"].kernel_s(KERNELS)
    if spent <= 0 or not ctx["attn_calls"]:
        return None
    bound = sum(attention_fwd_bound_s(c, ctx["sfu_per_s"], bias_bytes=4, stats=True)
                for c in ctx["attn_calls"])
    return 100.0 * bound / spent
