"""Kernels: the least time of the traced batch's diffusion bias-attention
calls, from their (B, T, H, d) (bf16 qkv and log2 bias), over the device
time of the kernels that ran them, in %."""
from port_bench.roofline import attention_fwd_bound_s

KERNELS = ("serve_fwd_wgmma", "serve_fwd_mma", "bias_attention_simt")


def read(ctx):
    if "trace" not in ctx:
        return None
    spent = ctx["trace"].kernel_s(KERNELS)
    if spent <= 0 or not ctx["attn_calls"]:
        return None
    bound = sum(attention_fwd_bound_s(c, ctx["sfu_per_s"]) for c in ctx["attn_calls"])
    return 100.0 * bound / spent
