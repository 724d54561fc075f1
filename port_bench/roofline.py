"""The yardstick's arithmetic: the card's peaks, the least time of a bias
attention call from its shape, and model FLOPs counted on the plain
reference.

Peaks are NVIDIA's published dense figures for one H100 SXM at its 700 W
limit: 989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM3.  The
exp2 rate is the card's own: 16 special-function results a clock an SM at
the card's largest SM clock.  Work is counted from the model's call shapes,
never from the kernels that ran them: each input byte read once, each output
byte written once, 4 B H T^2 d tensor FLOPs a forward (Q K^T and P V), 10
a backward (the logits again, dO V^T, dQ, dK, dV), B H T^2 exp2 each.
"""
from __future__ import annotations

import subprocess
from typing import Callable, Dict, List, Tuple

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
SFU_PER_CLOCK_PER_SM = 16

AttnCall = Tuple[int, int, int, int]  # (B, T, H, d)


def smi(query: str) -> str:
    """One ``nvidia-smi --query-gpu`` field of the first card."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=30)
    return out.stdout.strip().splitlines()[0]


def sfu_per_s(sms: int, max_sm_clock_mhz: float) -> float:
    return sms * SFU_PER_CLOCK_PER_SM * max_sm_clock_mhz * 1e6


def attention_fwd_bound_s(call: AttnCall, sfu: float, bias_bytes: int = 2,
                          stats: bool = False) -> float:
    """Least time of one forward: bf16 qkv in and out, the (H, T, T) bias
    at ``bias_bytes`` a value, with ``stats`` the fp32 row statistic out."""
    b, t, h, d = call
    nbytes = 2 * (b * t * 3 * h * d + b * t * h * d) + bias_bytes * h * t * t
    if stats:
        nbytes += 4 * b * h * t
    flops = 4.0 * b * h * t * t * d
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS, b * h * t * t / sfu)


def attention_bwd_bound_s(call: AttnCall, sfu: float) -> float:
    """Least time of one backward: qkv, out, dout (bf16), the fp32 bias and
    row statistic in; dqkv (bf16) and the batch-summed fp32 dbias out."""
    b, t, h, d = call
    nbytes = (2 * (b * t * 3 * h * d + 2 * b * t * h * d + b * t * 3 * h * d)
              + 4 * (2 * h * t * t + b * h * t))
    flops = 10.0 * b * h * t * t * d
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS, b * h * t * t / sfu)


def attention_calls(model: torch.nn.Module, block_type: type,
                    run: Callable[[], object]) -> List[AttnCall]:
    """(B, T, H, d) of every call of a ``block_type`` module (the reference's
    ``AttentionBlock``) while ``run()`` runs."""
    calls: List[AttnCall] = []

    def hook(module, args):
        x = args[0]
        calls.append((x.shape[0], x.shape[1], module.num_heads,
                      module.channels // module.num_heads))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, block_type)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
    return calls


def count_flops(run: Callable[[], object]) -> float:
    """Matrix-product FLOPs of ``run()`` (forward and any backward inside),
    by ``torch.utils.flop_counter``; run it on the ``meta`` device."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        run()
    return float(counter.get_total_flops())


def device_info() -> Dict[str, object]:
    """The card's name, power limit, SMs and largest SM clock."""
    props = torch.cuda.get_device_properties(0)
    clock = float(smi("clocks.max.sm").split()[0])
    return {"kind": torch.cuda.get_device_name(0), "power_limit": smi("power.limit"),
            "sms": props.multi_processor_count, "max_sm_clock_mhz": clock,
            "sfu_per_s": sfu_per_s(props.multi_processor_count, clock)}
