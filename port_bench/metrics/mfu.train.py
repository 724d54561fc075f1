"""Whole step: the model FLOPs of a step (forward and backward, counted on
the plain reference at the traced steps' shapes and layer-drop flags) over
the mean wall of the window's untraced steps, times the bf16 peak, in %."""
from port_bench.roofline import PEAK_BF16_FLOPS


def read(ctx):
    if not ctx.get("model_flops") or not ctx.get("step_wall_s"):
        return None
    return 100.0 * ctx["model_flops"] / ctx["steps"] / (ctx["step_wall_s"] * PEAK_BF16_FLOPS)
