"""Whole batch: the model FLOPs of a batch of the traced run (counted on the
plain reference at its shapes) over the wall of a batch timed without the
profiler, times the bf16 peak, in %."""
from port_bench.roofline import PEAK_BF16_FLOPS


def read(ctx):
    if not ctx.get("model_flops"):
        return None
    return 100.0 * ctx["model_flops"] / (ctx["batch_wall_s"] * PEAK_BF16_FLOPS)
