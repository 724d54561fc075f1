"""GPT decode: the ``generate`` stage wall of the traced run's timed batch
(no profiler) over its decode
steps, in ms a code (the engine's ``timings``, which wait for the device)."""


def read(ctx):
    t = ctx.get("timings", {}).get("generate")
    return None if t is None else t / ctx["decode_steps"] * 1e3
