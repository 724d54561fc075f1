"""Diffusion: the timed batch's ``diffuse`` stage wall, in seconds."""


def read(ctx):
    return ctx.get("timings", {}).get("diffuse")
