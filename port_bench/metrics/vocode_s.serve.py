"""Vocoder: the timed batch's ``vocode`` stage wall, in seconds."""


def read(ctx):
    return ctx.get("timings", {}).get("vocode")
