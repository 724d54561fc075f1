"""Device: the largest memory allocated during the window, in GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30 if ctx.get("peak_bytes") else None
