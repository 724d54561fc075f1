"""Device: 1 - busy / wall of a step, in %: the device busy time of the
profiled steps, a step, over the mean wall of the window's untraced steps."""


def read(ctx):
    if "trace" not in ctx or not ctx.get("step_wall_s"):
        return None
    return 100.0 * (1.0 - ctx["trace"].busy_s() / ctx["steps"] / ctx["step_wall_s"])
