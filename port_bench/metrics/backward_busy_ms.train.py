"""Step: device busy time inside the step's ``backward`` ranges, a step, in ms."""


def read(ctx):
    if "trace" not in ctx:
        return None
    return ctx["trace"].busy_in_s("backward") / ctx["steps"] * 1e3
