"""Device: 1 - busy / wall of a batch, in %: the device busy time of the
traced run's profiled batch over the wall of its batch timed on its own
without the profiler (whose host cost would double the decode's wall)."""


def read(ctx):
    if "trace" not in ctx:
        return None
    return 100.0 * (1.0 - ctx["trace"].busy_s() / ctx["batch_wall_s"])
