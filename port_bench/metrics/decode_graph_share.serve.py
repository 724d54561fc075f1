"""GPT decode: the share of the process's decode steps whose GPT call was a
replay of a CUDA graph, the counter ``decode.graph_replays`` over the
counter ``decode.steps``.  The last step of a decode samples and makes no
GPT call, so a process whose every call replays reads (n - 1) / n for
decodes of n steps.  None where the program keeps no such counter."""


def read(ctx):
    try:
        from detail_tts_tpu_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    counters = tracing.snapshot()["counters"]
    replays, steps = counters.get("decode.graph_replays"), counters.get("decode.steps")
    if replays is None or not steps or not steps["count"]:
        return None
    return replays["count"] / steps["count"]
