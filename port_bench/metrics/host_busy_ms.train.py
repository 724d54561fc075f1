"""Step: the host's time a training step other than its waits on the
device, in ms: a ``train_step`` root's span less the ``wait`` spans inside
it; the mean over the program's kept steps run without the profiler.  None
where the program keeps no such step."""
from collections import defaultdict


def read(ctx):
    try:
        from detail_tts_tpu_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    spans = tracing.snapshot()["spans"]
    waits = defaultdict(int)
    for s in spans:
        if s["name"] == "wait" and s["end_ns"] is not None:
            waits[s["root"]] += s["end_ns"] - s["start_ns"]
    steps = [r["end_ns"] - r["start_ns"] - waits[r["id"]] for r in spans
             if r["name"] == "train_step" and r["parent"] is None
             and r["end_ns"] is not None and not r["attrs"].get("profiled")]
    return sum(steps) / len(steps) / 1e6 if steps else None
