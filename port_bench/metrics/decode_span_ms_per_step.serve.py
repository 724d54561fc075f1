"""GPT decode: device-timeline time a decode step, in ms: the ``generate``
stage's CUDA-event duration (from before its first launch to after its
last) over its ``decode_step`` spans; the median over the batches run
without the profiler or ``timings``, the engine's first batch left out.
In the traced run that leaves the window's first batch, dispatched just
after the warm-up batch finished, so with no previous batch's tail in
flight: the reading lies ~20% above what the double-buffered batches of
an untraced window take.  None where the program keeps no spans."""
import statistics
from collections import Counter, defaultdict


def read(ctx):
    try:
        from detail_tts_tpu_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    spans = tracing.snapshot()["spans"]
    kids = defaultdict(list)
    for s in spans:
        kids[s["root"]].append(s)
    per = []
    for r in spans:
        a = r["attrs"]
        if (r["name"] != "batch" or r["parent"] is not None or r["end_ns"] is None
                or a.get("profiled") or a.get("synced") or a.get("batch", 0) == 0):
            continue
        steps = Counter(s["parent"] for s in kids[r["id"]] if s["name"] == "decode_step")
        for g in kids[r["id"]]:
            if g["name"] == "generate" and steps[g["id"]] and g["device_ms"] is not None:
                per.append(g["device_ms"] / steps[g["id"]])
    return statistics.median(per) if per else None
