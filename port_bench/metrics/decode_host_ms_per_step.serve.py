"""GPT decode: host time a decode step, in ms: the mean of a batch's
``decode_step`` spans; the median over the batches run without the
profiler or ``timings``, the engine's first batch left out.  In the traced
run that leaves the window's first batch, dispatched just after the
warm-up batch finished, so with no previous batch's tail in flight: the
reading lies ~20% above what the double-buffered batches of an untraced
window take.  None where the program keeps no spans."""
import statistics
from collections import defaultdict


def read(ctx):
    try:
        from detail_tts_tpu_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    spans = tracing.snapshot()["spans"]
    steps = defaultdict(list)
    for s in spans:
        if s["name"] == "decode_step" and s["end_ns"] is not None:
            steps[s["root"]].append(s["end_ns"] - s["start_ns"])
    per = []
    for r in spans:
        a = r["attrs"]
        if (r["name"] != "batch" or r["parent"] is not None or r["end_ns"] is None
                or a.get("profiled") or a.get("synced") or a.get("batch", 0) == 0):
            continue
        if steps[r["id"]]:
            per.append(statistics.fmean(steps[r["id"]]) / 1e6)
    return statistics.median(per) if per else None
