"""Where the time of one zero-shot request goes in the PyTorch port, on one GPU.

    python3 profile_port.py [--batch 2] [--codes 200]

Builds the full-width engine with seeded random weights, as chip_smoke.py
does, and answers one warm-up request.  Then it answers the same request
twice: once untraced, for each stage's wall time (``timings``), and once
under ``torch.profiler``, for the device time inside each stage (the union
of the device's kernel and copy intervals; the profiler slows the host, not
the kernels).  It prints each stage's wall time, device busy time and idle
share (1 - busy / wall), then the kernels with the most device time.  The
last line is one JSON object with the same numbers.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

STAGES = ("prepare", "generate", "diff_cond", "latents", "diffuse", "vocode", "host")


def union_us(spans):
    """Total length of the union of (start, end) intervals."""
    total, cur = 0.0, None
    for s, e in sorted(spans):
        if cur is None or s > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return total + (cur[1] - cur[0] if cur else 0.0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--codes", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_port.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)

    from detail_tts_tpu_torch.config import Config
    from detail_tts_tpu_torch.serving.pipeline import EngineConfig, random_engine

    cfg = Config()
    engine = random_engine(cfg, seed=0, device="cuda",
                           engine_cfg=EngineConfig(max_generate_length=args.codes + 1))
    sr = cfg.data.sampling_rate
    rng = np.random.default_rng(0)
    prompts = [rng.uniform(-0.3, 0.3, 3 * sr).astype(np.float32)
               for _ in range(args.batch)]
    texts = ["今天天气很好，我们一起去公园散步吧。"] * args.batch

    def request(timings=None):
        return engine.synthesize_batch(texts, prompts, seed=0, force_full=True,
                                       timings=timings)

    request()  # warm-up: builds the kernel, fills the caches
    wall = {}
    outs = request(wall)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        request({})  # with timings, so each stage ends in a synchronisation
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation and e.name not in STAGES]
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    windows = {e.name: (e.time_range.start, e.time_range.end) for e in events
               if e.name in STAGES and e.device_type == DeviceType.CPU}

    rows = {}
    for name in STAGES:
        ws, we = windows[name]
        busy_ms = union_us([(max(s, ws), min(e, we)) for s, e in spans
                            if e > ws and s < we]) / 1e3
        wall_ms = wall[name] * 1e3
        rows[name] = dict(wall_ms=wall_ms, busy_ms=busy_ms,
                          idle_share=1.0 - busy_ms / wall_ms)
    wall_all = sum(r["wall_ms"] for r in rows.values())
    busy_all = sum(r["busy_ms"] for r in rows.values())
    audio_s = sum(len(o) for o in outs) / sr
    print(f"request batch={args.batch} codes={args.codes}: {audio_s:.2f} s of audio, "
          f"wall {wall_all:.1f} ms, device busy {busy_all:.1f} ms "
          f"(idle share {1 - busy_all / wall_all:.3f})")
    for name, r in rows.items():
        print(f"  {name:9s} wall {r['wall_ms']:9.2f} ms  busy {r['busy_ms']:9.2f} ms"
              f"  idle {r['idle_share']:.3f}")

    per_kernel = {}
    for e in device:
        n, ms = per_kernel.get(e.name, (0, 0.0))
        per_kernel[e.name] = (n + 1, ms + (e.time_range.end - e.time_range.start) / 1e3)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:12]
    print(f"device launches {sum(n for n, _ in per_kernel.values())}; "
          "top device time (ms, launches, name):")
    for name, (n, ms) in top:
        print(f"  {ms:9.2f} {n:7d}  {name[:100]}")
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), batch=args.batch, codes=args.codes,
        audio_s=audio_s, wall_ms=wall_all, busy_ms=busy_all, stages=rows,
        launches=sum(n for n, _ in per_kernel.values()),
        top_kernels=[dict(name=k[:100], launches=n, ms=ms) for k, (n, ms) in top])))


if __name__ == "__main__":
    main()
