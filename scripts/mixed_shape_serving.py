"""Serving at mixed batch shapes on one GPU, in ``TTSServer``'s order.

    python3 scripts/mixed_shape_serving.py [--batches 16] [--codes 200] [--seed 0] [--kept N]

Builds the full-width engine (``Config()``, seeded random weights, the
shipped ``EngineConfig`` but for ``max_generate_length``, ``--codes`` + 1),
then runs a seeded sequence of ``--batches`` batches twice, the second pass
timed.  A batch holds 1-8 requests (the server's ``max_batch``), each a
text of 4, 10, 25 or 50 hanzi and a 3 s prompt, so the batches fall on
several (batch, text bucket) shapes.  Each pass runs the server's
double-buffered order: batch N+1's decode dispatched, batch N finalized,
N+1's tail dispatched; the decode stops early as the server's does (random
weights run every decode to its cap).

Prints, for the timed pass: its wall and seconds of audio a second, the
distinct shapes, the decode's graph captures and replays (the counters
``decode.graph_captures`` and ``decode.graph_replays``, where the program
keeps them) with each capture's host time, and the peak of allocated and
reserved memory.  ``--kept`` sets ``models/gpt.py``'s ``KEPT_STEPS`` (where
the program has it).  The last line is one JSON object.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HANZI = ("今天天气很好我们一起去公园散步吧这是一个用来测试的句子声音克隆需要几秒钟的"
         "提示音频然后模型会生成同一个说话人的语音")
TEXT_HANZI = (4, 10, 25, 50)


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--codes", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kept", type=int, default=None)
    args = ap.parse_args()

    from detail_tts_tpu_torch.config import Config
    from detail_tts_tpu_torch.models import gpt as gpt_module
    from detail_tts_tpu_torch.serving.pipeline import EngineConfig, random_engine

    try:
        from detail_tts_tpu_torch import tracing
    except ImportError:  # a program without the tracer
        tracing = None
    if args.kept is not None and hasattr(gpt_module, "KEPT_STEPS"):
        gpt_module.KEPT_STEPS = args.kept
    capture_s = []
    step_cls = getattr(gpt_module, "_Step", None)
    if step_cls is not None:
        capture = step_cls.capture

        def timed_capture(self, *a, **kw):
            t0 = time.perf_counter()
            capture(self, *a, **kw)
            capture_s.append(time.perf_counter() - t0)

        step_cls.capture = timed_capture

    def count(name):
        if tracing is None:
            return 0
        return tracing.snapshot()["counters"].get(name, {"count": 0})["count"]

    cfg = Config()
    engine = random_engine(cfg, seed=0, device="cuda",
                           engine_cfg=EngineConfig(max_generate_length=args.codes + 1))
    sr = cfg.data.sampling_rate
    rng = np.random.default_rng(args.seed)
    batches = []
    for i in range(args.batches):
        n = int(rng.integers(1, 9))
        texts = [HANZI[:int(rng.choice(TEXT_HANZI))] for _ in range(n)]
        prompts = [rng.uniform(-0.3, 0.3, 3 * sr).astype(np.float32) for _ in range(n)]
        batches.append((texts, prompts, i))
    shapes = sorted({(len(t), int(engine.prepare_text(t)[0].shape[1])) for t, _, _ in batches})

    def run_pass():
        audio, inflight = 0, None
        for texts, prompts, seed in batches:
            pending = engine.dispatch_decode(texts, prompts, seed=seed)
            if inflight is not None:
                audio += sum(len(w) for w in engine.finalize_batch(inflight))
            inflight = engine.dispatch_tail(pending)
        audio += sum(len(w) for w in engine.finalize_batch(inflight))
        return audio / sr

    run_pass()  # warm-up: kernel builds, caches, every shape once
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = [count(k) for k in ("decode.graph_captures", "decode.graph_replays",
                                 "decode.steps")]
    del capture_s[:]
    t0 = time.perf_counter()
    audio_s = run_pass()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    captures, replays, steps = [count(k) - b for k, b in zip(
        ("decode.graph_captures", "decode.graph_replays", "decode.steps"), before)]
    gib = 2.0 ** 30
    out = {
        "gpu": torch.cuda.get_device_name(), "torch": torch.__version__,
        "batches": args.batches, "codes": args.codes, "seed": args.seed,
        "kept": getattr(gpt_module, "KEPT_STEPS", None),
        "shapes": shapes, "n_shapes": len(shapes),
        "wall_s": wall, "audio_s": audio_s, "audio_s_per_s": audio_s / wall,
        "captures": captures, "replays": replays, "decode_steps": steps,
        "capture_host_ms": [s * 1e3 for s in capture_s],
        "peak_allocated_gib": torch.cuda.max_memory_allocated() / gib,
        "peak_reserved_gib": torch.cuda.max_memory_reserved() / gib,
    }
    print(f"{args.batches} batches on {len(shapes)} shapes, kept {out['kept']}: "
          f"{wall:.3f} s, {out['audio_s_per_s']:.3f} s/s, {captures} captures "
          f"({np.mean(capture_s) * 1e3 if capture_s else 0:.1f} ms of host each), "
          f"{replays} replays of {steps} steps, peak {out['peak_allocated_gib']:.3f} GiB")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
