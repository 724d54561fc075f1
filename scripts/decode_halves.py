"""A sampled bf16 decode of 4 rows against its two 2-row halves, on one GPU.

    python3 scripts/decode_halves.py [--eager] [--seeds 16]

The request of ``chip_smoke.py``'s phase 9 (4 texts, 3 s prompts, 64 codes
under ``force_full``, ``Config()`` with seeded random weights, bf16): for
each seed the one-card engine decodes the 4 rows as one batch and as the
two halves a (2 x 1) engine's data ranks decode (``Rows``, the request's
text width, the rows' own draws).  Prints per seed the codes that differ,
each row's first differing step, the largest |logit| difference before a
row's first flip (the same history on both sides) and at the prefill;
``--eager`` runs the GPT's static step without its CUDA graph (where the
program has one).  The last line is ``SUMMARY`` and one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

TEXTS = ["你好。", "今天天气很好，我们一起去公园散步吧。", "这是第三个请求。",
         "欢迎使用语音合成，这是一个长一点的句子。"]
CODES = 64


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--seeds", type=int, default=16)
    args = ap.parse_args()

    from detail_tts_tpu_torch.config import Config
    from detail_tts_tpu_torch.models import gpt as gpt_module
    from detail_tts_tpu_torch.ops import prng
    from detail_tts_tpu_torch.parallel.mesh import Rows
    from detail_tts_tpu_torch.serving.pipeline import EngineConfig, random_engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.eager and hasattr(gpt_module, "_replays"):
        gpt_module._replays = lambda model, device: False
    cfg = Config()
    engine = random_engine(cfg, seed=0, device="cuda", engine_cfg=EngineConfig(
        max_generate_length=CODES + 1, compute_dtype=torch.bfloat16,
        cache_dtype=torch.bfloat16))
    sr = cfg.data.sampling_rate
    rng = np.random.default_rng(9)  # phase 9's prompts
    wavs = [rng.uniform(-0.3, 0.3, 3 * sr).astype(np.float32) for _ in TEXTS]

    record = []
    sample_step = gpt_module.sample_step

    def recorded(logits, *a, **kw):
        record.append(logits.float().clone())
        return sample_step(logits, *a, **kw)

    gpt_module.sample_step = recorded

    def decode(mel, mlen, text, key, rows=None):
        record.clear()
        codes = engine._decode(mel, mlen, text, key, CODES + 1, True, rows)[0].cpu()
        return codes, list(record)

    out = []
    with torch.inference_mode():
        text = engine.prepare_text(TEXTS)[0]
        mel, mlen = engine.prepare_prompt(wavs)
        halves_in = [(*engine.prepare_prompt(wavs[a:a + 2]), text[a:a + 2], Rows(a, a + 2, 4))
                     for a in (0, 2)]
        for seed in range(args.seeds):
            key = prng.split(prng.as_key(seed), 3)[0]  # dispatch_decode's decode key
            full, full_logits = decode(mel, mlen, text, key)
            halves = [decode(m, ml, t, key, rows) for m, ml, t, rows in halves_in]
            differ = full != torch.cat([c for c, _ in halves])
            first = [int(differ[r].nonzero()[0]) if differ[r].any() else None
                     for r in range(4)]
            before = 0.0
            for r in range(4):
                h, i = divmod(r, 2)
                stop = len(full_logits) if first[r] is None else first[r] + 1
                for s in range(stop):
                    before = max(before, float(
                        (full_logits[s][r] - halves[h][1][s][i]).abs().max()))
            prefill = max(float((full_logits[0][2 * h:2 * h + 2] - halves[h][1][0]).abs().max())
                          for h in (0, 1))
            out.append({"seed": seed, "differ": int(differ.sum()), "first": first,
                        "logit_diff_before_flip": before, "prefill_logit_diff": prefill})
            print(json.dumps(out[-1]), flush=True)
    print("SUMMARY", json.dumps({
        "gpu": torch.cuda.get_device_name(), "eager": args.eager, "seeds": args.seeds,
        "codes_differ": sum(o["differ"] for o in out), "of": args.seeds * 4 * (CODES + 1),
        "rows_flipped": sum(f is not None for o in out for f in o["first"]),
        "of_rows": args.seeds * 4,
        "max_logit_diff_before_flip": max(o["logit_diff_before_flip"] for o in out),
        "max_prefill_logit_diff": max(o["prefill_logit_diff"] for o in out)}))


if __name__ == "__main__":
    main()
