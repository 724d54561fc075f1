"""Cells at a size that a CPU test run holds: a checkout root in a temporary
directory whose ``BENCHMARK.json`` names a tiny serving cell and a tiny
training cell (``small_test_config()`` widths, fp32), with this benchmark's
metrics and readers.  The tests of the harness drive them."""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, Optional

from port_bench.reference.config import small_test_config

HERE = Path(__file__).resolve().parent
SERVE, TRAIN = "tiny-serve-cell", "tiny-train-cell"
# limits a sound fp32 run on the CPU meets by orders of magnitude
SERVE_LIMITS = {"text_id_mismatches": 0, "prompt_mel_err": 1e-3, "decode_gap": 1e-3,
                "nucleus_gap": 1e-3, "latents_err": 1e-3, "cond_err": 1e-3, "mel_err": 1e-3,
                "wav_err": 1e-3}
TRAIN_LIMITS = {"change_gap": 5e-2, "grad_median_gap": 1e-3, "change_median_gap": 1e-3}


def _dump(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=1)


def make_root(root: Path, serve_limits: Optional[Dict] = None,
              train_limits: Optional[Dict] = None) -> Path:
    root = Path(root)
    pb = root / "port_bench"
    shutil.copytree(HERE / "metrics", pb / "metrics", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = small_test_config().to_dict()
    cfg.pop("mesh")
    engine = {"max_generate_length": 12, "text_buckets": [16, 32], "prompt_buckets": [32, 64],
              "code_buckets": [8, 12], "compute_dtype": "float32", "cache_dtype": "float32"}
    _dump(pb / "configs" / "tiny-serve.json", {**cfg, "engine": engine})
    train = json.loads(json.dumps(cfg))
    train["train"].update(target="diff", batch_size=4, gradient_accumulate_every=2,
                          val_freq=10 ** 9, save_freq=10 ** 9)
    _dump(pb / "configs" / "tiny-train.json", train)
    _dump(pb / "traffic" / "tiny-offline.json",
          {"kind": "serve_offline", "batch": 3, "text_chars": [2, 5],
           "prompt_seconds": [0.2, 0.6]})
    _dump(pb / "traffic" / "tiny-steps.json",
          {"kind": "train", "micro_batch": 4, "accum": 2, "frames": 32, "text_tokens": 8,
           "warmup_steps": 3, "traced_steps": 2})
    _dump(pb / "workloads" / f"{SERVE}.json",
          {"sample_rows": 3, "min_batches": 2,
           "limits": serve_limits or SERVE_LIMITS})
    _dump(pb / "workloads" / f"{TRAIN}.json",
          {"block_rows": 2, "limits": train_limits or TRAIN_LIMITS})
    with open(HERE.parent / "BENCHMARK.json", encoding="utf-8") as f:
        bench = json.load(f)
    bench["configs"] = [
        {"name": "tiny-serve", "source": "small_test_config()", "reduced": [],
         "file": "port_bench/configs/tiny-serve.json", "why": "CPU tests"},
        {"name": "tiny-train", "source": "small_test_config()", "reduced": [],
         "file": "port_bench/configs/tiny-train.json", "why": "CPU tests"}]
    bench["workloads"] = [
        {"name": SERVE, "config": "tiny-serve", "traffic": "tiny-offline", "chips": 1,
         "why": "CPU tests"},
        {"name": TRAIN, "config": "tiny-train", "traffic": "tiny-steps", "chips": 1,
         "why": "CPU tests"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [SERVE if w.startswith("serve") else TRAIN for w in m["workloads"]]
    _dump(root / "BENCHMARK.json", bench)
    return root
