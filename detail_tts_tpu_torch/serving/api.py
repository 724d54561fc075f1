"""Zero-shot synthesis CLI: the reference's api.py surface, with argparse.

Counterpart of ``detail_tts_tpu/serving/api.py``.  Reference flow
(api.py:21-50): pinyin -> BPE -> prompt mel -> SynthesizerTrn.infer -> wav;
here ``TTSEngine.synthesize``.

Usage:
  python -m detail_tts_tpu_torch.serving.api --text "你好世界" \\
      --prompt prompt.wav --out gen.wav \\
      [--config config.json] [--ckpt model.pt] [--device cuda] \\
      [--vq-only] [--long] [--sampler ancestral] [--diffusion-steps 25] \\
      [--seed 0]

Without ``--ckpt`` the engine runs with random weights (smoke mode).
``--ckpt`` takes a checkpoint directory the port's trainer wrote (its
newest step, weight norm folded on load) or a torch checkpoint file
(``model-*.pt`` of the reference, or ``train/checkpoint.py:save_variables``
output).  The engine runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

from detail_tts_tpu_torch.data.dataset import save_wav


def load_wav(path: str, target_sr: int) -> np.ndarray:
    import scipy.signal as sps
    from scipy.io import wavfile

    sr, wav = wavfile.read(path)
    wav = np.asarray(wav, np.float32)
    if wav.dtype != np.float32 or wav.max() > 2.0:
        wav = wav / 32768.0
    if wav.ndim > 1:
        wav = wav[:, 0]
    if sr != target_sr:
        wav = sps.resample_poly(wav, target_sr, sr).astype(np.float32)
    return wav


def build_engine(config: str | None, ckpt: str | None, seed: int = 0,
                 engine_cfg=None, device="cuda"):
    """An engine from a config file (or ``Config()``) and a checkpoint: a
    trainer's checkpoint directory or a torch checkpoint file (or seeded
    random weights, with a warning)."""
    import os

    import torch

    from detail_tts_tpu_torch.config import Config
    from detail_tts_tpu_torch.io.weights import load_reference_checkpoint
    from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
    from detail_tts_tpu_torch.serving.pipeline import (EngineConfig, TTSEngine,
                                                       random_engine,
                                                       resolve_device)

    cfg = Config.from_json(config) if config else Config()
    engine_cfg = engine_cfg or EngineConfig()
    if ckpt is None:
        print("WARNING: no --ckpt given; synthesizing with random weights",
              file=sys.stderr)
        return random_engine(cfg, seed=seed, engine_cfg=engine_cfg, device=device)
    dev = resolve_device(device)
    with torch.device(dev):
        model = SynthesizerTrn(cfg)
    if os.path.isdir(ckpt):
        from detail_tts_tpu_torch.train.checkpoint import restore_variables

        model.load_state_dict(restore_variables(ckpt, cfg))
        return TTSEngine(model, engine_cfg, device=dev)
    report = load_reference_checkpoint(ckpt, model)
    if report["unused"]:
        print(f"checkpoint: {len(report['unused'])} entries of modules the port "
              f"does not have (first: {report['unused'][:5]})", file=sys.stderr)
    return TTSEngine(model, engine_cfg, device=dev)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--text", required=True)
    p.add_argument("--prompt", required=True, help="prompt/reference wav path")
    p.add_argument("--out", default="gen.wav")
    p.add_argument("--config", default=None)
    p.add_argument("--ckpt", default=None,
                   help="a checkpoint dir the trainer wrote, or a torch "
                        "checkpoint file (model-*.pt)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--vq-only", action="store_true",
                   help="diffusion-free path (reference infer_gpt)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--long", action="store_true",
                   help="long-form mode: sentence chunking with prompt "
                        "reuse and crossfades (serving/longform.py)")
    p.add_argument("--sampler", default="ancestral",
                   choices=["ancestral", "ddim", "dpmpp_2m"],
                   help="diffusion sampler (reference live path: ancestral)")
    p.add_argument("--diffusion-steps", type=int, default=None,
                   help="override cfg.diffusion.infer_steps (fast mode)")
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--top-p", type=float, default=None)
    args = p.parse_args(argv)

    from detail_tts_tpu_torch.serving.pipeline import EngineConfig

    ecfg = EngineConfig(diffusion_sampler=args.sampler,
                        diffusion_steps=args.diffusion_steps)
    if args.temperature is not None:
        ecfg = dataclasses.replace(ecfg, temperature=args.temperature)
    if args.top_p is not None:
        ecfg = dataclasses.replace(ecfg, top_p=args.top_p)

    eng = build_engine(args.config, args.ckpt, args.seed, engine_cfg=ecfg,
                       device=args.device)
    sr = eng.cfg.data.sampling_rate
    prompt = load_wav(args.prompt, sr)
    if args.long:
        from detail_tts_tpu_torch.serving.longform import synthesize_long

        wav = synthesize_long(eng, args.text, prompt, seed=args.seed,
                              vq_only=args.vq_only)
    elif args.vq_only:
        wav = eng.synthesize_vq_batch([args.text], [prompt], seed=args.seed)[0]
    else:
        wav = eng.synthesize(args.text, prompt, seed=args.seed)
    save_wav(args.out, wav, sr)
    print(f"wrote {args.out}: {len(wav) / sr:.2f}s @ {sr} Hz")


if __name__ == "__main__":
    main()
