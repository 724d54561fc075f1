"""Full-lifecycle demo on the PyTorch port, the twin of lifecycle_demo.py:
raw recordings to served speech in one script.

Chains the workflows the other examples show alone, the reference user's
end-to-end path (prepare/ -> train.py -> api.py):
  1. prepare: VAD-split raw recordings into clips, transcripts -> jsonl
     (examples/prepare_demo_torch.py ``prepare``);
  2. staged training: a vqvae stage, then a gpt stage GROWN from the vqvae
     checkpoint (the reference's staged targets, train.py:132-175; a
     partial restore through ``train/checkpoint.py restore_checkpoint``,
     with the weight-norm (g, v) <-> folded crosswalk);
  3. serving: the final trainer checkpoint into ``TTSEngine``
     (``restore_variables`` folds weight norm) and a zero-shot utterance
     with one of the prepared clips as the voice prompt (reference
     api.py:21-50), seed 0 (JAX's PRNGKey(0)).

The model and steps are demo-tiny with --small, so the whole lifecycle runs
in a minute or two on the CPU; drop --small and pass more --steps for a real
run.  It runs on the GPU unless --cpu is given (without a GPU and without
--cpu it stops with the port's CUDA error).

Run:  python examples/lifecycle_demo_torch.py --in-dir raw/ --work-dir out/ \\
          [--transcripts table.tsv] [--steps N] [--cpu] [--small] [--vq-only]
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--in-dir", required=True, help="raw recordings (wav)")
    p.add_argument("--work-dir", required=True)
    p.add_argument("--transcripts", default=None,
                   help="jsonl/tsv/'|' table of (clip path, text)")
    p.add_argument("--steps", type=int, default=2,
                   help="training steps PER STAGE (demo-tiny default)")
    p.add_argument("--text", default="ni3 hao3 shi4 jie4 .",
                   help="text to synthesize in the serving phase")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--small", action="store_true",
                   help="small_test_config() model (smoke runs)")
    p.add_argument("--vq-only", action="store_true",
                   help="serve via the diffusion-free VQ path (faster)")
    args = p.parse_args(argv)

    import torch

    from detail_tts_tpu_torch.config import Config, small_test_config
    from detail_tts_tpu_torch.data.dataset import BucketSpec, read_wav, save_wav
    from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
    from detail_tts_tpu_torch.serving.pipeline import EngineConfig, TTSEngine, resolve_device
    from detail_tts_tpu_torch.train.checkpoint import restore_variables
    from detail_tts_tpu_torch.train.trainer import Trainer
    from prepare_demo_torch import prepare

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = small_test_config() if args.small else Config()
    sr = cfg.data.sampling_rate
    work = args.work_dir

    # -- phase 1: prepare (VAD -> clips -> jsonl) ------------------------------
    # placeholder text in Chinese: the jsonl row filter drops latin text,
    # like the reference ASR phase
    raw, clips, n, jsonl = prepare(args.in_dir, work, sr, args.transcripts,
                                   text="你好世界，准备演示。")
    print(f"[1/4] prepare: {len(raw)} recordings -> {len(clips)} clips "
          f"-> {n} jsonl rows -> {jsonl}")

    # demo-sized crops and buckets (the defaults are sized for the 24k corpus)
    buckets = (BucketSpec(crop_frames=96, crop_threshold=100,
                          raw_buckets=(128, 256, 512), text_buckets=(32,))
               if args.small else BucketSpec())

    def stage(target, prev_ckpt, max_steps):
        scfg = dataclasses.replace(
            cfg, train=dataclasses.replace(
                cfg.train, target=target, batch_size=2, gradient_accumulate_every=1,
                save_freq=args.steps, val_freq=10 ** 9))
        tr = Trainer(scfg, device=device, logs_folder=os.path.join(work, f"train_{target}"),
                     buckets=buckets)
        tr.default_data(jsonl, num_threads=1)
        if prev_ckpt:  # grow the next stage from the previous stage's checkpoint
            tr.load(prev_ckpt)
        try:
            metrics = tr.train(max_steps=max_steps, log_every=1)
        finally:
            tr.close()
        if tr.state.step != max_steps:
            raise RuntimeError(f"{target}: stopped at step {tr.state.step}, not {max_steps}")
        return os.path.join(work, f"train_{target}", "ckpt"), metrics

    # -- phase 2: train the vqvae stage ----------------------------------------
    ck1, m1 = stage("vqvae", None, args.steps)
    print(f"[2/4] train vqvae: {args.steps} steps, loss={m1['loss']:.4f} -> {ck1}")

    # -- phase 3: grow the gpt stage from the vqvae checkpoint -----------------
    ck2, m2 = stage("gpt", ck1, 2 * args.steps)
    print(f"[3/4] train gpt (grown from vqvae ckpt): {args.steps} steps, "
          f"loss={m2['loss']:.4f} -> {ck2}")

    # -- phase 4: serve from the trained checkpoint ----------------------------
    with torch.device(device):
        model = SynthesizerTrn(cfg)
    model.load_state_dict(restore_variables(ck2, cfg))  # weight norm folded
    ecfg = (EngineConfig(max_generate_length=8, text_buckets=(16,), prompt_buckets=(32,),
                         code_buckets=(8,))
            if args.small else EngineConfig())
    eng = TTSEngine(model, ecfg, device=device)
    prompt = read_wav(clips[0], sr)
    if args.vq_only:
        wav = eng.synthesize_vq_batch([args.text], [prompt], seed=0)[0]
    else:
        wav = eng.synthesize(args.text, prompt, seed=0)
    out = os.path.join(work, "lifecycle.wav")
    save_wav(out, wav, sr)
    print(f"[4/4] serve: wrote {out}: {len(wav) / sr:.2f}s @ {sr} Hz")


if __name__ == "__main__":
    main()
