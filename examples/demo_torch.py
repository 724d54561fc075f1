"""End-to-end demo on the PyTorch port, the twin of demo.py (the reference
demo.ipynb flow as a script).

Synthesizes a short Chinese sentence from a voice prompt:
  1. load config and weights (a checkpoint directory the port's trainer
     wrote, a converted reference torch checkpoint, or random weights for a
     smoke run: ``serving/api.py build_engine``);
  2. zero-shot synthesis through the full pipeline (AR codes -> GPT latents
     -> 50-step CFG diffusion -> flow-VAE/HiFi-GAN), seed 0 (JAX's
     PRNGKey(0));
  3. the diffusion-free VQ path for comparison, seed 0;
  4. long-form synthesis by sentence chunking, seed 1.

It runs on the GPU unless --cpu is given (without a GPU and without --cpu
it stops with the port's CUDA error).

Run:  python examples/demo_torch.py --prompt speaker.wav [--ckpt ...] [--cpu]
      python examples/demo_torch.py --prompt speaker.wav --small --cpu  # smoke
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--prompt", required=True)
    p.add_argument("--ckpt", default=None,
                   help="a checkpoint dir the port's trainer wrote (<logs>/ckpt), or a "
                        "torch checkpoint file (model-*.pt)")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--small", action="store_true",
                   help="small_test_config() model: the whole demo runs in seconds on "
                        "the CPU (random weights)")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--text", default=None)
    args = p.parse_args(argv)

    from detail_tts_tpu_torch.serving.api import build_engine, load_wav, save_wav
    from detail_tts_tpu_torch.serving.longform import synthesize_long
    from detail_tts_tpu_torch.serving.pipeline import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")
    text = args.text or ("你好。" if args.small else "大家好，这是一个端到端的语音合成演示。")
    if args.small:
        from detail_tts_tpu_torch.config import small_test_config
        from detail_tts_tpu_torch.serving.pipeline import EngineConfig, random_engine

        ecfg = EngineConfig(max_generate_length=8, text_buckets=(16,), prompt_buckets=(32,),
                            code_buckets=(8,))
        eng = random_engine(small_test_config(), engine_cfg=ecfg, device=device)
    else:
        eng = build_engine(None, args.ckpt, device=device)
    sr = eng.cfg.data.sampling_rate
    prompt = load_wav(args.prompt, sr)

    def out(name):
        return os.path.join(args.out_dir, name)

    wav = eng.synthesize(text, prompt, seed=0)
    save_wav(out("demo_full.wav"), wav, sr)
    print(f"demo_full.wav: {len(wav) / sr:.2f}s (diffusion path)")

    wav_vq = eng.synthesize_vq_batch([text], [prompt], seed=0)[0]
    save_wav(out("demo_vq.wav"), wav_vq, sr)
    print(f"demo_vq.wav: {len(wav_vq) / sr:.2f}s (diffusion-free path)")

    long_text = text * 3
    wav_long = synthesize_long(eng, long_text, prompt, seed=1,
                               max_chars=4 if args.small else 120)
    save_wav(out("demo_long.wav"), wav_long, sr)
    print(f"demo_long.wav: {len(wav_long) / sr:.2f}s (long-form chunked)")


if __name__ == "__main__":
    main()
