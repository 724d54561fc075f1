"""Where the time of one zero-shot request, or one training step, goes in the
PyTorch port, on one GPU.

    python3 profile_port.py [--batch 2] [--codes 200] [--sampler ancestral] [--steps 50]
    python3 profile_port.py --train [--target diff]

Serving: builds the full-width engine with seeded random weights, as
chip_smoke.py does, and answers one warm-up request.  Then it answers the
same request twice: once untraced, for each stage's wall time
(``timings``), and once under ``torch.profiler``, for the device time inside
each stage (the union of the device's kernel and copy intervals; the
profiler slows the host, not the kernels).

``--train``: the same for one step of training target ``--target`` (``diff``,
``gpt``, ``vqvae``, ``flowvae`` or ``all``) at full width (``Config()`` as
shipped: micro-batch 8 x 496 frames x accum 16, 64 text tokens; the GAN
targets batch 8 x 496 frames x accum 1; seeded synthetic batches) after a
warm-up step, split into the step's ranges ``latents`` (VQ codes and GPT
latents), ``forward``, ``backward`` and ``optimizer`` (each summed over the
micro-batches), and for the GAN targets ``discriminator`` and
``gen_loss``.

Each prints each stage's wall time, device busy time and idle share
(1 - busy / wall), the device launches, the kernels with the most device
time, and the device time of each of the port's own kernels (bias attention,
threefry, the sample step).
The last line is one JSON object with the same numbers.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

# name fragments of the port's hand-written kernels (csrc/: bias attention,
# threefry, the decode's sample step)
OWN_KERNELS = ("_mma<", "_wgmma<", "dbias_sum", "bias_attention_simt", "draw_kernel", "chain_kernel",
               "split_kernel", "sample_step_kernel")
STAGES = ("prepare", "generate", "diff_cond", "latents", "diffuse", "vocode", "host")
TRAIN_STAGES = ("latents", "forward", "discriminator", "gen_loss", "backward",
                "optimizer")


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


def split_by_stage(prof, stages, wall):
    """Device busy time inside each stage's host ranges (a stage may recur:
    its ranges are summed), beside the stage's wall time from ``wall``
    (seconds).  Returns (rows, device events)."""
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation and e.name not in stages]
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    windows = {}
    for e in events:
        if e.name in stages and e.device_type == DeviceType.CPU:
            windows.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    rows = {}
    for name in stages:
        busy_us = 0.0
        for ws, we in windows[name]:
            busy_us += union_us([(max(s, ws), min(e, we)) for s, e in spans
                                 if e > ws and s < we])
        wall_ms = wall[name] * 1e3
        rows[name] = dict(wall_ms=wall_ms, busy_ms=busy_us / 1e3,
                          idle_share=1.0 - busy_us / 1e3 / wall_ms)
    return rows, device


def report(rows, device, **extra):
    """Print the stage table and the kernels with the most device time; the
    last line is one JSON object."""
    wall_all = sum(r["wall_ms"] for r in rows.values())
    busy_all = sum(r["busy_ms"] for r in rows.values())
    print(f"wall {wall_all:.1f} ms, device busy {busy_all:.1f} ms "
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
    own = {k: v for k, v in per_kernel.items() if any(f in k for f in OWN_KERNELS)}
    print("the port's own kernels (ms, launches, name):")
    for name, (n, ms) in sorted(own.items(), key=lambda kv: -kv[1][1]):
        print(f"  {ms:9.2f} {n:7d}  {name[:100]}")
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), **extra, wall_ms=wall_all,
        busy_ms=busy_all, stages=rows, launches=sum(n for n, _ in per_kernel.values()),
        top_kernels=[dict(name=k[:100], launches=n, ms=ms) for k, (n, ms) in top],
        own_kernels=[dict(name=k[:100], launches=n, ms=ms) for k, (n, ms) in own.items()])))


def profile_train(target: str):
    """One traced training step of ``target`` at full width, split by stage."""
    import dataclasses

    from detail_tts_tpu_torch.config import Config
    from detail_tts_tpu_torch.ops import attention
    from detail_tts_tpu_torch.train.step import GAN_TARGETS, synthetic_batches
    from detail_tts_tpu_torch.train.trainer import Trainer

    cfg = Config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, target=target))
    accum = 1 if target in GAN_TARGETS else cfg.train.gradient_accumulate_every
    micro, frames = cfg.train.batch_size, 496
    data = synthetic_batches(cfg, accum, micro, frames, 64, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(1))
    logs = tempfile.mkdtemp(prefix="profile_port_")  # metrics of the warm-up step
    trainer = Trainer(cfg, data, device="cuda", seed=0, logs_folder=logs)
    trainer.train(max_steps=1)  # warm-up: builds the kernels
    wall = {}
    trainer.step_fn(trainer.state, trainer.next_batch(), trainer.generator, timings=wall)

    def counts():  # the training kernels' launches, the forward's by route
        return {**attention.TRAIN_LAUNCHES, **attention.TRAIN_FWD_LAUNCHES_BY_ROUTE}

    before = counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        metrics = trainer.step_fn(trainer.state, trainer.next_batch(), trainer.generator,
                                  timings={})
    kernels = {k: v - before[k] for k, v in counts().items()}
    stages = tuple(s for s in TRAIN_STAGES if s in wall)
    rows, device = split_by_stage(prof, stages, wall)
    loss = float(metrics["loss" if "loss" in metrics else "loss_gen_all"])
    print(f"{target} training step: micro-batch {micro} x {frames} frames x accum {accum}, "
          f"loss {loss:.6f}; training-kernel launches {kernels}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    report(rows, device, target=target, micro_batch=micro, frames=frames, accum=accum,
           mel_frames_per_s=accum * micro * frames / sum(wall.values()),
           kernel_launches=kernels)
    trainer.close()
    shutil.rmtree(logs, ignore_errors=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--codes", type=int, default=200)
    ap.add_argument("--sampler", default="ancestral",
                    help="EngineConfig.diffusion_sampler of the request")
    ap.add_argument("--steps", type=int, default=None,
                    help="EngineConfig.diffusion_steps (default: the config's 50)")
    ap.add_argument("--train", action="store_true",
                    help="profile one training step instead of a request")
    ap.add_argument("--target", default="diff",
                    help="the training target of --train (diff, gpt, vqvae, flowvae, all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_port.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    if args.train:
        profile_train(args.target)
        return

    from detail_tts_tpu_torch.config import Config
    from detail_tts_tpu_torch.serving.pipeline import EngineConfig, random_engine

    cfg = Config()
    engine = random_engine(cfg, seed=0, device="cuda", engine_cfg=EngineConfig(
        max_generate_length=args.codes + 1, diffusion_sampler=args.sampler,
        diffusion_steps=args.steps))
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
    rows, device = split_by_stage(prof, STAGES, wall)
    audio_s = sum(len(o) for o in outs) / sr
    steps = engine.schedule.num_timesteps
    print(f"request batch={args.batch} codes={args.codes} sampler={args.sampler} "
          f"steps={steps}: {audio_s:.2f} s of audio")
    report(rows, device, batch=args.batch, codes=args.codes, sampler=args.sampler,
           steps=steps, audio_s=audio_s)


if __name__ == "__main__":
    main()
