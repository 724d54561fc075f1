"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):

1. environment: the card's name and power limit, torch/CUDA versions, TF32
   settings; a CUDA device is required;
2. build: compiles ``detail_tts_tpu_torch/csrc/bias_attention.cu`` with nvcc;
3. kernel: ``bias_attention`` against its plain PyTorch version at the
   serving shapes (bf16, plus fp32 and a fully masked row), with CUDA-event
   times of the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (the yardstick, never used by the
   port) beside the card's bound;
4. serving: ``random_engine(Config())`` at full width, bf16, answers three
   requests through ``synthesize_batch``; checks the audio and that every
   ``AttentionBlock`` call of the path launched the kernel.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from detail_tts_tpu_torch.ops import attention  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# fp32 outside them, HBM3.  The exp2 peak is derived from the card itself:
# 16 special-function results per clock per SM.
PEAK_TFLOPS = {torch.bfloat16: 989.0, torch.float32: 67.0}
PEAK_BYTES_PER_S = 3.35e12
SFU_PER_CLOCK_PER_SM = 16
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_inputs(b, t, h, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device="cuda").to(dtype)
    bias = torch.randn((h, t, t), generator=g, device="cuda").to(dtype)
    return qkv, bias


def attention_bound_ms(b, t, h, d, dtype, sfu_per_s):
    """Least time for one call: bytes moved, tensor FLOP, exp2 count."""
    size = torch.finfo(dtype).bits // 8
    nbytes = size * (b * t * 3 * h * d + h * t * t + b * t * h * d)
    flops = 4.0 * b * h * t * t * d
    exps = float(b * h * t * t)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / (PEAK_TFLOPS[dtype] * 1e12), exps / sfu_per_s) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_environment():
    print("== environment", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    print(smi("name,power.limit"), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    sfu_per_s = props.multi_processor_count * SFU_PER_CLOCK_PER_SM * clock_mhz * 1e6
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"sms {props.multi_processor_count} max_sm_clock_mhz {clock_mhz} "
          f"matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}", flush=True)
    return sfu_per_s


def phase_build():
    print("== build", flush=True)
    path, seconds, log = attention.build()
    print(f"built {path.name} in {seconds:.1f} s", flush=True)
    for line in log.splitlines():  # ptxas -v: entry name, then its resources
        if "entry function" in line or "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)


def phase_kernel(sfu_per_s, extra_shapes=(), timed_shapes=()):
    """Kernel vs plain version; returns (max error, timing row)."""
    print("== kernel vs plain", flush=True)
    shapes = [(3, 1600, 16, 48), (4, 1600, 16, 48), (9, 1600, 16, 48),
              (16, 1600, 16, 48), (3, 1597, 16, 48), (4, 1597, 16, 48),
              (9, 1597, 16, 48), (16, 1597, 16, 48), (2, 400, 16, 96)]
    shapes += [s for s in extra_shapes if s not in shapes]
    worst = 0.0
    for i, (b, t, h, d) in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and b > 4:
                continue  # fp32 is the test route; keep its cases small
            qkv, bias = attention_inputs(b, t, h, d, dtype, seed=i)
            sm = 1.0 / math.sqrt(d)
            out = attention.bias_attention(qkv, bias, heads=h, sm_scale=sm)
            ref = attention.bias_attention_reference(qkv, bias, heads=h, sm_scale=sm)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = math.isfinite(err) and err <= TOL[dtype]
            print(f"  B={b} T={t} H={h} d={d} {str(dtype)[6:]}: "
                  f"max_abs_err {err:.3e} (tol {TOL[dtype]:.0e}) "
                  f"{'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"kernel disagrees with the plain version at {(b, t, h, d, dtype)}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)

    # a fully masked query row must come out exactly 0
    b, t, h, d = 3, 1597, 16, 48
    qkv, bias = attention_inputs(b, t, h, d, torch.bfloat16, seed=99)
    bias[5, 17, :] = -1e9
    out = attention.bias_attention(qkv, bias, heads=h, sm_scale=1 / math.sqrt(d))
    ref = attention.bias_attention_reference(qkv, bias, heads=h, sm_scale=1 / math.sqrt(d))
    row = out[:, 17, 5 * d:6 * d]
    err = (out.float() - ref.float()).abs().max().item()
    print(f"  masked row: max |out| {row.abs().max().item():.1e}, "
          f"max_abs_err {err:.3e}", flush=True)
    if torch.count_nonzero(row).item() != 0 or not err <= TOL[torch.bfloat16]:
        fail("fully masked row is not exactly 0 or the rest disagrees")
    worst = max(worst, err)

    # times at the diffusion trunk's shape for batch 8 at code bucket 400
    # (reported), then at the trunk shape of the requests below
    rows = [time_kernel(b, t, h, d, sfu_per_s)
            for b, t, h, d in [(16, 1600, 16, 48)] + list(timed_shapes)]
    return worst, rows[0]


def time_kernel(b, t, h, d, sfu_per_s):
    """CUDA-event times of kernel, plain version and SDPA at one shape."""
    qkv, bias = attention_inputs(b, t, h, d, torch.bfloat16, seed=7)
    sm = 1.0 / math.sqrt(d)
    q, k, v = (x.transpose(1, 2) for x in qkv.view(b, t, h, 3, d).unbind(3))
    mask = (bias.float() / attention.LOG2E).to(torch.bfloat16)[None]
    kernel_ms = cuda_ms(lambda: attention.bias_attention(qkv, bias, heads=h, sm_scale=sm))
    plain_ms = cuda_ms(lambda: attention.bias_attention_reference(
        qkv, bias, heads=h, sm_scale=sm))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=sm))
    bound_ms, bound_by = attention_bound_ms(b, t, h, d, torch.bfloat16, sfu_per_s)
    print(f"  time B={b} T={t} H={h} d={d} bf16: kernel_ms {kernel_ms} "
          f"plain_ms {plain_ms} library_ms(sdpa) {library_ms} bound_ms {bound_ms} "
          f"({bound_by}) -> {bound_ms / kernel_ms:.1%} of bound", flush=True)
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, shape=[b, t, h, d])


def serving_attention_shapes(cfg, ecfg, batches, prompt_frames):
    """(rows, T, heads, head dim) of every AttentionBlock call the serving
    requests below make: integrator B+1 and trunk 2B rows at 4x the code
    bucket, the latent conditioner at the code bucket, the contextual
    embedder at a quarter of the prompt bucket with twice the width."""
    d = cfg.diffusion
    code_bucket = next(b for b in ecfg.code_buckets
                       if b >= ecfg.max_generate_length - 1)
    prompt_bucket = next(b for b in ecfg.prompt_buckets if b >= prompt_frames)
    hd = d.model_channels // d.num_heads
    shapes = []
    for b in batches:
        shapes += [(b + 1, 4 * code_bucket, d.num_heads, hd),
                   (2 * b, 4 * code_bucket, d.num_heads, hd),
                   (b, code_bucket, d.num_heads, hd),
                   (b, prompt_bucket // 4, d.num_heads, 2 * hd)]
    return shapes


def phase_serving(engine, requests):
    """Answer ``requests`` through synthesize_batch; check audio and launches."""
    print("== serving", flush=True)
    d = engine.cfg.diffusion
    blocks_per_step = len(engine.model.diffusion.conditioning_timestep_integrator) \
        + d.num_layers
    per_request = (engine.schedule.num_timesteps * blocks_per_step
                   + len(engine.model.diffusion.contextual_embedder) - 2
                   + len(engine.model.diffusion.latent_conditioner) - 1)
    sr = engine.cfg.data.sampling_rate
    hop_per_code = engine.cfg.gpt.mel_length_compression
    outputs, counts = [], []
    attention.LAUNCHES = 0
    for texts, wavs, seed in requests:
        before = attention.LAUNCHES
        timings = {}
        t0 = time.perf_counter()
        outs = engine.synthesize_batch(texts, wavs, seed=seed, force_full=True,
                                       timings=timings)
        wall = time.perf_counter() - t0
        counts.append(attention.LAUNCHES - before)
        audio_s = sum(len(o) for o in outs) / sr
        print(f"  request batch={len(texts)} seed={seed}: {audio_s:.2f} s of audio "
              f"in {wall:.3f} s wall ({audio_s / wall:.2f}x real time); "
              f"kernel launches {counts[-1]} (expected {per_request}); timings "
              + json.dumps({k: round(v, 4) for k, v in timings.items()}), flush=True)
        eff = engine.ecfg.max_generate_length - 1
        for o in outs:
            if o.shape != (eff * hop_per_code,) or not np.all(np.isfinite(o)):
                fail(f"bad audio: shape {o.shape}, finite {np.all(np.isfinite(o))}")
        if counts[-1] != per_request:
            fail(f"{counts[-1]} kernel launches, expected {per_request}")
        outputs.append(outs)
    if not all(np.array_equal(a, b) for a, b in zip(outputs[0], outputs[-1])):
        fail("the repeated request with the same seed gave different audio")
    print(f"  repeated request reproduced its audio; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return attention.LAUNCHES, counts


def main():
    from detail_tts_tpu_torch.config import Config
    from detail_tts_tpu_torch.serving.pipeline import EngineConfig, random_engine

    sfu_per_s = phase_environment()
    phase_build()
    cfg = Config()
    ecfg = EngineConfig(max_generate_length=200)
    sr = cfg.data.sampling_rate
    rng = np.random.default_rng(0)
    prompts = [rng.uniform(-0.3, 0.3, 3 * sr).astype(np.float32) for _ in range(3)]
    texts = ["今天天气很好，我们一起去公园散步吧。", "你好，欢迎使用语音合成。",
             "这是第二个请求。"]
    requests = [(texts[:2], prompts[:2], 0), (texts[2:], prompts[2:], 1),
                (texts[:2], prompts[:2], 0)]

    served = serving_attention_shapes(
        cfg, ecfg, batches=(2, 1), prompt_frames=3 * sr // cfg.data.hop_length)
    worst, times = phase_kernel(sfu_per_s, served, timed_shapes=served[1:2])

    t0 = time.perf_counter()
    engine = random_engine(cfg, seed=0, engine_cfg=ecfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.model.parameters())
    print(f"== engine: Config() at full width, {n_params / 1e6:.1f} M parameters "
          f"{engine.cdt}, built in {time.perf_counter() - t0:.1f} s", flush=True)
    launches, per_request = phase_serving(engine, requests)

    kernels = [dict(
        name="bias_attention_fwd", route="cuda",
        source="detail_tts_tpu_torch/csrc/bias_attention.cu",
        replaces="detail_tts_tpu/ops/pallas/attention.py:404",
        launches=launches, launches_per_request=per_request,
        max_abs_err=worst, **times)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
