"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):

1. environment: the card's name and power limit, torch/CUDA versions, TF32
   settings; a CUDA device is required;
2. build: compiles ``detail_tts_tpu_torch/csrc/bias_attention.cu`` and
   ``bias_attention_bwd.cu`` with nvcc, one process each, at once; prints
   each kernel's ``ptxas -v`` registers and spills, and the CTAs per SM of
   the serving forward, the training forward and the backward kernels at
   d=48 and d=96;
3. kernel: ``bias_attention`` against its plain PyTorch version at the
   serving shapes and at T on the serving kernel's tile and bias-copy edges
   (bf16, plus fp32 and a fully masked row), with CUDA-event
   times of the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (the yardstick, never used by the
   port) beside the card's bound;
4. serving: ``random_engine(Config())`` at full width, bf16, answers three
   requests through ``synthesize_batch``; checks the audio and that every
   ``AttentionBlock`` call of the path launched the kernel;
4b. serving paths, on the same weights: each other sampler (``ddim``,
   ``dpmpp_2m_karras`` and ``dpmpp_2m`` at 50 steps, ``dpmpp_2m`` at 25)
   twice at batch 2, with its kernel launches (steps x 13 + 9 a request) and
   bit-identical repeats; ``pcm16_output`` against the float output's
   conversion; the diffusion-free VQ path (no launch) and ``vq_roundtrip``;
   a ``TTSServer`` answering 4 concurrent requests and refusing a sub-hop
   prompt, ``dispatch_batch`` + ``finalize_batch`` against
   ``synthesize_batch``; long-form streaming against ``synthesize_long``;
   the HTTP endpoint on 127.0.0.1;
5. train kernels vs plain: the training forward (with its row statistic)
   and the backward (delta, dq and the dbias partials; dk and dv; the
   partials' sum in batch order) against their plain versions at the
   training step's attention shapes (bf16 and fp32, ragged T, a fully
   masked row), the sum pass alone against its plain version, the backward
   twice for bit-identical dbias, and CUDA-event times of bare launches on
   buffers allocated beforehand (the training forward also through its
   wrapper) beside the bound, the plain versions and SDPA with a bias mask
   that requires grad;
6. training: ``Trainer`` over ``Config()`` at full width, target ``diff``,
   micro-batch 8 x 496 frames x accum 16 of seeded synthetic batches: a
   warm-up step and three timed steps, each checked for finite loss and grad
   norm and for one launch of each training kernel per AttentionBlock call;
   moved trainable and bit-identical frozen weights; a repeated step's
   bit-identical loss and grad norm; on one micro-batch that keeps every
   layer, a gradient for every trainable tensor and the kernel route
   against the plain route (and against a route that loses dbias, which
   the check must catch); the device idle share of one traced step;
6b. the other training targets through ``Trainer.train`` at the full width
   of ``Config()``: ``gpt`` and ``vqvae`` (micro-batch 8 x 496 frames x
   accum 16, 64 text tokens), ``flowvae`` and ``all`` (the two-phase GAN
   step with the discriminator, batch 8 x 496 frames, 10240-sample
   segments, weight norm on), each a warm-up step and two timed steps with
   their wall, mel frames per second and peak device memory: every loss and
   grad norm finite; every trainable tensor moved (the discriminator's too)
   and every frozen one bit-identical; the codebook moved under ``vqvae``
   and ``all`` only; under ``all`` each training kernel launched
   ``expected_train_launches`` times a step (0 times elsewhere), the
   serving kernel never; a repeated step bit-identical in every metric;
   for ``all`` the device idle share of one traced step.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import base64
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


def device_ms(fn, runs: int = 20, warmup: int = 3, only: str = ""):
    """Device time of one ``fn()``: the summed durations of the kernels that
    ``runs`` calls launch (those whose name holds ``only``), from the
    profiler's CUDA trace, over ``runs``.  Unlike a CUDA-event pair around
    one call, it holds none of the host time that a launch of a few
    microseconds can wait for.  None if the trace held no such kernel in
    three tries (the profiler's CUDA trace has come back empty)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                 and only in e.name]
        if spans:
            return sum(spans) / runs / 1e3
    return None


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
    t0 = time.perf_counter()
    for path, seconds, log in attention.build_all():
        print(f"built {path.name} in {seconds:.1f} s", flush=True)
        entry = None
        for line in log.splitlines():  # ptxas -v: entry name, then its resources
            if "entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
                print(f"  {entry[:90]}: {line.split(':', 1)[-1].strip()}", flush=True)
    print(f"build wall {time.perf_counter() - t0:.1f} s (parallel)", flush=True)
    fwd = attention._library(attention.SOURCE)
    lib = attention._library(attention.BWD_SOURCE)
    for d in (48, 96):
        serve = fwd.bias_attention_fwd_blocks_per_sm(d)
        train = fwd.bias_attention_train_fwd_blocks_per_sm(d)
        occ = [lib.bias_attention_bwd_blocks_per_sm(k, d) for k in (0, 1)]
        if min(occ + [serve, train]) <= 0:
            fail(f"kernels at d={d} fit no CTA on an SM (serving {serve}, training "
                 f"forward {train}, backward {occ})")
        print(f"  CTAs per SM at d={d}: serving forward {serve}, training forward {train}, "
              f"backward dq {occ[0]}, dk/dv {occ[1]}", flush=True)


def phase_kernel(sfu_per_s, extra_shapes=(), timed_shapes=()):
    """Kernel vs plain version; returns (max error, timing row)."""
    print("== kernel vs plain", flush=True)
    shapes = [(3, 1600, 16, 48), (4, 1600, 16, 48), (9, 1600, 16, 48),
              (16, 1600, 16, 48), (3, 1597, 16, 48), (4, 1597, 16, 48),
              (9, 1597, 16, 48), (16, 1597, 16, 48), (2, 400, 16, 96),
              (3, 127, 16, 48), (3, 129, 16, 48), (3, 300, 16, 48)]
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


# ------------------------------------------------------- training kernels

# Tolerances of the training kernels against their plain versions (the
# readings they were set from are in PERF.md).  out and d(qkv): the serving
# kernel's, d(qkv) relative to max(1, max |plain|) since it scales with the
# cotangent (bf16: P and dX are rounded to bf16 before the products).  lse:
# fp32 in both dtypes, from logits summed in another order.  dbias: relative
# to max |plain|; it is summed in fp32 from fp32 P and dX in both dtypes, and
# a dbias with one batch row's share lost must read above it.
LSE_TOL = DBIAS_TOL = 1e-4
TRAIN_KERNELS = ("bias_attention_train_fwd", "bias_attention_bwd_dq_dbias",
                 "bias_attention_bwd_dkv", "bias_attention_bwd_dbias_sum")


def scaled_err(x, ref, floor=1.0):
    ref = ref.float()
    return ((x.float() - ref).abs().max() / ref.abs().max().clamp_min(floor)).item()


def train_inputs(b, t, h, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device="cuda").to(dtype)
    bias = torch.randn((h, t, t), generator=g, device="cuda")
    dout = torch.randn((b, t, h * d), generator=g, device="cuda").to(dtype)
    return qkv, bias, dout


def train_bound_ms(b, t, h, d, sfu_per_s):
    """Least time of each training kernel in bf16, and of the whole backward:
    bytes moved (inputs read once, outputs written once), tensor FLOP (fp32
    adds for the sum pass), exp2 count."""
    c, bf, f4 = h * d, 2, 4
    exps, tt = float(b * h * t * t), h * t * t
    work = {  # kernel: (bytes, bf16 tensor FLOP, fp32 FLOP, exp2)
        # q, k, v, out -> out, lse
        "bias_attention_train_fwd": (bf * b * t * 4 * c + f4 * (tt + b * h * t),
                                     4.0 * b * h * t * t * d, 0.0, exps),
        # q, k, v, dout, out, bias, lse -> dq, delta, dbias (its function; the
        # partials it writes in place of dbias are the design's cost)
        "bias_attention_bwd_dq_dbias": (bf * b * t * 6 * c + f4 * (2 * tt + 2 * b * h * t),
                                        6.0 * b * h * t * t * d, 0.0, exps),
        # q, k, v, dout, bias, lse, delta -> dk, dv
        "bias_attention_bwd_dkv": (bf * b * t * 6 * c + f4 * (tt + 2 * b * h * t),
                                   8.0 * b * h * t * t * d, 0.0, exps),
        # B partials -> dbias
        "bias_attention_bwd_dbias_sum": (f4 * (b + 1) * tt, 0.0, float((b - 1) * tt), 0.0),
        # the whole backward: q, k, v, dout, out, bias, lse -> dqkv, dbias
        "backward": (bf * b * t * 8 * c + f4 * (2 * tt + b * h * t),
                     10.0 * b * h * t * t * d, 0.0, exps),
    }
    out = {}
    for name, (nbytes, flops, f32_flops, n_exp) in work.items():
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = max(flops / (PEAK_TFLOPS[torch.bfloat16] * 1e12),
                    f32_flops / (PEAK_TFLOPS[torch.float32] * 1e12), n_exp / sfu_per_s) * 1e3
        out[name] = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")
    return out


def check_train_kernels(b, t, h, d, dtype, seed, mask_row=False):
    """Each training kernel against its plain version at one shape, and the
    dbias gate against a known-wrong dbias; returns {kernel: (max abs err,
    scaled err)}."""
    qkv, bias, dout = train_inputs(b, t, h, d, dtype, seed)
    if mask_row:
        bias[h - 1, t // 3, :] = -1e9
    sm = 1.0 / math.sqrt(d)
    out, lse = attention.bias_attention_train_fwd(qkv, bias, heads=h, sm_scale=sm)
    ref_out, ref_lse = attention.bias_attention_train_reference(qkv, bias, heads=h,
                                                                sm_scale=sm)
    dqkv, dbias = attention.bias_attention_bwd(qkv, bias, out, lse, dout, heads=h,
                                               sm_scale=sm)
    ref_dqkv, ref_dbias = attention.bias_attention_bwd_reference(
        qkv, bias, out, lse, dout, heads=h, sm_scale=sm)
    torch.cuda.synchronize()
    g, rg = dqkv.view(b, t, h, 3, d), ref_dqkv.view(b, t, h, 3, d)
    errs = {
        "out": ((out.float() - ref_out.float()).abs().max().item(),) * 2,
        "lse": ((lse - ref_lse).abs().max().item(),) * 2,
        "dq": ((g[..., 0, :].float() - rg[..., 0, :].float()).abs().max().item(),
               scaled_err(g[..., 0, :], rg[..., 0, :])),
        "dbias": ((dbias - ref_dbias).abs().max().item(),
                  scaled_err(dbias, ref_dbias, floor=1e-30)),
        "dkv": ((g[..., 1:, :].float() - rg[..., 1:, :].float()).abs().max().item(),
                scaled_err(g[..., 1:, :], rg[..., 1:, :])),
    }
    tol = {"out": TOL[dtype], "lse": LSE_TOL, "dq": TOL[dtype], "dbias": DBIAS_TOL,
           "dkv": TOL[dtype]}
    ok = all(math.isfinite(e[1]) and e[1] <= tol[k] for k, e in errs.items())
    # what the dbias gate reads for a kernel that loses the last row's share
    _, last = attention.bias_attention_bwd_reference(
        qkv[-1:], bias, out[-1:], lse[-1:], dout[-1:], heads=h, sm_scale=sm)
    wrong = (last.abs().max() / ref_dbias.abs().max()).item()
    print(f"  B={b} T={t} H={h} d={d} {str(dtype)[6:]}{' masked row' if mask_row else ''}: "
          + " ".join(f"{k} {e[0]:.2e}/{e[1]:.2e}" for k, e in errs.items())
          + f" {'ok' if ok else 'MISMATCH'}; dbias with a row lost {wrong:.2e}", flush=True)
    if not ok:
        fail(f"training kernels disagree with the plain versions at {(b, t, h, d, dtype)}")
    if not wrong > DBIAS_TOL:
        fail(f"the dbias gate would pass a dbias with a batch row lost ({wrong:.2e})")
    if mask_row:
        r, hh = t // 3, h - 1
        zero = (out[:, r, hh * d:(hh + 1) * d], g[:, r, hh, 0], dbias[hh, r])
        if any(torch.count_nonzero(z).item() for z in zero) or not all(
                torch.isfinite(x).all() for x in (out, lse, dqkv, dbias)):
            fail("a fully masked row is not exactly 0 in out, dq and dbias")
    return {"bias_attention_train_fwd": errs["out"],
            "bias_attention_bwd_dq_dbias": max(errs["dq"], errs["dbias"]),
            "bias_attention_bwd_dkv": errs["dkv"],
            "bias_attention_bwd_dbias_sum": check_dbias_sum(b, t, h, seed)}


def check_dbias_sum(b, t, h, seed):
    """The sum pass against its plain version on seeded partials: the same
    fp32 adds in the same batch order, so the gate is bit-identity."""
    tp = attention.padded_len(t)
    g = torch.Generator(device="cuda").manual_seed(seed)
    part = torch.randn((b, h, tp, tp), generator=g, device="cuda")
    got = attention.bias_attention_dbias_sum(part, t)
    want = attention.bias_attention_dbias_sum_reference(part[:, :, :t, :t])
    err = (got - want).abs().max().item()
    print(f"  B={b} T={t} H={h}: dbias sum of seeded partials bit-identical to the plain "
          f"sum {torch.equal(got, want)}", flush=True)
    if not torch.equal(got, want):
        fail(f"the dbias sum differs from its plain version at {(b, t, h)}: {err:.3e}")
    return err, err / want.abs().max().item()


def sdpa_backend(fn) -> str:
    """Which SDPA implementation ``fn`` ran, from its device kernels' names."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = " ".join(e.key.lower() for e in prof.key_averages())
    for key, label in (("cudnn", "cudnn"), ("flash", "flash"),
                       ("fmha", "efficient"), ("efficient", "efficient")):
        if key in names:
            return label
    return "math"


def time_train_kernels(b, t, h, d, sfu_per_s):
    """CUDA-event times of the training kernels (bare launches on buffers
    allocated beforehand; also their device time from the profiler), the
    training forward's wrapper, the plain versions and SDPA (forward, and
    backward through torch.autograd.grad) at one shape."""
    qkv, bias, dout = train_inputs(b, t, h, d, torch.bfloat16, seed=7)
    sm = 1.0 / math.sqrt(d)
    out, lse = attention.bias_attention_train_fwd(qkv, bias, heads=h, sm_scale=sm)
    out_t, lse_t = torch.empty_like(out), torch.empty_like(lse)
    tp = attention.padded_len(t)
    delta = torch.empty((b, h, t), device="cuda")
    part = torch.empty((b, h, tp, tp), device="cuda")
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((h, t, t), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    args = (b, t, h, d, sm * attention.LOG2E, attention.LOG2E, sm, 0, stream)
    launch = {
        "bias_attention_train_fwd": lambda: attention._launch(
            attention.SOURCE, "bias_attention_train_fwd", qkv.data_ptr(), bias.data_ptr(),
            out_t.data_ptr(), lse_t.data_ptr(), b, t, h, d, sm * attention.LOG2E,
            attention.LOG2E, 0, stream),
        "bias_attention_bwd_dq_dbias": lambda: attention._launch(
            attention.BWD_SOURCE, "bias_attention_bwd_dq", qkv.data_ptr(), bias.data_ptr(),
            dout.data_ptr(), out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dqkv.data_ptr(), part.data_ptr(), *args),
        "bias_attention_bwd_dkv": lambda: attention._launch(
            attention.BWD_SOURCE, "bias_attention_bwd_dkv", qkv.data_ptr(), bias.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), *args),
        "bias_attention_bwd_dbias_sum": lambda: attention._launch(
            attention.BWD_SOURCE, "bias_attention_bwd_dbias_sum", part.data_ptr(),
            dbias.data_ptr(), b, t, h, stream),
    }
    ms = {name: cuda_ms(fn) for name, fn in launch.items()}
    dev = {name: device_ms(fn) for name, fn in launch.items()}
    wrapper_ms = cuda_ms(lambda: attention.bias_attention_train_fwd(
        qkv, bias, heads=h, sm_scale=sm))
    bwd_ms = cuda_ms(lambda: attention.bias_attention_bwd(qkv, bias, out, lse, dout,
                                                          heads=h, sm_scale=sm))
    plain_fwd = cuda_ms(lambda: attention.bias_attention_train_reference(
        qkv, bias, heads=h, sm_scale=sm), runs=5)
    plain_bwd = cuda_ms(lambda: attention.bias_attention_bwd_reference(
        qkv, bias, out, lse, dout, heads=h, sm_scale=sm), runs=5)
    part_t = part[:, :, :t, :t]
    plain_sum = cuda_ms(lambda: attention.bias_attention_dbias_sum_reference(part_t))
    lib_sum = cuda_ms(lambda: part_t.sum(0))

    q, k, v = (x.detach().transpose(1, 2).requires_grad_(True)
               for x in qkv.view(b, t, h, 3, d).unbind(3))
    mask_leaf = bias.to(torch.bfloat16).requires_grad_(True)
    mask = mask_leaf[None].expand(b, h, t, t)
    do = dout.view(b, t, h, d).transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=sm)

    lib_fwd = cuda_ms(lambda: sdpa())
    o = sdpa()
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(o, (q, k, v, mask_leaf), do,
                                                  retain_graph=True))
    backend = sdpa_backend(lambda: torch.autograd.grad(sdpa(), (q, k, v, mask_leaf), do))
    bounds = train_bound_ms(b, t, h, d, sfu_per_s)
    plain = {"bias_attention_train_fwd": plain_fwd, "bias_attention_bwd_dbias_sum": plain_sum}
    library = {"bias_attention_train_fwd": lib_fwd, "bias_attention_bwd_dbias_sum": lib_sum}
    rows = {}
    for name in TRAIN_KERNELS:
        rows[name] = dict(ms=ms[name], device_ms=dev[name],
                          plain_ms=plain.get(name, plain_bwd),
                          library_ms=library.get(name, lib_bwd),
                          bound_ms=bounds[name][0], bound_by=bounds[name][1],
                          shape=[b, t, h, d])
        share = ("" if dev[name] is None
                 else f" ({bounds[name][0] / dev[name]:.1%} of its device time)")
        print(f"  time B={b} T={t} H={h} d={d} bf16 {name}: ms {ms[name]} "
              f"(device time {dev[name]}) bound_ms {bounds[name][0]} ({bounds[name][1]}) "
              f"-> {bounds[name][0] / ms[name]:.1%} of bound{share}", flush=True)
    rows["bias_attention_train_fwd"]["wrapper_ms"] = wrapper_ms
    print(f"  time bias_attention_train_fwd through its wrapper (checks, two "
          f"torch.empty, the ctypes call) {wrapper_ms} ms beside the bare launch "
          f"{ms['bias_attention_train_fwd']} ms", flush=True)
    print(f"  time sum pass: plain (batch-order adds) {plain_sum} ms, "
          f"torch.sum over the batch {lib_sum} ms", flush=True)
    bound_bwd = bounds["backward"]
    print(f"  time whole backward (bias_attention_bwd: delta, dq/partials, dk/dv, sum) "
          f"{bwd_ms} ms, bound_ms {bound_bwd[0]} ({bound_bwd[1]}) -> "
          f"{bound_bwd[0] / bwd_ms:.1%} of bound; SDPA ({backend}) backward {lib_bwd} ms "
          f"({lib_bwd / bwd_ms:.2f}x ours); kernel 4 + backward "
          f"{ms['bias_attention_train_fwd'] + bwd_ms} ms; plain forward {plain_fwd} ms + "
          f"backward {plain_bwd} ms; SDPA forward {lib_fwd} ms", flush=True)
    return rows, backend


def phase_train_kernels(sfu_per_s):
    """Training kernels vs plain versions; returns (worst errors, time rows)."""
    print("== train kernels vs plain", flush=True)
    worst = {name: (0.0, 0.0) for name in TRAIN_KERNELS}
    cases = [(8, 496, 16, 48, torch.bfloat16), (8, 124, 16, 48, torch.bfloat16),
             (8, 124, 16, 96, torch.bfloat16), (8, 495, 16, 48, torch.bfloat16),
             (4, 495, 16, 48, torch.float32), (8, 124, 16, 48, torch.float32),
             (8, 124, 16, 96, torch.float32)]
    for i, (b, t, h, d, dtype) in enumerate(cases):
        errs = check_train_kernels(b, t, h, d, dtype, seed=100 + i)
        if dtype == torch.bfloat16:
            worst = {k: max(worst[k], errs[k]) for k in worst}
    for dtype in (torch.bfloat16, torch.float32):
        errs = check_train_kernels(3, 495, 16, 48, dtype, seed=99, mask_row=True)
        if dtype == torch.bfloat16:
            worst = {k: max(worst[k], errs[k]) for k in worst}

    qkv, bias, dout = train_inputs(8, 496, 16, 48, torch.bfloat16, seed=5)
    out, lse = attention.bias_attention_train_fwd(qkv, bias, heads=16, sm_scale=0.1)
    first = attention.bias_attention_bwd(qkv, bias, out, lse, dout, heads=16, sm_scale=0.1)
    second = attention.bias_attention_bwd(qkv, bias, out, lse, dout, heads=16, sm_scale=0.1)
    same = [torch.equal(x, y) for x, y in zip(first, second)]
    print(f"  backward twice at B=8 T=496: dqkv bit-identical {same[0]}, "
          f"dbias bit-identical {same[1]}", flush=True)
    if not all(same):
        fail("the backward is not bit-identical from run to run")
    rows, backend = time_train_kernels(8, 496, 16, 48, sfu_per_s)
    return worst, rows, backend


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


def b1_per_request(engine) -> int:
    """B1 launches of one diffusion request: the integrator blocks and trunk
    layers each model evaluation (one a step), plus the contextual embedder
    and the latent conditioner once."""
    diff = engine.model.diffusion
    blocks_per_step = len(diff.conditioning_timestep_integrator) + engine.cfg.diffusion.num_layers
    return (engine.schedule.num_timesteps * blocks_per_step
            + len(diff.contextual_embedder) - 2 + len(diff.latent_conditioner) - 1)


def phase_serving(engine, requests):
    """Answer ``requests`` through synthesize_batch; check audio and launches.
    Returns (launches, launches per request, (wall, timings) per request)."""
    print("== serving", flush=True)
    per_request = b1_per_request(engine)
    sr = engine.cfg.data.sampling_rate
    hop_per_code = engine.cfg.gpt.mel_length_compression
    outputs, counts, records = [], [], []
    attention.LAUNCHES = 0
    for texts, wavs, seed in requests:
        before = attention.LAUNCHES
        timings = {}
        t0 = time.perf_counter()
        outs = engine.synthesize_batch(texts, wavs, seed=seed, force_full=True,
                                       timings=timings)
        wall = time.perf_counter() - t0
        records.append((wall, timings))
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
    return attention.LAUNCHES, counts, records


# ------------------------------------------------------------ serving paths

FAST_MODE = ("dpmpp_2m", 25)  # the JAX engine's fast mode
SAMPLER_RUNS = (("ddim", 50), ("dpmpp_2m_karras", 50), ("dpmpp_2m", 50), FAST_MODE)


def check_audio(engine, outs, what, dtype=np.float32):
    """Finite audio of exactly eff x 1024 samples (force_full) per item."""
    n = (engine.ecfg.max_generate_length - 1) * engine.cfg.gpt.mel_length_compression
    for o in outs:
        if o.shape != (n,) or o.dtype != dtype or not np.all(np.isfinite(o)):
            fail(f"{what}: bad audio: shape {o.shape} (want {(n,)}), dtype {o.dtype}, "
                 f"finite {np.all(np.isfinite(o))}")


def serve_request(engine, label, texts, wavs, seed, vq=False):
    """One force_full request, its B1 launches counted from 0; prints the
    wall time, audio seconds per wall second and the stage timings."""
    attention.LAUNCHES = 0
    timings = {}
    t0 = time.perf_counter()
    if vq:
        outs = engine.synthesize_vq_batch(texts, wavs, seed=seed, force_full=True)
    else:
        outs = engine.synthesize_batch(texts, wavs, seed=seed, force_full=True,
                                       timings=timings)
    wall = time.perf_counter() - t0
    audio_s = sum(len(o) for o in outs) / engine.cfg.data.sampling_rate
    print(f"  {label} batch={len(texts)} seed={seed}: {audio_s:.2f} s of audio in "
          f"{wall:.3f} s wall ({audio_s / wall:.2f}x real time); kernel launches "
          f"{attention.LAUNCHES}; timings "
          + json.dumps({k: round(v, 4) for k, v in timings.items()}), flush=True)
    return outs, attention.LAUNCHES, wall, timings


def phase_serving_paths(engine, texts, prompts, ancestral_records):
    """Phase 4b on ``engine``'s weights; returns the B1 launches of its paths."""
    import dataclasses
    import threading
    import urllib.error
    import urllib.request

    from detail_tts_tpu_torch.serving.http_api import _decode_wav_bytes, _encode_wav_bytes, serve
    from detail_tts_tpu_torch.serving.longform import synthesize_long, synthesize_long_stream
    from detail_tts_tpu_torch.serving.pipeline import TTSEngine, to_pcm16
    from detail_tts_tpu_torch.serving.server import TTSServer

    print("== serving paths", flush=True)

    def variant(**kw):
        return TTSEngine(engine.model, dataclasses.replace(engine.ecfg, **kw), device="cuda",
                         tokenizer=engine.tokenizer)

    pair, prompts2 = texts[:2], prompts[:2]
    total, diffuse_ms, walls, fast = 0, {}, {}, None
    # (a) each sampler twice at batch 2
    for sampler, steps in SAMPLER_RUNS:
        eng = variant(diffusion_sampler=sampler, diffusion_steps=steps)
        want = b1_per_request(eng)
        runs = []
        for _ in range(2):
            outs, launches, wall, timings = serve_request(eng, f"{sampler} {steps} steps",
                                                          pair, prompts2, seed=0)
            total += launches
            check_audio(eng, outs, f"{sampler} at {steps} steps")
            if launches != want or want != steps * 13 + 9:
                fail(f"{sampler} at {steps} steps: {launches} kernel launches, expected "
                     f"{want} (steps x 13 + 9 = {steps * 13 + 9})")
            runs.append(outs)
        if not all(np.array_equal(a, b) for a, b in zip(*runs)):
            fail(f"{sampler} at {steps} steps: the repeated request gave different audio")
        diffuse_ms[(sampler, steps)] = timings["diffuse"] * 1e3
        walls[(sampler, steps)] = wall
        if (sampler, steps) == FAST_MODE:
            fast, fast_outs = eng, runs[0]
    anc_wall, anc_timings = ancestral_records[-1]  # phase 4's third request
    print("  diffuse of the warm b2 request (ms): "
          + ", ".join(f"{s} {n}: {ms:.1f}" for (s, n), ms in diffuse_ms.items())
          + f"; ancestral 50 (phase 4): {anc_timings['diffuse'] * 1e3:.1f}; request wall "
          f"{FAST_MODE[0]} {FAST_MODE[1]} against ancestral 50: {walls[FAST_MODE]:.3f} / "
          f"{anc_wall:.3f} s", flush=True)

    # (b) int16 output equals the float output's conversion, bit for bit
    outs, launches, _, _ = serve_request(
        variant(diffusion_sampler=FAST_MODE[0], diffusion_steps=FAST_MODE[1], pcm16_output=True),
        "pcm16 %s %d steps" % FAST_MODE, pair, prompts2, seed=0)
    total += launches
    check_audio(fast, outs, "pcm16", dtype=np.int16)
    if not all(np.array_equal(o, to_pcm16(torch.from_numpy(f)).numpy())
               for o, f in zip(outs, fast_outs)):
        fail("pcm16_output differs from the float output's clip, scale and round")
    print("  pcm16 output bit-identical to the float output's conversion", flush=True)

    # (c) the diffusion-free VQ path and the VQ round trip
    outs, launches, _, _ = serve_request(engine, "vq", pair, prompts2, seed=0, vq=True)
    total += launches
    check_audio(engine, outs, "the VQ path")
    if launches != 0:
        fail(f"the VQ path launched the diffusion kernel {launches} times")
    mel, mel_len = engine.prepare_prompt(prompts[:1])
    n = int(mel_len[0]) // 4 * 4
    attention.LAUNCHES = 0
    recon, wav = engine.vq_roundtrip(mel[:, :n])
    total += attention.LAUNCHES
    if (recon.shape != (1, n, mel.shape[2]) or wav.shape != (1, n * engine.cfg.data.hop_length, 1)
            or not (torch.isfinite(recon).all() and torch.isfinite(wav).all())):
        fail(f"vq_roundtrip: mel {tuple(recon.shape)}, wav {tuple(wav.shape)}, or not finite")
    print(f"  vq_roundtrip of a {n}-frame prompt mel: mel {tuple(recon.shape)}, wav "
          f"{tuple(wav.shape)}, finite", flush=True)

    # (d) the server: 4 concurrent requests, a refused sub-hop prompt; the
    # split dispatch against synthesize_batch
    attention.LAUNCHES = 0
    with TTSServer(engine, max_batch=4, max_wait_ms=200.0) as server:
        try:
            server.submit("短", np.zeros(100, np.float32))
            fail("the server took a prompt shorter than one hop")
        except ValueError as e:
            print(f"  server refused a sub-hop prompt: {e}", flush=True)
        t0 = time.perf_counter()
        futs = [server.submit(texts[i % len(texts)], prompts[i % len(prompts)], seed=i)
                for i in range(4)]
        outs = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
    total += attention.LAUNCHES
    for o in outs:
        if o.ndim != 1 or not len(o) or not np.all(np.isfinite(o)):
            fail(f"a server request gave bad audio: shape {o.shape}")
    audio_s = sum(len(o) for o in outs) / engine.cfg.data.sampling_rate
    print(f"  server, 4 concurrent requests: {audio_s:.2f} s of audio in {wall:.3f} s wall "
          f"({audio_s / wall:.2f}x real time), {server.batches_dispatched} batch(es), "
          f"kernel launches {attention.LAUNCHES}", flush=True)
    if server.requests_served != 4:
        fail(f"the server served {server.requests_served} requests, not 4")
    attention.LAUNCHES = 0
    split = fast.finalize_batch(fast.dispatch_batch(pair, prompts2, seed=0, force_full=True))
    total += attention.LAUNCHES
    if not all(np.array_equal(a, b) for a, b in zip(split, fast_outs)):
        fail("dispatch_batch + finalize_batch differs from synthesize_batch")
    print("  dispatch_batch + finalize_batch bit-identical to synthesize_batch", flush=True)

    # (e) long form: the joined stream equals the one-shot result
    text = "今天天气很好。我们一起去公园散步吧！你好，欢迎使用语音合成。"
    attention.LAUNCHES = 0
    t0 = time.perf_counter()
    whole = synthesize_long(fast, text, prompts[0], seed=3, batch_size=2)
    wall = time.perf_counter() - t0
    parts = list(synthesize_long_stream(fast, text, prompts[0], seed=3, batch_size=2))
    total += attention.LAUNCHES
    joined = np.concatenate(parts)
    print(f"  long form, 3 sentences in batches of 2 ({FAST_MODE[0]} {FAST_MODE[1]} steps): "
          f"{len(whole) / engine.cfg.data.sampling_rate:.2f} s of audio in {wall:.3f} s "
          f"wall; stream of {len(parts)} parts equal {np.array_equal(joined, whole)}",
          flush=True)
    if len(parts) < 2 or not np.array_equal(joined, whole) or not np.all(np.isfinite(whole)):
        fail("the joined long-form stream differs from synthesize_long")

    # (f) the HTTP endpoint
    box = {}
    attention.LAUNCHES = 0
    thread = threading.Thread(target=serve, kwargs=dict(
        engine=fast, host="127.0.0.1", port=0, max_batch=2, max_wait_ms=5.0,
        httpd_box=box), daemon=True)
    thread.start()
    deadline = time.monotonic() + 60
    while "httpd" not in box and time.monotonic() < deadline:
        time.sleep(0.01)
    if "httpd" not in box:
        fail("the HTTP server did not start")
    url = "http://127.0.0.1:%d" % box["httpd"].server_address[1]
    local = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # no proxy

    def post(prompt):
        body = json.dumps({"text": texts[1], "seed": 1, "prompt_wav_b64": base64.b64encode(
            _encode_wav_bytes(prompt, engine.cfg.data.sampling_rate)).decode()}).encode()
        return local.open(urllib.request.Request(
            url + "/synthesize", data=body, headers={"Content-Type": "application/json"}),
            timeout=300)

    try:
        with local.open(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        answers = []  # the first request on the server's thread, then a warm one
        for _ in range(2):
            t0 = time.perf_counter()
            with post(prompts[1]) as r:
                answers.append((r.status, r.headers["Content-Type"], r.read(),
                                time.perf_counter() - t0))
        audio = [_decode_wav_bytes(a[2], engine.cfg.data.sampling_rate) for a in answers]
        try:
            post(np.zeros(100, np.float32))
            refused = None
        except urllib.error.HTTPError as e:
            refused = e.code
    finally:
        box["httpd"].shutdown()
        thread.join(timeout=60)
    total += attention.LAUNCHES
    print(f"  HTTP: /healthz {health}; /synthesize twice: "
          + "; ".join(f"{st} {ct}, {len(a) / engine.cfg.data.sampling_rate:.2f} s of audio "
                      f"in {w:.3f} s" for (st, ct, _, w), a in zip(answers, audio))
          + f"; sub-hop prompt {refused}; server thread stopped {not thread.is_alive()}",
          flush=True)
    if not (health.get("ok") and refused == 400 and not thread.is_alive() and all(
            st == 200 and ct == "audio/wav" and len(a) and np.all(np.isfinite(a))
            for (st, ct, _, _), a in zip(answers, audio))):
        fail("the HTTP endpoint did not answer as it should")
    return total


# ----------------------------------------------------------------- training

# The kernel route against the plain route on one micro-batch, both under
# bf16 autocast: relative differences of the loss, of the trainable grad norm
# and of the grad norm of the T5 bias tables, which only dbias reaches.  Set
# from the readings in PERF.md; a route that loses dbias must read above.  The
# T5 norm's is wider: the kernels take delta = rowsum(dO * O) from the bf16
# out, autograd through the plain forward from its fp32 o, and dbias sums
# P * (dP - delta) with cancellation.
ROUTE_TOL = {"loss": 1e-3, "grad_norm": 1e-3, "t5_grad_norm": 1e-2}


def expected_train_launches(cfg, layers_kept):
    """Launches of each training kernel for one step: per micro-batch, the 5
    contextual-embedder, 4 latent-conditioner and 3 integrator blocks plus
    the trunk layers kept by layer drop (the 3 trailing ResBlocks have no
    attention)."""
    n = cfg.diffusion.num_layers
    return sum(5 + 4 + 3 + sum(keep[:n]) for keep in layers_kept)


def micro_metrics(state, cfg, mb, draws):
    """Loss, trainable grad norm and T5-table grad norm of one micro-batch
    under autocast, and the trainable parameters left with no gradient (None
    or all zero)."""
    from detail_tts_tpu_torch.models.synthesizer import make_train_schedule
    model = state.model
    model.zero_grad(set_to_none=True)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        latents = model.gpt_latents(mb)
        loss = model.forward_diff(mb, make_train_schedule(cfg, device="cuda"), draws,
                                  latents=latents)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).float()
             for n, p in model.named_parameters() if p.requires_grad}

    def norm(names):
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(grads[n]) for n in names])).item()

    t5 = [n for n in grads if n.endswith("relative_attention_bias.weight")]
    metrics = (loss.item(), norm(grads), norm(t5))
    missing = sorted(n for n, g in grads.items() if not bool(g.any()))
    model.zero_grad(set_to_none=True)
    return metrics, missing


def with_route(route, fn):
    """``fn()`` with the AttentionBlocks' training attention set to ``route``."""
    from detail_tts_tpu_torch.nn import diff_blocks
    kept = diff_blocks.bias_attention_train
    diff_blocks.bias_attention_train = route
    try:
        return fn()
    finally:
        diff_blocks.bias_attention_train = kept


def phase_training(cfg_full):
    """Target diff at full width through Trainer.train; returns launches."""
    import dataclasses

    from detail_tts_tpu_torch.models.synthesizer import draw_diff, make_train_schedule
    from detail_tts_tpu_torch.train.step import synthetic_batches
    from detail_tts_tpu_torch.train.trainer import Trainer

    print("== training", flush=True)
    cfg = dataclasses.replace(cfg_full, train=dataclasses.replace(cfg_full.train,
                                                                  target="diff"))
    accum, micro, frames, text_len = (cfg.train.gradient_accumulate_every,
                                      cfg.train.batch_size, 496, 64)
    data_gen = torch.Generator(device="cuda").manual_seed(1)
    data = synthetic_batches(cfg, accum, micro, frames, text_len, generator=data_gen,
                             device="cuda")
    t0 = time.perf_counter()
    trainer = Trainer(cfg, data, device="cuda", seed=0)
    state = trainer.state
    n_train = sum(p.numel() for p in state.params)
    n_all = sum(p.numel() for p in state.model.parameters())
    print(f"  Config() target diff: {n_train / 1e6:.1f} M trainable of {n_all / 1e6:.1f} M "
          f"parameters (fp32 master weights, AdamW fp32), micro-batch {micro} x {frames} "
          f"frames x accum {accum}, text {text_len}; built in {time.perf_counter() - t0:.1f} s; "
          f"matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32} autocast bf16 "
          f"{cfg.train.use_bf16}", flush=True)

    t0 = time.perf_counter()
    trainer.train(max_steps=1, log_every=1)  # warm-up
    torch.cuda.synchronize()
    print(f"  warm-up step {time.perf_counter() - t0:.3f} s", flush=True)

    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    torch.cuda.reset_peak_memory_stats()
    attention.LAUNCHES = 0
    for name in TRAIN_KERNELS:
        attention.TRAIN_LAUNCHES[name] = 0
    expected, walls = 0, []
    for _ in range(3):
        counts = dict(attention.TRAIN_LAUNCHES)
        t0 = time.perf_counter()
        logged = trainer.train(max_steps=state.step + 1, log_every=1)
        walls.append(time.perf_counter() - t0)
        m = trainer.last_metrics
        want = expected_train_launches(cfg, m["layers_kept"])
        got = {k: attention.TRAIN_LAUNCHES[k] - counts[k] for k in TRAIN_KERNELS}
        expected += want
        frames_s = accum * micro * frames / walls[-1]
        print(f"  step {state.step}: loss {logged['loss']:.6f} grad_norm "
              f"{logged['grad_norm']:.6f} wall {walls[-1]:.3f} s, {frames_s:.1f} mel "
              f"frames/s; launches {got} (expected {want} each)", flush=True)
        if not (math.isfinite(logged["loss"]) and math.isfinite(logged["grad_norm"])):
            fail("the loss or grad norm is not finite")
        if any(v != want for v in got.values()):
            fail(f"training kernel launches {got}, expected {want} each")
    launches = dict(attention.TRAIN_LAUNCHES)
    if attention.LAUNCHES != 0:
        fail(f"the training step launched the serving kernel {attention.LAUNCHES} times")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  median step {statistics.median(walls):.3f} s, "
          f"{accum * micro * frames / statistics.median(walls):.1f} mel frames/s, "
          f"peak device memory {peak:.2f} GiB", flush=True)

    trainable = {n for n, p in state.model.named_parameters() if p.requires_grad}
    after = state.model.state_dict()
    still = sorted(n for n in trainable if torch.equal(after[n], before[n]))
    changed = sorted(n for n in after if n not in trainable
                     and not torch.equal(after[n], before[n]))
    print(f"  {len(trainable) - len(still)} of {len(trainable)} trainable tensors moved; "
          f"{len(after) - len(trainable) - len(changed)} of {len(after) - len(trainable)} "
          "frozen tensors bit-identical", flush=True)
    if still or changed:
        fail(f"unmoved trainable {still[:3]} or changed frozen {changed[:3]}")
    del before

    # the same step from the same state and seed gives the same loss bits
    snap = state.snapshot()
    gen_state = trainer.generator.get_state()
    batch = next(data)
    first = trainer.step_fn(state, batch, trainer.generator)
    state.restore(snap)
    trainer.generator.set_state(gen_state)
    second = trainer.step_fn(state, batch, trainer.generator)
    same_loss = torch.equal(first["loss"], second["loss"])
    same_norm = torch.equal(first["grad_norm"], second["grad_norm"])
    print(f"  repeated step: loss {first['loss'].item():.9f} / {second['loss'].item():.9f} "
          f"bit-identical {same_loss}; grad_norm bit-identical {same_norm}", flush=True)
    if not (same_loss and same_norm):
        fail("the repeated step gave another loss or grad norm")
    del snap

    # kernel route against the plain route on one micro-batch that keeps
    # every layer and has an unconditioned row, so every trainable parameter
    # must get a gradient
    mb = {k: v[0] for k, v in batch.items()}
    gen = torch.Generator(device="cuda").manual_seed(3)
    draws = draw_diff(cfg, make_train_schedule(cfg, device="cuda"), mb["raw_mel"].shape,
                      gen, torch.device("cuda"))
    uncond = draws.uncond.clone()
    uncond[0] = True
    draws = draws._replace(uncond=uncond, keep=(True,) * len(draws.keep))
    kernel, missing = micro_metrics(state, cfg, mb, draws)
    print(f"  one micro-batch, every layer kept: {len(missing)} trainable tensors "
          "without a gradient", flush=True)
    if missing:
        fail(f"trainable tensors got no gradient: {missing[:3]}")

    def plain_route(qkv, bias, *, heads, sm_scale):
        return attention.bias_attention_train_reference(qkv, bias, heads=heads,
                                                        sm_scale=sm_scale)[0]

    def lost_dbias_route(qkv, bias, *, heads, sm_scale):  # known wrong
        return plain_route(qkv, bias.detach(), heads=heads, sm_scale=sm_scale)

    plain = with_route(plain_route, lambda: micro_metrics(state, cfg, mb, draws)[0])
    wrong = with_route(lost_dbias_route, lambda: micro_metrics(state, cfg, mb, draws)[0])
    rel = {k: abs(a - b) / abs(b) for k, a, b in zip(ROUTE_TOL, kernel, plain)}
    rel_wrong = {k: abs(a - b) / abs(b) for k, a, b in zip(ROUTE_TOL, wrong, plain)}
    print(f"  kernel vs plain route: loss {kernel[0]:.6f} / {plain[0]:.6f}, grad norm "
          f"{kernel[1]:.6f} / {plain[1]:.6f}, T5 grad norm {kernel[2]:.6f} / {plain[2]:.6f}; "
          f"relative differences {json.dumps(rel)} (tolerances {json.dumps(ROUTE_TOL)}); "
          f"a route that loses dbias reads {json.dumps(rel_wrong)}", flush=True)
    if any(not rel[k] <= ROUTE_TOL[k] for k in ROUTE_TOL):
        fail("the kernel route disagrees with the plain route")
    if all(rel_wrong[k] <= ROUTE_TOL[k] for k in ROUTE_TOL):
        fail("the route check would pass a route that loses dbias")

    # device idle share of one traced step
    step_ms = statistics.median(walls) * 1e3
    wall_ms, busy_ms, n, idle = idle_share(
        lambda: trainer.step_fn(state, next(data), trainer.generator), step_ms)
    print(f"  traced step: wall {wall_ms:.1f} ms (traced), device busy {busy_ms:.1f} ms, "
          f"{n} device launches; idle share against the untraced median step "
          f"{step_ms:.1f} ms: {idle:.3f}", flush=True)
    del trainer, state, data
    torch.cuda.empty_cache()
    return launches


def idle_share(fn, step_ms):
    """(traced wall ms, device busy ms, device launches, idle share against
    ``step_ms``) of one traced ``fn()``: the profiler slows the host, not
    the kernels, so the idle share is taken against an untraced wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from profile_port import union_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = union_us(spans) / 1e3
    return wall_ms, busy_ms, len(spans), 1 - busy_ms / step_ms


TRAIN_TARGETS = ("gpt", "vqvae", "flowvae", "all")


def train_target(cfg_full, target):
    """Phase 6b for one target; returns the training kernels' launches."""
    import dataclasses

    from detail_tts_tpu_torch.train.step import GAN_TARGETS, synthetic_batches
    from detail_tts_tpu_torch.train.trainer import Trainer

    gan = target in GAN_TARGETS
    cfg = dataclasses.replace(cfg_full, train=dataclasses.replace(cfg_full.train,
                                                                  target=target))
    accum = 1 if gan else cfg.train.gradient_accumulate_every
    micro, frames, text_len = cfg.train.batch_size, 496, 64
    data = synthetic_batches(cfg, accum, micro, frames, text_len, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(1))
    t0 = time.perf_counter()
    trainer = Trainer(cfg, data, device="cuda", seed=0)
    state = trainer.state
    n_train = sum(p.numel() for p in state.params)
    n_all = sum(p.numel() for p in state.model.parameters())
    n_disc = sum(p.numel() for p in state.d_params) if gan else 0
    print(f"  {target}: {n_train / 1e6:.1f} M trainable of {n_all / 1e6:.1f} M parameters"
          + (f", discriminator {n_disc / 1e6:.1f} M" if gan else "")
          + f", batch {micro} x {frames} frames x accum {accum}"
          + (f", segment {cfg.train.segment_size} samples, weight norm "
             f"{cfg.train.weight_norm}" if gan else f", text {text_len}")
          + f"; built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    trainer.train(max_steps=1, log_every=1)  # warm-up
    torch.cuda.synchronize()
    print(f"  {target}: warm-up step {time.perf_counter() - t0:.3f} s", flush=True)

    def tensors():
        out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
        if gan:
            out.update({f"disc.{k}": v for k, v in state.disc.state_dict().items()})
        return out

    before = {k: v.cpu() for k, v in tensors().items()}  # off the card: peak is the step's
    torch.cuda.reset_peak_memory_stats()
    attention.LAUNCHES = 0
    for name in TRAIN_KERNELS:
        attention.TRAIN_LAUNCHES[name] = 0
    walls = []
    for _ in range(2):
        counts = dict(attention.TRAIN_LAUNCHES)
        t0 = time.perf_counter()
        logged = trainer.train(max_steps=state.step + 1, log_every=1)
        walls.append(time.perf_counter() - t0)
        m = trainer.last_metrics
        want = expected_train_launches(cfg, m["layers_kept"]) if target == "all" else 0
        got = {k: attention.TRAIN_LAUNCHES[k] - counts[k] for k in TRAIN_KERNELS}
        scalars = {k: v for k, v in logged.items() if k != "steps_per_sec"}
        print(f"  {target} step {state.step}: wall {walls[-1]:.3f} s, "
              f"{accum * micro * frames / walls[-1]:.1f} mel frames/s; "
              + ", ".join(f"{k} {v:.6g}" for k, v in scalars.items())
              + f"; training-kernel launches {got} (expected {want} each)", flush=True)
        if not all(math.isfinite(v) for v in scalars.values()):
            fail(f"{target}: a loss or grad norm is not finite: {scalars}")
        if any(v != want for v in got.values()):
            fail(f"{target}: training kernel launches {got}, expected {want} each")
    if attention.LAUNCHES != 0:
        fail(f"{target}: the step launched the serving kernel {attention.LAUNCHES} times")
    launches = dict(attention.TRAIN_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_s = statistics.median(walls)
    print(f"  {target}: median step {step_s:.3f} s, {accum * micro * frames / step_s:.1f} "
          f"mel frames/s, peak device memory {peak:.2f} GiB", flush=True)

    trainable = {f"model.{n}" for n, p in state.model.named_parameters() if p.requires_grad}
    if gan:
        trainable |= {f"disc.{n}" for n, _ in state.disc.named_parameters()}
    codebook = {k for k in before if "._codebook." in k}
    after = {k: v.cpu() for k, v in tensors().items()}
    still = sorted(k for k in trainable if torch.equal(after[k], before[k]))
    changed = sorted(k for k in after if k not in trainable | codebook
                     and not torch.equal(after[k], before[k]))
    cb_moved = sorted(k for k in codebook if not torch.equal(after[k], before[k]))
    want_cb = target in ("vqvae", "all")
    print(f"  {target}: {len(trainable) - len(still)} of {len(trainable)} trainable tensors "
          f"moved{' (discriminator included)' if gan else ''}; "
          f"{len(after) - len(trainable) - len(codebook) - len(changed)} of "
          f"{len(after) - len(trainable) - len(codebook)} frozen tensors bit-identical; "
          f"codebook buffers moved {cb_moved} (expected {'some' if want_cb else 'none'})",
          flush=True)
    if still or changed:
        fail(f"{target}: unmoved trainable {still[:3]} or changed frozen {changed[:3]}")
    if bool(cb_moved) != want_cb:
        fail(f"{target}: codebook buffers moved {cb_moved}, expected "
             f"{'some' if want_cb else 'none'}")
    del before, after

    # the same step from the same state and generator state: the same bits
    snap = state.snapshot()
    gen_state = trainer.generator.get_state()
    batch = trainer.next_batch()
    runs = []
    for _ in range(2):
        state.restore(snap)
        trainer.generator.set_state(gen_state)
        runs.append(trainer.step_fn(state, batch, trainer.generator))
    same = {k: torch.equal(runs[0][k], runs[1][k]) for k in runs[0] if torch.is_tensor(runs[0][k])}
    print(f"  {target}: repeated step bit-identical {same}", flush=True)
    if not all(same.values()):
        fail(f"{target}: the repeated step gave other metrics: {same}")
    del snap
    if target == "all":
        wall_ms, busy_ms, n, idle = idle_share(
            lambda: trainer.step_fn(state, trainer.next_batch(), trainer.generator),
            step_s * 1e3)
        print(f"  all: traced step wall {wall_ms:.1f} ms (traced), device busy "
              f"{busy_ms:.1f} ms, {n} device launches; idle share against the "
              f"untraced median step {step_s * 1e3:.1f} ms: {idle:.3f}", flush=True)
    del trainer, state, data
    torch.cuda.empty_cache()
    return launches


def phase_train_targets(cfg_full):
    """Phase 6b: every other training target; returns the training kernels'
    launches (all of them under ``all``)."""
    print("== training targets", flush=True)
    print(f"  cudnn.benchmark {torch.backends.cudnn.benchmark}; each step runs with "
          "cudnn.deterministic on", flush=True)
    total = {name: 0 for name in TRAIN_KERNELS}
    for target in TRAIN_TARGETS:
        for name, n in train_target(cfg_full, target).items():
            total[name] += n
    return total


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
    train_worst, train_times, backend = phase_train_kernels(sfu_per_s)

    t0 = time.perf_counter()
    engine = random_engine(cfg, seed=0, engine_cfg=ecfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.model.parameters())
    print(f"== engine: Config() at full width, {n_params / 1e6:.1f} M parameters "
          f"{engine.cdt}, built in {time.perf_counter() - t0:.1f} s", flush=True)
    launches, per_request, records = phase_serving(engine, requests)
    launches += phase_serving_paths(engine, texts, prompts, records)
    del engine
    torch.cuda.empty_cache()

    train_launches = phase_training(cfg)
    target_launches = phase_train_targets(cfg)

    kernels = [dict(
        name="bias_attention_fwd", route="cuda",
        source="detail_tts_tpu_torch/csrc/bias_attention.cu",
        replaces="detail_tts_tpu/ops/pallas/attention.py:404",
        launches=launches, launches_per_request=per_request,
        max_abs_err=worst, **times)]
    sources = {"bias_attention_train_fwd": ("bias_attention.cu", 259),
               "bias_attention_bwd_dq_dbias": ("bias_attention_bwd.cu", 286),
               "bias_attention_bwd_dkv": ("bias_attention_bwd.cu", 308),
               "bias_attention_bwd_dbias_sum": ("bias_attention_bwd.cu", 286)}
    for name in TRAIN_KERNELS:
        src, line = sources[name]
        kernels.append(dict(
            name=name, route="cuda", source=f"detail_tts_tpu_torch/csrc/{src}",
            replaces=f"detail_tts_tpu/ops/pallas/attention.py:{line}",
            launches=train_launches[name] + target_launches[name],
            launches_over="3 diff steps (phase 6) and 2 all steps (phase 6b)",
            max_abs_err=train_worst[name][0], max_scaled_err=train_worst[name][1],
            library=("torch.sum over the batch" if name.endswith("sum") else
                     "scaled_dot_product_attention (" + backend + ")"),
            **train_times[name]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
