"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):

1. environment: the card's name and power limit, torch/CUDA versions, TF32
   settings; a CUDA device is required;
2. build: compiles ``detail_tts_tpu_torch/csrc/bias_attention.cu``,
   ``bias_attention_bwd.cu``, ``threefry.cu`` and ``sample.cu`` with nvcc,
   one process each, at once; prints
   each kernel's ``ptxas -v`` registers and spills, and the CTAs per SM of
   the serving forward, the training forward and the backward kernels at
   d=48 and d=96 (the backward's wgmma kernels with their waves over the
   SMs and their ptxas lines at the step's trunk, d=48, and its contextual
   embedder, d=96); the training forward's route
   (``train_fwd_wgmma`` or ``train_fwd_mma``), query rows a CTA, registers,
   CTAs an SM, shared memory and waves at ``TRAIN_FWD_SHAPES`` (the step's
   three shapes, the raw buckets 1024 and 2824, the conditioner at 706
   codes; C entry ``bias_attention_train_fwd_info``);
3. kernel: ``bias_attention`` against its plain PyTorch version at the
   serving shapes and at T on the serving kernels' tile and bias-copy edges
   (bf16, plus fp32; d = 48 and the contextual embedder's d = 96 on both
   routes; a fully masked row and masked keys on each), each call's route
   (``serve_fwd_wgmma`` or ``serve_fwd_mma``; the C entry against
   ``attention.bias_attention_fwd_route``) counted and a repeat launch
   bit-identical; each route's registers, shared memory and L2-bytes
   model at d = 48 and 96; CUDA-event and device times of each kernel
   (``serve_fwd_wgmma`` at the trunk, ``serve_fwd_wgmma<96>`` at the
   contextual embedder, ``serve_fwd_mma`` at the latent conditioner of
   code bucket 100), the plain version and
   ``F.scaled_dot_product_attention`` (the yardstick, never used by the
   port) beside the card's bound, and the wrapper's host time a call;
3b. threefry: ``threefry_draw`` (JAX's threefry2x32 bits, uniforms,
   normals and Gumbels) against its plain version at the main path's draw
   shapes (a decode step's (B, 8194) Gumbels, the diffusion's (B, 4 x
   bucket, 128) and the vocoder's (B, 4 x bucket, 192) normals, at b8 / 400
   and b2 / 200 codes) and at odd sizes: bits bit-identical, floats within
   ``PRNG_ULPS``; a scaled draw; ``threefry_keys``' decode chain and split
   bit-identical; a draw under a device key row equal to the host key's;
   row 0 of a batch-2 draw equal to the batch-1 draw and a draw from an
   offset equal to those rows of the whole; CUDA-event and device times
   beside the bound (integer operations at 64 a clock an SM, or bytes
   written) and the plain version's;
3c. the sample step: ``sample_step`` (the decode step's penalty,
   temperature, typical and top-p filters, Gumbels, argmax and bookkeeping
   in one kernel: a row over a cluster of 8 CTAs up to V = 65,536, past it
   over a group of G CTAs, up to every SM) against
   ``sample_step_reference`` at (B, V) = (1, 2, 8, 16) x 8194, (1, 8) x
   8193, (2, 16) x 1000, the wide vocabularies (1, 8) x 16386, (2,
   12289) and (1, 65536), and past the shared-memory path
   (``WIDE_SAMPLE_SHAPES``: (1, 65537), (3, 65539) with rows off every
   16-byte boundary, (2, 131073), (8, 131073) in two groups of four rows,
   (1, 1048579), (1, 4194305), (1, 8388609) and (1, 16777217), past what
   the card's shared memory caches), bf16 and fp32 logits,
   under ``SAMPLE_SETTINGS`` (top-p, top-p and typical, typical, both off),
   with and without force_full and a data rank's offset, on random logits,
   logits tied at the top-p boundary, a -0.0 / +0.0 pair, rows with one
   finite logit and rows with none: every token equal except in rows
   whose plain boundary mass lies within ``SAMPLE_NEAR`` of its threshold,
   those rows under ``SAMPLE_FLIPS`` of all, codes, seen, lengths and
   finished bit-identical where the tokens agree, and a repeated launch
   bit-identical; at ``WIDE_ALONE_SHAPES`` ((3, 65539), (8, 131073), (3,
   1048579), (3, 8388609)) each row launched alone bit-identical to the same
   row in the batch; CUDA-event and device times at (1, 2, 8, 16) x 8194
   under top-p, top-p and typical, and both off, at (2, 12289), (8,
   16386) and (1, 65536) under top-p, and at ``WIDE_SAMPLE_SHAPES`` under
   the three (the plain version beside top-p), with C and the threads a CTA
   (on the wide path G, the groups in flight, the cached tokens a CTA and
   the device time's share of the bound),
   beside the bound (bytes), the floor (an empty kernel on the cluster grid:
   launch to launch, and its device time), the plain version's and the
   parent's decode step (stock launches around a ``threefry_draw``), each
   with its device launches.
   After phase 4, on real decode steps: every step of a b8 / 200-code bf16
   decode of phase 4's engine recorded and held the same way; an fp32
   engine's b2 decode through the kernel against the same decode stepping
   through ``sample_step_reference`` (every code and length equal, unless
   the first differing step is a row at the boundary);
4. serving: ``random_engine(Config())`` at full width, bf16, answers three
   requests through ``synthesize_batch``; checks the audio, that every
   ``AttentionBlock`` call of the path launched the kernel, on the route
   and head dim ``b1_routes_per_request`` gives (at code bucket 200 every
   call on ``serve_fwd_wgmma``: d = 48, and d = 96 for the contextual
   embedder at the prompt bucket's T / 4), that every
   random draw of the request launched ``threefry_draw`` (steps + 1 a
   request: none in the decode) and its two key buffers ``threefry_keys``,
   and that every decode step executed launched ``sample_step`` once;
   reads row 0 of the first request alone against its batch;
4b. serving paths, on the same weights: each other sampler (``ddim``,
   ``dpmpp_2m_karras`` and ``dpmpp_2m`` at 50 steps, ``dpmpp_2m`` at 25)
   twice at batch 2, with its kernel launches (steps x 13 + 9 a request,
   each on its route and head dim; threefry 2 draws and one key buffer
   outside ``ancestral``, a sample step a decode step) and bit-identical
   repeats; a request at code bucket 100, whose latent conditioner (T %
   8 != 0) takes ``serve_fwd_mma``; ``pcm16_output`` against the
   float output's conversion; the diffusion-free VQ path (no launch) and
   ``vq_roundtrip``; a ``TTSServer`` answering 4 concurrent requests and
   refusing a sub-hop prompt, ``dispatch_batch`` + ``finalize_batch``
   against ``synthesize_batch``; long-form streaming against
   ``synthesize_long``; the HTTP endpoint on 127.0.0.1; on each, one
   ``sample_step`` launch for every decode step executed (``DecodeSteps``);
5. train kernels vs plain: the training forward (with its row statistic)
   and the backward (delta, dq and the dbias partials; dk and dv; the
   partials' sum in batch order) against their plain versions at the
   training step's attention shapes (bf16 and fp32, ragged T, a fully
   masked row, whose lse must be ``MASKED_LSE``; batch 8 and a world-2
   rank's batch 4), each call's forward route (``train_fwd_wgmma``: bf16,
   T % 4 == 0, at d = 96 and at d <= 64 on a grid of 128-row CTAs of at
   least half the SMs; ``train_fwd_mma``; ``train_fwd_simt``) and backward
   route (``bwd_wgmma``: bf16, d <= 64 or d = 96, T % 4 == 0; ``bwd_mma``;
   ``bwd_simt``) printed, the C entries' against
   ``attention.bias_attention_train_fwd_route``'s and
   ``attention.bias_attention_bwd_route``'s and each counted once (also by
   head dim), the contextual embedder's d = 96 on both forward and
   backward routes (T = 124 and 125), the
   forward twice bit-identical, the sum pass alone against its plain
   version, a fully masked row and masked keys exactly 0 (d = 48 and 96),
   the backward twice for bit-identical dbias (d = 48 and 96), and
   CUDA-event times
   of bare launches on buffers allocated beforehand (the training forward
   also through its wrapper) beside the bound, the plain versions and SDPA
   with a bias mask that requires grad, on the wgmma routes at (8, 496, 16,
   48), (8, 124, 16, 48), (8, 1024, 16, 48) and (8, 124, 16, 96) and on the
   mma.sync routes at (8, 125, 16, 96) (``train_fwd_mma<96, 1>`` beside
   ``train_fwd_wgmma<96>``); then the four training kernels at
   the data loader's raw buckets T = 512, 1024 and 2824 (batch 8, bf16);
6. training: ``Trainer`` over ``Config()`` at full width, target ``diff``,
   micro-batch 8 x 496 frames x accum 16 of seeded synthetic batches: a
   warm-up step and three timed steps, then one step of 8 x 500 frames
   (the loader's other crop: T = 125, where the contextual embedder and the
   latent conditioner take the mma.sync kernels), each checked for finite loss and grad
   norm and for one launch of each training kernel per AttentionBlock call,
   each forward and backward call on the route its shape takes
   (``expected_train_fwd_routes``, ``expected_bwd_routes``,
   ``expected_bwd_dims``; phases 6b and 7 gate the same);
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
   for ``all`` the device idle share of one traced step;
7. from a corpus on disk, in a temporary directory removed at the end:
   ``CORPUS_CLIPS`` (64) seeded speech-like clips of 1-10 s at 24, 44.1 and 16 kHz, two outside
   the duration filter and two long recordings cut by ``prepare_cli vad``,
   their transcripts through ``prepare_cli transcripts``; the native
   decoder against scipy; ``python -m detail_tts_tpu_torch.train`` (target
   ``diff``, ``Config()`` with ``CORPUS_ACCUM`` (4) micro-batches a step
   in place of 16, 2 steps, 8 decode threads) in a subprocess, which
   must write finite metrics, ``ckpt/2`` and the eval dumps; in this
   process trainer A on the corpus (one decode thread) takes 2 steps, and
   its step 3 on the next batch must be bit-identical (loss, grad norm,
   trainable tensors, AdamW state) to trainer R's restored from A's
   checkpoint with A's generator state, each training kernel launched
   ``expected_train_launches`` times, with the raw bucket, the batch waits,
   the step wall, mel frames/s, peak memory and the idle share printed;
   ``prepare_cli extract-vq`` in a subprocess, its codes against an
   exact-length ``encode_masked`` run on four files (a differing code must
   be a tie within 1e-5 relative); ``build_engine`` over the CLI's
   checkpoint answers one request with a prepared clip as the prompt (B1
   launched steps x 13 + 9 times); the phase's wall;
8. data parallelism and remat at the full width of ``Config()``: (a) the
   Trainer over a world-1 NCCL process group (TCP store on 127.0.0.1) for
   ``diff`` (micro-batch 8 x accum 2) and ``all`` (batch 8, GPT dropout
   0.1), two steps each, bit-identical to the plain Trainer in every metric
   and trainable tensor, each training kernel launched
   ``expected_train_launches`` times; (b) two processes on the one card
   over gloo, ``diff`` (8 a global micro-batch, 4 a rank, x accum 2) and
   ``vqvae`` from a fresh codebook (the k-means gather) under bf16
   autocast and in fp32, two steps each: the ranks' tensors bit-identical
   (SHA-256 of every trainable tensor and buffer), loss and grad norm
   within 1e-3 relative of world 1, the codebook within 1e-4 of world 1's
   in fp32 and 1e-2 under bf16 (its bf16 features round per micro-batch
   shape), each rank's launches, the gradient all-reduce's wall a step and
   each rank's peak memory; (c) ``gpt``
   (micro-batch 8 x accum 2, dropout 0.1) with ``remat_gpt`` on and off
   from one seed: loss and grad norm within 1e-6 relative, a lower peak
   with remat;
9. the mesh's model axis and sharded serving at the full width of
   ``Config()``, two gloo ranks on the one card against the one-card
   engine and the plain Trainer: (a) a (2 x 1) engine, 2 rows a rank of a
   4-row request at 64 codes under force_full: the deterministic tail
   (fixed codes -> latents, mel, wav) in fp32 at JAX's mesh tolerances
   (2e-4, 2e-3, 2e-3 of the one-card output's max), and in fp32 and bf16
   bit-identical to the one-card engine's computation of the same rows as
   2-row batches; the sampled fp32 request's codes equal to the one-card
   engine's, the bf16 request's audio within ``BF16_WAV_TOL``, B1 launched
   steps x 13 + 9 times a request on each rank, and the threefry kernels
   and a ``sample_step`` a decode step as in phase 4 on each rank; (b) a (1 x 2) engine (the
   GPT split over the ranks): the same tail in fp32, the sampled codes'
   agreement printed (a flip is a reading: the split sums in another
   order); (c) ``gpt`` at (1 x 2), micro-batch 8 x 496 x accum 2, dropout
   on, in fp32: loss and grad norm within 1e-3 of the plain Trainer's for
   2 steps, the gathered weights' distance from world 1's within
   ``STEP_TOL`` of the change world 1's two steps made, tensor by tensor
   (two planted faults read from the same tensors, no update and one
   shard's update lost, must read above it; ``NOISE_STEP``, a tensor
   whose exact gradient is 0, is read and not gated), the replicated tensors
   bit-identical across the ranks (SHA-256), and the (1 x 2) checkpoint
   restored at world 1 gives the same third step within 1e-3; under bf16
   autocast 2 steps within ``GPT_BF16_TOL``; (d) one ``diff`` step at
   (1 x 2), whose frozen latents pass runs the sharded
   GPT: within the route tolerances of phase 8's world-1 step, each
   training kernel launched ``expected_train_launches`` times on each rank;
10. the front ends over the sharded engine (``serving/spmd.py``) at the
   full width of ``Config()``, two gloo ranks on the one card, a (2 x 1)
   engine in fp32 and in bf16, ancestral 50 with early stop at up to
   ``PHASE10_CODES`` codes: rank 0 serves through a ``LeaderEngine``, rank
   1 runs ``follow``.  A ``TTSServer`` answers 4 concurrent requests (zh
   texts of 3-20 characters, 3 s prompts) as one batch, then as two
   back-to-back batches of 2; a batch with a fault planted on rank 1 must
   fail its futures with a ``RuntimeError`` naming rank 1, and the next
   batch must resolve; one HTTP ``/synthesize`` and a 3-chunk
   ``synthesize_long``.  Each batch is held against the one-card front
   ends given the same groups and seeds: fp32 every code equal and the
   audio within 2e-3 of max, bf16 at least 0.9 of the codes equal and the
   audio of each item whose codes all agree within ``BF16_WAV_TOL``; B1
   launched steps x 13 + 9 times a batch on each rank, and on each rank
   and on one card a ``sample_step`` for every decode step executed (the
   early stop waits for every rank) and ``threefry_draw`` only in the
   tails; every decode on the
   engine's card (rank 0's on the server's dispatch thread); both
   processes exit 0;
11. the worked examples at the full width of ``Config()``, each a
   subprocess on the card (``python3 chip_smoke.py --example SCRIPT
   ARGS...`` runs one with its launches counted): three seeded recordings
   of speech-like noise through ``examples/lifecycle_demo_torch.py``
   (VAD, transcripts, a 2-step ``vqvae`` stage and a ``gpt`` stage grown
   from its checkpoint at batch 2, the full diffusion path from the
   ``gpt`` checkpoint at default buckets), ``prepare_demo_torch.py`` with
   that checkpoint, and ``demo_torch.py`` with it and a prepared clip as
   the prompt: every exit code 0 and phase line printed, both checkpoints
   on disk, every wav finite and non-empty at 24 kHz, the ``.vq.npy``
   codes in [0, ``vq_bins``), one ``sample_step`` launch a decode step
   executed and ``steps x 13 + 9`` B1 launches a diffusion request, each
   on its route and head dim (the contextual embedder's by the T of each
   prompt mel it conditions on); each script's wall.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import base64
import ctypes
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from detail_tts_tpu_torch.ops import attention, prng, sampling  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# fp32 outside them, HBM3.  The exp2 peak is derived from the card itself:
# 16 special-function results per clock per SM.
PEAK_TFLOPS = {torch.bfloat16: 989.0, torch.float32: 67.0}
PEAK_BYTES_PER_S = 3.35e12
SFU_PER_CLOCK_PER_SM = 16
# 32-bit integer results per clock per SM of Hopper (the H100 white paper's
# 64 INT32 units an SM), and those that threefry2x32 takes an element (20
# rounds of add, rotate, xor; 6 key injections of two adds; the final xor;
# csrc/threefry.cu): the threefry kernels' operations bound
INT32_PER_CLOCK_PER_SM = 64
THREEFRY_INT_OPS = 73
# The decode's key chain is sequential: step s + 1's key is threefry2x32 of
# step s's.  One threefry2x32 is 46 dependent integer operations (each of
# its 20 rounds an add, then the xor that needs it, the rotate beside the
# add; one add at each of the 5 key injections and at the start), each
# issued ~4 clocks after the one it waits for (the dependent-issue latency
# of Hopper's integer add, xor and funnel shift): the chain's bound is n x
# 46 x 4 clocks, whatever the card's throughput.
THREEFRY_DEPTH = 46
INT_LATENCY_CLOCKS = 4
# the threefry kernels' floats against their plain versions, in units of
# the last place of max(|plain|, 1) (the same libdevice functions, one
# rounding an operation on both sides: read bit-identical)
PRNG_ULPS = 2
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# Phase 9's bf16 readings against one card (first chip run of the phase,
# H100 80GB HBM3, 700 W): the (2 x 1) request's audio 0.168 of max |one card|
# away with every code equal (a data rank's 2-row batches round otherwise
# than one card's 4-row batch; its tail is held bit for bit to one card's
# 2-row computation instead), gated at 0.5; the (1 x 2) gpt step under bf16
# autocast 1.2e-3 off in grad norm at step 2 (the split sums and Adam's
# ~lr steps on gradients near 0), gated at 5e-3.  The fp32 runs carry the
# tight gates.
BF16_WAV_TOL = 0.5
GPT_BF16_TOL = 5e-3


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
    microseconds can wait for.  ``only`` may be a tuple: kernels whose name
    holds any of its strings.  The profiler's CUDA trace has come back
    empty, or short of launches or holding some of another trace's: a trace
    whose count of such kernels is not a whole multiple of ``runs`` is
    taken again, up to five times in all, and then None (with the counts
    printed), never a mean over what it kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = (only,) if isinstance(only, str) else only
    for _ in range(warmup):
        fn()
    seen, counts = set(), []
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        seen.update(e.name[:60] for e in events)
        spans = [e.time_range.end - e.time_range.start for e in events
                 if not e.is_user_annotation and any(o in e.name for o in names)]
        if spans and len(spans) % runs == 0:
            if counts:
                print(f"  device_ms: {counts} kernels named {names} in the traces of {runs} "
                      f"calls before this one's {len(spans)}", flush=True)
            return sum(spans) / runs / 1e3
        counts.append(len(spans))
    print(f"  device_ms: {counts} kernels named {names} in five traces of {runs} calls; "
          f"their device events: {sorted(seen)[:6]}", flush=True)
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
    ptxas = {}  # entry name: its ptxas -v registers line
    for path, seconds, log in attention.build_all():
        print(f"built {path.name} in {seconds:.1f} s", flush=True)
        entry = None
        for line in log.splitlines():  # ptxas -v: entry name, then its resources
            if "entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
                print(f"  {entry[:90]}: {line.split(':', 1)[-1].strip()}", flush=True)
                if "registers" in line:
                    ptxas[entry] = line.split(":", 1)[-1].strip()
    print(f"build wall {time.perf_counter() - t0:.1f} s (parallel)", flush=True)
    fwd = attention._library(attention.SOURCE)
    lib = attention._library(attention.BWD_SOURCE)
    prng._library()  # threefry.cu's entries bound
    for d in (48, 96):
        serve = fwd.bias_attention_fwd_blocks_per_sm(d)
        train = train_fwd_info(8, 496, 16, d)["blocks"]  # its kernel at the trunk's T
        # the backward's mma.sync kernels and its wgmma ones
        occ = [lib.bias_attention_bwd_blocks_per_sm(k, d) for k in (0, 1, 2, 3)]
        if min(occ + [serve, train]) <= 0:
            fail(f"kernels at d={d} fit no CTA on an SM (serving {serve}, training "
                 f"forward {train}, backward {occ})")
        print(f"  CTAs per SM at d={d}: serving forward {serve}, training forward {train}, "
              f"backward bwd_dq_mma {occ[0]}, bwd_dkv_mma {occ[1]}, bwd_dq_wgmma {occ[2]}, "
              f"bwd_dkv_wgmma {occ[3]}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the training forward at the step's shapes and the raw buckets: its
    # route, tiling, registers, CTAs an SM, shared memory and waves
    for b, t, h, d in TRAIN_FWD_SHAPES:
        info = train_fwd_info(b, t, h, d)
        ctas = b * -(-t // info["rows"]) * h
        print(f"  training forward at ({b}, {t}, {h}, {d}): {info['route']}, "
              f"{info['rows']}-row CTAs, {info['registers']} registers, {info['blocks']} "
              f"CTAs an SM, {info['smem']} B shared a CTA; {ctas} CTAs, "
              f"{ctas / (info['blocks'] * sms):.2f} waves over {sms} SMs", flush=True)
    # the wgmma backward's grid at the step's trunk and contextual embedder:
    # CTAs, and waves over the SMs, beside each kernel's ptxas line
    for b, t, h, d in ((8, 496, 16, 48), (8, 124, 16, 96)):
        ctas = b * -(-t // 64) * h
        for which, name in ((2, "bwd_dq_wgmma"), (3, "bwd_dkv_wgmma")):
            per_sm = lib.bias_attention_bwd_blocks_per_sm(which, d)
            line = next((v for k, v in ptxas.items() if f"{name}ILi{d}E" in k), "not printed")
            print(f"  {name}<{d}> at ({b}, {t}, {h}, {d}): {ctas} CTAs, {per_sm} an SM, "
                  f"{ctas / (per_sm * sms):.2f} waves over {sms} SMs; ptxas: {line}",
                  flush=True)


ROUTE_CODES = {0: "serve_fwd_wgmma", 1: "serve_fwd_mma", 2: "bias_attention_simt"}
# the training forward's shapes in phase 2: the step's trunk, latent
# conditioner and contextual embedder, the raw buckets 1024 and 2824 and the
# conditioner at 706 codes
TRAIN_FWD_SHAPES = [(8, 496, 16, 48), (8, 124, 16, 48), (8, 124, 16, 96), (8, 1024, 16, 48),
                    (8, 2824, 16, 48), (8, 706, 16, 48), (4, 496, 16, 48), (4, 124, 16, 48)]


def sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def train_fwd_info(b, t, h, d, dtype=torch.bfloat16):
    """The training forward's kernel and launch at one call, from the C
    entry ``bias_attention_train_fwd_info``; its route checked against
    ``attention.bias_attention_train_fwd_route``."""
    info = (ctypes.c_int * 5)()
    rc = attention._library(attention.SOURCE).bias_attention_train_fwd_info(
        b, t, h, d, attention._DTYPE_CODE[dtype], info)
    if rc != 0 or info[2] <= 0:
        fail(f"bias_attention_train_fwd_info at {(b, t, h, d, dtype)}: {rc}, {list(info)}")
    route = attention.TRAIN_FWD_ROUTES[info[0]]
    mirror = attention.bias_attention_train_fwd_route(b, t, h, d, dtype, sm_count())
    if route != mirror:
        fail(f"the C entry routes the training forward at {(b, t, h, d, dtype)} to {route}, "
             f"the wrapper to {mirror}")
    return dict(route=route, rows=info[1], blocks=info[2], smem=info[3], registers=info[4])


def route_info(route, d):
    """(registers a thread, dynamic shared memory) of a serving route's
    kernel at head dim d, from the C entry."""
    out = [ctypes.c_int() for _ in range(2)]
    code = {v: k for k, v in ROUTE_CODES.items()}[route]
    rc = attention._library(attention.SOURCE).bias_attention_fwd_route_info(
        code, d, *(ctypes.byref(o) for o in out))
    if rc != 0:
        fail(f"bias_attention_fwd_route_info({route}, {d}) failed ({rc})")
    return tuple(o.value for o in out)


def serving_l2_bytes(b, t, h, d, route):
    """The bytes a serving launch pulls from L2 into the SMs, by the kernels'
    tiling: each CTA reads its (b, h)'s whole K and V and its query rows of Q
    and of the bias for every key."""
    rows = 128 if route == "serve_fwd_wgmma" or (route == "serve_fwd_mma" and d <= 64) else 64
    ctas = b * -(-t // rows) * h
    size = 4 if route == "bias_attention_simt" else 2
    kv_q = ctas * (2 * t * d + rows * d) * size
    bias = b * h * t * t * size
    return kv_q + bias


def check_route(t, d, dtype):
    """The C entry's route against ``attention.bias_attention_fwd_route``."""
    code = attention._library(attention.SOURCE).bias_attention_fwd_route(
        t, d, attention._DTYPE_CODE[dtype])
    route = attention.bias_attention_fwd_route(t, d, dtype)
    if ROUTE_CODES.get(code) != route:
        fail(f"the C entry routes T={t} d={d} {dtype} to {code}, the wrapper to {route}")
    return route


def phase_kernel(sfu_per_s, extra_shapes=(), timed_shapes=()):
    """Kernel vs plain version; returns (max error, timing rows by route)."""
    print("== kernel vs plain", flush=True)
    # d = 96 (the contextual embedder): every prompt bucket's T on
    # serve_fwd_wgmma (16, 128, 400), and T % 8 != 0 on serve_fwd_mma
    shapes = [(3, 1600, 16, 48), (4, 1600, 16, 48), (9, 1600, 16, 48),
              (16, 1600, 16, 48), (3, 1597, 16, 48), (4, 1597, 16, 48),
              (9, 1597, 16, 48), (16, 1597, 16, 48), (2, 400, 16, 96),
              (8, 400, 16, 96), (1, 16, 16, 96), (3, 130, 16, 96), (3, 397, 16, 96),
              (3, 127, 16, 48), (3, 129, 16, 48), (3, 300, 16, 48)]
    shapes += [s for s in extra_shapes if s not in shapes]
    for route, d in (("serve_fwd_wgmma", 48), ("serve_fwd_wgmma", 96), ("serve_fwd_mma", 48),
                     ("serve_fwd_mma", 96)):
        regs, smem = route_info(route, d)
        model = serving_l2_bytes(16, 1600, 16, d, route) / 1e9
        print(f"  route {route} d={d}: {regs} registers a thread, {smem} B of shared "
              f"memory; L2 -> SM bytes model at (16, 1600, 16, {d}) {model:.3f} GB",
              flush=True)
    worst = 0.0
    for i, (b, t, h, d) in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and b > 4:
                continue  # fp32 is the test route; keep its cases small
            route = check_route(t, d, dtype)
            qkv, bias = attention_inputs(b, t, h, d, dtype, seed=i)
            sm = 1.0 / math.sqrt(d)
            before = dict(attention.LAUNCHES_BY_ROUTE)
            out = attention.bias_attention(qkv, bias, heads=h, sm_scale=sm)
            again = attention.bias_attention(qkv, bias, heads=h, sm_scale=sm)
            ref = attention.bias_attention_reference(qkv, bias, heads=h, sm_scale=sm)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok = math.isfinite(err) and err <= TOL[dtype]
            same = torch.equal(out, again)
            counted = attention.LAUNCHES_BY_ROUTE[route] - before[route] == 2
            print(f"  B={b} T={t} H={h} d={d} {str(dtype)[6:]}: {route}, "
                  f"max_abs_err {err:.3e} (tol {TOL[dtype]:.0e}) "
                  f"{'ok' if ok else 'MISMATCH'}; repeat bit-identical {same}", flush=True)
            if not ok:
                fail(f"kernel disagrees with the plain version at {(b, t, h, d, dtype)}")
            if not same or not counted:
                fail(f"at {(b, t, h, d, dtype)}: repeat bit-identical {same}, launches "
                     f"counted on {route} {counted}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)

    # a fully masked query row must come out exactly 0, and masked keys take
    # no weight, on each route and head dim of the main path
    for b, t, h, d in ((3, 1597, 16, 48), (3, 1600, 16, 48), (3, 128, 16, 96),
                       (3, 130, 16, 96)):
        qkv, bias = attention_inputs(b, t, h, d, torch.bfloat16, seed=99)
        bias[5, 17, :] = -1e9
        bias[2, :, t - 9:] = -1e9
        out = attention.bias_attention(qkv, bias, heads=h, sm_scale=1 / math.sqrt(d))
        ref = attention.bias_attention_reference(qkv, bias, heads=h, sm_scale=1 / math.sqrt(d))
        row = out[:, 17, 5 * d:6 * d]
        err = (out.float() - ref.float()).abs().max().item()
        print(f"  masked row and keys at B={b} T={t} H={h} d={d} "
              f"({attention.bias_attention_fwd_route(t, d, torch.bfloat16)}): max |out| of "
              f"the row {row.abs().max().item():.1e}, max_abs_err {err:.3e}", flush=True)
        if torch.count_nonzero(row).item() != 0 or not err <= TOL[torch.bfloat16]:
            fail(f"at {(b, t, h, d)} a fully masked row is not exactly 0 or the rest "
                 "disagrees")
        worst = max(worst, err)

    # times at the diffusion trunk's shape for batch 8 at code bucket 400
    # (reported), then at ``timed_shapes``, each under its kernel's name
    # (``kernel_name``; the first shape of each)
    rows = {"serve_fwd_wgmma": time_kernel(16, 1600, 16, 48, sfu_per_s)}
    for b, t, h, d in timed_shapes:
        name = kernel_name(attention.bias_attention_fwd_route(t, d, torch.bfloat16), d)
        if name not in rows:
            rows[name] = time_kernel(b, t, h, d, sfu_per_s)
    return worst, rows


def kernel_name(route, d):
    """The name a route's kernel at head dim ``d`` has in the kernels line:
    the wgmma kernels at the contextual embedder's d = 96 apart from their
    trunk's instantiation (``route<96>``), the mma.sync kernels by route."""
    return f"{route}<96>" if d == 96 and route.endswith("wgmma") else route


def time_kernel(b, t, h, d, sfu_per_s):
    """CUDA-event and device times of the kernel (the route's), the plain
    version and SDPA at one shape, and the wrapper's host time a call."""
    qkv, bias = attention_inputs(b, t, h, d, torch.bfloat16, seed=7)
    sm = 1.0 / math.sqrt(d)
    q, k, v = (x.transpose(1, 2) for x in qkv.view(b, t, h, 3, d).unbind(3))
    mask = (bias.float() / attention.LOG2E).to(torch.bfloat16)[None]
    route = attention.bias_attention_fwd_route(t, d, torch.bfloat16)
    kernel_ms = cuda_ms(lambda: attention.bias_attention(qkv, bias, heads=h, sm_scale=sm))
    kernel_device_ms = device_ms(lambda: attention.bias_attention(qkv, bias, heads=h,
                                                                  sm_scale=sm),
                                 only=route)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):  # enqueued behind one another: the host's share of a call
        attention.bias_attention(qkv, bias, heads=h, sm_scale=sm)
    host_us = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    plain_ms = cuda_ms(lambda: attention.bias_attention_reference(
        qkv, bias, heads=h, sm_scale=sm))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=sm))
    bound_ms, bound_by = attention_bound_ms(b, t, h, d, torch.bfloat16, sfu_per_s)
    print(f"  time B={b} T={t} H={h} d={d} bf16 on {route}: kernel_ms {kernel_ms} "
          f"device_ms {kernel_device_ms} plain_ms {plain_ms} library_ms(sdpa) {library_ms} "
          f"bound_ms {bound_ms} ({bound_by}) -> {bound_ms / kernel_ms:.1%} of bound; "
          f"wrapper host {host_us:.1f} us a call", flush=True)
    return dict(ms=kernel_ms, device_ms=kernel_device_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                host_us=host_us, shape=[b, t, h, d])


# ------------------------------------------------------ threefry kernels

# draws the main path makes (b2 / 200 codes in phase 4, b8 / 400 in the
# benchmark's shape): a decode step's Gumbel (B, 8194), the diffusion's
# normals (B, 4 x bucket, 128), the vocoder's (B, 4 x bucket, 192); and odd sizes
PRNG_SHAPES = [(8, 8194), (8, 1600, 128), (8, 1600, 192), (2, 8194), (2, 800, 128),
               (1,), (3,), (7, 33), (5, 257, 3)]


def prng_ulps(x, ref) -> float:
    """max |x - ref| in units of the last place of max(|ref|, 1), float32."""
    m = ref.float().abs().clamp_min(1.0)
    spacing = torch.nextafter(m, torch.full_like(m, math.inf)) - m
    return ((x.float() - ref.float()).abs() / spacing).max().item()


def int32_per_s() -> float:
    """The card's 32-bit integer results a second: SMs x 64 x max SM clock."""
    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    return props.multi_processor_count * INT32_PER_CLOCK_PER_SM * clock_mhz * 1e6


def phase_prng():
    """Phase 3b: the threefry kernels against their plain versions; returns
    (max abs error, max error in ulps, timing row of ``threefry_draw``, of
    ``threefry_keys``)."""
    print("== threefry kernels vs plain", flush=True)
    dev = torch.device("cuda")
    key = prng.split(prng.PRNGKey(2024))[1]
    worst = worst_abs = 0.0
    for shape in PRNG_SHAPES:
        for kind in prng.KINDS:
            out = prng.draw(key, shape, kind, device=dev)
            ref = prng.draw_reference(key, shape, kind, device=dev)
            torch.cuda.synchronize()
            differ = int((out != ref).sum())
            err = 0.0 if kind == "bits" and not differ else (
                math.inf if kind == "bits" else prng_ulps(out, ref))
            ok = out.shape == ref.shape and out.dtype == ref.dtype and err <= PRNG_ULPS
            if kind != "bits":
                ok = ok and bool(torch.isfinite(out).all())
            print(f"  {kind} {shape}: {differ} of {out.numel()} elements differ, "
                  f"max {err:g} ulp (gate {PRNG_ULPS}) {'ok' if ok else 'MISMATCH'}", flush=True)
            if not ok:
                fail(f"threefry_draw disagrees with its plain version: {kind} {shape}")
            worst = max(worst, err)
            if kind != "bits":
                worst_abs = max(worst_abs, (out - ref).abs().max().item())
    # a scaled draw (the diffusion's temperature), a device key, row prefix, offset
    scaled = prng.draw(key, (8, 1600, 128), "normal", scale=0.5, device=dev)
    err = prng_ulps(scaled, prng.draw_reference(key, (8, 1600, 128), "normal", scale=0.5,
                                                device=dev))
    chain = prng.decode_keys(key, 200, dev)
    split = prng.split_keys(key, 50, dev)
    want_chain = torch.from_numpy(prng.keys_reference(key, 200, True).view(np.int32)).to(dev)
    want_split = torch.from_numpy(prng.keys_reference(key, 50, False).view(np.int32)).to(dev)
    step_key = tuple(int(w) for w in want_chain[17].cpu().numpy().view(np.uint32))
    checks = {
        "scaled normal within the gate": err <= PRNG_ULPS,
        "decode key chain (200) bit-identical": torch.equal(chain, want_chain),
        "split keys (50) bit-identical": torch.equal(split, want_split),
        "draw under a device key row = under the host key": torch.equal(
            prng.draw(chain[17], (8, 8194), "gumbel"),
            prng.draw(step_key, (8, 8194), "gumbel", device=dev)),
    }
    for kind in prng.KINDS:
        whole = prng.draw(key, (8, 1600, 128), kind, device=dev)
        checks[f"{kind}: row 0 of a batch-2 draw = the batch-1 draw"] = torch.equal(
            prng.draw(key, (2, 1600, 128), kind, device=dev)[:1],
            prng.draw(key, (1, 1600, 128), kind, device=dev))
        checks[f"{kind}: rows 5-7 from their offset = those rows of the whole"] = torch.equal(
            prng.draw(key, (3, 1600, 128), kind, offset=5 * 1600 * 128, device=dev),
            whole[5:])
    torch.cuda.synchronize()
    for what, ok in checks.items():
        print(f"  {what}: {'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            fail(f"threefry: {what}")
    rate = int32_per_s()
    rows = [time_prng_draw(key, shape, kind, rate)
            for shape, kind in (((8, 1600, 128), "normal"), ((8, 8194), "gumbel"),
                                ((2, 800, 128), "normal"), ((2, 8194), "gumbel"))]
    return worst_abs, worst, rows[0], time_prng_keys(key, 200, rate)


def time_prng_draw(key, shape, kind, rate):
    """CUDA-event and device times of ``threefry_draw`` and of its plain
    version at one shape, beside the bound (no library call draws JAX's
    threefry)."""
    dev = torch.device("cuda")
    n = math.prod(shape)
    kernel_ms = cuda_ms(lambda: prng.draw(key, shape, kind, device=dev))
    kernel_device_ms = device_ms(lambda: prng.draw(key, shape, kind, device=dev),
                                 only="draw_kernel")
    plain_ms = cuda_ms(lambda: prng.draw_reference(key, shape, kind, device=dev), runs=5)
    t_bytes = 4.0 * n / PEAK_BYTES_PER_S * 1e3
    t_ops = float(THREEFRY_INT_OPS) * n / rate * 1e3
    bound_ms, bound_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
    print(f"  time threefry_draw {kind} {shape}: kernel_ms {kernel_ms} device_ms "
          f"{kernel_device_ms} plain_ms {plain_ms} bound_ms {bound_ms} ({bound_by}) -> "
          f"{bound_ms / kernel_ms:.1%} of bound by events", flush=True)
    return dict(ms=kernel_ms, device_ms=kernel_device_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None, shape=list(shape),
                kind=kind)


def time_prng_keys(key, n, rate):
    """Times of ``threefry_keys`` writing the decode's chain of ``n`` keys,
    against its plain version (host numpy, then the copy to the card)."""
    dev = torch.device("cuda")
    kernel_ms = cuda_ms(lambda: prng.decode_keys(key, n, dev))
    kernel_device_ms = device_ms(lambda: prng.decode_keys(key, n, dev), only="chain_kernel")
    plain_ms = cuda_ms(lambda: torch.from_numpy(
        prng.keys_reference(key, n, True).view(np.int32)).to(dev), runs=5)
    t_bytes = 8.0 * n / PEAK_BYTES_PER_S * 1e3
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    # the chain's latency: n dependent threefry2x32 (the throughput bound,
    # 2 x 73 operations a key over the card, is ~10,000 x less)
    t_ops = max(2.0 * THREEFRY_INT_OPS * n / rate,
                n * THREEFRY_DEPTH * INT_LATENCY_CLOCKS / clock_hz) * 1e3
    bound_ms, bound_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
    print(f"  time threefry_keys chain of {n}: kernel_ms {kernel_ms} device_ms "
          f"{kernel_device_ms} plain_ms {plain_ms} bound_ms {bound_ms} ({bound_by}: the "
          f"latency of {n} dependent threefry2x32, {THREEFRY_DEPTH} dependent integer "
          f"operations each at {INT_LATENCY_CLOCKS} clocks)", flush=True)
    return dict(ms=kernel_ms, device_ms=kernel_device_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None, keys=n)


def prng_per_request(engine, decode_steps: int, vq: bool = False):
    """Launches of one request: (threefry draws, key buffers, sample steps).
    The decode draws inside ``sample_step``, once a decode step, and makes
    no ``threefry_draw``; the draws are the vocoder's, and the diffusion's
    initial noise and under ``ancestral`` one normal a step but the last
    (which adds none); a key buffer for the decode's chain and one for the
    ancestral steps."""
    if vq:
        return 1, 1, decode_steps
    ancestral = engine.ecfg.diffusion_sampler == "ancestral"
    steps = engine.schedule.num_timesteps - 1 if ancestral else 0
    return 1 + steps + 1, 1 + ancestral, decode_steps


def zero_prng():
    for name in prng.LAUNCHES:
        prng.LAUNCHES[name] = 0
    sampling.LAUNCHES["sample_step"] = 0


def prng_counts():
    """(threefry draws, key buffers, sample steps) launched."""
    return (prng.LAUNCHES["threefry_draw"], prng.LAUNCHES["threefry_keys"],
            sampling.LAUNCHES["sample_step"])


class DecodeSteps:
    """While entered, counts the decode steps that each
    ``generate_speech_tokens`` call of the engines executed: max(lengths)
    over the request's rows (every row under force_full; under early stop
    the step at which the last row stopped, or all of them), over the data
    group where the call has one (its early stop waits for every rank)."""

    def __init__(self):
        self.steps = 0

    def __enter__(self):
        from detail_tts_tpu_torch.serving import pipeline
        self._orig = pipeline.generate_speech_tokens

        def counted(*args, **kwargs):
            from detail_tts_tpu_torch.parallel.mesh import all_reduce_max_host
            codes, lengths = self._orig(*args, **kwargs)
            n = int(lengths.max())
            if kwargs.get("group") is not None:
                n = all_reduce_max_host([n], kwargs["group"])[0]
            self.steps += n
            return codes, lengths

        pipeline.generate_speech_tokens = counted
        return self

    def __exit__(self, *exc):
        from detail_tts_tpu_torch.serving import pipeline
        pipeline.generate_speech_tokens = self._orig


# ------------------------------------------------------ the sample step

# Phase 3c's settings, (temperature, top_p, repetition_penalty,
# typical_mass): the engine's defaults, typical on beside them and alone,
# both filters off.
SAMPLE_SETTINGS = {"top-p": (0.8, 0.8, 2.0, 1.0), "top-p+typical": (0.8, 0.8, 2.0, 0.9),
                   "typical": (1.0, 1.0, 2.0, 0.9), "off": (1.0, 1.0, 1.0, 1.0)}
SAMPLE_SHAPES = [(1, 8194), (2, 8194), (8, 8194), (16, 8194), (1, 8193), (8, 8193),
                 (2, 1000), (16, 1000), (1, 16386), (8, 16386), (2, 12289), (1, 65536)]
# past the shared-memory path's 65536, on the wide path: one more; an odd V
# whose rows 1 and 2 start off every 16-byte boundary; V = 2^17 + 1, in two
# rows and in eight (two groups of G = 65 CTAs taking four rows each in
# turn); V in the millions (past the shared path's 23-bit count); and past
# the ~5.9 M tokens that the card's shared memory caches, where every pass
# re-reads the rest.  No configuration of the repo sends a V past 65,536:
# these are cases the kernel is held correct at.
WIDE_SAMPLE_SHAPES = [(1, 65537), (3, 65539), (2, 131073), (8, 131073), (1, 1048579),
                      (1, 4194305), (1, 8388609), (1, 16777217)]
# a wide row alone against the same row inside its batch (bit-identical):
# aligned and not, groups taking several rows, all cached and past the cache
WIDE_ALONE_SHAPES = [(3, 65539), (8, 131073), (3, 1048579), (3, 8388609)]
# A token may differ from the plain version's only in a row whose plain
# boundary mass (its cumulative probability nearest 1 - top_p, or the
# typical mass) lies within SAMPLE_NEAR of it: the kernel's sums run in
# another order.  Such rows must stay under SAMPLE_FLIPS of the rows.
SAMPLE_NEAR = 1e-5
SAMPLE_FLIPS = 1e-3


def boundary_margin(logits, seen, temperature, top_p, repetition_penalty, typical_mass):
    """(B,) distance of the plain version's cumulative masses from their
    thresholds, the least over typical filtering and top-p (inf where both
    are off)."""
    x = sampling.apply_temperature(sampling.apply_repetition_penalty(
        logits.float(), seen, repetition_penalty), temperature)
    margin = torch.full((x.shape[0],), math.inf, device=x.device)
    if typical_mass < 1.0:
        logp = torch.log_softmax(x, dim=-1)
        p = logp.exp()
        entropy = -torch.where(p > 0, p * logp, 0.0).sum(dim=-1, keepdim=True)
        order = torch.sort((-logp - entropy).abs(), dim=-1, stable=True)[1]
        cum = p.gather(-1, order).cumsum(dim=-1)
        margin = torch.minimum(margin, (cum - float(np.float32(typical_mass))).abs().amin(-1))
        x = sampling.apply_typical(x, typical_mass)
    if top_p < 1.0:
        cum = torch.softmax(torch.sort(x, dim=-1, stable=True)[0], dim=-1).cumsum(dim=-1)
        margin = torch.minimum(margin, (cum - float(np.float32(1.0 - top_p))).abs().amin(-1))
    return margin


def check_sample_step(logits, seen, codes, lengths, finished, step, key, setting,
                      offset=0, force_full=False, stop=8193):
    """The kernel against its plain version on copies of one step's inputs:
    returns (rows, rows whose tokens differ, those of them near the boundary,
    what failed or None, max |token - plain token|).  Where the tokens
    agree, codes, seen, lengths and finished must be bit-identical, and a
    second launch must repeat the first bit for bit."""
    t, top_p, pen, mass = setting
    kw = dict(temperature=t, top_p=top_p, repetition_penalty=pen, typical_mass=mass,
              stop_token=stop, force_full=force_full, offset=offset)
    state = (seen, codes, lengths, finished)
    mine = [x.clone() for x in state]
    again = [x.clone() for x in state]
    plain = [x.clone() for x in state]
    tok = sampling.sample_step(logits, *mine, step, key, **kw)
    tok2 = sampling.sample_step(logits, *again, step, key, **kw)
    ref = sampling.sample_step_reference(logits, *plain, step, key, **kw)
    torch.cuda.synchronize()
    same = tok == ref
    differ = (~same).nonzero().flatten().tolist()
    near = []
    if differ:
        margin = boundary_margin(logits, seen, t, top_p, pen, mass)
        near = [r for r in differ if margin[r].item() < SAMPLE_NEAR]
    problem = None
    if len(near) != len(differ):
        problem = f"rows {sorted(set(differ) - set(near))} differ away from the boundary"
    for name, a, b in zip(("seen", "codes", "lengths", "finished"), mine, plain):
        if not torch.equal(a[same], b[same]):
            problem = f"{name} differs where the tokens agree"
    if not torch.equal(tok, tok2) or not all(map(torch.equal, mine, again)):
        problem = "a repeated launch differs"
    if tok.dtype != torch.int64 or tok.shape != ref.shape:
        problem = f"tokens {tok.dtype} {tuple(tok.shape)}"
    return tok.shape[0], differ, near, problem, int((tok - ref).abs().max())


def sample_inputs(b, v, dtype, seed, case="random"):
    """One step's seeded inputs on the card: logits ~ 2 N(0, 1) in ``dtype``
    (``case``: "ties" rounds them to quarters, so values tie at the top-p
    boundary; "zeros" adds a -0.0 / +0.0 pair in every row; "one-finite"
    sets all but one logit of each row to -inf; "all-inf" every logit of
    every other row), seen ~1%, a third of the
    rows finished, codes and lengths mid-request, step 5 of a 200-step key
    chain."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, v), generator=g, device=dev) * 2.0
    if case == "ties":
        x = torch.round(x * 4.0) / 4.0
    elif case == "zeros":
        x[:, 3], x[:, 7] = -0.0, 0.0
    elif case == "one-finite":
        keep = torch.randint(0, v, (b,), generator=g, device=dev)
        x = torch.where(torch.arange(v, device=dev) == keep[:, None], x, -math.inf)
    elif case == "all-inf":
        x[::2] = -math.inf
    seen = torch.rand((b, v), generator=g, device=dev) < 0.01
    codes = torch.randint(0, v, (b, 200), generator=g, device=dev)
    lengths = torch.randint(0, 6, (b,), generator=g, device=dev)
    finished = torch.rand((b,), generator=g, device=dev) < 0.33
    keys = prng.decode_keys(seed, 200, dev)
    return x.to(dtype).contiguous(), seen, codes, lengths, finished, 5, keys[5]


def sample_bound_ms(b, v, dtype):
    """Least time of one step: logits and seen read once, the tokens, a
    codes column and the seen, lengths and finished entries written, over
    the card's memory rate (the operations, ~100 a token with its Gumbel,
    take less at 132 SMs)."""
    nbytes = b * v * (torch.finfo(dtype).bits // 8 + 1) + b * (8 + 8 + 1 + 8 + 1)
    return nbytes / PEAK_BYTES_PER_S * 1e3


def wide_shape(b, v):
    """The wide launch at (b, v) fp32: (G, the CTAs a row; the groups, rows
    in flight; the tokens a CTA caches in shared memory)."""
    out = [ctypes.c_int() for _ in range(3)]
    sampling._launch("sample_step_wide_shape", v, b, 1, *(ctypes.byref(o) for o in out))
    return tuple(o.value for o in out)


def check_wide_alone(b, v, dtype, seed, setting):
    """Each row of a (b, v) step launched alone, from its own offset, against
    the same row inside the batch: token and state bit-identical.  Returns
    what failed or None."""
    x, seen, codes, lengths, finished, step, key = sample_inputs(b, v, dtype, seed)
    t, top_p, pen, mass = setting
    kw = dict(temperature=t, top_p=top_p, repetition_penalty=pen, typical_mass=mass,
              stop_token=v - 1, force_full=False)
    batch = [a.clone() for a in (seen, codes, lengths, finished)]
    tok = sampling.sample_step(x, *batch, step, key, offset=0, **kw)
    for r in range(b):
        alone = [a[r:r + 1].clone() for a in (seen, codes, lengths, finished)]
        one = sampling.sample_step(x[r:r + 1].clone(), *alone, step, key, offset=r * v, **kw)
        torch.cuda.synchronize()
        if int(one) != int(tok[r]):
            return f"row {r}: token {int(one)} alone, {int(tok[r])} in the batch"
        for name, mine, theirs in zip(("seen", "codes", "lengths", "finished"), alone, batch):
            if not torch.equal(mine, theirs[r:r + 1]):
                return f"row {r}: {name} differs alone"
    return None


def time_sample_step(b, v, setting, label, against_plain):
    """CUDA-event and device times of the kernel and the floor (an empty
    kernel on the same grid: its launch-to-launch time back to back, and
    its device time); with
    ``against_plain``, the times and device launches of its plain version
    and of the parent's decode step too.  On the wide path (V > 65,536)
    also its G, groups and cached tokens a CTA, and the share of the bytes
    bound its device time reaches."""
    dev = torch.device("cuda")
    x, seen, codes, lengths, finished, step, key = sample_inputs(b, v, torch.float32, 77)
    t, top_p, pen, mass = setting
    kw = dict(temperature=t, top_p=top_p, repetition_penalty=pen, typical_mass=mass,
              stop_token=v - 1, force_full=True)
    cluster, threads = ctypes.c_int(), ctypes.c_int()
    sampling._library().sample_step_shape(ctypes.byref(cluster), ctypes.byref(threads))
    row = dict(shape=[b, v], setting=label, bound_ms=sample_bound_ms(b, v, torch.float32),
               bound_by="bytes", library_ms=None, cluster=cluster.value, threads=threads.value)
    row["ms"] = cuda_ms(lambda: sampling.sample_step(x, seen, codes, lengths, finished, step,
                                                     key, **kw))
    row["device_ms"] = device_ms(lambda: sampling.sample_step(
        x, seen, codes, lengths, finished, step, key, **kw), only="sample_step_kernel")
    if against_plain:
        for name, fn in (("plain", sampling.sample_step_reference),
                         ("chain", parent_chain_step)):
            row[f"{name}_ms"] = cuda_ms(lambda: fn(x, seen, codes, lengths, finished, step,
                                                   key, **kw), runs=5)
            row[f"{name}_device_ms"], row[f"{name}_launches"] = device_profile(
                lambda: fn(x, seen, codes, lengths, finished, step, key, **kw))
    runs = 200
    stream = torch.cuda.current_stream(dev).cuda_stream
    sampling._launch("sample_step_floor", b, stream)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        sampling._launch("sample_step_floor", b, stream)
    end.record()
    end.synchronize()
    row["floor_ms"] = start.elapsed_time(end) / runs
    row["floor_device_ms"] = device_ms(lambda: sampling._launch(
        "sample_step_floor", b, stream), only="empty_kernel")
    plain = (f"; plain version ms {row['plain_ms']} device_ms {row['plain_device_ms']} "
             f"launches {row['plain_launches']}; the parent's step (stock launches and the "
             f"threefry_draw kernel) ms {row['chain_ms']} device_ms "
             f"{row['chain_device_ms']} launches {row['chain_launches']}"
             if against_plain else "")
    grid = f"C {row['cluster']} x {row['threads']} threads"
    if v > 65536:
        row["wide_ctas"], row["wide_groups"], row["wide_cache"] = wide_shape(b, v)
        row["bound_share"] = (row["bound_ms"] / row["device_ms"] if row["device_ms"]
                              else None)
        grid = (f"wide: G {row['wide_ctas']} CTAs x {row['threads']} threads a row, "
                f"{row['wide_groups']} group(s), {row['wide_cache']} cached tokens a CTA; "
                f"device time at {row['bound_share']} of the bytes bound")
    print(f"  time sample_step {label} ({b}, {v}) fp32, {grid}: kernel_ms {row['ms']} "
          f"device_ms {row['device_ms']}{plain}; bound_ms "
          f"{row['bound_ms']} (bytes); floor_ms {row['floor_ms']} (an empty kernel on the "
          f"cluster grid, back to back; its device_ms {row['floor_device_ms']})", flush=True)
    return row


def parent_chain_step(logits, seen, codes, lengths, finished, step, key, *, temperature,
                      top_p, repetition_penalty, typical_mass, stop_token, force_full):
    """The decode step as the loop ran it before ``sample_step``: the
    warpers as stock launches (dividing by a Python number), the Gumbel draw
    of ``threefry_draw`` (a kernel), the argmax and seven bookkeeping
    launches.  Timed beside the kernel; nothing of the port calls it."""
    x = logits.float()
    if repetition_penalty != 1.0:
        x = torch.where(seen, torch.where(x > 0, x / repetition_penalty,
                                          x * repetition_penalty), x)
    if temperature != 1.0:
        x = x / temperature
    x = sampling.apply_top_p(sampling.apply_typical(x, typical_mass), top_p)
    tok = torch.argmax(prng.draw(key, x.shape, "gumbel") + x, dim=-1)
    tok = torch.where(finished, stop_token, tok)
    codes[:, step] = tok
    seen[torch.arange(tok.shape[0], device=tok.device), tok] = True
    lengths = torch.where(finished, lengths, lengths + 1)
    if not force_full:
        finished = finished | (tok == stop_token)
    return tok


def device_profile(fn, runs: int = 5):
    """(device ms, device launches) of one ``fn()``: the summed durations and
    the count of the kernels and copies that ``runs`` calls launch, from the
    profiler, over ``runs``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    return sum(spans) / runs / 1e3, len(spans) / runs


class SampleTally:
    """Rows compared in phase 3c, the rows whose tokens differ and those of
    them near the boundary."""

    def __init__(self):
        self.rows, self.differ, self.near, self.max_abs = 0, 0, 0, 0

    def add(self, what, result):
        rows, differ, near, problem, max_abs = result
        self.max_abs = max(self.max_abs, max_abs)
        self.rows += rows
        self.differ += len(differ)
        self.near += len(near)
        if differ:
            print(f"  {what}: tokens differ in rows {differ} (near the boundary {near})",
                  flush=True)
        if problem:
            fail(f"sample_step disagrees with its plain version: {what}: {problem}")

    def gate(self, what):
        print(f"  {what}: {self.rows} rows, tokens differ in {self.differ} (near the "
              f"boundary {self.near}; gate: all near it and under {SAMPLE_FLIPS:g} of the "
              f"rows)", flush=True)
        if self.differ and self.differ >= SAMPLE_FLIPS * self.rows:
            fail(f"sample_step: {self.differ} of {self.rows} rows differ near the boundary")


def phase_sample():
    """Phase 3c: ``sample_step`` against its plain version at the decode's
    shapes and settings and at odd ones; returns the tally and the timing
    rows."""
    print("== sample_step vs plain", flush=True)
    tally = SampleTally()
    cases = [(b, v, dtype, "random") for b, v in SAMPLE_SHAPES + WIDE_SAMPLE_SHAPES
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(8, 8194, torch.float32, c) for c in ("ties", "zeros", "one-finite", "all-inf")]
    cases += [(16, 1000, torch.bfloat16, c) for c in ("ties", "zeros", "one-finite",
                                                      "all-inf")]
    seed = 0
    for b, v, dtype, case in cases:
        for label, setting in SAMPLE_SETTINGS.items():
            for force_full, offset in ((False, 0), (True, 3 * v)):
                seed += 1
                inputs = sample_inputs(b, v, dtype, seed, case)
                tally.add(f"({b}, {v}) {str(dtype)[6:]} {case} {label} force_full "
                          f"{force_full} offset {offset}",
                          check_sample_step(*inputs, setting, offset=offset,
                                            force_full=force_full, stop=v - 1))
    tally.gate("synthetic steps")
    for b, v in WIDE_ALONE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for label, setting in SAMPLE_SETTINGS.items():
                seed += 1
                problem = check_wide_alone(b, v, dtype, seed, setting)
                if problem:
                    fail(f"sample_step ({b}, {v}) {str(dtype)[6:]} {label}: a wide row alone "
                         f"differs from the same row in the batch: {problem}")
        print(f"  ({b}, {v}): each row alone bit-identical to the row in the batch (bf16 and "
              f"fp32, {len(SAMPLE_SETTINGS)} settings)", flush=True)
    times = [time_sample_step(b, 8194, SAMPLE_SETTINGS[label], label, against_plain=b == 8)
             for label in ("top-p", "top-p+typical", "off") for b in (1, 2, 8, 16)]
    times += [time_sample_step(b, v, SAMPLE_SETTINGS["top-p"], "top-p", against_plain=False)
              for b, v in ((2, 12289), (8, 16386), (1, 65536))]
    times += [time_sample_step(b, v, SAMPLE_SETTINGS[label], label,
                               against_plain=label == "top-p")
              for b, v in WIDE_SAMPLE_SHAPES for label in ("top-p", "top-p+typical", "off")]
    return tally, times


class StepRecorder:
    """In place of ``models.gpt.sample_step`` while entered: keeps a copy
    of every decode step's inputs, then runs ``fn`` (the kernel's wrapper,
    or the plain version called by name)."""

    def __init__(self, fn=None):
        self.fn, self.steps = fn or sampling.sample_step, []

    def __enter__(self):
        from detail_tts_tpu_torch.models import gpt
        self._orig, gpt.sample_step = gpt.sample_step, self
        return self

    def __exit__(self, *exc):
        from detail_tts_tpu_torch.models import gpt
        gpt.sample_step = self._orig

    def __call__(self, logits, seen, codes, lengths, finished, step, key, **kw):
        self.steps.append((logits.clone(), seen.clone(), codes.clone(), lengths.clone(),
                           finished.clone(), step, key.clone(), kw))
        return self.fn(logits, seen, codes, lengths, finished, step, key, **kw)


def check_recorded_steps(recorder, what, tally):
    """Every recorded decode step through the kernel and its plain version."""
    for logits, seen, codes, lengths, finished, step, key, kw in recorder.steps:
        setting = (kw["temperature"], kw["top_p"], kw["repetition_penalty"],
                   kw["typical_mass"])
        tally.add(f"{what} step {step}", check_sample_step(
            logits, seen, codes, lengths, finished, step, key, setting, offset=kw["offset"],
            force_full=kw["force_full"], stop=kw["stop_token"]))


def phase_sample_decode(engine, cfg, texts, prompts, tally):
    """Phase 3c on real decode steps, after phase 4: a b8 decode of the
    phase's engine (bf16) recorded and every step held against the plain
    version; then an fp32 engine's b2 request decoded through the kernel and
    through ``sample_step_reference`` (called by name in
    ``generate_speech_tokens``): every code and length equal, unless the
    first step that differs is a row near the boundary."""
    from detail_tts_tpu_torch.serving.pipeline import EngineConfig, random_engine

    texts8 = [texts[i % len(texts)] for i in range(8)]
    prompts8 = [prompts[i % len(prompts)] for i in range(8)]
    zero_prng()
    with StepRecorder() as rec, DecodeSteps() as steps:
        pending = engine.dispatch_decode(texts8, prompts8, seed=5, force_full=True)
        torch.cuda.synchronize()
    n = engine.ecfg.max_generate_length
    if prng_counts() != (0, 1, n) or steps.steps != n:
        fail(f"the b8 decode: launches {prng_counts()} (draws, key buffers, sample steps), "
             f"expected (0, 1, {n}); executed steps {steps.steps}")
    check_recorded_steps(rec, "b8 bf16 decode", tally)
    print(f"  b8 bf16 decode of {n} steps: every step held against the plain version; "
          f"codes {tuple(pending.codes.shape)}", flush=True)

    fp32 = random_engine(cfg, seed=0, device="cuda", engine_cfg=EngineConfig(
        max_generate_length=n, compute_dtype=torch.float32, cache_dtype=torch.float32))
    runs = {}
    for name, fn in (("kernel", sampling.sample_step),
                     ("plain", sampling.sample_step_reference)):
        zero_prng()
        with StepRecorder(fn) as rec:
            pending = fp32.dispatch_decode(texts[:2], prompts[:2], seed=11)
            runs[name] = (pending.codes.cpu(), pending.lengths.cpu(), rec, prng_counts())
    (codes, lengths, rec, counts), (pcodes, plengths, _, pcounts) = runs["kernel"], runs["plain"]
    executed = int(lengths.max())
    if counts != (0, 1, executed) or pcounts != (0, 1, 0):
        fail(f"the fp32 decode: launches {counts} through the kernel (expected (0, 1, "
             f"{executed})), {pcounts} through the plain version")
    differ = (codes != pcodes).nonzero().tolist()
    if differ or not torch.equal(lengths, plengths):
        if not differ:
            fail("the fp32 decode: lengths differ with every code equal")
        first = min(s for _, s in differ)
        rows = sorted({r for r, s in differ if s == first})
        logits, seen, _, _, _, step, _, kw = rec.steps[first]
        margin = boundary_margin(logits, seen, kw["temperature"], kw["top_p"],
                                 kw["repetition_penalty"], kw["typical_mass"])
        near = [r for r in rows if margin[r].item() < SAMPLE_NEAR]
        print(f"  fp32 decode: codes first differ at step {first}, rows {rows} (near the "
              f"boundary {near})", flush=True)
        if near != rows:
            fail(f"the fp32 decode through the kernel differs from the plain version's at "
                 f"step {first}, rows {rows}, away from the boundary")
        tally.differ += len(rows)
        tally.near += len(rows)
    tally.rows += codes.shape[0] * executed
    print(f"  fp32 b2 decode through the kernel and through sample_step_reference: "
          f"{executed} steps, codes equal {not differ}, lengths {lengths.tolist()} / "
          f"{plengths.tolist()}", flush=True)
    del fp32
    torch.cuda.empty_cache()
    tally.gate("synthetic and decode steps")


# ------------------------------------------------------- training kernels

# Tolerances of the training kernels against their plain versions (the
# readings they were set from are in PERF.md).  out and d(qkv): the serving
# kernel's, d(qkv) relative to max(1, max |plain|) since it scales with the
# cotangent (bf16: P and dX are rounded to bf16 before the products).  lse:
# fp32 in both dtypes, from logits summed in another order.  dbias: relative
# to max |plain|; it is summed in fp32 from fp32 P and dX in both dtypes, and
# a dbias with one batch row's share lost must read above it.
LSE_TOL = DBIAS_TOL = 1e-4
RAW_BUCKETS_CHECKED = (512, 1024, 2824)
TRAIN_KERNELS = ("bias_attention_train_fwd", "bias_attention_bwd_dq_dbias",
                 "bias_attention_bwd_dkv", "bias_attention_bwd_dbias_sum")
# the forward's and the backward's wgmma kernels at the contextual embedder's
# d = 96, listed apart from their d = 48 instantiations
TRAIN_FWD_WGMMA_96 = "train_fwd_wgmma<96>"
BWD_WGMMA_96 = ("bwd_dq_wgmma<96>", "bwd_dkv_wgmma<96>")
# the bf16 forward's and backward's kernels by route (the entries above
# launch them)
ROUTE_KERNELS = ("train_fwd_wgmma", "train_fwd_mma", "bwd_dq_wgmma", "bwd_dkv_wgmma",
                 "bwd_dq_mma", "bwd_dkv_mma", TRAIN_FWD_WGMMA_96) + BWD_WGMMA_96


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


def check_bwd_route(b, t, d, dtype):
    """The C entry's backward route against ``attention.bias_attention_bwd_route``."""
    code = attention._library(attention.BWD_SOURCE).bias_attention_bwd_route(
        b, t, d, attention._DTYPE_CODE[dtype])
    route = attention.bias_attention_bwd_route(b, t, d, dtype)
    if code < 0 or attention.BWD_ROUTES[code] != route:
        fail(f"the C entry routes the backward at B={b} T={t} d={d} {dtype} to {code}, "
             f"the wrapper to {route}")
    return route


def check_train_kernels(b, t, h, d, dtype, seed, mask_row=False):
    """Each training kernel against its plain version at one shape, and the
    dbias gate against a known-wrong dbias; returns {kernel: (max abs err,
    scaled err)}: the forward's and the backward's under their route's
    kernels' names too (``kernel_name``: at d = 96 on the wgmma routes
    ``TRAIN_FWD_WGMMA_96`` and ``BWD_WGMMA_96``).  ``mask_row``: a fully
    masked query row and the last 9 keys of head 0 masked in every row,
    which must give exact zeros."""
    qkv, bias, dout = train_inputs(b, t, h, d, dtype, seed)
    if mask_row:
        bias[h - 1, t // 3, :] = -1e9
        bias[0, :, t - 9:] = -1e9
    sm = 1.0 / math.sqrt(d)
    route = check_bwd_route(b, t, d, dtype)
    fwd_route = train_fwd_info(b, t, h, d, dtype)["route"]
    before = attention.BWD_LAUNCHES_BY_ROUTE[route]
    before_dim = attention.BWD_LAUNCHES_BY_DIM.get((route, d), 0)
    fwd_before = attention.TRAIN_FWD_LAUNCHES_BY_ROUTE[fwd_route]
    fwd_before_dim = attention.TRAIN_FWD_LAUNCHES_BY_DIM.get((fwd_route, d), 0)
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
    print(f"  B={b} T={t} H={h} d={d} {str(dtype)[6:]}{' masked row' if mask_row else ''} "
          f"({fwd_route}, {route}): "
          + " ".join(f"{k} {e[0]:.2e}/{e[1]:.2e}" for k, e in errs.items())
          + f" {'ok' if ok else 'MISMATCH'}; dbias with a row lost {wrong:.2e}", flush=True)
    if (attention.BWD_LAUNCHES_BY_ROUTE[route] != before + 1
            or attention.BWD_LAUNCHES_BY_DIM[route, d] != before_dim + 1):
        fail(f"the backward at {(b, t, h, d, dtype)} was not counted once on {route} "
             f"at d = {d}")
    if (attention.TRAIN_FWD_LAUNCHES_BY_ROUTE[fwd_route] != fwd_before + 1
            or attention.TRAIN_FWD_LAUNCHES_BY_DIM[fwd_route, d] != fwd_before_dim + 1):
        fail(f"the forward at {(b, t, h, d, dtype)} was not counted once on {fwd_route} "
             f"at d = {d}")
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
        if torch.count_nonzero(g[:, t - 9:, 0, 1:]).item():
            fail("masked keys do not get exactly 0 in dk and dv")
        if not bool((lse[:, hh, r] == attention.MASKED_LSE).all()):
            fail("a fully masked row's lse is not MASKED_LSE")
    again = attention.bias_attention_train_fwd(qkv, bias, heads=h, sm_scale=sm)
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        fail(f"the forward at {(b, t, h, d, dtype)} is not bit-identical from run to run")
    dq_kernel, dkv_kernel = (BWD_WGMMA_96 if (route, d) == ("bwd_wgmma", 96)
                             else attention.BWD_ROUTE_KERNELS[route])
    return {"bias_attention_train_fwd": errs["out"], kernel_name(fwd_route, d): errs["out"],
            "bias_attention_bwd_dq_dbias": max(errs["dq"], errs["dbias"]),
            "bias_attention_bwd_dkv": errs["dkv"],
            "bias_attention_bwd_dbias_sum": check_dbias_sum(b, t, h, seed),
            dq_kernel: max(errs["dq"], errs["dbias"]), dkv_kernel: errs["dkv"]}


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
    route = check_bwd_route(b, t, d, torch.bfloat16)
    fwd_route = train_fwd_info(b, t, h, d)["route"]
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
        if name in ("bias_attention_bwd_dq_dbias", "bias_attention_bwd_dkv"):
            kernel = (BWD_WGMMA_96 if (route, d) == ("bwd_wgmma", 96)
                      else attention.BWD_ROUTE_KERNELS[route])[name.endswith("dkv")]
            rows[kernel] = dict(rows[name], bwd_route=route)
            name_shown = f"{name} ({kernel})"
        elif name == "bias_attention_train_fwd":
            rows[kernel_name(fwd_route, d)] = rows[name]
            name_shown = f"{name} ({kernel_name(fwd_route, d)})"
        else:
            name_shown = name
        print(f"  time B={b} T={t} H={h} d={d} bf16 {name_shown}: ms {ms[name]} "
              f"(device time {dev[name]}) bound_ms {bounds[name][0]} ({bounds[name][1]}) "
              f"-> {bounds[name][0] / ms[name]:.1%} of bound{share}", flush=True)
    rows["bias_attention_train_fwd"]["wrapper_ms"] = wrapper_ms
    print(f"  time bias_attention_train_fwd through its wrapper (checks, two "
          f"torch.empty, the ctypes call) {wrapper_ms} ms beside the bare launch "
          f"{ms['bias_attention_train_fwd']} ms", flush=True)
    print(f"  time sum pass: plain (batch-order adds) {plain_sum} ms, "
          f"torch.sum over the batch {lib_sum} ms", flush=True)
    bound_bwd = bounds["backward"]
    print(f"  time whole backward (bias_attention_bwd on {route}: delta, dq/partials, dk/dv, "
          f"sum) {bwd_ms} ms, bound_ms {bound_bwd[0]} ({bound_bwd[1]}) -> "
          f"{bound_bwd[0] / bwd_ms:.1%} of bound; SDPA ({backend}) backward {lib_bwd} ms "
          f"({lib_bwd / bwd_ms:.2f}x ours); kernel 4 + backward "
          f"{ms['bias_attention_train_fwd'] + bwd_ms} ms; plain forward {plain_fwd} ms + "
          f"backward {plain_bwd} ms; SDPA forward {lib_fwd} ms", flush=True)
    return rows, backend


def phase_train_kernels(sfu_per_s):
    """Training kernels vs plain versions; returns (worst errors, time rows)."""
    print("== train kernels vs plain", flush=True)
    worst = {name: (0.0, 0.0) for name in TRAIN_KERNELS + ROUTE_KERNELS}
    # B = 4: a rank's micro-batch of 8 over a world of 2 (phase 8)
    # (B, T, 16, 96): the contextual embedder at a 496-frame prompt (T = 124,
    # the wgmma routes) and at the 500-frame crop (T = 125, mma.sync), and at
    # the examples' batch 2
    cases = [(8, 496, 16, 48, torch.bfloat16), (8, 124, 16, 48, torch.bfloat16),
             (8, 124, 16, 96, torch.bfloat16), (4, 496, 16, 48, torch.bfloat16),
             (4, 124, 16, 48, torch.bfloat16), (4, 124, 16, 96, torch.bfloat16),
             (8, 125, 16, 96, torch.bfloat16), (2, 124, 16, 96, torch.bfloat16),
             (8, 495, 16, 48, torch.bfloat16),
             (4, 495, 16, 48, torch.float32), (8, 124, 16, 48, torch.float32),
             (8, 124, 16, 96, torch.float32)]
    for i, (b, t, h, d, dtype) in enumerate(cases):
        errs = check_train_kernels(b, t, h, d, dtype, seed=100 + i)
        if dtype == torch.bfloat16:
            worst = {k: max(worst[k], errs.get(k, (0.0, 0.0))) for k in worst}
    for dtype, t, d in ((torch.bfloat16, 495, 48), (torch.bfloat16, 496, 48),
                        (torch.float32, 495, 48), (torch.bfloat16, 124, 96),
                        (torch.bfloat16, 125, 96)):
        errs = check_train_kernels(3, t, 16, d, dtype, seed=99, mask_row=True)
        if dtype == torch.bfloat16:
            worst = {k: max(worst[k], errs.get(k, (0.0, 0.0))) for k in worst}
    # the data loader's raw buckets, where the diffusion trunk runs on a
    # corpus: the smallest, phase 7's and the largest (not a multiple of 64)
    for i, t in enumerate(RAW_BUCKETS_CHECKED):
        errs = check_train_kernels(8, t, 16, 48, torch.bfloat16, seed=200 + i)
        worst = {k: max(worst[k], errs.get(k, (0.0, 0.0))) for k in worst}
        torch.cuda.empty_cache()

    for b, t, h, d in ((8, 496, 16, 48), (8, 124, 16, 96)):
        qkv, bias, dout = train_inputs(b, t, h, d, torch.bfloat16, seed=5)
        out, lse = attention.bias_attention_train_fwd(qkv, bias, heads=h, sm_scale=0.1)
        first = attention.bias_attention_bwd(qkv, bias, out, lse, dout, heads=h, sm_scale=0.1)
        second = attention.bias_attention_bwd(qkv, bias, out, lse, dout, heads=h, sm_scale=0.1)
        same = [torch.equal(x, y) for x, y in zip(first, second)]
        print(f"  backward twice at B={b} T={t} H={h} d={d} "
              f"({attention.bias_attention_bwd_route(b, t, d, torch.bfloat16)}): dqkv "
              f"bit-identical {same[0]}, dbias bit-identical {same[1]}", flush=True)
        if not all(same):
            fail(f"the backward at {(b, t, h, d)} is not bit-identical from run to run")
    # the wgmma routes at the step's trunk, its latent conditioner and the
    # raw bucket 1024, and at the contextual embedder's d = 96 (T = 124,
    # where SDPA's backward is the yardstick); the mma.sync routes at the
    # contextual embedder's shape at the 500-frame crop (T = 125:
    # train_fwd_mma<96, 1> beside train_fwd_wgmma<96> at T = 124)
    rows, backend = time_train_kernels(8, 496, 16, 48, sfu_per_s)
    rows_124, _ = time_train_kernels(8, 124, 16, 48, sfu_per_s)
    rows_1024, _ = time_train_kernels(8, 1024, 16, 48, sfu_per_s)
    rows_96, _ = time_train_kernels(8, 124, 16, 96, sfu_per_s)
    rows_125, _ = time_train_kernels(8, 125, 16, 96, sfu_per_s)
    for name in TRAIN_KERNELS + ("train_fwd_wgmma", "bwd_dq_wgmma", "bwd_dkv_wgmma"):
        rows[name]["at_124"] = rows_124[name]
        rows[name]["at_raw_bucket_1024"] = rows_1024[name]
    rows.update({name: rows_96[name] for name in (TRAIN_FWD_WGMMA_96,) + BWD_WGMMA_96})
    rows.update({name: rows_125[name] for name in ("train_fwd_mma", "bwd_dq_mma",
                                                   "bwd_dkv_mma")})
    torch.cuda.empty_cache()
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


def embedder_call(diffusion, prompt_frames):
    """(T, head dim, launches) of the contextual embedder of ``diffusion``
    on a prompt mel of ``prompt_frames``: its attention blocks at twice the
    trunk's width after two stride-2 convolutions."""
    c = diffusion.cfg
    return (-(-(-(-prompt_frames // 2)) // 2), 2 * c.model_channels // c.num_heads,
            len(diffusion.contextual_embedder) - 2)


def b1_routes(calls, dtype):
    """[(T, head dim, launches)] by the serving kernel each launch takes
    (``attention.bias_attention_fwd_route``), keyed as ``route_counts`` keys
    them: by route, and by route and head dim."""
    routes = dict.fromkeys(attention.SERVE_ROUTES, 0)
    for t, dim, n in calls:
        route = attention.bias_attention_fwd_route(t, dim, dtype)
        routes[route] += n
        routes[f"{route}<{dim}>"] = routes.get(f"{route}<{dim}>", 0) + n
    return routes


def b1_routes_per_request(engine, code_bucket, prompt_bucket=None):
    """``b1_per_request`` by route (``b1_routes``): the integrator blocks and
    trunk layers each step at 4 x the code bucket and the latent conditioner
    at the code bucket (d = 48: serve_fwd_wgmma where T % 8 == 0), and with
    ``prompt_bucket`` the contextual embedder at d = 96 and a quarter of it
    (serve_fwd_wgmma where T % 8 == 0, which every prompt bucket gives)."""
    d = engine.cfg.diffusion
    hd = d.model_channels // d.num_heads
    diff = engine.model.diffusion
    calls = [(4 * code_bucket, hd, engine.schedule.num_timesteps * (
        len(diff.conditioning_timestep_integrator) + d.num_layers)),
             (code_bucket, hd, len(diff.latent_conditioner) - 1)]
    if prompt_bucket is not None:
        calls.append(embedder_call(diff, prompt_bucket))
    routes = b1_routes(calls, engine.cdt)
    if prompt_bucket is not None and sum(
            routes[r] for r in attention.SERVE_ROUTES) != b1_per_request(engine):
        fail(f"B1 routes {routes} do not add up to {b1_per_request(engine)} a request")
    return routes


def route_counts():
    """B1's launches by route, and by route and head dim as ``route<d>``."""
    return {**attention.LAUNCHES_BY_ROUTE,
            **{f"{r}<{d}>": n for (r, d), n in attention.LAUNCHES_BY_DIM.items()}}


def routes_since(before):
    """``route_counts`` since ``before``, without the head dims that took none."""
    return {k: v - before.get(k, 0) for k, v in route_counts().items()
            if k in attention.SERVE_ROUTES or v != before.get(k, 0)}


def zero_routes():
    """B1's launch counts, by route and by head dim, to 0."""
    attention.LAUNCHES = 0
    for name in attention.LAUNCHES_BY_ROUTE:
        attention.LAUNCHES_BY_ROUTE[name] = 0
    attention.LAUNCHES_BY_DIM.clear()


def request_buckets(engine, wavs):
    """(code bucket, prompt bucket) of a force_full request on ``engine``."""
    code_bucket = next(b for b in engine.ecfg.code_buckets
                       if b >= engine.ecfg.max_generate_length - 1)
    return code_bucket, engine.prepare_prompt(wavs)[0].shape[1]


def phase_serving(engine, requests):
    """Answer ``requests`` through synthesize_batch; check audio and launches
    (B1's and the threefry kernels', each counted from 0 before the first
    request).  Returns (B1 launches, B1 launches of each request, (wall,
    timings) per request, threefry launches (draws, key buffers), B1
    launches a request by route)."""
    print("== serving", flush=True)
    per_request = b1_per_request(engine)
    prng_want = prng_per_request(engine, engine.ecfg.max_generate_length)
    sr = engine.cfg.data.sampling_rate
    hop_per_code = engine.cfg.gpt.mel_length_compression
    outputs, counts, records = [], [], []
    zero_routes()  # read at the end of the run
    zero_prng()
    for texts, wavs, seed in requests:
        routes_want = b1_routes_per_request(engine, *request_buckets(engine, wavs))
        before, prng_before, routes_before = attention.LAUNCHES, prng_counts(), route_counts()
        timings = {}
        t0 = time.perf_counter()
        with DecodeSteps() as executed:
            outs = engine.synthesize_batch(texts, wavs, seed=seed, force_full=True,
                                           timings=timings)
        wall = time.perf_counter() - t0
        records.append((wall, timings))
        counts.append(attention.LAUNCHES - before)
        routes_got = routes_since(routes_before)
        prng_got = tuple(a - b for a, b in zip(prng_counts(), prng_before))
        audio_s = sum(len(o) for o in outs) / sr
        print(f"  request batch={len(texts)} seed={seed}: {audio_s:.2f} s of audio "
              f"in {wall:.3f} s wall ({audio_s / wall:.2f}x real time); "
              f"kernel launches {counts[-1]} (expected {per_request}), by route "
              f"{routes_got} (expected {routes_want}); threefry draws, "
              f"key buffers, sample steps {prng_got} (expected {prng_want}; decode steps "
              f"executed {executed.steps}); timings "
              + json.dumps({k: round(v, 4) for k, v in timings.items()}), flush=True)
        if executed.steps != prng_want[2]:
            fail(f"the decode executed {executed.steps} steps, expected {prng_want[2]}")
        eff = engine.ecfg.max_generate_length - 1
        for o in outs:
            if o.shape != (eff * hop_per_code,) or not np.all(np.isfinite(o)):
                fail(f"bad audio: shape {o.shape}, finite {np.all(np.isfinite(o))}")
        if counts[-1] != per_request or routes_got != routes_want:
            fail(f"{counts[-1]} kernel launches by route {routes_got}, expected "
                 f"{per_request} by route {routes_want}")
        if prng_got != prng_want:
            fail(f"threefry and sample step launches {prng_got}, expected {prng_want}")
        outputs.append(outs)
    if not all(np.array_equal(a, b) for a, b in zip(outputs[0], outputs[-1])):
        fail("the repeated request with the same seed gave different audio")
    launches, prng_launches = attention.LAUNCHES, prng_counts()
    # the first request's row 0 alone: the same draws (tests/test_torch_invariance.py
    # holds the audio at 5e-4 in fp32); read, not gated: bf16 rounds a batch of 1
    # otherwise than one of 2, and a code that flips makes another utterance
    texts, wavs, seed = requests[0]
    alone = engine.synthesize_batch(texts[:1], wavs[:1], seed=seed, force_full=True)[0]
    apart = float(np.abs(alone - outputs[0][0]).max() / np.abs(outputs[0][0]).max())
    print(f"  repeated request reproduced its audio; row 0 alone against its batch of "
          f"{len(texts)}: max |diff| / max |batched| {apart:.4g} (read); peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return launches, counts, records, prng_launches, routes_want


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
    """One force_full request, its B1, threefry and sample step launches
    counted from 0 (a sample step for each decode step it executed), B1's
    on the routes ``b1_routes_per_request`` gives (none on the VQ path);
    prints the wall time, audio seconds per wall second and the stage
    timings."""
    attention.LAUNCHES = 0
    zero_prng()
    routes_want = (dict.fromkeys(attention.SERVE_ROUTES, 0) if vq else
                   b1_routes_per_request(engine, *request_buckets(engine, wavs)))
    routes_before = route_counts()
    timings = {}
    t0 = time.perf_counter()
    with DecodeSteps() as executed:
        if vq:
            outs = engine.synthesize_vq_batch(texts, wavs, seed=seed, force_full=True)
        else:
            outs = engine.synthesize_batch(texts, wavs, seed=seed, force_full=True,
                                           timings=timings)
    wall = time.perf_counter() - t0
    routes_got = routes_since(routes_before)
    audio_s = sum(len(o) for o in outs) / engine.cfg.data.sampling_rate
    print(f"  {label} batch={len(texts)} seed={seed}: {audio_s:.2f} s of audio in "
          f"{wall:.3f} s wall ({audio_s / wall:.2f}x real time); kernel launches "
          f"{attention.LAUNCHES} by route {routes_got}; threefry draws, key buffers, sample "
          f"steps {prng_counts()} (decode steps executed {executed.steps}); timings "
          + json.dumps({k: round(v, 4) for k, v in timings.items()}), flush=True)
    if executed.steps != engine.ecfg.max_generate_length:
        fail(f"{label}: the decode executed {executed.steps} steps under force_full")
    if routes_got != routes_want:
        fail(f"{label}: B1 launches by route {routes_got}, expected {routes_want}")
    return outs, attention.LAUNCHES, wall, timings


def sample_steps_gate(what, executed):
    """One ``sample_step`` launch for each decode step executed."""
    got = sampling.LAUNCHES["sample_step"]
    print(f"  {what}: sample_step launches {got}, decode steps executed {executed.steps}",
          flush=True)
    if got != executed.steps:
        fail(f"{what}: {got} sample_step launches for {executed.steps} decode steps")


def phase_serving_paths(engine, texts, prompts, ancestral_records):
    """Phase 4b on ``engine``'s weights; returns the B1 launches of its paths
    and the threefry launches (draws, key buffers)."""
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
    prng_total = np.zeros(3, np.int64)
    # (a) each sampler twice at batch 2
    for sampler, steps in SAMPLER_RUNS:
        eng = variant(diffusion_sampler=sampler, diffusion_steps=steps)
        want = b1_per_request(eng)
        runs = []
        for _ in range(2):
            outs, launches, wall, timings = serve_request(eng, f"{sampler} {steps} steps",
                                                          pair, prompts2, seed=0)
            total += launches
            prng_total += np.array(prng_counts())
            check_audio(eng, outs, f"{sampler} at {steps} steps")
            if launches != want or want != steps * 13 + 9:
                fail(f"{sampler} at {steps} steps: {launches} kernel launches, expected "
                     f"{want} (steps x 13 + 9 = {steps * 13 + 9})")
            prng_want = prng_per_request(eng, eng.ecfg.max_generate_length)
            if prng_counts() != prng_want:
                fail(f"{sampler} at {steps} steps: threefry and sample step launches "
                     f"{prng_counts()}, "
                     f"expected {prng_want}")
            runs.append(outs)
        if not all(np.array_equal(a, b) for a, b in zip(*runs)):
            fail(f"{sampler} at {steps} steps: the repeated request gave different audio")
        diffuse_ms[(sampler, steps)] = timings["diffuse"] * 1e3
        walls[(sampler, steps)] = wall
        if (sampler, steps) == FAST_MODE:
            fast, fast_outs = eng, runs[0]
    # (a') the latent conditioner at code bucket 100, whose T % 8 != 0 keeps
    # serve_fwd_mma on the main path (phase 4's bucket 200 runs every call on
    # serve_fwd_wgmma)
    short = variant(max_generate_length=101, diffusion_sampler=FAST_MODE[0],
                    diffusion_steps=FAST_MODE[1])
    outs, launches, _, _ = serve_request(short, "code bucket 100, %s %d steps" % FAST_MODE,
                                         pair, prompts2, seed=0)
    total += launches
    prng_total += np.array(prng_counts())
    check_audio(short, outs, "code bucket 100")
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
    prng_total += np.array(prng_counts())
    check_audio(fast, outs, "pcm16", dtype=np.int16)
    if not all(np.array_equal(o, to_pcm16(torch.from_numpy(f)).numpy())
               for o, f in zip(outs, fast_outs)):
        fail("pcm16_output differs from the float output's clip, scale and round")
    print("  pcm16 output bit-identical to the float output's conversion", flush=True)

    # (c) the diffusion-free VQ path and the VQ round trip
    outs, launches, _, _ = serve_request(engine, "vq", pair, prompts2, seed=0, vq=True)
    total += launches
    prng_total += np.array(prng_counts())
    check_audio(engine, outs, "the VQ path")
    if launches != 0:
        fail(f"the VQ path launched the diffusion kernel {launches} times")
    prng_want = prng_per_request(engine, engine.ecfg.max_generate_length, vq=True)
    if prng_counts() != prng_want:
        fail(f"the VQ path: threefry and sample step launches {prng_counts()}, expected "
             f"{prng_want}")
    mel, mel_len = engine.prepare_prompt(prompts[:1])
    n = int(mel_len[0]) // 4 * 4
    attention.LAUNCHES = 0
    zero_prng()
    recon, wav = engine.vq_roundtrip(mel[:, :n])
    total += attention.LAUNCHES
    prng_total += np.array(prng_counts())
    if prng_counts()[2]:
        fail(f"vq_roundtrip launched sample_step {prng_counts()[2]} times")
    if (recon.shape != (1, n, mel.shape[2]) or wav.shape != (1, n * engine.cfg.data.hop_length, 1)
            or not (torch.isfinite(recon).all() and torch.isfinite(wav).all())):
        fail(f"vq_roundtrip: mel {tuple(recon.shape)}, wav {tuple(wav.shape)}, or not finite")
    print(f"  vq_roundtrip of a {n}-frame prompt mel: mel {tuple(recon.shape)}, wav "
          f"{tuple(wav.shape)}, finite", flush=True)

    # (d) the server: 4 concurrent requests, a refused sub-hop prompt; the
    # split dispatch against synthesize_batch
    attention.LAUNCHES = 0
    zero_prng()
    with DecodeSteps() as executed, TTSServer(engine, max_batch=4,
                                              max_wait_ms=200.0) as server:
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
    prng_total += np.array(prng_counts())
    for o in outs:
        if o.ndim != 1 or not len(o) or not np.all(np.isfinite(o)):
            fail(f"a server request gave bad audio: shape {o.shape}")
    audio_s = sum(len(o) for o in outs) / engine.cfg.data.sampling_rate
    print(f"  server, 4 concurrent requests: {audio_s:.2f} s of audio in {wall:.3f} s wall "
          f"({audio_s / wall:.2f}x real time), {server.batches_dispatched} batch(es), "
          f"kernel launches {attention.LAUNCHES}", flush=True)
    if server.requests_served != 4:
        fail(f"the server served {server.requests_served} requests, not 4")
    sample_steps_gate("the server", executed)
    attention.LAUNCHES = 0
    zero_prng()
    with DecodeSteps() as executed:
        split = fast.finalize_batch(fast.dispatch_batch(pair, prompts2, seed=0,
                                                        force_full=True))
    total += attention.LAUNCHES
    prng_total += np.array(prng_counts())
    sample_steps_gate("the split dispatch", executed)
    if not all(np.array_equal(a, b) for a, b in zip(split, fast_outs)):
        fail("dispatch_batch + finalize_batch differs from synthesize_batch")
    print("  dispatch_batch + finalize_batch bit-identical to synthesize_batch", flush=True)

    # (e) long form: the joined stream equals the one-shot result
    text = "今天天气很好。我们一起去公园散步吧！你好，欢迎使用语音合成。"
    attention.LAUNCHES = 0
    zero_prng()
    t0 = time.perf_counter()
    with DecodeSteps() as executed:
        whole = synthesize_long(fast, text, prompts[0], seed=3, batch_size=2)
        wall = time.perf_counter() - t0
        parts = list(synthesize_long_stream(fast, text, prompts[0], seed=3, batch_size=2))
    total += attention.LAUNCHES
    prng_total += np.array(prng_counts())
    sample_steps_gate("long form", executed)
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
    zero_prng()
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

    with DecodeSteps() as executed:  # the requests' decodes, on the server's thread
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
    prng_total += np.array(prng_counts())
    sample_steps_gate("HTTP", executed)
    print(f"  HTTP: /healthz {health}; /synthesize twice: "
          + "; ".join(f"{st} {ct}, {len(a) / engine.cfg.data.sampling_rate:.2f} s of audio "
                      f"in {w:.3f} s" for (st, ct, _, w), a in zip(answers, audio))
          + f"; sub-hop prompt {refused}; server thread stopped {not thread.is_alive()}",
          flush=True)
    if not (health.get("ok") and refused == 400 and not thread.is_alive() and all(
            st == 200 and ct == "audio/wav" and len(a) and np.all(np.isfinite(a))
            for (st, ct, _, _), a in zip(answers, audio))):
        fail("the HTTP endpoint did not answer as it should")
    return total, tuple(int(x) for x in prng_total)


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


def train_attention_shapes(cfg, batch, raw_frames, prompt_frames):
    """[(calls a micro-batch, (B, T, H, d))] of the diffusion's AttentionBlocks
    in a training micro-batch: the 3 integrator blocks and the trunk layers
    kept at the raw mel's frames (calls None: layer drop decides), the 4
    latent-conditioner blocks at the code length (a quarter of the raw
    frames), the 5 contextual-embedder blocks, twice as wide, at the prompt
    mel's frames after two stride-2 convolutions."""
    c = cfg.diffusion
    d = c.model_channels // c.num_heads
    ctx = -(-(-(-prompt_frames // 2)) // 2)
    return [(None, (batch, raw_frames, c.num_heads, d)),
            (4, (batch, raw_frames // 4, c.num_heads, d)),
            (5, (batch, ctx, c.num_heads, 2 * d))]


def expected_routes(cfg, layers_kept, batch, raw_frames, prompt_frames, route_of, routes):
    """Calls of each of ``routes`` in one step of bf16 micro-batches, as
    ``route_of(b, t, h, d)`` routes each AttentionBlock's shape."""
    n = cfg.diffusion.num_layers
    out = {route: 0 for route in routes}
    for keep in layers_kept:
        for calls, (b, t, h, d) in train_attention_shapes(cfg, batch, raw_frames,
                                                          prompt_frames):
            out[route_of(b, t, h, d)] += 3 + sum(keep[:n]) if calls is None else calls
    return out


def expected_train_fwd_routes(cfg, layers_kept, batch, raw_frames, prompt_frames, sms):
    """Forward calls of each route (``attention.TRAIN_FWD_ROUTES``) in one
    step on a card of ``sms`` SMs, as
    ``attention.bias_attention_train_fwd_route`` routes them."""
    return expected_routes(
        cfg, layers_kept, batch, raw_frames, prompt_frames,
        lambda b, t, h, d: attention.bias_attention_train_fwd_route(b, t, h, d, torch.bfloat16,
                                                                    sms),
        attention.TRAIN_FWD_ROUTES)


def expected_bwd_routes(cfg, layers_kept, batch, raw_frames, prompt_frames):
    """Backward calls of each route (``attention.BWD_ROUTES``) in one step,
    as ``attention.bias_attention_bwd_route`` routes them."""
    return expected_routes(
        cfg, layers_kept, batch, raw_frames, prompt_frames,
        lambda b, t, h, d: attention.bias_attention_bwd_route(b, t, d, torch.bfloat16),
        attention.BWD_ROUTES)


def expected_train_fwd_dims(cfg, layers_kept, batch, raw_frames, prompt_frames, sms):
    """Forward calls of each (route, head dim) in one step, as
    ``attention.TRAIN_FWD_LAUNCHES_BY_DIM`` counts them: the trunk's d and the
    contextual embedder's 2 d on each route."""
    d = cfg.diffusion.model_channels // cfg.diffusion.num_heads
    return expected_routes(
        cfg, layers_kept, batch, raw_frames, prompt_frames,
        lambda b, t, h, hd: (attention.bias_attention_train_fwd_route(
            b, t, h, hd, torch.bfloat16, sms), hd),
        [(route, x) for route in attention.TRAIN_FWD_ROUTES for x in (d, 2 * d)])


def expected_bwd_dims(cfg, layers_kept, batch, raw_frames, prompt_frames):
    """Backward calls of each (route, head dim) in one step, as
    ``attention.BWD_LAUNCHES_BY_DIM`` counts them: the trunk's d and the
    contextual embedder's 2 d on each route."""
    d = cfg.diffusion.model_channels // cfg.diffusion.num_heads
    return expected_routes(
        cfg, layers_kept, batch, raw_frames, prompt_frames,
        lambda b, t, h, hd: (attention.bias_attention_bwd_route(b, t, hd, torch.bfloat16), hd),
        [(route, x) for route in attention.BWD_ROUTES for x in (d, 2 * d)])


# the forward and backward calls of each route in phases 6, 6b and 7, and
# both by (route, head dim), each phase's counts set to 0 before it and added
# here after it (kernels line)
ROUTE_LAUNCHES = {route: 0 for route in attention.TRAIN_FWD_ROUTES + attention.BWD_ROUTES}
PHASE6_STEPS = "4 diff steps (phase 6: 3 of 8 x 496 frames x accum 16, 1 of 8 x 500 frames)"
TRAIN_LAUNCHES_OVER = (f"{PHASE6_STEPS}, 2 all steps (phase 6b), 6 diff steps from the corpus "
                       "in this process (phase 7)")


def route_counts_now():
    """The training forward's launches and the backward's calls by route,
    and both by (route, head dim)."""
    return {**attention.TRAIN_FWD_LAUNCHES_BY_ROUTE, **attention.BWD_LAUNCHES_BY_ROUTE,
            **attention.TRAIN_FWD_LAUNCHES_BY_DIM, **attention.BWD_LAUNCHES_BY_DIM}


def zero_train_counts():
    """Every training kernel's count and the forward's and backward's by
    route (and head dim) to 0."""
    for name in TRAIN_KERNELS:
        attention.TRAIN_LAUNCHES[name] = 0
    for counts in (attention.TRAIN_FWD_LAUNCHES_BY_ROUTE, attention.BWD_LAUNCHES_BY_ROUTE):
        for route in counts:
            counts[route] = 0
    attention.TRAIN_FWD_LAUNCHES_BY_DIM.clear()
    attention.BWD_LAUNCHES_BY_DIM.clear()


def train_counts():
    """The training kernels' launch counts and the routes'."""
    return {**attention.TRAIN_LAUNCHES, **route_counts_now()}


def add_train_routes():
    """This phase's forward and backward calls by route into
    ``ROUTE_LAUNCHES``."""
    for route, n in route_counts_now().items():
        ROUTE_LAUNCHES[route] = ROUTE_LAUNCHES.get(route, 0) + n


def check_step_routes(cfg, layers_kept, before, shape, what):
    """One bf16 step's forward and backward calls by route (and by head
    dim) against ``expected_train_fwd_routes``, ``expected_bwd_routes``,
    ``expected_train_fwd_dims`` and ``expected_bwd_dims`` at ``shape`` =
    (micro-batch, raw frames, prompt frames); returns them."""
    want = {**expected_train_fwd_routes(cfg, layers_kept, *shape, sm_count()),
            **expected_bwd_routes(cfg, layers_kept, *shape),
            **expected_train_fwd_dims(cfg, layers_kept, *shape, sm_count()),
            **expected_bwd_dims(cfg, layers_kept, *shape)}
    now = route_counts_now()
    got = {r: now.get(r, 0) - before.get(r, 0) for r in want}
    if got != want:
        fail(f"{what}: forward and backward calls by route {got}, expected {want}")
    return got


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


def phase_training(cfg_full, logs):
    """Target diff at full width through Trainer.train (metrics into
    ``logs``); returns launches."""
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
    trainer = Trainer(cfg, data, device="cuda", seed=0, logs_folder=logs)
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
    zero_train_counts()
    walls = []
    for _ in range(3):
        counts = train_counts()
        t0 = time.perf_counter()
        logged = trainer.train(max_steps=state.step + 1, log_every=1)
        walls.append(time.perf_counter() - t0)
        m = trainer.last_metrics
        want = expected_train_launches(cfg, m["layers_kept"])
        got = {k: attention.TRAIN_LAUNCHES[k] - counts[k] for k in TRAIN_KERNELS}
        routes = check_step_routes(cfg, m["layers_kept"], counts, (micro, frames, frames),
                                   f"step {state.step}")
        frames_s = accum * micro * frames / walls[-1]
        print(f"  step {state.step}: loss {logged['loss']:.6f} grad_norm "
              f"{logged['grad_norm']:.6f} wall {walls[-1]:.3f} s, {frames_s:.1f} mel "
              f"frames/s; launches {got} (expected {want} each); forward and backward calls "
              f"by route {routes}", flush=True)
        if not (math.isfinite(logged["loss"]) and math.isfinite(logged["grad_norm"])):
            fail("the loss or grad norm is not finite")
        if any(v != want for v in got.values()):
            fail(f"training kernel launches {got}, expected {want} each")
    # one step at the loader's other crop, 500 frames (micro-batch 8, accum
    # 1): the latent conditioner and the contextual embedder at T = 125
    # (T % 4 != 0) take the backward's mma.sync kernels, as such a batch from
    # a corpus does
    crop = 500
    trainer.data_iter = synthetic_batches(cfg, 1, micro, crop, text_len, generator=data_gen,
                                          device="cuda")
    counts = train_counts()
    t0 = time.perf_counter()
    logged = trainer.train(max_steps=state.step + 1, log_every=1)
    wall = time.perf_counter() - t0
    m = trainer.last_metrics
    want = expected_train_launches(cfg, m["layers_kept"])
    got = {k: attention.TRAIN_LAUNCHES[k] - counts[k] for k in TRAIN_KERNELS}
    routes = check_step_routes(cfg, m["layers_kept"], counts, (micro, crop, crop),
                               f"step {state.step} at {crop} frames")
    print(f"  step {state.step} at {crop} frames, accum 1: loss {logged['loss']:.6f} grad_norm "
          f"{logged['grad_norm']:.6f} wall {wall:.3f} s; launches {got} (expected {want} "
          f"each); forward and backward calls by route {routes}", flush=True)
    if not (math.isfinite(logged["loss"]) and math.isfinite(logged["grad_norm"])):
        fail(f"the loss or grad norm at {crop} frames is not finite")
    if any(v != want for v in got.values()):
        fail(f"training kernel launches at {crop} frames {got}, expected {want} each")
    trainer.data_iter = data
    launches = dict(attention.TRAIN_LAUNCHES)
    add_train_routes()
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


def train_target(cfg_full, target, logs):
    """Phase 6b for one target (metrics into ``logs``); returns the training
    kernels' launches."""
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
    trainer = Trainer(cfg, data, device="cuda", seed=0, logs_folder=os.path.join(logs, target))
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
    zero_train_counts()
    walls = []
    for _ in range(2):
        counts = train_counts()
        t0 = time.perf_counter()
        logged = trainer.train(max_steps=state.step + 1, log_every=1)
        walls.append(time.perf_counter() - t0)
        m = trainer.last_metrics
        want = expected_train_launches(cfg, m["layers_kept"]) if target == "all" else 0
        got = {k: attention.TRAIN_LAUNCHES[k] - counts[k] for k in TRAIN_KERNELS}
        routes = check_step_routes(cfg, m["layers_kept"] if target == "all" else [], counts,
                                   (micro, frames, frames), f"{target} step {state.step}")
        scalars = {k: v for k, v in logged.items() if k != "steps_per_sec"}
        print(f"  {target} step {state.step}: wall {walls[-1]:.3f} s, "
              f"{accum * micro * frames / walls[-1]:.1f} mel frames/s; "
              + ", ".join(f"{k} {v:.6g}" for k, v in scalars.items())
              + f"; training-kernel launches {got} (expected {want} each), forward and "
              f"backward calls by route {routes}", flush=True)
        if not all(math.isfinite(v) for v in scalars.values()):
            fail(f"{target}: a loss or grad norm is not finite: {scalars}")
        if any(v != want for v in got.values()):
            fail(f"{target}: training kernel launches {got}, expected {want} each")
    if attention.LAUNCHES != 0:
        fail(f"{target}: the step launched the serving kernel {attention.LAUNCHES} times")
    launches = dict(attention.TRAIN_LAUNCHES)
    add_train_routes()
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


def phase_train_targets(cfg_full, logs):
    """Phase 6b: every other training target; returns the training kernels'
    launches (all of them under ``all``)."""
    print("== training targets", flush=True)
    print(f"  cudnn.benchmark {torch.backends.cudnn.benchmark}; each step runs with "
          "cudnn.deterministic on", flush=True)
    total = {name: 0 for name in TRAIN_KERNELS}
    for target in TRAIN_TARGETS:
        for name, n in train_target(cfg_full, target, logs).items():
            total[name] += n
    return total


# ------------------------------------------------- from a corpus on disk

SENTENCES = ("今天天气很好，我们一起去公园散步吧。", "你好，欢迎使用语音合成。", "这是第二个请求。",
             "春天来了，花都开了。", "请把窗户打开，屋里太热了。", "他每天早上六点起床跑步。",
             "这本书我已经看了三遍。", "明天下午三点在会议室开会。", "我们需要更多的时间来完成这个项目。",
             "小猫在沙发上睡着了。", "火车马上就要开了，快一点！", "谢谢你的帮助，我非常感激。")
CORPUS_RATES = (24000, 44100, 16000)
# Phase 7's depth, cut to keep the script inside its time limit: clips of
# 1-10 s in the corpus (160 before), and micro-batches a training step (the
# 16 of Config(), which phase 6 runs).  Every check of the phase runs at it.
CORPUS_CLIPS = 64
CORPUS_ACCUM = 4
TIE_REL = 1e-5  # two codebook distances this close: a tie the card's arithmetic decided


def speech_like(rng, sr, secs):
    """Bursts of amplitude-modulated noise and harmonics of a drifting pitch,
    separated by short silences (under the VAD's 0.5 s)."""
    n = int(secs * sr)
    out = np.zeros(n, np.float32)
    pos = 0
    while pos < n:
        burst = int(rng.uniform(0.4, 1.6) * sr)
        t = np.arange(min(burst, n - pos)) / sr
        f0 = rng.uniform(90, 260) * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        voice = sum(np.sin(k * phase) / k for k in range(1, 6))
        env = np.sin(np.pi * t / max(t[-1], 1e-3)) * (0.6 + 0.4 * np.sin(2 * np.pi * 4 * t))
        out[pos:pos + len(t)] = 0.25 * env * (voice + 0.1 * rng.standard_normal(len(t)))
        pos += burst + int(rng.uniform(0.05, 0.3) * sr)
    return out


def make_corpus(root, rng):
    """CORPUS_CLIPS clips of 1-10 s at 24, 44.1 and 16 kHz, two outside the duration
    filter, and two long recordings cut by ``prepare_cli vad``; a transcript
    table of them all through ``prepare_cli transcripts``.  Returns the jsonl
    path and the clips' count and seconds."""
    from detail_tts_tpu_torch.data import prepare_cli
    from detail_tts_tpu_torch.data.dataset import save_wav
    clips, raw = root / "clips", root / "raw"
    clips.mkdir()
    raw.mkdir()
    names, secs = [], 0.0
    for i in range(CORPUS_CLIPS):
        sr = CORPUS_RATES[i % 3]
        d = float(rng.uniform(1.0, 10.0))
        save_wav(str(clips / f"c{i:03d}.wav"), speech_like(rng, sr, d), sr)
        names.append(f"c{i:03d}.wav")
        secs += d
    for name, d in (("short.wav", 0.5), ("long.wav", 31.0)):  # outside 0.69-30.1 s
        save_wav(str(clips / name), speech_like(rng, 24000, d), 24000)
        names.append(name)
    for k in range(2):  # bursts of 2-6 s between 0.8-1.2 s of silence
        parts = []
        for _ in range(4):
            parts += [np.zeros(int(rng.uniform(0.8, 1.2) * 24000), np.float32),
                      speech_like(rng, 24000, rng.uniform(2.0, 6.0))]
        save_wav(str(raw / f"rec{k}.wav"), np.concatenate(parts), 24000)
    prepare_cli.main(["vad", "--in-dir", str(raw), "--out-dir", str(clips), "--workers", "1"])
    vad = sorted(n for n in os.listdir(clips) if n.startswith("rec"))
    if len(vad) < 6:
        fail(f"prepare_cli vad cut the two recordings into {len(vad)} clips, expected 8")
    table = root / "meta.tsv"
    table.write_text("".join(f"{n}\t{SENTENCES[i % len(SENTENCES)]}\n"
                             for i, n in enumerate(names + vad)))
    jsonl = root / "data.jsonl"
    prepare_cli.main(["transcripts", "--table", str(table), "--jsonl", str(jsonl),
                      "--clips-dir", str(clips)])
    rows = [json.loads(x) for x in jsonl.read_text().splitlines()]
    if len(rows) != len(names) + len(vad):
        fail(f"data.jsonl has {len(rows)} rows, expected {len(names) + len(vad)}")
    print(f"  corpus: {len(names)} clips ({secs:.1f} s in the {CORPUS_CLIPS} of 1-10 s at "
          f"{'/'.join(map(str, CORPUS_RATES))} Hz, two outside the filter) and {len(vad)} "
          f"clips cut by prepare_cli vad from 2 recordings; {len(rows)} jsonl rows", flush=True)
    return jsonl, clips


def check_native_decode(clips):
    import scipy.signal as sps
    from scipy.io import wavfile

    from detail_tts_tpu_torch.native import library_path, load_library, load_wav_native
    if load_library() is None:
        fail("the native WAV decoder did not build or load")
    path = clips / "c001.wav"  # 44.1 kHz
    sr, pcm = wavfile.read(str(path))
    got = load_wav_native(str(path), 24000)
    ref = sps.resample_poly(pcm.astype(np.float64) / 32768.0, 80, 147)
    err = float(np.abs(got[100:-100] - ref[100:-100]).max())
    print(f"  native decoder {library_path().name} loaded; {sr} Hz clip -> 24 kHz: "
          f"{len(got)} samples (scipy {len(ref)}), interior max_abs_err {err:.2e} (tol 5e-4)",
          flush=True)
    if sr != 44100 or len(got) != len(ref) or not err <= 5e-4:
        fail("the native resampler disagrees with scipy.signal.resample_poly")


def run_cli(args, timeout):
    """``python -m <args>`` from the repository's root; fails on a non-zero
    exit, printing the end of its output."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=os.path.dirname(
        os.path.abspath(__file__)), capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    tail = "\n".join((proc.stdout + proc.stderr).strip().splitlines()[-12:])
    print(f"  python -m {' '.join(args[:1])} exited {proc.returncode} in {wall:.1f} s; its "
          f"output ends:\n    " + tail.replace("\n", "\n    "), flush=True)
    if proc.returncode != 0:
        fail(f"python -m {args[0]} exited {proc.returncode}")
    return wall


def check_wav(path, sr=None):
    """A wav's seconds; it must be non-empty, finite and (given ``sr``) at
    that rate."""
    from scipy.io import wavfile
    if not path.is_file():
        fail(f"{path.name} was not written")
    rate, wav = wavfile.read(str(path))
    if not (len(wav) and np.all(np.isfinite(wav.astype(np.float32)))) or sr not in (None, rate):
        fail(f"{path.name}: {len(wav)} samples at {rate} Hz, or not finite")
    return len(wav) / rate


class TimedIterator:
    """An iterator whose ``__next__`` waits are recorded in ``waits``."""

    def __init__(self, it):
        self.it, self.waits = it, []

    def __next__(self):
        t0 = time.perf_counter()
        batch = next(self.it)
        self.waits.append(time.perf_counter() - t0)
        return batch


def step_breakdown(trainer, step_ms):
    """Two more steps of ``trainer``: one with the stage walls (each stage
    ends in a synchronisation), one traced; prints each stage's wall, busy
    and idle, the busy time, launches and idle share of the step against
    the untraced ``step_ms``, and the kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from profile_port import OWN_KERNELS, TRAIN_STAGES, split_by_stage, union_us
    batches = [trainer.next_batch() for _ in range(2)]
    wall = {}
    trainer.step_fn(trainer.state, batches[0], trainer.generator, timings=wall)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.step_fn(trainer.state, batches[1], trainer.generator, timings={})
        torch.cuda.synchronize()
    rows, device = split_by_stage(prof, tuple(k for k in TRAIN_STAGES if k in wall), wall)
    busy_ms = union_us([(e.time_range.start, e.time_range.end) for e in device]) / 1e3
    print(f"  stages of one step (wall from a step with synchronised stages, busy from a "
          f"traced one): " + "; ".join(
              f"{k} {r['wall_ms']:.1f} / {r['busy_ms']:.1f} ms, idle {r['idle_share']:.3f}"
              for k, r in rows.items())
          + f"; device busy {busy_ms:.1f} ms, {len(device)} device launches, idle share "
          f"against the untraced step {step_ms:.1f} ms: {1 - busy_ms / step_ms:.3f}", flush=True)
    per_kernel = {}
    for e in device:
        n, ms = per_kernel.get(e.name, (0, 0.0))
        per_kernel[e.name] = (n + 1, ms + (e.time_range.end - e.time_range.start) / 1e3)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])
    own = [kv for kv in top if any(f in kv[0] for f in OWN_KERNELS)]
    print("  top device time (ms, launches): " + "; ".join(
        f"{name[:60]} {ms:.1f}, {n}" for name, (n, ms) in top[:8]), flush=True)
    print("  the port's kernels in the step (ms, launches): " + "; ".join(
        f"{name[:60]} {ms:.2f}, {n}" for name, (n, ms) in own), flush=True)


def moments_equal(a, b):
    """Every AdamW moment of two trainers' states, by parameter name:
    (number compared, names that differ)."""
    na = {id(p): n for n, p in a.model.named_parameters()}
    nb = {n: p for n, p in b.model.named_parameters()}
    count, differ = 0, []
    for p, st in a.optimizer.state.items():
        other = b.optimizer.state[nb[na[id(p)]]]
        for k, v in st.items():
            count += 1
            if not torch.equal(v, other[k]):
                differ.append(f"{na[id(p)]}.{k}")
    return count, differ


def diff_step_launched(cfg, metrics, counts, what, batch):
    """One ``diff`` step's launches of each training kernel, and its forward
    and backward calls by route at ``batch``'s shapes, against the expected;
    returns the former."""
    want = expected_train_launches(cfg, metrics["layers_kept"])
    got = {k: attention.TRAIN_LAUNCHES[k] - counts[k] for k in TRAIN_KERNELS}
    if any(v != want for v in got.values()):
        fail(f"{what}: training kernel launches {got}, expected {want} each")
    shape = (batch["raw_mel"].shape[1], batch["raw_mel"].shape[2], batch["mel"].shape[2])
    routes = check_step_routes(cfg, metrics["layers_kept"], counts, shape, what)
    print(f"  {what}: forward and backward calls by route {routes} at (micro-batch, raw, "
          f"prompt frames) {shape}", flush=True)
    return want


def resume_in_process(cfg, cfg_path, jsonl, root):
    """Trainer A on the corpus (one decode thread) takes 2 steps and saves;
    its step 3 on batch X against Trainer R restored from A's checkpoint,
    from the same generator state."""
    from detail_tts_tpu_torch.train.trainer import Trainer
    a = Trainer(str(cfg_path), device="cuda", seed=0, logs_folder=str(root / "a"))
    a.default_data(str(jsonl), num_threads=1)
    loader = a.data_iter
    a.data_iter = TimedIterator(loader)
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        logged = a.train(max_steps=a.state.step + 1, log_every=1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        print(f"  A step {a.state.step}: loss {logged['loss']:.6f} grad_norm "
              f"{logged['grad_norm']:.6f}; wall {walls[-1]:.3f} s, of which "
              f"{a.data_iter.waits[-1]:.3f} s waiting for the batch", flush=True)
    if not (root / "a" / "ckpt" / "2").is_dir():
        fail("trainer A saved no checkpoint at step 2")
    x = a.next_batch()
    t_raw = x["raw_mel"].shape[2]
    true_frames = int(x["raw_spec_length"].sum())
    padded = x["raw_mel"].shape[0] * x["raw_mel"].shape[1] * t_raw
    gen_state = a.generator.get_state()
    torch.cuda.reset_peak_memory_stats()
    counts = train_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = a.step_fn(a.state, x, a.generator)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_step = diff_step_launched(cfg, want, counts, "A step 3", x)
    print(f"  batch X: raw bucket T = {t_raw} (crop T = {x['mel'].shape[2]}), "
          f"{x['raw_mel'].shape[0]} x {x['raw_mel'].shape[1]} clips, {true_frames} true of "
          f"{padded} padded frames; A step 3: wall {wall:.3f} s, {padded / wall:.1f} padded / "
          f"{true_frames / wall:.1f} true mel frames/s, peak device memory {peak:.2f} GiB, "
          f"{per_step} launches of each training kernel", flush=True)
    if t_raw != 1024:
        fail(f"the corpus's raw bucket is {t_raw}, expected 1024")

    r = Trainer(str(cfg_path), device="cuda", seed=1, logs_folder=str(root / "r"))
    t0 = time.perf_counter()
    r.load(str(root / "a" / "ckpt"))
    load_s = time.perf_counter() - t0
    if r.state.step != 2:
        fail(f"trainer R restored step {r.state.step}, expected 2")
    r.generator.set_state(gen_state)
    counts = train_counts()
    got = r.step_fn(r.state, x, r.generator)
    diff_step_launched(cfg, got, counts, "R step 3", x)
    same = {k: torch.equal(got[k], want[k]) for k in ("loss", "grad_norm")}
    pa = dict(a.state.model.named_parameters())
    differ = [n for n, p in r.state.model.named_parameters()
              if p.requires_grad and not torch.equal(p, pa[n])]
    n_trainable = sum(p.requires_grad for p in pa.values())
    n_moments, moments_differ = moments_equal(a.state, r.state)
    print(f"  R restored ckpt/2 and took step 3 on X: loss {got['loss'].item():.9f} / "
          f"{want['loss'].item():.9f}, bit-identical {same}; {n_trainable - len(differ)} of "
          f"{n_trainable} trainable tensors and {n_moments - len(moments_differ)} of "
          f"{n_moments} AdamW state tensors bit-identical", flush=True)
    if not all(same.values()) or differ or moments_differ:
        fail(f"resume is not bit-identical: {same}, {differ[:3]}, {moments_differ[:3]}")
    del r
    torch.cuda.empty_cache()

    step_breakdown(a, wall * 1e3)
    print(f"  waits for batches (s): {[round(w, 3) for w in a.data_iter.waits]}", flush=True)
    # The dump prints its failures and raises none: check that it wrote its
    # files (step 2's dump wrote the same milestone's, so those go first).
    dumps = [root / "a" / f"{kind}-{a.state.step // cfg.train.save_freq}.wav"
             for kind in ("sample", "gt")]
    for p in dumps:
        p.unlink(missing_ok=True)
    t0 = time.perf_counter()
    a._eval_dump(x)
    eval_s = time.perf_counter() - t0
    for p in dumps:
        check_wav(p)
    t0 = time.perf_counter()
    a.save()
    save_s = time.perf_counter() - t0
    size = (root / "a" / "ckpt" / str(a.state.step) / "state.pt").stat().st_size
    print(f"  eval dump (infer_flowvae at T = {t_raw}, two wavs) {eval_s:.3f} s; checkpoint of "
          f"{size / 2**30:.2f} GiB: save {save_s:.3f} s, R's restore {load_s:.3f} s", flush=True)
    a.data_iter = loader
    a.close()
    del a
    torch.cuda.empty_cache()


def check_extract_vq(cfg, cfg_path, jsonl, ckpt_dir):
    """``prepare_cli extract-vq`` in a subprocess, then four files against an
    exact-length ``encode_masked`` run here."""
    from detail_tts_tpu_torch.audio.mel import MelFrontend
    from detail_tts_tpu_torch.data.dataset import read_wav
    from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
    from detail_tts_tpu_torch.train.checkpoint import restore_variables
    run_cli(["detail_tts_tpu_torch.data.prepare_cli", "extract-vq", "--jsonl", str(jsonl),
             "--ckpt", str(ckpt_dir), "--config", str(cfg_path)], timeout=600)
    rows = [json.loads(x) for x in jsonl.read_text().splitlines()]
    hop, sr = cfg.data.hop_length, cfg.data.sampling_rate
    lengths = {}
    for row in rows:
        n = len(read_wav(row["path"], sr)) // hop // 4 * 4
        path = row["path"] + ".vq.npy"
        if not os.path.isfile(path) or np.load(path).shape != (n // 4,):
            fail(f"{path}: missing or not {n // 4} codes")
        lengths[row["path"]] = n
    with torch.device("cuda"):
        model = SynthesizerTrn(cfg)
    model.load_state_dict(restore_variables(ckpt_dir, cfg))
    model.eval().requires_grad_(False)
    d = cfg.data
    fe = MelFrontend(d.sampling_rate, d.filter_length, hop, d.win_length, d.n_mel_channels,
                     d.mel_fmin, d.mel_fmax, device="cuda")
    layer = model.quantizer.vq.layers[0]
    embed = layer._codebook.embed.float()
    picked = [r["path"] for r in rows[::len(rows) // 4]][:4]
    ties = []
    with torch.no_grad():
        for path in picked:
            n = lengths[path]
            mel = fe.mel_spectrogram(torch.from_numpy(read_wav(path, sr)).cuda()[None])[:, :n]
            exact = model.encode_masked(mel, torch.tensor([n], device="cuda"))[0][0].cpu().numpy()
            saved = np.load(path + ".vq.npy")
            z = layer.project_in(model.vq_encode_features(mel))[0].float()
            for j in np.flatnonzero(saved != exact):
                da = float((z[j] - embed[saved[j]]).square().sum())
                db = float((z[j] - embed[exact[j]]).square().sum())
                gap = abs(da - db) / max(da, db)
                print(f"  {os.path.basename(path)} code {j}: bucketed {saved[j]} (distance {da}) "
                      f"vs exact-length {exact[j]} (distance {db}), relative gap {gap:.2e}",
                      flush=True)
                if not gap < TIE_REL:
                    fail(f"{path}: code {j} differs from an exact-length run by more than a tie")
                ties.append(gap)
    print(f"  extract-vq: {len(rows)} rows with n_frames // 4 codes; {len(picked)} files "
          f"against exact-length encode_masked: {len(ties)} codes differ, all ties "
          f"(relative gap < {TIE_REL:.0e})", flush=True)
    del model
    torch.cuda.empty_cache()


def serve_from_checkpoint(cfg_path, ckpt_dir, clips):
    """``build_engine`` over the trainer's checkpoint; one request at batch 1
    with a prepared clip as the prompt.  Returns the B1 launches."""
    from detail_tts_tpu_torch.data.dataset import read_wav
    from detail_tts_tpu_torch.serving.api import build_engine
    from detail_tts_tpu_torch.serving.pipeline import EngineConfig
    engine = build_engine(str(cfg_path), str(ckpt_dir), engine_cfg=EngineConfig(
        max_generate_length=200), device="cuda")
    unfolded = [k for k in engine.model.state_dict() if k.endswith(("weight_g", "weight_v"))]
    if unfolded:
        fail(f"the served model kept weight-norm pairs: {unfolded[:3]}")
    prompt_path = sorted(p for p in os.listdir(clips) if p.startswith("rec"))[0]
    prompt = read_wav(str(clips / prompt_path), engine.cfg.data.sampling_rate)
    outs, launches, wall, _ = serve_request(engine, "from the trained checkpoint",
                                            SENTENCES[3:4], [prompt], seed=0)
    check_audio(engine, outs, "serving from the trained checkpoint")
    want = b1_per_request(engine)
    steps = engine.schedule.num_timesteps
    print(f"  served {prompt_path} ({len(prompt) / 24000:.2f} s) as the prompt: weight norm "
          f"folded on load; B1 launches {launches} (steps x 13 + 9 = {steps * 13 + 9})",
          flush=True)
    if launches != want or want != steps * 13 + 9:
        fail(f"serving from the checkpoint launched B1 {launches} times, expected {want}")
    del engine
    torch.cuda.empty_cache()
    return launches


def phase_corpus(cfg_full, root):
    """Phase 7: a corpus on disk through the data-prep CLI, the training CLI,
    resume, extract-vq and serving.  Returns (training-kernel launches of the
    in-process steps, B1 launches)."""
    import dataclasses
    import pathlib
    print("== from a corpus on disk", flush=True)
    root = pathlib.Path(root)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg_full, train=dataclasses.replace(
        cfg_full.train, target="diff", save_freq=2, val_freq=2,
        gradient_accumulate_every=CORPUS_ACCUM))
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    jsonl, clips = make_corpus(root, np.random.default_rng(7))
    check_native_decode(clips)

    cli = root / "cli"
    run_cli(["detail_tts_tpu_torch.train", "--config", str(cfg_path), "--data", str(jsonl),
             "--steps", "2", "--logs-folder", str(cli), "--num-workers", "8"], timeout=900)
    lines = [json.loads(x) for x in (cli / "metrics.jsonl").read_text().splitlines()]
    last = lines[-1] if lines else {}
    if not (last.get("step") == 2 and math.isfinite(last.get("loss", math.nan))
            and math.isfinite(last.get("grad_norm", math.nan))):
        fail(f"the training CLI's metrics.jsonl ends with {last}")
    if not (cli / "ckpt" / "2" / "state.pt").is_file():
        fail("the training CLI wrote no ckpt/2")
    secs = [check_wav(cli / f"{kind}-1.wav") for kind in ("sample", "gt")]
    print(f"  training CLI: metrics.jsonl step 2 loss {last['loss']:.6f} grad_norm "
          f"{last['grad_norm']:.6f} ({last['steps_per_sec']:.3f} steps/s); ckpt/2; "
          f"sample-1.wav {secs[0]:.2f} s and gt-1.wav {secs[1]:.2f} s finite", flush=True)

    attention.LAUNCHES = 0
    zero_train_counts()
    resume_in_process(cfg, cfg_path, jsonl, root)
    train_launches = dict(attention.TRAIN_LAUNCHES)
    add_train_routes()
    if attention.LAUNCHES != 0:
        fail(f"training from the corpus launched the serving kernel {attention.LAUNCHES} times")
    check_extract_vq(cfg, cfg_path, jsonl, cli / "ckpt")
    attention.LAUNCHES = 0
    b1 = serve_from_checkpoint(cfg_path, cli / "ckpt", clips)
    print(f"  phase 7 wall {time.perf_counter() - t0:.1f} s ({CORPUS_CLIPS} clips, "
          f"{CORPUS_ACCUM} micro-batches a step)", flush=True)
    return train_launches, b1


# ------------------------------------------- data parallelism and remat


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def zero_counts():
    attention.LAUNCHES = 0
    for name in TRAIN_KERNELS:
        attention.TRAIN_LAUNCHES[name] = 0


def phase8_cfg(cfg_full, target, accum, **train):
    import dataclasses
    return dataclasses.replace(cfg_full, train=dataclasses.replace(
        cfg_full.train, target=target, gradient_accumulate_every=accum, **train))


def phase8_data(cfg, accum):
    """The global batches of phase 8: micro-batch 8 x 496 frames, 64 text
    tokens, seeded on the card."""
    from detail_tts_tpu_torch.train.step import synthetic_batches
    return synthetic_batches(cfg, accum, 8, 496, 64, device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(1))


def phase8_world1(cfg_full, group, logs):
    """(a): the distributed Trainer (a world-1 NCCL group) against the plain
    Trainer, bit for bit; returns (launches, world-1 readings of ``diff``)."""
    from detail_tts_tpu_torch.train.trainer import Trainer

    launches = {name: 0 for name in TRAIN_KERNELS}
    readings = None
    for target, accum in (("diff", 2), ("all", 1)):
        cfg = phase8_cfg(cfg_full, target, accum)
        runs = []
        for g in (None, group):
            t0 = time.perf_counter()
            trainer = Trainer(cfg, phase8_data(cfg, accum), device="cuda", seed=0,
                              logs_folder=os.path.join(logs, f"{target}-{g is not None}"),
                              group=g)
            steps = []
            for _ in range(2):
                zero_counts()
                trainer.train(max_steps=trainer.state.step + 1, log_every=1)
                m = trainer.last_metrics
                got = dict(attention.TRAIN_LAUNCHES)
                want = expected_train_launches(cfg, m["layers_kept"])
                if any(v != want for v in got.values()) or attention.LAUNCHES:
                    fail(f"phase 8 {target}: launches {got}, serving {attention.LAUNCHES}, "
                         f"expected {want} each and 0")
                if g is not None:
                    for name in TRAIN_KERNELS:
                        launches[name] += got[name]
                steps.append({k: v.clone() for k, v in m.items() if torch.is_tensor(v)})
            state = {n: p.detach().clone() for n, p in trainer.state.model.named_parameters()
                     if p.requires_grad}
            runs.append((steps, state, time.perf_counter() - t0))
            if target == "diff" and g is None:
                readings = [{k: float(v) for k, v in s.items()} for s in steps]
            trainer.close()
            del trainer
            torch.cuda.empty_cache()
        (plain, sd_plain, _), (dp, sd_dp, wall) = runs
        same_metrics = all(torch.equal(v, dp[i][k]) for i, s in enumerate(plain)
                           for k, v in s.items())
        differ = [n for n, v in sd_plain.items() if not torch.equal(v, sd_dp[n])]
        key = "loss" if target == "diff" else "loss_gen_all"
        norm = "grad_norm" if target == "diff" else "grad_norm_g"
        print(f"  (a) {target} world 1 over NCCL: loss {[s[key].item() for s in dp]}, "
              f"{norm} {[s[norm].item() for s in dp]}; every metric of 2 steps bit-identical "
              f"to the plain Trainer's {same_metrics}; {len(sd_plain) - len(differ)} of "
              f"{len(sd_plain)} trainable tensors bit-identical (trainer built and 2 steps "
              f"in {wall:.1f} s)", flush=True)
        if not same_metrics or differ:
            fail(f"phase 8 {target}: the world-1 step is not the plain step ({differ[:3]})")
        del runs, sd_plain, sd_dp
        torch.cuda.empty_cache()
    return launches, readings


# The runs of phase 8 (b): name -> (target, bf16 autocast).  ``vqvae`` runs
# twice: under bf16 autocast its encoder's features round per micro-batch
# shape (cuDNN picks other algorithms at 4 rows than at 8), so the codebook,
# a mean of those features, is held to world 1's at the features' bf16
# resolution there and at 1e-4 in fp32.
PHASE8_RUNS = {"diff": ("diff", True), "vqvae": ("vqvae", True),
               "vqvae_fp32": ("vqvae", False)}
CODEBOOK_TOL = {True: 1e-2, False: 1e-4}


def phase8_rank(rank, port, out_dir, cfg_full):
    """(b), one of two ranks on the one card over gloo: the runs of
    :data:`PHASE8_RUNS` (``vqvae`` from a fresh codebook), two steps each,
    through the Trainer's step with its stage walls; writes what the parent
    checks."""
    import torch.distributed as dist

    from detail_tts_tpu_torch.parallel.mesh import init_distributed, shard_batch
    from detail_tts_tpu_torch.train.trainer import Trainer
    from dp_port import digest  # SHA-256 of every trainable tensor and buffer

    # the parent's settings (phase 1): TF32 off in matmuls and cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group, dev = init_distributed(f"tcp://127.0.0.1:{port}", backend="gloo",
                                  device="cuda:0", rank=rank, world_size=2)
    try:
        out = {}
        for run, (target, bf16) in PHASE8_RUNS.items():
            cfg = phase8_cfg(cfg_full, target, 2, use_bf16=bf16)
            data = (shard_batch(b, group, 1) for b in phase8_data(cfg, 2))
            trainer = Trainer(cfg, data, device=dev, seed=0, group=group,
                              logs_folder=os.path.join(out_dir, f"{run}-{rank}"))
            state, steps = trainer.state, []
            torch.cuda.reset_peak_memory_stats()
            for _ in range(2):
                zero_counts()
                timings = {}
                t0 = time.perf_counter()
                m = trainer.step_fn(state, trainer.next_batch(), trainer.generator,
                                    timings=timings,
                                    dropout_generator=trainer.dropout_generator)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                steps.append({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                              "launches": dict(attention.TRAIN_LAUNCHES),
                              "serving": attention.LAUNCHES,
                              "expected": (expected_train_launches(cfg, m["layers_kept"])
                                           if target == "diff" else 0),
                              "allreduce_s": timings["allreduce"], "wall_s": wall,
                              "digest": digest(state)})
            out[run] = {"steps": steps,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "grads_mb": sum(p.numel() * 4 for p in state.params) / 1e6,
                        "embed": state.model.quantizer.vq.layers[0]._codebook.embed.cpu()}
            trainer.close()
            del trainer, state
            torch.cuda.empty_cache()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase8_world1_refs(cfg_full, logs):
    """World 1 of the ``vqvae`` runs of (b) through the plain Trainer: the
    metrics of two steps and the codebook after them."""
    from detail_tts_tpu_torch.train.trainer import Trainer

    refs = {}
    for run, (target, bf16) in PHASE8_RUNS.items():
        if target != "vqvae":
            continue
        cfg = phase8_cfg(cfg_full, target, 2, use_bf16=bf16)
        trainer = Trainer(cfg, phase8_data(cfg, 2), device="cuda", seed=0,
                          logs_folder=os.path.join(logs, f"{run}-w1"))
        steps = []
        for _ in range(2):
            trainer.train(max_steps=trainer.state.step + 1, log_every=1)
            steps.append({k: float(v) for k, v in trainer.last_metrics.items()
                          if torch.is_tensor(v)})
        refs[run] = (steps, trainer.state.model.quantizer.vq.layers[0]._codebook.embed.cpu())
        trainer.close()
        del trainer
        torch.cuda.empty_cache()
    return refs


def phase8_world2(cfg_full, diff_ref, logs):
    """(b): two processes on the one card over gloo, against world 1."""
    import torch.multiprocessing as mp

    refs = phase8_world1_refs(cfg_full, logs)
    refs["diff"] = (diff_ref, None)
    t0 = time.perf_counter()
    mp.start_processes(phase8_rank, args=(free_port(), logs, cfg_full), nprocs=2,
                       join=True, start_method="spawn")
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(logs, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    launches = {name: 0 for name in TRAIN_KERNELS}
    for run, (target, bf16) in PHASE8_RUNS.items():
        ref, embed_ref = refs[run]
        for i in range(2):
            s0, s1 = ranks[0][run]["steps"][i], ranks[1][run]["steps"][i]
            rel = {k: abs(s0[k] - ref[i][k]) / abs(ref[i][k]) for k in ("loss", "grad_norm")}
            print(f"  (b) {run} world 2 step {i + 1}: loss {s0['loss']:.6f} (world 1 "
                  f"{ref[i]['loss']:.6f}), grad_norm {s0['grad_norm']:.6f} (world 1 "
                  f"{ref[i]['grad_norm']:.6f}), relative {json.dumps(rel)}; ranks' tensors "
                  f"bit-identical {torch.equal(s0['digest'], s1['digest'])}; all-reduce of "
                  f"{ranks[0][run]['grads_mb']:.1f} MB fp32 grads {s0['allreduce_s']:.3f} / "
                  f"{s1['allreduce_s']:.3f} s, step wall {s0['wall_s']:.3f} / "
                  f"{s1['wall_s']:.3f} s (rank 0 / 1, stages synchronised; step 1 holds "
                  f"the ranks' start skew); launches {s0['launches']} / {s1['launches']} "
                  f"(expected {s0['expected']} each)", flush=True)
            if not torch.equal(s0["digest"], s1["digest"]):
                fail(f"phase 8 {run}: the ranks' tensors differ after step {i + 1}")
            if any(not r <= ROUTE_TOL[k] for k, r in rel.items()):
                fail(f"phase 8 {run}: world 2 is {rel} from world 1")
            for s in (s0, s1):
                if any(v != s["expected"] for v in s["launches"].values()) or s["serving"]:
                    fail(f"phase 8 {run}: launches {s['launches']}, serving {s['serving']}")
                for name in TRAIN_KERNELS:
                    launches[name] += s["launches"][name]
        if embed_ref is not None:
            embed = ranks[0][run]["embed"]
            err = (embed - embed_ref).abs().max().item() / max(1.0, embed_ref.abs().max().item())
            print(f"  (b) {run} codebook after 2 steps: max |world 2 - world 1| / max(1, "
                  f"max |world 1|) {err:.3e} (gate {CODEBOOK_TOL[bf16]:g})", flush=True)
            if not err <= CODEBOOK_TOL[bf16]:
                fail(f"phase 8 {run}: the world-2 codebook is {err:.3e} from world 1's")
    print("  (b) peak device memory per rank (rank 0 / 1): "
          + ", ".join(f"{run} {ranks[0][run]['peak_gib']:.2f} / {ranks[1][run]['peak_gib']:.2f} "
                      "GiB" for run in PHASE8_RUNS)
          + f"; two ranks spawned, built, stepped and joined in {wall:.1f} s", flush=True)
    return launches


def phase8_remat(cfg_full, logs):
    """(c): ``gpt`` with remat on and off from one seed."""
    from detail_tts_tpu_torch.train.trainer import Trainer

    runs = {}
    for remat in (True, False):
        cfg = phase8_cfg(cfg_full, "gpt", 2, remat_gpt=remat)
        trainer = Trainer(cfg, phase8_data(cfg, 2), device="cuda", seed=0,
                          logs_folder=os.path.join(logs, f"gpt-remat-{remat}"))
        trainer.train(max_steps=1, log_every=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.train(max_steps=2, log_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m = trainer.last_metrics
        runs[remat] = (m["loss"].item(), m["grad_norm"].item(),
                       torch.cuda.max_memory_allocated() / 2**30, wall)
        trainer.close()
        del trainer
        torch.cuda.empty_cache()
    on, off = runs[True], runs[False]
    rel = [abs(a - b) / abs(b) for a, b in zip(on[:2], off[:2])]
    print(f"  (c) gpt, micro-batch 8 x accum 2, dropout {cfg_full.gpt.dropout}, step 2: remat "
          f"on loss {on[0]:.9f} grad_norm {on[1]:.9f}, off {off[0]:.9f} / {off[1]:.9f} "
          f"(relative {rel[0]:.2e}, {rel[1]:.2e}; gate 1e-6); peak device memory "
          f"{on[2]:.2f} GiB with remat, {off[2]:.2f} GiB without; step wall {on[3]:.3f} / "
          f"{off[3]:.3f} s", flush=True)
    if any(not r <= 1e-6 for r in rel):
        fail("phase 8: remat changed the gpt step")
    if not on[2] < off[2]:
        fail("phase 8: remat did not lower the gpt step's peak memory")


def phase_parallel(cfg_full, logs):
    """Phase 8: data parallelism and remat; returns the training kernels'
    launches of (a) and (b), and world 1's ``diff`` readings."""
    import torch.distributed as dist
    from detail_tts_tpu_torch.parallel.mesh import init_distributed

    print("== data parallelism and remat", flush=True)
    print(f"  {smi('name,power.limit')}", flush=True)
    os.makedirs(logs)
    group, _ = init_distributed(f"tcp://127.0.0.1:{free_port()}", device="cuda:0", rank=0,
                                world_size=1)
    try:
        launches, diff_ref = phase8_world1(cfg_full, group, logs)
    finally:
        dist.destroy_process_group()
    for name, n in phase8_world2(cfg_full, diff_ref, logs).items():
        launches[name] += n
    phase8_remat(cfg_full, logs)
    return launches, diff_ref


# ------------------------------------------- the model axis, sharded serving

# Phase 9's request: 4 rows (2 a data rank at (2 x 1)), 64 codes under
# force_full.  The deterministic tail is held at JAX's mesh tolerances
# (tests/test_serving_mesh.py:67), relative to the one-card output's max.
PHASE9_ROWS, PHASE9_CODES = 4, 64
TAIL_TOL = {"latents": 2e-4, "mel": 2e-3, "wav": 2e-3}
# ||w_tp - w_1|| / ||w_1 - w_0||, the worst trainable GPT tensor after 2 steps
STEP_TOL = 0.1
# Read, not gated: the key projection's bias of the conditioning encoder's
# softmax attention adds q . b to every score of a query, which softmax
# cancels, so its exact gradient is 0 and its step is rounding noise that
# AdamW (eps 1e-9) scales to ~lr (it reads 0.64 where the rest read <= 3.6e-3)
NOISE_STEP = r"gpt\.conditioning_encoder\.slf_attn\.w_ks\.bias"
PHASE9_MESHES = ((2, 1), (1, 2))


def phase9_request(cfg):
    sr = cfg.data.sampling_rate
    rng = np.random.default_rng(9)
    texts = ["你好。", "今天天气很好，我们一起去公园散步吧。", "这是第三个请求。",
             "欢迎使用语音合成，这是一个长一点的句子。"][:PHASE9_ROWS]
    # prompts of one length: one prompt bucket, so B1 runs steps x 13 + 9 times
    wavs = [rng.uniform(-0.3, 0.3, 3 * sr).astype(np.float32) for _ in texts]
    codes = torch.as_tensor(rng.integers(0, 8192, size=(len(texts), PHASE9_CODES)))
    eff = np.array([PHASE9_CODES - 3 * i for i in range(len(texts))], np.int64)
    return texts, wavs, codes, eff


def phase9_engine_cfg(dtype):
    from detail_tts_tpu_torch.serving.pipeline import EngineConfig
    return EngineConfig(max_generate_length=PHASE9_CODES + 1, compute_dtype=dtype,
                        cache_dtype=dtype)


def engine_tail(engine, texts, wavs, codes, eff, rows=None):
    """Fixed codes -> (latents, mel, wav) of every item (JAX's
    ``_deterministic_tail``): this data rank's rows, fixed keys,
    gathered over the data group.  ``rows`` (a one-card engine): only those
    rows of the request, at its text width and with its draws, as a data
    rank computes them."""
    from detail_tts_tpu_torch.audio.mel import FRAMES_PER_CODE
    from detail_tts_tpu_torch.parallel.mesh import all_gather_rows

    given = rows is not None
    rows = rows if given else engine._rows(len(texts))
    mine = slice(None) if rows is None else slice(rows.start, rows.stop)
    dev = engine.device
    with torch.inference_mode():
        # given rows: the request's text width (its prompts are of one length)
        text = engine.prepare_text(texts)[0][mine] if given else \
            engine.prepare_text(texts[mine])[0]
        refer_mel, refer_len = engine.prepare_prompt(wavs[mine])
        codes_b, wav_len, bucket = engine._pad_codes(codes[mine].to(dev), eff[mine])
        latents = engine.model.gpt(refer_mel.to(engine.cdt), refer_len, text, codes_b, wav_len)
        mel = engine.diffuse(latents, engine.diffusion_cond(refer_mel, refer_len),
                             engine.attention_biases(bucket * FRAMES_PER_CODE), (0, 7),
                             rows)
        wav = engine._vocode(mel, eff[mine], (0, 8), rows)[..., 0]
        out = [latents.float(), mel.float(), wav.float()]
        if not given and rows is not None and rows.stop - rows.start < rows.total:
            out = [all_gather_rows(x, engine.mesh.data_group) for x in out]
    return [x.cpu() for x in out]


def sampled_request(engine, texts, wavs):
    """The request through the split dispatch (seed 0, force_full): (every
    item's codes, wavs, B1 launches, wall); fails unless it launched
    ``prng_per_request``'s threefry kernels and a sample step for each
    decode step."""
    from detail_tts_tpu_torch.parallel.mesh import all_gather_rows

    attention.LAUNCHES = 0
    zero_prng()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = engine.dispatch_decode(texts, wavs, seed=0, force_full=True)
    codes = pending.codes
    if pending.rows is not None and pending.rows.stop - pending.rows.start < pending.rows.total:
        codes = all_gather_rows(codes, engine.mesh.data_group)
    outs = engine.finalize_batch(engine.dispatch_tail(pending))
    wall = time.perf_counter() - t0
    want = prng_per_request(engine, engine.ecfg.max_generate_length)
    if prng_counts() != want:
        fail(f"phase 9 on {engine.device}: threefry and sample step launches "
             f"{prng_counts()}, expected {want}")
    return codes.cpu(), outs, attention.LAUNCHES, wall


def phase9_gpt_cfg(cfg_full, target, model, use_bf16=False):
    """``target`` at accum 2 on a (world / ``model`` x ``model``) mesh;
    ``gpt`` in fp32 unless ``use_bf16`` (``diff`` as phase 8 runs it)."""
    import dataclasses
    cfg = phase8_cfg(cfg_full, target, 2, use_bf16=use_bf16 or target != "gpt")
    return dataclasses.replace(cfg, mesh=dataclasses.replace(
        cfg.mesh, data_parallel=-1, model_parallel=model))


def phase9_rank(rank, port, out_dir, cfg_full):
    """One of two ranks on the one card over gloo: the engines at (2 x 1)
    and (1 x 2), then the ``gpt`` Trainer at (1 x 2) (2 steps, a checkpoint,
    a third step) and one ``diff`` step at (1 x 2); writes what the parent
    checks."""
    import torch.distributed as dist

    from detail_tts_tpu_torch.parallel import mesh
    from detail_tts_tpu_torch.serving.pipeline import random_engine
    from detail_tts_tpu_torch.train.trainer import Trainer
    from dp_port import digest  # SHA-256 of the replicated trainable tensors and buffers

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group, dev = mesh.init_distributed(f"tcp://127.0.0.1:{port}", backend="gloo",
                                       device="cuda:0", rank=rank, world_size=2)
    try:
        texts, wavs, codes, eff = phase9_request(cfg_full)
        out = {}
        for data, model in PHASE9_MESHES:
            m = mesh.make_mesh(data, model, group)
            res = {}
            for dtype in ((torch.float32, torch.bfloat16) if data > 1 else (torch.float32,)):
                engine = random_engine(cfg_full, seed=0, engine_cfg=phase9_engine_cfg(dtype),
                                       device=dev, mesh=m)
                res["tail " + str(dtype)] = engine_tail(engine, texts, wavs, codes, eff)
                res[str(dtype)] = sampled_request(engine, texts, wavs)
                res["b1_per_request"] = b1_per_request(engine)
                del engine
                torch.cuda.empty_cache()
            out[(data, model)] = res

        # (c) gpt at (1 x 2) under bf16 autocast: 2 steps, a reading
        cfg = phase9_gpt_cfg(cfg_full, "gpt", 2, use_bf16=True)
        trainer = Trainer(cfg, phase8_data(cfg, 2), device=dev, seed=0, group=group,
                          logs_folder=os.path.join(out_dir, "gpt-tp-bf16"))
        out["gpt_bf16"] = []
        for _ in range(2):
            trainer.train(max_steps=trainer.state.step + 1, log_every=1)
            out["gpt_bf16"].append({k: trainer.last_metrics[k].item()
                                    for k in ("loss", "grad_norm")})
        trainer.close()
        del trainer
        torch.cuda.empty_cache()

        # (c) gpt at (1 x 2) in fp32: 2 steps, a checkpoint, a third step
        cfg = phase9_gpt_cfg(cfg_full, "gpt", 2)
        trainer = Trainer(cfg, phase8_data(cfg, 2), device=dev, seed=0, group=group,
                          logs_folder=os.path.join(out_dir, "gpt-tp"))
        steps = []
        for i in range(3):
            if i == 2:
                trainer.save()
            trainer.train(max_steps=trainer.state.step + 1, log_every=1)
            m = trainer.last_metrics
            steps.append({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                          "digest": digest(trainer.state)})
            if i == 1:  # the gathered weights against world 1's (rank 0 reads them)
                full = mesh.gather_state_dict(trainer.state.model)
                err = None
                if rank == 0:
                    err = step_readings(full, *(torch.load(
                        os.path.join(out_dir, f"{w}_gpt.pt"), weights_only=True)
                        for w in ("w0", "w1")), mesh.model_shards(trainer.state.model))
                del full
        out["gpt"] = {"steps": steps, "param_err": err,
                      "sharded": len(mesh.model_shards(trainer.state.model)),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        trainer.close()
        del trainer
        torch.cuda.empty_cache()

        # (d) diff at (1 x 2): the frozen latents pass runs the sharded GPT
        cfg = phase9_gpt_cfg(cfg_full, "diff", 2)
        trainer = Trainer(cfg, phase8_data(cfg, 2), device=dev, seed=0, group=group,
                          logs_folder=os.path.join(out_dir, "diff-tp"))
        zero_counts()
        trainer.train(max_steps=1, log_every=1)
        m = trainer.last_metrics
        out["diff"] = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                       "launches": dict(attention.TRAIN_LAUNCHES),
                       "serving": attention.LAUNCHES,
                       "expected": expected_train_launches(cfg, m["layers_kept"]),
                       "digest": digest(trainer.state)}
        trainer.close()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase9_world1(cfg_full, logs):
    """The one-card references: the engine's tail, its fp32 and bf16
    requests, and the plain ``gpt`` Trainer's first two steps (its GPT
    weights after them saved for the ranks)."""
    from detail_tts_tpu_torch.serving.pipeline import random_engine
    from detail_tts_tpu_torch.train.trainer import Trainer

    from detail_tts_tpu_torch.parallel.mesh import Rows

    texts, wavs, codes, eff = phase9_request(cfg_full)
    n, half = len(texts), len(texts) // 2
    ref = {}
    for dtype in (torch.float32, torch.bfloat16):
        engine = random_engine(cfg_full, seed=0, engine_cfg=phase9_engine_cfg(dtype),
                               device="cuda")
        ref["tail " + str(dtype)] = engine_tail(engine, texts, wavs, codes, eff)
        # the two halves as the (2 x 1) ranks compute them: 2-row batches
        halves = [engine_tail(engine, texts, wavs, codes, eff, Rows(a, a + half, n))
                  for a in (0, half)]
        ref["halves " + str(dtype)] = [torch.cat(x) for x in zip(*halves)]
        ref[str(dtype)] = sampled_request(engine, texts, wavs)
        del engine
        torch.cuda.empty_cache()
    for bf16 in (True, False):
        cfg = phase9_gpt_cfg(cfg_full, "gpt", 1, use_bf16=bf16)
        trainer = Trainer(cfg, phase8_data(cfg, 2), device="cuda", seed=0,
                          logs_folder=os.path.join(logs, f"gpt-w1-{bf16}"))

        def save_weights(name):
            torch.save({n: p.detach().float().cpu() for n, p in
                        trainer.state.model.named_parameters() if p.requires_grad},
                       os.path.join(logs, name))

        if not bf16:
            save_weights("w0_gpt.pt")
        steps = []
        for _ in range(2):
            trainer.train(max_steps=trainer.state.step + 1, log_every=1)
            steps.append({k: float(v) for k, v in trainer.last_metrics.items()
                          if torch.is_tensor(v)})
        if not bf16:
            save_weights("w1_gpt.pt")
        ref["gpt_bf16" if bf16 else "gpt"] = steps
        trainer.close()
        del trainer
        torch.cuda.empty_cache()
    return ref


def phase9_restored_step(cfg_full, logs):
    """World 1 restored from the (1 x 2) checkpoint takes the third step."""
    from detail_tts_tpu_torch.train.trainer import Trainer

    cfg = phase9_gpt_cfg(cfg_full, "gpt", 1)
    data = phase8_data(cfg, 2)
    next(data), next(data)
    trainer = Trainer(cfg, data, device="cuda", seed=5,
                      logs_folder=os.path.join(logs, "gpt-restored"))
    trainer.load(os.path.join(logs, "gpt-tp", "ckpt"))
    if trainer.state.step != 2:
        fail(f"phase 9: the (1 x 2) checkpoint restored step {trainer.state.step}, not 2")
    trainer.train(max_steps=3, log_every=1)
    m = {k: float(v) for k, v in trainer.last_metrics.items() if torch.is_tensor(v)}
    trainer.close()
    return m


def step_readings(full, w0, w1, shards):
    """The (1 x 2) GPT's gathered trainable weights ``full`` against world
    1's after the same steps, ``w1``, from the same start ``w0``: for each
    tensor ||w_tp - w_1|| / ||w_1 - w_0||, the distance relative to the
    change that world 1's steps made.  Returns the worst tensor's reading
    and its name (``NOISE_STEP`` apart, whose reading is returned on its
    own), and two planted faults read the same way from the same
    tensors, each the least over the tensors it applies to (the fault
    hardest to see): no update (w_tp = w_0), and model rank 1's shard of a
    sharded tensor left at w_0.  A tensor that world 1's steps left
    unchanged reads 0 where w_tp equals it, else inf."""
    from detail_tts_tpu_torch.parallel.mesh import shard_tensor

    sound, no_update, lost = {}, {}, {}
    for n, start in w0.items():
        step = (w1[n] - start).double()
        size = step.norm().item()
        miss = (full[n].cpu().double() - w1[n].double()).norm().item()
        sound[n] = miss / size if size else (0.0 if miss == 0 else math.inf)
        if size:
            no_update[n] = (start - w1[n]).double().norm().item() / size  # w_tp = w_0
            if n in shards:
                lost[n] = shard_tensor(step, shards[n]._replace(rank=1)).norm().item() / size
    noise = {n: sound.pop(n) for n in list(sound) if re.fullmatch(NOISE_STEP, n)}
    worst = max(sound, key=sound.get)
    hardest = min(lost, key=lost.get)
    return {"worst": sound[worst], "worst_tensor": worst, "tensors": len(sound),
            "noise": noise, "no_update": min(no_update.values()),
            "lost_shard": lost[hardest], "lost_shard_tensor": hardest}


def rel_err(a, b) -> float:
    """max |a - b| / max |b| (b the one-card output)."""
    return (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-12)


def wav_err(outs, ref) -> float:
    """The largest |sharded - one card| over the items, relative to the
    one-card audio's max; inf where the lengths differ."""
    if any(a.shape != b.shape for a, b in zip(outs, ref)):
        return math.inf
    scale = max(float(np.abs(b).max()) for b in ref)
    return max(float(np.abs(a - b).max()) for a, b in zip(outs, ref)) / scale


def phase_mesh(cfg_full, diff_ref, logs):
    """Phase 9: the mesh's model axis and sharded serving on the one card
    (two gloo ranks); returns (B1 launches, training kernels' launches) of
    the ranks.  ``diff_ref``: phase 8's world-1 ``diff`` readings (None:
    one plain step is taken here, to run the phase alone)."""
    import torch.multiprocessing as mp

    from detail_tts_tpu_torch.train.trainer import Trainer

    print("== the model axis and sharded serving (two gloo ranks on the one card)", flush=True)
    print(f"  {smi('name,power.limit')}", flush=True)
    os.makedirs(logs)
    if diff_ref is None:
        cfg = phase8_cfg(cfg_full, "diff", 2)
        trainer = Trainer(cfg, phase8_data(cfg, 2), device="cuda", seed=0,
                          logs_folder=os.path.join(logs, "diff-w1"))
        trainer.train(max_steps=1, log_every=1)
        diff_ref = [{k: float(v) for k, v in trainer.last_metrics.items()
                     if torch.is_tensor(v)}]
        trainer.close()
        del trainer
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = phase9_world1(cfg_full, logs)
    t_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    mp.start_processes(phase9_rank, args=(free_port(), logs, cfg_full), nprocs=2,
                       join=True, start_method="spawn")
    t_ranks = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(logs, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]
    b1 = 0
    fp32, bf16 = str(torch.float32), str(torch.bfloat16)
    ref_codes, ref_wavs, _, ref_wall = ref[fp32]
    for data, model in PHASE9_MESHES:
        label = f"({data} x {model})"
        for r, out in enumerate(ranks):
            res = out[(data, model)]
            errs = {name: rel_err(a, b) for name, a, b in
                    zip(("latents", "mel", "wav"), res["tail " + fp32], ref["tail " + fp32])}
            if data > 1:  # a data rank computes its rows as one card's 2-row batch does
                for dtype in (fp32, bf16):
                    same = all(torch.equal(a, b) for a, b in
                               zip(res["tail " + dtype], ref["halves " + dtype]))
                    spread = {name: float(f"{rel_err(a, b):.3e}") for name, a, b in
                              zip(("latents", "mel", "wav"), ref["halves " + dtype],
                                  ref["tail " + dtype])}
                    print(f"  (a) {label} rank {r} {dtype} tail bit-identical to one card's "
                          f"2-row batches {same}; those against its 4-row batch "
                          f"{json.dumps(spread)}", flush=True)
                    if not same:
                        fail(f"phase 9 {label} rank {r}: the {dtype} tail is not one card's "
                             "2-row computation of its rows")
            codes, wavs, launches, wall = res[fp32]
            agree = float((codes == ref_codes).float().mean())
            werr = wav_err(wavs, ref_wavs)
            print(f"  (a/b) {label} rank {r} fp32: tail max |sharded - one card| / max |one "
                  f"card| {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} (gates "
                  f"{json.dumps(TAIL_TOL)}); sampled codes equal to one card's "
                  f"{agree:.4f}, wav {werr:.3e}; B1 launches {launches} (expected "
                  f"{res['b1_per_request']}); request wall {wall:.3f} s (one card "
                  f"{ref_wall:.3f} s)", flush=True)
            if any(not errs[k] <= TAIL_TOL[k] for k in TAIL_TOL):
                fail(f"phase 9 {label}: the deterministic tail is {errs} from one card's")
            if data > 1 and agree != 1.0:
                fail(f"phase 9 {label}: the fp32 request's codes differ from one card's")
            if launches != res["b1_per_request"]:
                fail(f"phase 9 {label} rank {r}: {launches} B1 launches")
            b1 += launches
            if bf16 in res:
                codes16, wavs16, launches16, wall16 = res[bf16]
                agree16 = float((codes16 == ref[bf16][0]).float().mean())
                werr16 = wav_err(wavs16, ref[bf16][1])
                print(f"  (a) {label} rank {r} bf16: sampled codes equal to one card's "
                      f"{agree16:.4f}, wav max |sharded - one card| / max |one card| "
                      f"{werr16:.3e} (gate {BF16_WAV_TOL:g}); B1 launches {launches16}; "
                      f"request wall {wall16:.3f} s (one card {ref[bf16][3]:.3f} s)",
                      flush=True)
                if not werr16 <= BF16_WAV_TOL:
                    fail(f"phase 9 {label}: the bf16 request is {werr16:.3e} from one card's")
                if launches16 != res["b1_per_request"]:
                    fail(f"phase 9 {label} rank {r}: {launches16} B1 launches (bf16)")
                b1 += launches16

    # (c) gpt at (1 x 2) against world 1: under bf16 a reading (gated at
    # GPT_BF16_TOL), in fp32 the gates
    for i in range(2):
        s0, w = ranks[0]["gpt_bf16"][i], ref["gpt_bf16"][i]
        rel = {k: abs(s0[k] - w[k]) / abs(w[k]) for k in ("loss", "grad_norm")}
        print(f"  (c) gpt (1 x 2) bf16 autocast step {i + 1}: loss {s0['loss']:.6f} (world 1 "
              f"{w['loss']:.6f}), grad_norm {s0['grad_norm']:.6f} (world 1 "
              f"{w['grad_norm']:.6f}), relative {json.dumps(rel)} (gate {GPT_BF16_TOL:g})",
              flush=True)
        if any(not r <= GPT_BF16_TOL for r in rel.values()):
            fail(f"phase 9 gpt bf16 step {i + 1}: {rel} from world 1")
    g0, g1 = ranks[0]["gpt"], ranks[1]["gpt"]
    for i in range(2):
        s0, s1, w = g0["steps"][i], g1["steps"][i], ref["gpt"][i]
        rel = {k: abs(s0[k] - w[k]) / abs(w[k]) for k in ("loss", "grad_norm")}
        same = torch.equal(s0["digest"], s1["digest"])
        print(f"  (c) gpt (1 x 2) fp32 step {i + 1}: loss {s0['loss']:.6f} (world 1 {w['loss']:.6f}), "
              f"grad_norm {s0['grad_norm']:.6f} (world 1 {w['grad_norm']:.6f}), relative "
              f"{json.dumps(rel)}; replicated tensors bit-identical across the ranks {same}",
              flush=True)
        if any(not r <= 1e-3 for r in rel.values()) or not same:
            fail(f"phase 9 gpt step {i + 1}: {rel}, ranks identical {same}")
    e = g0["param_err"]
    noise = json.dumps({n: float(f"{v:.3e}") for n, v in e["noise"].items()})
    print(f"  (c) gpt (1 x 2): {g0['sharded']} tensors sharded; gathered GPT weights after 2 "
          f"steps, ||tp - world 1|| / ||world 1 - start||, the worst of {e['tensors']} "
          f"tensors: {e['worst']:.3e} ({e['worst_tensor']}; gate {STEP_TOL:g}); read, not "
          f"gated (exact gradient 0): {noise}; planted "
          f"faults: no update {e['no_update']:.3e}, rank 1's shard not updated "
          f"{e['lost_shard']:.3e} (the least, {e['lost_shard_tensor']}); peak device memory "
          f"per rank {g0['peak_gib']:.2f} / {g1['peak_gib']:.2f} GiB", flush=True)
    if not e["worst"] <= STEP_TOL:
        fail(f"phase 9 gpt: {e['worst_tensor']} is {e['worst']:.3e} of its step from world 1's")
    if not min(e["no_update"], e["lost_shard"]) > STEP_TOL:
        fail(f"phase 9 gpt: a planted fault reads {e} within the gate {STEP_TOL:g}")
    restored = phase9_restored_step(cfg_full, logs)
    s0 = g0["steps"][2]
    rel = {k: abs(s0[k] - restored[k]) / abs(restored[k]) for k in ("loss", "grad_norm")}
    print(f"  (c) the (1 x 2) checkpoint at step 2 restored at world 1: step 3 loss "
          f"{restored['loss']:.6f}, grad_norm {restored['grad_norm']:.6f}; (1 x 2)'s step 3 "
          f"{s0['loss']:.6f} / {s0['grad_norm']:.6f}; relative {json.dumps(rel)}", flush=True)
    if any(not r <= 1e-3 for r in rel.values()) or not torch.equal(s0["digest"],
                                                                   g1["steps"][2]["digest"]):
        fail(f"phase 9: the restored step is {rel} from the (1 x 2) step")

    # (d) diff at (1 x 2)
    launches = {name: 0 for name in TRAIN_KERNELS}
    d0, d1 = ranks[0]["diff"], ranks[1]["diff"]
    rel = {k: abs(d0[k] - diff_ref[0][k]) / abs(diff_ref[0][k]) for k in ("loss", "grad_norm")}
    print(f"  (d) diff (1 x 2) step 1: loss {d0['loss']:.6f}, grad_norm {d0['grad_norm']:.6f} "
          f"(world 1, phase 8: {diff_ref[0]['loss']:.6f} / {diff_ref[0]['grad_norm']:.6f}; "
          f"relative {json.dumps(rel)}); launches {d0['launches']} / {d1['launches']} "
          f"(expected {d0['expected']} each); ranks bit-identical "
          f"{torch.equal(d0['digest'], d1['digest'])}", flush=True)
    if any(not r <= ROUTE_TOL[k] for k, r in rel.items()):
        fail(f"phase 9 diff: {rel} from world 1")
    if not torch.equal(d0["digest"], d1["digest"]):
        fail("phase 9 diff: the ranks' tensors differ")
    for d in (d0, d1):
        if any(v != d["expected"] for v in d["launches"].values()) or d["serving"]:
            fail(f"phase 9 diff: launches {d['launches']}, serving {d['serving']}")
        for name in TRAIN_KERNELS:
            launches[name] += d["launches"][name]
    print(f"  phase 9: references {t_ref:.1f} s, two ranks spawned, run and joined in "
          f"{t_ranks:.1f} s", flush=True)
    return b1, launches


# ---------------------------------------- the front ends over the sharded engine

# Phase 10's requests: zh texts of 3-20 characters, 3 s prompts, ancestral 50
# with early stop at up to PHASE10_CODES codes; a batch of FAULT_TEXT raises
# on rank 1 after its call ran (a rank-local fault: no rank waits in a
# collective).  fp32: every code equal and the audio at JAX's mesh tolerance
# for wav (tests/test_serving_mesh.py).  bf16 (the engine is not
# batch-invariant, phase 9): CODES_EQUAL of the codes, and BF16_WAV_TOL on
# the audio of each item whose codes all agree.  An item with a flipped code
# is another utterance from there on, and its audio is read, not gated: such
# an item of a 2-row batch with 0.970 of its codes equal read 0.504 of max
# (H100 80GB HBM3, 700 W; PERF.md §6).
PHASE10_CODES = 40
PHASE10_TEXTS = ("你好。", "今天天气很好，我们一起去公园散步吧。", "这是第三个请求。",
                 "欢迎使用语音合成，这是一个长一点的句子。")
PHASE10_LONG = "今天天气很好。我们一起去公园散步吧！你好，欢迎使用语音合成。"  # 3 chunks
FAULT_TEXT = "这一批在一个进程上出错。"
WAV_TOL = {torch.float32: 2e-3, torch.bfloat16: BF16_WAV_TOL}
CODES_EQUAL = {torch.float32: 1.0, torch.bfloat16: 0.9}


def phase10_requests(cfg):
    sr = cfg.data.sampling_rate
    rng = np.random.default_rng(10)
    return [(t, rng.uniform(-0.3, 0.3, 3 * sr).astype(np.float32), 20 + i)
            for i, t in enumerate(PHASE10_TEXTS)]


def phase10_engine(cfg_full, dtype, device, mesh=None):
    from detail_tts_tpu_torch.serving.pipeline import EngineConfig, random_engine
    return random_engine(cfg_full, seed=0, device=device, mesh=mesh, engine_cfg=EngineConfig(
        max_generate_length=PHASE10_CODES + 1, compute_dtype=dtype, cache_dtype=dtype))


def phase10_hooks(engine, rank=0):
    """On ``engine``'s instance: record each ``dispatch_decode``'s thread,
    current card, whether its batch is ``FAULT_TEXT``'s and B1 launches
    (the diffusion conditioning's), and each ``dispatch_tail``'s label (set
    by the scenario), rows, codes and B1 launches; on rank 1 a batch of
    ``FAULT_TEXT`` raises after its ``dispatch_decode`` ran."""
    import threading

    rec = {"label": None, "decodes": [], "tails": []}
    decode, tail = engine.dispatch_decode, engine.dispatch_tail

    def dispatch_decode(texts, *args, **kwargs):
        before = attention.LAUNCHES
        out = decode(texts, *args, **kwargs)
        rec["decodes"].append((threading.current_thread().name, torch.cuda.current_device(),
                               FAULT_TEXT in texts, attention.LAUNCHES - before))
        if rank == 1 and FAULT_TEXT in texts:
            raise RuntimeError("a fault planted on rank 1")
        return out

    def dispatch_tail(pending):
        before = attention.LAUNCHES
        out = tail(pending)
        rec["tails"].append((rec["label"], pending.rows, pending.codes.cpu(),
                             attention.LAUNCHES - before))
        return out

    engine.dispatch_decode, engine.dispatch_tail = dispatch_decode, dispatch_tail
    return rec


def phase10_scenario(engine, requests, rec, fault):
    """The front ends over ``engine`` (a ``LeaderEngine`` or a one-card
    engine): a ``TTSServer`` answers the 4 requests as one batch, then as
    two back-to-back batches of 2; with ``fault`` a batch of ``FAULT_TEXT``
    and the first pair again; one HTTP ``/synthesize``; a 3-chunk
    ``synthesize_long``.  Returns (outputs, walls)."""
    import threading
    import urllib.request

    from detail_tts_tpu_torch.serving.http_api import _decode_wav_bytes, _encode_wav_bytes, serve
    from detail_tts_tpu_torch.serving.longform import synthesize_long
    from detail_tts_tpu_torch.serving.server import TTSServer

    out, walls = {}, {}
    for label, max_batch in (("four", 4), ("pairs", 2)):
        rec["label"] = label
        with TTSServer(engine, max_batch=max_batch, max_wait_ms=1000.0) as server:
            t0 = time.perf_counter()
            futs = [server.submit(t, w, seed=s) for t, w, s in requests]
            out[label] = [f.result(timeout=600) for f in futs]
            walls[label] = time.perf_counter() - t0
            if label == "pairs" and fault:
                rec["label"] = "fault next"
                futs = [server.submit(FAULT_TEXT, w, seed=s) for _, w, s in requests[:2]]
                futs += [server.submit(t, w, seed=s) for t, w, s in requests[:2]]
                out["fault"] = []
                for f in futs[:2]:
                    try:
                        f.result(timeout=600)
                        out["fault"].append(None)
                    except RuntimeError as e:
                        out["fault"].append(str(e))
                out["fault next"] = [f.result(timeout=600) for f in futs[2:]]
        out[label + " batches"] = server.batches_dispatched

    rec["label"] = "http"
    sr = engine.cfg.data.sampling_rate
    box = {}
    thread = threading.Thread(target=serve, kwargs=dict(
        engine=engine, host="127.0.0.1", port=0, max_batch=2, max_wait_ms=5.0,
        httpd_box=box), daemon=True)
    thread.start()
    deadline = time.monotonic() + 60
    while "httpd" not in box and time.monotonic() < deadline:
        time.sleep(0.01)
    if "httpd" not in box:
        fail("phase 10: the HTTP server did not start")
    text, wav, seed = requests[1]
    body = json.dumps({"text": text, "seed": seed, "prompt_wav_b64": base64.b64encode(
        _encode_wav_bytes(wav, sr)).decode()}).encode()
    local = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # no proxy
    try:
        t0 = time.perf_counter()
        with local.open(urllib.request.Request(
                "http://127.0.0.1:%d/synthesize" % box["httpd"].server_address[1],
                data=body, headers={"Content-Type": "application/json"}), timeout=600) as r:
            out["http"] = [_decode_wav_bytes(r.read(), sr)] if r.status == 200 else []
        walls["http"] = time.perf_counter() - t0
    finally:
        box["httpd"].shutdown()
        thread.join(timeout=60)
    if thread.is_alive():
        fail("phase 10: the HTTP server did not stop")

    rec["label"] = "long"
    t0 = time.perf_counter()
    out["long"] = [synthesize_long(engine, PHASE10_LONG, requests[0][1], seed=7)]
    walls["long"] = time.perf_counter() - t0
    return out, walls


def phase10_rank(rank, port, out_dir, cfg_full):
    """One of two ranks on the one card over gloo: for each dtype a (2 x 1)
    engine, rank 0 running the scenario through a ``LeaderEngine``, rank 1
    in ``follow``; writes what the parent checks."""
    import torch.distributed as dist

    from detail_tts_tpu_torch.parallel import mesh
    from detail_tts_tpu_torch.serving.spmd import LeaderEngine, follow
    from dp_port import channel_summary, time_channel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group, dev = mesh.init_distributed(f"tcp://127.0.0.1:{port}", backend="gloo",
                                       device="cuda:0", rank=rank, world_size=2)
    channel = time_channel()  # the leader's broadcasts and outcome agreements
    try:
        requests = phase10_requests(cfg_full)
        out = {}
        for dtype in (torch.float32, torch.bfloat16):
            engine = phase10_engine(cfg_full, dtype, dev, mesh.make_mesh(2, 1, group))
            rec = phase10_hooks(engine, rank)
            zero_counts()
            zero_prng()
            for v in channel.values():
                v.clear()
            t0 = time.perf_counter()
            with DecodeSteps() as executed:
                if rank == 0:
                    with LeaderEngine(engine) as leader:
                        res, walls = phase10_scenario(leader, requests, rec, fault=True)
                else:
                    res, walls = {"followed": follow(engine)}, {}
            res.update(rec=rec, walls=walls, launches=attention.LAUNCHES,
                       prng=prng_counts(), executed=executed.steps,
                       draws_per_tail=prng_per_request(engine, 0)[0],
                       b1_per_request=b1_per_request(engine), wall=time.perf_counter() - t0,
                       device=engine.device.index, channel=channel_summary(channel))
            out[str(dtype)] = res
            del engine
            torch.cuda.empty_cache()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase10_codes(tails):
    """Each labelled batch's codes of every row, from the ranks' tails."""
    out = []
    for calls in zip(*tails):
        label, rows, codes, _ = calls[0]
        full = torch.full((codes.shape[0] if rows is None else rows.total, codes.shape[1]), -1,
                          dtype=codes.dtype)
        for _, rows, codes, _ in calls:
            full[slice(None) if rows is None else slice(rows.start, rows.stop)] = codes
        out.append((label, full))
    return out


def phase_frontends(cfg_full, logs):
    """Phase 10: the server, HTTP and long form over a (2 x 1) engine of two
    gloo ranks on the one card against the one-card front ends; returns the
    ranks' B1 launches."""
    import torch.multiprocessing as mp

    print("== the front ends over the sharded engine (two gloo ranks on the one card)",
          flush=True)
    print(f"  {smi('name,power.limit')}", flush=True)
    os.makedirs(logs)
    requests = phase10_requests(cfg_full)
    ref = {}
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        engine = phase10_engine(cfg_full, dtype, "cuda")
        rec = phase10_hooks(engine)
        zero_prng()
        with DecodeSteps() as executed:
            ref[str(dtype)] = phase10_scenario(engine, requests, rec, fault=False) + (rec,)
        sample_steps_gate(f"{dtype} one card", executed)
        del engine
        torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0
    t0 = time.perf_counter()
    # join=True raises unless both ranks exit 0
    mp.start_processes(phase10_rank, args=(free_port(), logs, cfg_full), nprocs=2,
                       join=True, start_method="spawn")
    t_ranks = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(logs, f"rank{r}.pt"), weights_only=False)
             for r in range(2)]

    def fmt(x):
        return "none" if x is None else f"{x:.3e}"

    b1 = 0
    for dtype in (torch.float32, torch.bfloat16):
        one, one_walls, one_rec = ref[str(dtype)]
        r0, r1 = ranks[0][str(dtype)], ranks[1][str(dtype)]
        want = r0["b1_per_request"]
        tails = phase10_codes([r0["rec"]["tails"], r1["rec"]["tails"]])
        for r, res in enumerate((r0, r1)):
            # a batch's launches: its decode's (the conditioning) and its tail's
            decodes = [n for *_, fault, n in res["rec"]["decodes"] if not fault]
            faulted = sum(n for *_, fault, n in res["rec"]["decodes"] if fault)
            per_batch = [d + n for d, (*_, n) in zip(decodes, res["rec"]["tails"])]
            print(f"  {dtype} rank {r}: B1 launches {res['launches']} over "
                  f"{len(per_batch)} batches ({per_batch}; expected {want} each) and the "
                  f"faulted batch's decode ({faulted})", flush=True)
            if (per_batch != [want] * len(tails) or len(decodes) != len(tails)
                    or res["launches"] != want * len(tails) + faulted):
                fail(f"phase 10 {dtype} rank {r}: B1 launches {per_batch}, expected {want} "
                     "a batch")
            b1 += res["launches"]
            # a sample step for each decode step executed (the faulted batch's
            # too); the threefry draws are the tails' only
            draws, buffers, steps = res["prng"]
            print(f"  {dtype} rank {r}: sample_step launches {steps} for {res['executed']} "
                  f"decode steps executed; threefry draws {draws} over {len(tails)} tails "
                  f"(expected {res['draws_per_tail']} each), key buffers {buffers}",
                  flush=True)
            if steps != res["executed"] or draws != res["draws_per_tail"] * len(tails):
                fail(f"phase 10 {dtype} rank {r}: launches {res['prng']}, decode steps "
                     f"{res['executed']}")
        threads = {name for name, *_ in r0["rec"]["decodes"]}
        cards = {card for _, card, *_ in r0["rec"]["decodes"] + r1["rec"]["decodes"]}
        if cards != {r0["device"]} or "tts-dispatch" not in threads:
            fail(f"phase 10 {dtype}: decodes ran on threads {threads}, cards {cards}")
        # each label's batches in order; "fault next" is the first pair again
        one_codes, codes = {}, {}
        for label, c in phase10_codes([one_rec["tails"]]):
            one_codes.setdefault(label, []).append(c)
        one_codes["fault next"] = one_codes["pairs"][:1]
        for label, c in tails:
            codes.setdefault(label, []).append(c)
        one = dict(one, **{"fault next": one["pairs"][:2]})
        for label in ("four", "pairs", "fault next", "http", "long"):
            a, b = codes.get(label, []), one_codes[label]
            if [x.shape for x in a] != [x.shape for x in b] or len(r0[label]) != len(
                    one[label]):
                fail(f"phase 10 {dtype} {label}: batches of {[x.shape for x in a]} codes and "
                     f"{len(r0[label])} outputs, one card {[x.shape for x in b]} and "
                     f"{len(one[label])}")
            same = torch.cat(a) == torch.cat(b)
            agree = float(same.float().mean())
            # the audio of an item whose codes all agree; an item with a
            # flipped code is another utterance from there on: read only
            rows = same.all(dim=1).tolist()
            if len(rows) != len(one[label]):  # long form: one wav of every row
                rows = [all(rows)] * len(one[label])
            werr, flipped = (wav_err([x for x, k in zip(r0[label], rows) if k == keep],
                                     [y for y, k in zip(one[label], rows) if k == keep])
                             if keep in rows else None for keep in (True, False))
            print(f"  {dtype} {label}: {len(a)} batch(es) of {[x.shape[0] for x in a]} rows, "
                  f"codes equal to one card's {agree:.4f} (items with every code equal "
                  f"{rows}), wav max |sharded - one card| / max |one card| of those "
                  f"{fmt(werr)} (gates {CODES_EQUAL[dtype]:g}, {WAV_TOL[dtype]:g}), of the "
                  f"others {fmt(flipped)} (read); wall "
                  f"{r0['walls'].get(label, math.nan):.3f} "
                  f"s (one card {one_walls.get(label, math.nan):.3f} s)", flush=True)
            if not (agree >= CODES_EQUAL[dtype] and werr is not None
                    and werr <= WAV_TOL[dtype]):
                fail(f"phase 10 {dtype} {label}: codes {agree}, wav {werr}")
        if (r0["four batches"], r0["pairs batches"]) != (1, 3):
            fail(f"phase 10 {dtype}: batches {r0['four batches']}, {r0['pairs batches']}")
        print(f"  {dtype} planted fault on rank 1: {r0['fault']}; the next batch resolved; "
              f"rank 1 followed {r1['followed']} calls; ranks' walls {r0['wall']:.1f} / "
              f"{r1['wall']:.1f} s; control channel on rank 0 {json.dumps(r0['channel'])}",
              flush=True)
        if not all(e and "rank 1: RuntimeError: a fault planted on rank 1" in e
                   and "rank 0:" not in e for e in r0["fault"]):
            fail(f"phase 10 {dtype}: the planted fault read {r0['fault']}")
    print(f"  phase 10: one-card references {t_ref:.1f} s, two ranks spawned, run and joined "
          f"in {t_ranks:.1f} s", flush=True)
    return b1


_T0 = time.perf_counter()


# ------------------------------------------------------- the worked examples

# each script's phase lines, as its JAX twin prints them
EXAMPLE_LINES = {
    "lifecycle_demo_torch.py": ("[1/4] prepare:", "[2/4] train vqvae:",
                                "[3/4] train gpt (grown from vqvae ckpt):", "[4/4] serve: wrote"),
    "prepare_demo_torch.py": ("[1/4] vad:", "[2/4] jsonl:", "[3/4] vq: encoded", "[4/4] batch:"),
    "demo_torch.py": ("demo_full.wav:", "demo_vq.wav:", "demo_long.wav:"),
}
EXAMPLE_COUNTS = "example launches: "


class DiffusionRequests:
    """While entered, counts the diffusion requests of every ``TTSEngine``
    (one ``diffuse`` call each) and the B1 launches they make
    (``b1_per_request`` of the engine's sampler, and by route
    ``b1_routes_per_request`` at the request's code bucket, the contextual
    embedder's at each prompt mel it conditions on)."""

    def _add(self, routes):
        for k, v in routes.items():
            self.routes[k] = self.routes.get(k, 0) + v

    def __enter__(self):
        from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
        from detail_tts_tpu_torch.serving.pipeline import TTSEngine
        self.requests, self.b1 = 0, 0
        self.routes = dict.fromkeys(attention.SERVE_ROUTES, 0)
        self._orig = orig = TTSEngine.diffuse
        self._orig_cond = orig_cond = SynthesizerTrn.diffusion_conditioning

        def counted(engine, latents, *args, **kwargs):
            self.requests += 1
            self.b1 += b1_per_request(engine)
            self._add(b1_routes_per_request(engine, latents.shape[1]))
            return orig(engine, latents, *args, **kwargs)

        def conditioned(model, refer_mel):
            self._add(b1_routes([embedder_call(model.diffusion, refer_mel.shape[1])],
                                refer_mel.dtype))
            return orig_cond(model, refer_mel)

        TTSEngine.diffuse = counted
        SynthesizerTrn.diffusion_conditioning = conditioned
        return self

    def __exit__(self, *exc):
        from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
        from detail_tts_tpu_torch.serving.pipeline import TTSEngine
        TTSEngine.diffuse = self._orig
        SynthesizerTrn.diffusion_conditioning = self._orig_cond


def run_example_counted(script, args):
    """``python3 chip_smoke.py --example SCRIPT ARGS...``: runs an example
    script in this process as ``__main__`` with its arguments, counting the
    decode steps it executed, its diffusion requests and the kernels'
    launches, and prints them as one JSON line after its own output."""
    import runpy
    sys.path.insert(0, os.path.dirname(os.path.abspath(script)))
    sys.argv = [script, *args]
    zero_routes()
    zero_prng()
    with DecodeSteps() as steps, DiffusionRequests() as diffusion:
        runpy.run_path(script, run_name="__main__")
    torch.cuda.synchronize()
    print(EXAMPLE_COUNTS + json.dumps(dict(
        b1=attention.LAUNCHES, b1_expected=diffusion.b1, diffusion_requests=diffusion.requests,
        b1_routes=route_counts(), b1_routes_expected=diffusion.routes,
        sample_step=sampling.LAUNCHES["sample_step"], decode_steps=steps.steps,
        threefry_draw=prng.LAUNCHES["threefry_draw"],
        threefry_keys=prng.LAUNCHES["threefry_keys"])), flush=True)


def run_example(name, args, timeout):
    """One example script in a subprocess on the card (through
    ``run_example_counted``): its exit code must be 0 and every phase line
    of ``EXAMPLE_LINES`` printed; its output is kept (printed here).  Returns
    (its launch counts, its wall seconds)."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--example",
                           os.path.join(here, "examples", name), *args], cwd=here,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    out = proc.stdout.strip().splitlines()
    print(f"  {name} exited {proc.returncode} in {wall:.1f} s; its stdout:\n    "
          + "\n    ".join(out[-20:]), flush=True)
    if proc.returncode != 0:
        print("    stderr ends: " + "\n    ".join(proc.stderr.strip().splitlines()[-20:]),
              flush=True)
        fail(f"examples/{name} exited {proc.returncode}")
    missing = [tag for tag in EXAMPLE_LINES[name] if not any(x.startswith(tag) for x in out)]
    if missing:
        fail(f"examples/{name} did not print {missing}")
    counts = [x for x in out if x.startswith(EXAMPLE_COUNTS)]
    if not counts:
        fail(f"examples/{name}: no launch counts")
    return json.loads(counts[-1][len(EXAMPLE_COUNTS):]), wall


def check_example_serving(name, counts, min_requests):
    """A serving script's gates: one ``sample_step`` launch a decode step
    executed, at least ``min_requests`` diffusion requests, and ``steps x
    13 + 9`` B1 launches each."""
    print(f"  {name}: {counts}", flush=True)
    if counts["sample_step"] != counts["decode_steps"] or counts["decode_steps"] == 0:
        fail(f"examples/{name}: {counts['sample_step']} sample_step launches for "
             f"{counts['decode_steps']} decode steps executed")
    if (counts["diffusion_requests"] < min_requests or counts["b1"] != counts["b1_expected"]
            or counts["b1_routes"] != counts["b1_routes_expected"]):
        fail(f"examples/{name}: {counts['b1']} B1 launches by route {counts['b1_routes']} for "
             f"{counts['diffusion_requests']} diffusion requests (expected at least "
             f"{min_requests}, and {counts['b1_expected']} launches by route "
             f"{counts['b1_routes_expected']})")


def phase_examples(cfg, root):
    """Phase 11: the three worked examples, the user's whole path at the
    full width of ``Config()``, each a subprocess on the card: three seeded
    recordings of speech-like noise; ``lifecycle_demo_torch.py`` (prepare,
    a 2-step ``vqvae`` stage, a ``gpt`` stage grown from it, batch 2, then
    the full diffusion path from the ``gpt`` checkpoint with default
    buckets); ``prepare_demo_torch.py`` with that checkpoint; ``demo_torch.py``
    with that checkpoint and a prepared clip as the prompt.  Gates: exit
    codes 0, every phase line, both checkpoints on disk, every wav finite
    and non-empty at 24 kHz, the ``.vq.npy`` codes in [0, codebook size),
    and in the serving parts one ``sample_step`` launch a decode step
    executed and ``steps x 13 + 9`` B1 launches a diffusion request, each
    on the route ``b1_routes_per_request`` gives.  Returns the B1 and
    sample-step launches and the B1 launches by route."""
    import pathlib
    from scipy.io import wavfile
    print("== the worked examples", flush=True)
    root = pathlib.Path(root)
    raw = root / "raw"
    raw.mkdir(parents=True)
    sr = cfg.data.sampling_rate
    rng = np.random.default_rng(11)
    for k in range(3):  # bursts of noise between 0.8 s silences, as tests/test_prepare.py
        sil = np.zeros(int(0.8 * sr), np.float32)
        parts = [sil]
        for _ in range(2):
            parts += [rng.uniform(-0.5, 0.5, int(rng.uniform(1.5, 3.0) * sr)).astype(
                np.float32), sil]
        wavfile.write(str(raw / f"rec{k}.wav"), sr,
                      (np.concatenate(parts) * 32767).astype(np.int16))
    walls = {}

    life = root / "lifecycle"
    counts, walls["lifecycle"] = run_example(
        "lifecycle_demo_torch.py", ["--in-dir", str(raw), "--work-dir", str(life),
                                    "--steps", "2"], timeout=900)
    check_example_serving("lifecycle_demo_torch.py", counts, 1)
    b1, samples, routes = counts["b1"], counts["sample_step"], dict(counts["b1_routes"])
    ckpts = {t: life / f"train_{t}" / "ckpt" for t in ("vqvae", "gpt")}
    for target, ckpt in ckpts.items():
        steps = sorted(int(d.name) for d in ckpt.iterdir()) if ckpt.is_dir() else []
        if not steps or not (ckpt / str(steps[-1]) / "state.pt").is_file():
            fail(f"the lifecycle's {target} checkpoint is not on disk")
    secs = check_wav(life / "lifecycle.wav", sr)
    print(f"  lifecycle: checkpoints {', '.join(str(c) for c in ckpts.values())}; "
          f"lifecycle.wav {secs:.2f} s", flush=True)

    prep = root / "prepare"
    counts, walls["prepare"] = run_example(
        "prepare_demo_torch.py", ["--in-dir", str(raw), "--work-dir", str(prep),
                                  "--ckpt", str(ckpts["gpt"])], timeout=600)
    if counts["b1"] or counts["sample_step"]:
        fail(f"prepare_demo_torch.py launched serving kernels: {counts}")
    codes = [np.load(f) for f in sorted((prep / "clips").glob("*.vq.npy"))]
    if not codes or any(c.size == 0 or c.min() < 0 or c.max() >= cfg.vaegan.vq_bins
                        for c in codes):
        fail(f"prepare_demo_torch.py: {len(codes)} .vq.npy files, not all non-empty with "
             f"codes in [0, {cfg.vaegan.vq_bins})")
    print(f"  prepare: {len(codes)} .vq.npy files, {sum(c.size for c in codes)} codes in "
          f"[0, {cfg.vaegan.vq_bins})", flush=True)

    demo = root / "demo"
    demo.mkdir()
    prompt = sorted((life / "clips").glob("*.wav"))[0]
    counts, walls["demo"] = run_example(
        "demo_torch.py", ["--prompt", str(prompt), "--ckpt", str(ckpts["gpt"]),
                          "--out-dir", str(demo)], timeout=900)
    # the full path's, and long form's a batch of its chunks (the VQ path runs none)
    check_example_serving("demo_torch.py", counts, 2)
    b1, samples = b1 + counts["b1"], samples + counts["sample_step"]
    routes = {k: routes.get(k, 0) + counts["b1_routes"].get(k, 0)
              for k in {**routes, **counts["b1_routes"]}}
    secs = {n: check_wav(demo / n, sr)
            for n in ("demo_full.wav", "demo_vq.wav", "demo_long.wav")}
    print(f"  demo: {secs} (s); prompt {prompt.name}", flush=True)
    print(f"  example walls (s): {walls}; B1 launches by route {routes}", flush=True)
    return b1, samples, routes


def stamp():
    """The seconds since the script started, after each phase."""
    print(f"-- {time.perf_counter() - _T0:.1f} s", flush=True)


def main():
    from detail_tts_tpu_torch.config import Config
    from detail_tts_tpu_torch.serving.pipeline import EngineConfig, random_engine

    sfu_per_s = phase_environment()
    stamp()
    phase_build()
    stamp()
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
    # timed: the trunk at b2 (serve_fwd_wgmma), the contextual embedder
    # (serve_fwd_wgmma<96>), the latent conditioner at code bucket 100
    # (serve_fwd_mma)
    conditioner_100 = (2, 100, cfg.diffusion.num_heads, served[2][3])
    worst, times = phase_kernel(sfu_per_s, served + [conditioner_100],
                                timed_shapes=[served[1], served[3], conditioner_100])
    stamp()
    prng_abs, prng_ulp, prng_times, keys_times = phase_prng()
    stamp()
    sample_tally, sample_times = phase_sample()
    stamp()
    train_worst, train_times, backend = phase_train_kernels(sfu_per_s)
    stamp()

    t0 = time.perf_counter()
    engine = random_engine(cfg, seed=0, engine_cfg=ecfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.model.parameters())
    print(f"== engine: Config() at full width, {n_params / 1e6:.1f} M parameters "
          f"{engine.cdt}, built in {time.perf_counter() - t0:.1f} s", flush=True)
    launches, per_request, records, prng_launches, routes_per_request = phase_serving(
        engine, requests)
    stamp()
    phase_sample_decode(engine, cfg, texts, prompts, sample_tally)
    stamp()
    sample_launches = prng_counts()[2]  # the b8 decode's
    paths_launches, paths_prng = phase_serving_paths(engine, texts, prompts, records)
    launches += paths_launches
    stamp()
    del engine
    torch.cuda.empty_cache()

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        train_launches = phase_training(cfg, os.path.join(work, "phase6"))
        stamp()
        target_launches = phase_train_targets(cfg, os.path.join(work, "phase6b"))
        stamp()
        corpus_launches, corpus_b1 = phase_corpus(cfg, os.path.join(work, "phase7"))
        stamp()
        parallel_launches, diff_ref = phase_parallel(cfg, os.path.join(work, "phase8"))
        stamp()
        mesh_b1, mesh_launches = phase_mesh(cfg, diff_ref, os.path.join(work, "phase9"))
        stamp()
        frontends_b1 = phase_frontends(cfg, os.path.join(work, "phase10"))
        stamp()
        examples_b1, examples_samples, examples_routes = phase_examples(
            cfg, os.path.join(work, "phase11"))
        stamp()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # B1's kernels on the main path, by the route (and head dim) each launch
    # took: this process's serving launches from phase 4 on and the
    # examples' (phase 11); serve_fwd_wgmma at the trunk's d = 48 and at the
    # contextual embedder's d = 96 apart (each instantiation its own launches)
    here = route_counts()
    by_route = {k: here.get(k, 0) + examples_routes.get(k, 0)
                for k in {**here, **examples_routes}}
    d = cfg.diffusion.model_channels // cfg.diffusion.num_heads
    kernels = []
    for name, key, what in (
            ("serve_fwd_wgmma", f"serve_fwd_wgmma<{d}>",
             "bf16 at d <= 64 and T % 8 == 0: the trunk, the integrator and the latent "
             "conditioner at a code bucket that is a multiple of 8"),
            ("serve_fwd_wgmma<96>", f"serve_fwd_wgmma<{2 * d}>",
             "bf16 at d = 96 and T % 8 == 0: the contextual embedder at every prompt "
             "bucket (T = bucket / 4)"),
            ("serve_fwd_mma", "serve_fwd_mma",
             "the other bf16 calls, T % 8 != 0: the latent conditioner at code buckets of "
             "100, 300, 500")):
        if by_route.get(key, 0) == 0:
            fail(f"B1's kernel {name} was launched no time on the main path")
        kernels.append(dict(
            name=name, route="cuda", source="detail_tts_tpu_torch/csrc/bias_attention.cu",
            replaces="detail_tts_tpu/ops/pallas/attention.py:404",
            entry="bias_attention_fwd", takes=what, launches=by_route[key],
            launches_by_route_and_head_dim={k: v for k, v in by_route.items() if "<" in k},
            launches_over="every serving launch of this process from phase 4 on (phases "
                          "4, 4b, 7 and the one-card references of phases 9 and 10) and "
                          "the examples' requests (phase 11)",
            launches_per_request=routes_per_request.get(key, 0),
            b1_launches_per_request=per_request,
            b1_launches_all_phases=launches + corpus_b1 + mesh_b1 + frontends_b1
            + examples_b1,
            max_abs_err=worst, **times[name]))
    for i, (name, row, replaces, per) in enumerate((
            ("threefry_draw", prng_times, "detail_tts_tpu/models/diffusion.py:285",
             "steps + 1 a request under ancestral (the diffusion's initial noise, a "
             "normal an ancestral step but the last, the vocoder's), 2 under the other "
             "samplers, 1 on the VQ path; none in the decode"),
            ("threefry_keys", keys_times, "detail_tts_tpu/models/gpt.py:358",
             "2 a request: the decode's key chain, the ancestral steps' split"))):
        kernels.append(dict(
            name=name, route="cuda", source="detail_tts_tpu_torch/csrc/threefry.cu",
            replaces=replaces, launches=prng_launches[i] + paths_prng[i],
            launches_per_request=per,
            launches_over="phases 4 and 4b (every request, server, long form and HTTP)",
            max_abs_err=prng_abs if i == 0 else 0.0, max_ulp=prng_ulp if i == 0 else 0.0,
            library="none draws JAX's threefry", **row))
    sample_row = next(t for t in sample_times if t["shape"] == [8, 8194]
                      and t["setting"] == "top-p")
    kernels.append(dict(
        name="sample_step", route="cuda", source="detail_tts_tpu_torch/csrc/sample.cu",
        replaces="detail_tts_tpu/ops/sampling.py:86 sample_token and "
                 "detail_tts_tpu/models/gpt.py:364-371 body_fn's bookkeeping (no pallas_call)",
        launches=prng_launches[2] + sample_launches + paths_prng[2] + examples_samples,
        launches_per_request="one a decode step executed (max_len under force_full)",
        launches_over="phases 4 and 4b (every request, server, long form and HTTP), "
                      "phase 3c's b8 decode and the examples' decodes (phase 11); phases "
                      "9 and 10 gate each rank's",
        max_abs_err=sample_tally.max_abs, rows_compared=sample_tally.rows,
        rows_differ=sample_tally.differ,
        wide=[{k: t[k] for k in ("shape", "setting", "ms", "device_ms", "bound_ms",
                                 "bound_share", "wide_ctas", "wide_groups", "wide_cache")}
              for t in sample_times if t["shape"][1] > 65536],
        library="none", **sample_row))
    name = "bias_attention_bwd_dbias_sum"
    kernels.append(dict(
        name=name, route="cuda", source="detail_tts_tpu_torch/csrc/bias_attention_bwd.cu",
        replaces="detail_tts_tpu/ops/pallas/attention.py:286",
        launches=(train_launches[name] + target_launches[name] + corpus_launches[name]
                  + parallel_launches[name] + mesh_launches[name]),
        launches_over=f"{PHASE6_STEPS}, 2 all steps (phase 6b), 6 diff steps "
                      "from the corpus in this process (phase 7: trainer A's 5, R's 1), "
                      "in phase 8 the world-1 NCCL Trainer's 2 diff and 2 all steps "
                      "and both world-2 ranks' 2 diff steps, and both (1 x 2) ranks' "
                      "diff step (phase 9)",
        max_abs_err=train_worst[name][0], max_scaled_err=train_worst[name][1],
        library="torch.sum over the batch", **train_times[name]))
    # kernel 4's bf16 kernels, by the route each launch took; the wgmma kernel
    # at the trunk's d = 48 and at the contextual embedder's d = 96 apart
    for name, route, dim, what in (
            ("train_fwd_wgmma", "train_fwd_wgmma", d,
             "bf16 at d <= 64 and T % 4 == 0 on grids of at least half the SMs: at "
             "micro-batch 8 the trunk, the integrator and the latent conditioner"),
            (TRAIN_FWD_WGMMA_96, "train_fwd_wgmma", 2 * d,
             "bf16 at d = 96 and T % 4 == 0: the contextual embedder at a 496-frame prompt "
             "(T = 124)"),
            ("train_fwd_mma", "train_fwd_mma", None,
             "the other bf16 calls: T % 4 != 0 (the latent conditioner and the contextual "
             "embedder at the 500-frame crop's T = 125, the latent conditioner at 706 "
             "codes), smaller grids at d <= 64")):
        n = ROUTE_LAUNCHES[route] if dim is None else ROUTE_LAUNCHES.get((route, dim), 0)
        if n == 0:
            fail(f"the training forward's kernel {name} was launched no time on the main path")
        kernels.append(dict(
            name=name, route="cuda", source="detail_tts_tpu_torch/csrc/bias_attention.cu",
            replaces="detail_tts_tpu/ops/pallas/attention.py:259",
            entry="bias_attention_train_fwd", takes=what, launches=n,
            launches_by_head_dim={str(k[1]): v for k, v in ROUTE_LAUNCHES.items()
                                  if isinstance(k, tuple) and k[0] == route
                                  and dim in (None, k[1])},
            launches_over=TRAIN_LAUNCHES_OVER,
            max_abs_err=train_worst[name][0], max_scaled_err=train_worst[name][1],
            library="scaled_dot_product_attention (" + backend + ")",
            **train_times[name]))
    # the backward's two kernels of each bf16 route, launched once each a
    # call; the wgmma kernels at the trunk's d = 48 and at the contextual
    # embedder's d = 96 apart (each instantiation its own launches)
    for route, names, dim, what in (
            ("bwd_wgmma", attention.BWD_ROUTE_KERNELS["bwd_wgmma"], d,
             "bf16 at d <= 64 and T % 4 == 0: the trunk, the integrator and the latent "
             "conditioner"),
            ("bwd_wgmma", BWD_WGMMA_96, 2 * d,
             "bf16 at d = 96 and T % 4 == 0: the contextual embedder at a 496-frame prompt "
             "(T = 124)"),
            ("bwd_mma", attention.BWD_ROUTE_KERNELS["bwd_mma"], None,
             "the other bf16 calls, T % 4 != 0: the latent conditioner and the contextual "
             "embedder (d = 96) at the 500-frame crop (T = 125), the latent conditioner "
             "at 706 codes")):
        n = ROUTE_LAUNCHES[route] if dim is None else ROUTE_LAUNCHES.get((route, dim), 0)
        if ROUTE_LAUNCHES[route] == 0:
            fail(f"the backward's route {route} was launched no time on the main path")
        if n == 0:
            fail(f"the backward's kernels {names} were launched no time on the main path")
        by_dim = {str(k[1]): v for k, v in ROUTE_LAUNCHES.items()
                  if isinstance(k, tuple) and k[0] == route and dim in (None, k[1])}
        for kernel, line in zip(names, (286, 308)):
            kernels.append(dict(
                name=kernel, route="cuda",
                source="detail_tts_tpu_torch/csrc/bias_attention_bwd.cu",
                replaces=f"detail_tts_tpu/ops/pallas/attention.py:{line}",
                entry="bias_attention_bwd_dq" if line == 286 else "bias_attention_bwd_dkv",
                takes=what, launches=n, launches_by_head_dim=by_dim,
                launches_over=TRAIN_LAUNCHES_OVER,
                max_abs_err=train_worst[kernel][0], max_scaled_err=train_worst[kernel][1],
                library="scaled_dot_product_attention (" + backend + ") backward",
                **train_times[kernel]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--example"]:
        run_example_counted(sys.argv[2], sys.argv[3:])
    else:
        main()
