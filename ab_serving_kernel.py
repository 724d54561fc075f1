"""Time the bf16 serving kernel ``bias_attention_fwd``, or with ``--train``
the bf16 training forward ``bias_attention_train_fwd`` or the training
backward, or with ``--sample`` the decode step's sampler ``sample_step``,
of several sources in turns on one GPU.

    python3 ab_serving_kernel.py LABEL=path/to/bias_attention.cu [...] \\
        [--train] [--cold] [--shape B T H D ...] [--runs 50]
    python3 ab_serving_kernel.py --train LABEL=path/to/bias_attention_bwd.cu [...] \\
        [--variants] [--cold] [--shape B T H D ...] [--runs 50]
    python3 ab_serving_kernel.py --host LABEL=path/to/checkout [...] \\
        [--train] [--shape B T H D ...] [--runs 50]
    python3 ab_serving_kernel.py --sample LABEL=path/to/sample.cu [...] \\
        [--shape B V ...] [--runs 50]

Each source is built at once with the package's nvcc flags (it includes the
``mma.cuh`` beside it), loaded with ctypes, checked once against the plain
PyTorch version, and timed in turns (the labels in the order given, then in
reverse: A B B A for two) as bare launches on buffers allocated beforehand,
both with CUDA events around each launch (median of ``--runs``) and by the
profiler's device time (mean of ``--runs``; no host time).  Default shapes:
the diffusion trunk at batch 8 and 400 codes, B=16, T=1600, H=16, d=48, the
integrator there (B=9) and the trunk at batch 2 and 200 codes, (4, 800, 16,
48);
with ``--train`` the training step's three, (8, 496, 16, 48), (8, 124, 16,
48) and (8, 124, 16, 96).  With ``--train`` ``out`` is checked against the
plain version's and ``lse`` against ``bias_attention_train_reference``'s,
and the package's own wrapper ``bias_attention_train_fwd`` (its checks,
allocations and ctypes call) is timed beside the bare launches.  With
``--cold`` every timed launch follows a write of 256 MB, so that its inputs
come from HBM rather than L2, as in a training step, and only the device
time is taken (of the kernel alone).  Prints the
card's name and power limit first, the ``ptxas -v`` lines of each source's
d=48 and d=96 kernels, and one JSON object last.  Needs a CUDA device.

With ``--host`` each source is the root of a checkout of the repo (this
one, or an earlier commit's ``git archive`` unpacked under ``build/``),
and the host's share of a serving call is timed: in turns (A B B A), a
process that imports that checkout's ``detail_tts_tpu_torch`` makes
``--runs`` calls back to back, without a synchronisation between them
(the card's queue takes them all), of the package's wrapper
``attention.bias_attention`` and of its bare C entry ``bias_attention_fwd``
through ctypes, at each shape; each prints the median of 7 such loops in
host microseconds a call.  With ``--host --train`` the calls are the
training backward's (the wrapper ``attention.bias_attention_bwd`` and its
three bare C entries) and the training forward's (the wrapper
``attention.bias_attention_train_fwd`` and its bare C entry
``bias_attention_train_fwd``), at the step's shapes.

With ``--train`` and sources named ``bias_attention_bwd*.cu`` (this
package's, or an earlier one from ``git show
<commit>:detail_tts_tpu_torch/csrc/bias_attention_bwd.cu`` with its
``mma.cuh`` and ``hopper.cuh`` beside it under ``build/``) the backward is
timed instead: at each shape (default ``BWD_SHAPES``: the step's three and
the raw bucket (8, 1024, 16, 48)) each source's C entries
``bias_attention_bwd_dq`` (delta, dq, the dbias partials), ``_dkv`` and
``_dbias_sum`` are launched on buffers allocated beforehand, the d(qkv)
and dbias they give held against ``bias_attention_bwd_reference`` once,
and each entry and the three together (``all``) timed in turns by the
profiler's device time (and CUDA events when warm), the package's own
wrapper ``bias_attention_bwd`` beside them; the route the package's C
entry ``bias_attention_bwd_route`` names for each shape is printed.  With
``--variants [LABEL ...]`` each backward source (or those named) also gives two copies under
``build/variants/LABEL/`` that are timed in turns with it and not checked:
``LABEL-noproducts``, whose products (mma.sync or wgmma) are a single
dependent add (the copies, exp2 and stores stay), ``LABEL-nocopies``,
whose tile copies into shared memory (cp.async, TMA, bulk) and dbias
partial stores are gone (the products and exp2 stay, on whatever shared
memory holds), and ``LABEL-nostores``, whose partial stores alone are
gone: what holds the kernel, the arithmetic or the bytes.  With ``--train``
on forward sources ``--variants`` gives ``LABEL-noproducts``, ``LABEL-nobias``
(the fp32 bias tile's copies alone gone) and ``LABEL-nocopies`` (every copy
into shared memory gone: K, V, Q and the bias, by ``cp.async`` or TMA),
timed in turns with the source, their errors printed and not checked.

With ``--sample`` each source is a ``sample.cu`` with ``threefry.cuh``
beside it and the package's C entries ``sample_step`` and
``sample_step_floor`` (this package's, or an earlier one from ``git show
<commit>:detail_tts_tpu_torch/csrc/sample.cu`` under ``build/``).  At each
(B, V) (default ``SAMPLE_AB_SHAPES``: (1, 2, 8, 16) x 8194 on the shared
path, then the wide path's (1, 65537), (2, 131073), (1, 1048579) and (1,
8388609)) and setting (top-p, top-p and typical, both off:
``chip_smoke.SAMPLE_SETTINGS``) on fp32 logits, each source's tokens are
checked once against ``sample_step_reference``, then its bare launches are
timed in turns, and the floor (its empty kernel on its cluster grid, back
to back); a source with ``sample_step_wide_shape`` also reports each wide
launch's G, groups in flight and cached tokens a CTA.

With ``--sample --trace`` each source (a ``sample.cu`` of this package's
wide kernel) is copied under ``build/trace/LABEL/`` with ``SAMPLE_TRACE``
defined, which turns on its ``clock64`` stamps of CTA 0's thread 0 at the
wide kernel's phases (the first read, each arrival at and release from a
group barrier, the end of each radix sweep, the draw), built, launched at
each wide (B, V) and setting after three warm-up launches, and each
phase's SM cycles printed: where one step's time goes, which no profiler
here reaches.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (SAMPLE_SETTINGS, attention_inputs, cuda_ms,  # noqa: E402
                        device_ms, sample_inputs, scaled_err, smi, train_inputs)
from detail_tts_tpu_torch.ops import attention, sampling  # noqa: E402

TRAIN_SHAPES = [(8, 496, 16, 48), (8, 124, 16, 48), (8, 124, 16, 96)]
SERVE_SHAPES = [(16, 1600, 16, 48), (9, 1600, 16, 48), (4, 800, 16, 48)]
# the backward's: the training step's three and the corpus's raw bucket 1024
BWD_SHAPES = TRAIN_SHAPES + [(8, 1024, 16, 48)]
BWD_ENTRIES = ("bias_attention_bwd_dq", "bias_attention_bwd_dkv", "bias_attention_bwd_dbias_sum")
# what each timed row launches: an entry, or the three in turn
BWD_RUNS = {**{entry: (entry,) for entry in BWD_ENTRIES}, "all": BWD_ENTRIES}
# the device-time filter of each backward entry's kernels
BWD_KERNEL_NAMES = {"bias_attention_bwd_dq": ("bwd_dq",), "bias_attention_bwd_dkv": ("bwd_dkv",),
                    "bias_attention_bwd_dbias_sum": ("dbias_sum",)}
# --sample's default shapes: the decode's V on the shared path, then the wide
# path's (one token past it, 2^17 + 1, and V in the millions, which no
# configuration of the repo sends)
SAMPLE_AB_SHAPES = [(1, 8194), (2, 8194), (8, 8194), (16, 8194), (1, 65537), (2, 131073),
                    (1, 1048579), (1, 8388609)]


def ptxas_lines(log: str, keep) -> list:
    """The ``ptxas -v`` resource lines of the kernels whose names ``keep``."""
    lines, name = [], ""
    for line in log.splitlines():
        if "entry function" in line:
            name = line.split("'")[1]
        elif keep(name) and ("registers" in line or "spill" in line):
            lines.append(f"{name[:80]}: {line.split(':', 1)[-1].strip()}")
    return lines


def load(source: Path, entry: str):
    """Build ``source`` and return (its C entry ``entry``, ptxas lines)."""
    path, _, log = attention.build(source)
    fn = getattr(ctypes.CDLL(str(path)), entry)
    fn.argtypes = attention._SIGNATURES[attention.SOURCE][entry]
    fn.restype = ctypes.c_int
    return fn, ptxas_lines(log, lambda name: "Li48E" in name or "Li96E" in name)


def load_bwd(source: Path):
    """Build a backward source: ({entry: C function}, ptxas lines)."""
    path, _, log = attention.build(source)
    lib = ctypes.CDLL(str(path))
    fns = {}
    for entry in BWD_ENTRIES:
        fn = getattr(lib, entry)
        fn.argtypes = attention._SIGNATURES[attention.BWD_SOURCE][entry]
        fn.restype = ctypes.c_int
        fns[entry] = fn
    return fns, ptxas_lines(log, lambda name: "Li48E" in name or "Li96E" in name)


# --variants: (label suffix, [(text, replacement)], declarations added after
# the includes).  Each replacement applies where its text occurs (the
# mma.sync kernels' texts in a parent's source, the wgmma kernels' too in
# this package's); a variant that applies none is skipped.
_FAKES = """
#include "hopper.cuh"
// (timing variants) a product as one dependent add of its operands; copies
// and stores that move nothing (a stage's barrier completes at once)
__device__ __forceinline__ void fake_mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  d[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) & 0x3f800000u);
}
__device__ __forceinline__ void fake_ss(float (&d)[32], uint64_t a, uint64_t b, int) {
  d[0] += __uint_as_float((uint32_t)(a ^ b) & 0x3f800000u);
}
template <int N>
__device__ __forceinline__ void fake_ss_n(float (&d)[N / 2], uint64_t a, uint64_t b, int) {
  d[0] += __uint_as_float((uint32_t)(a ^ b) & 0x3f800000u);
}
template <int N>
__device__ __forceinline__ void fake_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  d[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ (uint32_t)b) & 0x3f800000u);
}
template <int D, int ROWS = 64>
__device__ __forceinline__ void fake_copy_tile(attn::bf16*, const attn::bf16*, int, int, long) {}
template <int LDB>
__device__ __forceinline__ void fake_copy_bias_tile(float*, const float*, int, int, int, bool) {}
template <int ROWS, int W>
__device__ __forceinline__ void fake_copy_bias_f32(float*, const float*, int, int, int) {}
__device__ __forceinline__ void fake_cp4(void*, const void*, bool) {}
__device__ __forceinline__ void fake_cp16(void*, const void*, bool) {}
__device__ __forceinline__ void fake_tma_load_3d(void*, const CUtensorMap*, uint64_t*, int, int,
                                                 int) {}
__device__ __forceinline__ void fake_tma_load_2d(void*, const CUtensorMap*, uint64_t*, int, int) {}
__device__ __forceinline__ void fake_bulk_load(void*, const void*, uint32_t, uint64_t*) {}
__device__ __forceinline__ void fake_expect_tx(uint64_t* bar, uint32_t) {
  hopper::mbar_arrive(bar);
}
"""
_STORES = [("*reinterpret_cast<float2*>(prow0 + col) = make_float2(s[n][0], s[n][1]);", ""),
           ("*reinterpret_cast<float2*>(prow1 + col) = make_float2(s[n][2], s[n][3]);", ""),
           ("tma_store_3d(&part_map, st, j * BK, q0, b * heads + h);", ""),
           ("tma_store_3d(&part_map, st + kBiasBox * 4, j * BK + 32, q0, b * heads + h);", "")]
VARIANTS = (
    ("noproducts", [("mma_bf16(", "fake_mma_bf16("), ("wgmma_m64n64k16_ss(", "fake_ss("),
                    ("wgmma_ss<QH>(", "fake_ss_n<QH>("), ("wgmma_rs<D>(", "fake_rs<D>(")]),
    ("nocopies", [("copy_tile<", "fake_copy_tile<"), ("copy_bias_tile<", "fake_copy_bias_tile<"),
                  ("cp_async_4(Ls", "fake_cp4(Ls"), ("cp_async_4(Dl", "fake_cp4(Dl"),
                  ("tma_load_3d(", "fake_tma_load_3d("), ("bulk_load(", "fake_bulk_load("),
                  ("mbar_expect_tx(", "fake_expect_tx(")] + _STORES),
    ("nostores", _STORES),
)
# the training forward's (bias_attention.cu): its products, its fp32 bias
# copies alone, or every copy (K, V, Q and the bias) taken out
FWD_VARIANTS = (
    ("noproducts", VARIANTS[0][1]),
    ("nobias", [("copy_bias_f32<", "fake_copy_bias_f32<"),
                ("mbar_expect_tx(&full[s], L::STAGE);\n    tma_load_3d(st, bmap",
                 "mbar_expect_tx(&full[s], L::STAGE - 2 * L::BIAS_BOX);\n    "
                 "tma_load_3d(st, bmap"),
                ("tma_load_3d(st, bmap", "fake_tma_load_3d(st, bmap"),
                ("tma_load_3d(st + L::BIAS_BOX, bmap", "fake_tma_load_3d(st + L::BIAS_BOX, bmap")]),
    ("nocopies", [("copy_tile<", "fake_copy_tile<"), ("copy_bias_f32<", "fake_copy_bias_f32<"),
                  ("cp_async_16(st + ", "fake_cp16(st + "), ("tma_load_3d(", "fake_tma_load_3d("),
                  ("tma_load_2d(", "fake_tma_load_2d("), ("mbar_expect_tx(", "fake_expect_tx(")]),
)


def variant_sources(label: str, path: Path, variants=VARIANTS):
    """Step 0's variants of a source (``VARIANTS`` of a backward one,
    ``FWD_VARIANTS`` of a forward one): [(label, path)] under
    ``build/variants/LABEL/``, the source's headers copied beside each."""
    text = path.read_text()
    include = '#include "mma.cuh"\n'
    out = []
    for suffix, edits in variants:
        body = text
        for old, new in edits:
            body = body.replace(old, new)
        if body == text:
            print(f"  --variants: {path} has none of {suffix}'s texts: no {label}-{suffix}")
            continue
        body = body.replace(include, include + _FAKES, 1)
        folder = Path("build") / "variants" / f"{label}-{suffix}"
        folder.mkdir(parents=True, exist_ok=True)
        for header in ("mma.cuh", "hopper.cuh"):
            if (path.parent / header).is_file():
                shutil.copy(path.parent / header, folder / header)
        (folder / path.name).write_text(body)
        out.append((f"{label}-{suffix}", folder / path.name))
    return out


# --host: one checkout's host microseconds a serving call, in a process of
# its own (argv: checkout root, shapes as JSON, calls a loop)
HOST_CHILD = r"""
import json, math, statistics, sys, time
root, shapes, runs = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3])
train = len(sys.argv) > 4 and sys.argv[4] == "train"
sys.path.insert(0, root)
import torch
from detail_tts_tpu_torch.ops import attention


def train_row(b, t, h, d):
    # the training backward: the package's wrapper, and its three bare C
    # entries on buffers allocated beforehand; the training forward's wrapper
    # and bare C entry
    g = torch.Generator(device="cuda").manual_seed(7)
    qkv = torch.randn((b, t, 3 * h * d), device="cuda", generator=g).to(torch.bfloat16)
    bias = torch.randn((h, t, t), device="cuda", generator=g)
    dout = torch.randn((b, t, h * d), device="cuda", generator=g).to(torch.bfloat16)
    sm = 1 / math.sqrt(d)
    out, lse = attention.bias_attention_train_fwd(qkv, bias, heads=h, sm_scale=sm)
    tp = attention.padded_len(t)
    delta = torch.empty((b, h, t), device="cuda")
    part = torch.empty((b, h, tp, tp), device="cuda")
    dqkv, dbias = torch.empty_like(qkv), torch.empty((h, t, t), device="cuda")
    lib = attention._library(attention.BWD_SOURCE)
    stream = torch.cuda.current_stream().cuda_stream
    scales = (sm * attention.LOG2E, attention.LOG2E, sm, 0, stream)

    def wrapper():
        attention.bias_attention_bwd(qkv, bias, out, lse, dout, heads=h, sm_scale=sm)

    def entry():
        rc = (lib.bias_attention_bwd_dq(qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(),
                                        out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                        dqkv.data_ptr(), part.data_ptr(), b, t, h, d, *scales)
              or lib.bias_attention_bwd_dkv(qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(),
                                            lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(),
                                            b, t, h, d, *scales)
              or lib.bias_attention_bwd_dbias_sum(part.data_ptr(), dbias.data_ptr(), b, t,
                                                  h, stream))
        if rc != 0:
            raise RuntimeError("a backward entry failed")

    fwd = attention._library(attention.SOURCE)
    out_t, lse_t = torch.empty_like(out), torch.empty_like(lse)

    def fwd_wrapper():
        attention.bias_attention_train_fwd(qkv, bias, heads=h, sm_scale=sm)

    def fwd_entry():
        if fwd.bias_attention_train_fwd(qkv.data_ptr(), bias.data_ptr(), out_t.data_ptr(),
                                        lse_t.data_ptr(), b, t, h, d, sm * attention.LOG2E,
                                        attention.LOG2E, 0, stream) != 0:
            raise RuntimeError("bias_attention_train_fwd failed")

    return dict(wrapper_us=wrapper, entry_us=entry, fwd_wrapper_us=fwd_wrapper,
                fwd_entry_us=fwd_entry)


def serve_row(b, t, h, d):
    # a serving call: the package's wrapper, and its bare C entry
    g = torch.Generator(device="cuda").manual_seed(7)
    qkv = torch.randn((b, t, 3 * h * d), device="cuda", generator=g).to(torch.bfloat16)
    bias = torch.randn((h, t, t), device="cuda", generator=g).to(torch.bfloat16)
    out = torch.empty((b, t, h * d), dtype=torch.bfloat16, device="cuda")
    lib = attention._library(attention.SOURCE)
    args = (qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), b, t, h, d,
            attention.LOG2E / math.sqrt(d), 0, torch.cuda.current_stream().cuda_stream)

    def wrapper():
        attention.bias_attention(qkv, bias, heads=h, sm_scale=1 / math.sqrt(d))

    def entry():
        if lib.bias_attention_fwd(*args) != 0:
            raise RuntimeError("bias_attention_fwd failed")

    return dict(wrapper_us=wrapper, entry_us=entry)


rows = []
for b, t, h, d in shapes:
    fns = (train_row if train else serve_row)(b, t, h, d)
    row = dict(shape=[b, t, h, d], source=attention.__file__)
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        loops = []
        for _ in range(7):
            t0 = time.perf_counter()
            for _ in range(runs):
                fn()
            loops.append((time.perf_counter() - t0) / runs * 1e6)
            torch.cuda.synchronize()
        row[name] = statistics.median(loops)
    rows.append(row)
print("HOST " + json.dumps(rows))
"""


def host_main(args, labels, roots):
    """--host: the host microseconds a serving call (with --train a training
    backward call) of each checkout, in turns."""
    shapes = args.shape or (TRAIN_SHAPES if args.train else SERVE_SHAPES)
    got = {label: [] for label in labels}
    for label, root in list(zip(labels, roots)) + list(zip(labels, roots))[::-1]:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", HOST_CHILD, root, json.dumps(shapes),
                               str(args.runs), "train" if args.train else "serve"],
                              cwd=root, capture_output=True, text=True)
        line = next((x for x in proc.stdout.splitlines() if x.startswith("HOST ")), None)
        if proc.returncode != 0 or line is None:
            sys.exit(f"--host {label}: the timing process failed ({proc.returncode}):\n"
                     f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        got[label].append(json.loads(line[5:]))
    results = []
    for i, (b, t, h, d) in enumerate(shapes):
        row = dict(shape=[b, t, h, d], calls_a_loop=args.runs)
        for label in labels:
            keys = [k for k in got[label][0][i] if k.endswith("_us")]
            row[label] = {k: [turn[i][k] for turn in got[label]] for k in keys}
            print(f"  B={b} T={t} H={h} d={d}: {label} host us a call: "
                  + "; ".join(f"{k[:-3]} " + ", ".join(f"{x:.2f}" for x in row[label][k])
                              for k in keys)
                  + f" ({got[label][0][i]['source']})", flush=True)
        results.append(row)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "host": results}))


def load_sample(path: str):
    """Build a ``sample.cu``: (launch(args), floor(b), ptxas lines, the wide
    launch's (G, groups, cached tokens a CTA) at (b, v), or None where the
    source has no ``sample_step_wide_shape``)."""
    lib_path, _, log = attention.build(Path(path))
    lib = ctypes.CDLL(str(lib_path))
    for name in ("sample_step", "sample_step_floor"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = sampling._SIGNATURES[name], ctypes.c_int
    shape_fn = getattr(lib, "sample_step_wide_shape", None)
    if shape_fn is not None:
        shape_fn.argtypes = sampling._SIGNATURES["sample_step_wide_shape"]
        shape_fn.restype = ctypes.c_int

    def launch(args):
        rc = lib.sample_step(*args)
        if rc != 0:
            raise RuntimeError(f"sample_step of {path} failed ({rc})")

    def floor(b):
        rc = lib.sample_step_floor(b, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"sample_step_floor of {path} failed ({rc})")

    def wide_shape(b, v):
        if shape_fn is None or v <= 65536:
            return None
        out = [ctypes.c_int() for _ in range(3)]
        rc = shape_fn(v, b, 1, *(ctypes.byref(o) for o in out))
        if rc != 0:
            raise RuntimeError(f"sample_step_wide_shape of {path} failed ({rc})")
        return tuple(o.value for o in out)

    return launch, floor, ptxas_lines(log, lambda name: "sample_step_kernel" in name), wide_shape


def sample_case(b, v, setting):
    """(the C entry's arguments, check(launch)) at one shape and setting:
    fp32 logits, force_full, the step's state updated in place by every
    timed launch as in a decode."""
    x, seen, codes, lengths, finished, step, key = sample_inputs(b, v, torch.float32, 77)
    t, top_p, pen, mass = setting
    kw = dict(temperature=t, top_p=top_p, repetition_penalty=pen, typical_mass=mass,
              stop_token=v - 1, force_full=True)
    tok = torch.empty(b, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def args(state):
        return [x.data_ptr(), 1, *(a.data_ptr() for a in state), tok.data_ptr(),
                key.data_ptr(), b, v, codes.shape[1], step, int(pen != 1.0), pen,
                int(t != 1.0), t, int(mass < 1.0), float(np.float32(mass)), int(top_p < 1.0),
                float(np.float32(1.0 - top_p)), v - 1, 1, 0, stream]

    def check(launch):
        """Rows whose token differs from the plain version's."""
        mine = [a.clone() for a in (seen, codes, lengths, finished)]
        plain = [a.clone() for a in (seen, codes, lengths, finished)]
        launch(args(mine))
        ref = sampling.sample_step_reference(x, *plain, step, key, offset=0, **kw)
        torch.cuda.synchronize()
        return (tok != ref).nonzero().flatten().tolist()

    return args((seen, codes, lengths, finished)), check


# the wide kernel's phase tags under SAMPLE_TRACE (csrc/sample.cu)
_TRACE_TAGS = {1: "start", 2: "first read", 3: "arrive", 4: "released", 5: "radix sweep",
               6: "draw", 7: "end"}


def traced_source(path: Path, label: str) -> Path:
    """A copy of a ``sample.cu`` under ``build/trace/LABEL/`` that defines
    ``SAMPLE_TRACE`` first, so its wide kernel stamps its phases and it has a
    C entry ``sample_trace_read(out, n)``."""
    text = path.read_text()
    if "SAMPLE_TRACE" not in text:
        raise SystemExit(f"--trace: {path} has no SAMPLE_TRACE stamps")
    out = Path("build") / "trace" / label / "sample.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("#define SAMPLE_TRACE 1\n" + text)
    shutil.copy(path.parent / "threefry.cuh", out.parent / "threefry.cuh")
    return out


def trace_main(args, labels, specs):
    """``--sample --trace``: each source's wide kernel, phase by phase."""
    for label, spec in zip(labels, specs):
        lib = ctypes.CDLL(str(attention.build(traced_source(Path(spec), label))[0]))
        lib.sample_step.argtypes, lib.sample_step.restype = sampling._SIGNATURES[
            "sample_step"], ctypes.c_int
        lib.sample_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        for b, v in args.shape or [s for s in SAMPLE_AB_SHAPES if s[1] > 65536]:
            for setting_name in ("top-p", "top-p+typical", "off"):
                call_args, _ = sample_case(b, v, SAMPLE_SETTINGS[setting_name])
                for _ in range(4):  # three warm-ups, then the one read
                    if lib.sample_step(*call_args) != 0:
                        raise RuntimeError(f"sample_step of {spec} failed")
                torch.cuda.synchronize()
                buf, n = (ctypes.c_ulonglong * 1024)(), ctypes.c_uint()
                if lib.sample_trace_read(buf, ctypes.byref(n)) != 0:
                    raise RuntimeError("sample_trace_read failed")
                stamps = [(buf[2 * i], buf[2 * i + 1]) for i in range(n.value)]
                phases = [f"{_TRACE_TAGS[tag]} +{t - prev}" for (tag, t), (_, prev) in
                          zip(stamps[1:], stamps)]
                print(f"  trace {label} ({b}, {v}) fp32 {setting_name}: "
                      f"{stamps[-1][1] - stamps[0][1]} SM cycles: " + ", ".join(phases),
                      flush=True)


def sample_main(args, labels, specs):
    """``--sample``: the sampler sources in turns at each shape and setting."""
    with ThreadPoolExecutor(max_workers=len(specs)) as pool:
        built = dict(zip(labels, pool.map(load_sample, specs)))
    for label in labels:
        for line in built[label][2]:
            print(f"  {label}: {line}", flush=True)
    results = []
    for b, v in args.shape or SAMPLE_AB_SHAPES:
        for setting_name in ("top-p", "top-p+typical", "off"):
            call_args, check = sample_case(b, v, SAMPLE_SETTINGS[setting_name])
            differ = {label: check(built[label][0]) for label in labels}
            times = {label: [] for label in labels}
            dev = {label: [] for label in labels}
            floors = {label: [] for label in labels}
            for label in labels + labels[::-1]:
                launch, floor = built[label][:2]
                times[label].append(cuda_ms(lambda: launch(call_args), runs=args.runs))
                dev[label].append(device_ms(lambda: launch(call_args), runs=args.runs,
                                            only="sample_step_kernel"))
                floors[label].append(cuda_ms(lambda: [floor(b) for _ in range(200)],
                                             runs=5) / 200)
            wide = {label: built[label][3](b, v) for label in labels}
            for label in labels:
                print(f"  ({b}, {v}) fp32 {setting_name}: {label} ms {times[label]} device_ms "
                      f"{dev[label]} floor_ms {floors[label]} rows differing from the plain "
                      f"version {differ[label]}"
                      + (f"; wide G {wide[label][0]}, groups {wide[label][1]}, cached tokens a "
                         f"CTA {wide[label][2]}" if wide[label] else ""), flush=True)
            results.append(dict(shape=[b, v], setting=setting_name, ms=times, device_ms=dev,
                                floor_ms=floors, differ=differ, wide=wide))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "results": results}))


def serving_case(b, t, h, d):
    """(launch(fn), errors(), wrapper or None) of the serving kernel at one shape."""
    qkv, bias = attention_inputs(b, t, h, d, torch.bfloat16, seed=7)
    sm = 1.0 / math.sqrt(d)
    ref = attention.bias_attention_reference(qkv, bias, heads=h, sm_scale=sm)
    out = torch.empty_like(ref)
    stream = torch.cuda.current_stream().cuda_stream

    def run(fn):
        rc = fn(qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), b, t, h, d,
                sm * attention.LOG2E, 0, stream)
        if rc != 0:
            raise RuntimeError(f"bias_attention_fwd failed ({rc})")

    def errors():
        return {"out": (out.float() - ref.float()).abs().max().item()}

    return run, errors, None


def train_case(b, t, h, d):
    """(launch(fn), errors(), wrapper) of the training forward at one shape."""
    qkv, bias, _ = train_inputs(b, t, h, d, torch.bfloat16, seed=7)
    sm = 1.0 / math.sqrt(d)
    ref_out, ref_lse = attention.bias_attention_train_reference(qkv, bias, heads=h,
                                                                sm_scale=sm)
    out, lse = torch.empty_like(ref_out), torch.empty_like(ref_lse)
    stream = torch.cuda.current_stream().cuda_stream

    def run(fn):
        rc = fn(qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), lse.data_ptr(), b, t, h,
                d, sm * attention.LOG2E, attention.LOG2E, 0, stream)
        if rc != 0:
            raise RuntimeError(f"bias_attention_train_fwd failed ({rc})")

    def errors():
        return {"out": (out.float() - ref_out.float()).abs().max().item(),
                "lse": (lse - ref_lse).abs().max().item()}

    def wrapper():
        attention.bias_attention_train_fwd(qkv, bias, heads=h, sm_scale=sm)

    return run, errors, wrapper


def bwd_case(b, t, h, d):
    """(launch(fns, which), errors(fns), wrapper) of the backward at one
    shape: ``which`` a key of ``BWD_RUNS``."""
    qkv, bias, dout = train_inputs(b, t, h, d, torch.bfloat16, seed=7)
    sm = 1.0 / math.sqrt(d)
    out, lse = attention.bias_attention_train_fwd(qkv, bias, heads=h, sm_scale=sm)
    ref_dqkv, ref_dbias = attention.bias_attention_bwd_reference(
        qkv, bias, out, lse, dout, heads=h, sm_scale=sm)
    tp = attention.padded_len(t)
    delta = torch.empty((b, h, t), device="cuda")
    part = torch.empty((b, h, tp, tp), device="cuda")
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty((h, t, t), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    scales = (sm * attention.LOG2E, attention.LOG2E, sm, 0, stream)
    args = {
        "bias_attention_bwd_dq": (qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(),
                                  out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                  dqkv.data_ptr(), part.data_ptr(), b, t, h, d, *scales),
        "bias_attention_bwd_dkv": (qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(),
                                   lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), b, t, h,
                                   d, *scales),
        "bias_attention_bwd_dbias_sum": (part.data_ptr(), dbias.data_ptr(), b, t, h, stream),
    }

    def run(fns, which):
        for entry in BWD_RUNS[which]:
            rc = fns[entry](*args[entry])
            if rc != 0:
                raise RuntimeError(f"{entry} failed ({rc})")

    def errors(fns):
        """The scaled errors of d(qkv) and dbias against the plain version."""
        run(fns, "all")
        torch.cuda.synchronize()
        return {"dqkv": scaled_err(dqkv, ref_dqkv),
                "dbias": scaled_err(dbias, ref_dbias, floor=1e-30)}

    def wrapper():
        attention.bias_attention_bwd(qkv, bias, out, lse, dout, heads=h, sm_scale=sm)

    return run, errors, wrapper


def add_variants(args, labels, paths, variants):
    """With ``--variants``: each source's (or each named one's) step-0
    copies appended to ``labels`` and ``paths``."""
    if args.variants is None:
        return
    for label, path in list(zip(labels, paths)):
        if args.variants and label not in args.variants:
            continue
        for vlabel, vpath in variant_sources(label, path, variants):
            labels.append(vlabel)
            paths.append(vpath)


def bwd_main(args, labels, paths):
    """``--train`` with backward sources: each entry and the whole backward
    of every source (and with ``--variants`` step 0's copies) in turns."""
    add_variants(args, labels, paths, VARIANTS)
    with ThreadPoolExecutor(max_workers=len(paths)) as pool:
        built = dict(zip(labels, pool.map(load_bwd, paths)))
    for label in labels:
        for line in built[label][1]:
            print(f"  {label}: {line}", flush=True)
    checked = [label for label in labels if "-no" not in label]
    lib = attention._library(attention.BWD_SOURCE)
    results = []
    for b, t, h, d in args.shape or BWD_SHAPES:
        route = attention.BWD_ROUTES[lib.bias_attention_bwd_route(b, t, d, 0)]
        run, errors, wrapper = bwd_case(b, t, h, d)
        errs = {label: errors(built[label][0]) for label in checked}
        flush = torch.empty(64 << 20, device="cuda") if args.cold else None
        row = dict(shape=[b, t, h, d], package_route=route, max_scaled_err=errs)
        for which, entries in BWD_RUNS.items():
            only = tuple(name for entry in entries for name in BWD_KERNEL_NAMES[entry])
            times = {label: [] for label in labels}
            dev = {label: [] for label in labels}
            for label in labels + labels[::-1]:
                fns = built[label][0]
                if flush is None:
                    times[label].append(cuda_ms(lambda: run(fns, which), runs=args.runs))
                    dev[label].append(device_ms(lambda: run(fns, which), runs=args.runs,
                                                only=only))
                else:  # the kernels' names, not the L2 flush's
                    dev[label].append(device_ms(lambda: (flush.zero_(), run(fns, which)),
                                                runs=args.runs, only=only))
            for label in labels:
                print(f"  B={b} T={t} H={h} d={d} {which}: {label} ms {times[label]} "
                      f"device_ms {dev[label]}", flush=True)
            row[which] = dict(ms=times, device_ms=dev)
        for label in checked:
            print(f"  B={b} T={t} H={h} d={d}: {label} errors {errs[label]}; the package "
                  f"routes this shape to {route}", flush=True)
        row["wrapper_ms"] = cuda_ms(wrapper, runs=args.runs)
        print(f"  B={b} T={t} H={h} d={d}: the package's wrapper bias_attention_bwd ms "
              f"{row['wrapper_ms']}", flush=True)
        results.append(row)
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "results": results}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+",
                    help="LABEL=path of a bias_attention.cu (--sample: of a sample.cu, "
                         "--host: of a checkout's root)")
    ap.add_argument("--train", action="store_true",
                    help="time the training forward bias_attention_train_fwd")
    ap.add_argument("--sample", action="store_true",
                    help="time the decode step's sampler sample_step")
    ap.add_argument("--trace", action="store_true",
                    help="with --sample: the wide kernel's phases in SM cycles")
    ap.add_argument("--host", action="store_true",
                    help="the host us a serving call of each checkout (LABEL=root)")
    ap.add_argument("--variants", nargs="*", metavar="LABEL",
                    help="with --train: also time step 0's variants (products out, copies "
                         "out) of these sources (of all without LABEL)")
    ap.add_argument("--cold", action="store_true",
                    help="evict L2 (a 256 MB write) before every timed launch")
    ap.add_argument("--shape", nargs="+", type=int, action="append",
                    help="B T H D (--sample: B V)")
    ap.add_argument("--runs", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_serving_kernel.py needs a CUDA device")
    print(smi("name,power.limit"), flush=True)
    if args.sample:
        run = trace_main if args.trace else sample_main
        run(args, [s.split("=", 1)[0] for s in args.sources],
            [s.split("=", 1)[1] for s in args.sources])
        return
    if args.host:
        host_main(args, [s.split("=", 1)[0] for s in args.sources],
                  [s.split("=", 1)[1] for s in args.sources])
        return
    entry = "bias_attention_train_fwd" if args.train else "bias_attention_fwd"
    labels = [s.split("=", 1)[0] for s in args.sources]
    paths = [Path(s.split("=", 1)[1]) for s in args.sources]
    if args.train and all(p.stem.startswith("bias_attention_bwd") for p in paths):
        bwd_main(args, labels, paths)
        return
    if args.train:
        add_variants(args, labels, paths, FWD_VARIANTS)
    with ThreadPoolExecutor(max_workers=len(paths)) as pool:
        built = dict(zip(labels, pool.map(lambda p: load(p, entry), paths)))
    for label in labels:
        for line in built[label][1]:
            print(f"  {label}: {line}", flush=True)

    default = TRAIN_SHAPES if args.train else SERVE_SHAPES
    only = "train_fwd" if args.train else "serve_fwd"  # the kernels, not the L2 flush
    results = []
    for b, t, h, d in args.shape or default:
        run, errors, wrapper = (train_case if args.train else serving_case)(b, t, h, d)
        errs = {}
        for label in labels:
            run(built[label][0])
            torch.cuda.synchronize()
            errs[label] = errors()
        times = {label: [] for label in labels}
        dev = {label: [] for label in labels}
        flush = torch.empty(64 << 20, device="cuda") if args.cold else None
        for label in labels + labels[::-1]:
            if flush is None:
                times[label].append(cuda_ms(lambda: run(built[label][0]), runs=args.runs))
                dev[label].append(device_ms(lambda: run(built[label][0]), runs=args.runs,
                                            only=only))
            else:
                dev[label].append(device_ms(lambda: (flush.zero_(), run(built[label][0])),
                                            runs=args.runs, only=only))
        for label in labels:
            print(f"  B={b} T={t} H={h} d={d}: {label} ms {times[label]} device_ms "
                  f"{dev[label]} max_abs_err "
                  + " ".join(f"{k} {v:.3e}" for k, v in errs[label].items()), flush=True)
        row = dict(shape=[b, t, h, d], ms=times, device_ms=dev, max_abs_err=errs)
        if wrapper is not None:
            row["wrapper_ms"] = cuda_ms(wrapper, runs=args.runs)
            print(f"  B={b} T={t} H={h} d={d}: the package's wrapper "
                  f"bias_attention_train_fwd ms {row['wrapper_ms']}", flush=True)
        results.append(row)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "results": results}))


if __name__ == "__main__":
    main()
