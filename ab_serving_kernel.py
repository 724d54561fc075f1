"""Time the bf16 serving kernel ``bias_attention_fwd``, or with ``--train``
the bf16 training forward ``bias_attention_train_fwd``, of several sources
in turns on one GPU.

    python3 ab_serving_kernel.py LABEL=path/to/bias_attention.cu [...] \\
        [--train] [--cold] [--shape B T H D ...] [--runs 50]

Each source is built at once with the package's nvcc flags (it includes the
``mma.cuh`` beside it), loaded with ctypes, checked once against the plain
PyTorch version, and timed in turns (the labels in the order given, then in
reverse: A B B A for two) as bare launches on buffers allocated beforehand,
both with CUDA events around each launch (median of ``--runs``) and by the
profiler's device time (mean of ``--runs``; no host time).  Default shapes:
the diffusion trunk at batch 8 and 400 codes, B=16, T=1600, H=16, d=48;
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
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from chip_smoke import (attention_inputs, cuda_ms, device_ms, smi,  # noqa: E402
                        train_inputs)
from detail_tts_tpu_torch.ops import attention  # noqa: E402

TRAIN_SHAPES = [(8, 496, 16, 48), (8, 124, 16, 48), (8, 124, 16, 96)]


def load(source: Path, entry: str):
    """Build ``source`` and return (its C entry ``entry``, ptxas lines)."""
    path, _, log = attention.build(source)
    fn = getattr(ctypes.CDLL(str(path)), entry)
    fn.argtypes = attention._SIGNATURES[attention.SOURCE][entry]
    fn.restype = ctypes.c_int
    lines, name = [], ""
    for line in log.splitlines():
        if "entry function" in line:
            name = line.split("'")[1]
        elif ("Li48E" in name or "Li96E" in name) and ("registers" in line
                                                       or "spill" in line):
            lines.append(f"{name[:80]}: {line.split(':', 1)[-1].strip()}")
    return fn, lines


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+", help="LABEL=path of a bias_attention.cu")
    ap.add_argument("--train", action="store_true",
                    help="time the training forward bias_attention_train_fwd")
    ap.add_argument("--cold", action="store_true",
                    help="evict L2 (a 256 MB write) before every timed launch")
    ap.add_argument("--shape", nargs=4, type=int, action="append", metavar=("B", "T", "H", "D"))
    ap.add_argument("--runs", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_serving_kernel.py needs a CUDA device")
    print(smi("name,power.limit"), flush=True)
    entry = "bias_attention_train_fwd" if args.train else "bias_attention_fwd"
    labels = [s.split("=", 1)[0] for s in args.sources]
    paths = [Path(s.split("=", 1)[1]) for s in args.sources]
    with ThreadPoolExecutor(max_workers=len(paths)) as pool:
        built = dict(zip(labels, pool.map(lambda p: load(p, entry), paths)))
    for label in labels:
        for line in built[label][1]:
            print(f"  {label}: {line}", flush=True)

    default = TRAIN_SHAPES if args.train else [(16, 1600, 16, 48)]
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
                dev[label].append(device_ms(lambda: run(built[label][0]), runs=args.runs))
            else:  # the kernels' own names all end in _mma (the flush's does not)
                dev[label].append(device_ms(lambda: (flush.zero_(), run(built[label][0])),
                                            runs=args.runs, only="_mma"))
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
