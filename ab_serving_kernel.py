"""Time the bf16 serving kernel ``bias_attention_fwd`` of several sources in
turns on one GPU.

    python3 ab_serving_kernel.py LABEL=path/to/bias_attention.cu [...] \\
        [--shape B T H D ...] [--runs 50]

Each source is built at once with the package's nvcc flags (it includes the
``mma.cuh`` beside it), loaded with ctypes, checked once against the plain
PyTorch version, and timed with CUDA events (median of ``--runs`` launches)
in turns: the labels in the order given, then in reverse (A B B A for two),
at each shape (default: the diffusion trunk at batch 8 and 400 codes,
B=16, T=1600, H=16, d=48).  Prints the card's name and power limit first,
the ``ptxas -v`` lines of each source's d=48 and d=96 kernels, and one JSON object
last.  Needs a CUDA device.
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

from chip_smoke import attention_inputs, cuda_ms, smi  # noqa: E402
from detail_tts_tpu_torch.ops import attention  # noqa: E402


def load(source: Path):
    """Build ``source`` and return (its ``bias_attention_fwd``, ptxas lines)."""
    path, _, log = attention.build(source)
    fn = ctypes.CDLL(str(path)).bias_attention_fwd
    fn.argtypes = attention._SIGNATURES[attention.SOURCE]["bias_attention_fwd"]
    fn.restype = ctypes.c_int
    lines, entry = [], ""
    for line in log.splitlines():
        if "entry function" in line:
            entry = line.split("'")[1]
        elif ("Li48E" in entry or "Li96E" in entry) and ("registers" in line
                                                         or "spill" in line):
            lines.append(f"{entry[:80]}: {line.split(':', 1)[-1].strip()}")
    return fn, lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+", help="LABEL=path of a bias_attention.cu")
    ap.add_argument("--shape", nargs=4, type=int, action="append", metavar=("B", "T", "H", "D"))
    ap.add_argument("--runs", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_serving_kernel.py needs a CUDA device")
    print(smi("name,power.limit"), flush=True)
    labels = [s.split("=", 1)[0] for s in args.sources]
    paths = [Path(s.split("=", 1)[1]) for s in args.sources]
    with ThreadPoolExecutor(max_workers=len(paths)) as pool:
        built = dict(zip(labels, pool.map(load, paths)))
    for label in labels:
        for line in built[label][1]:
            print(f"  {label}: {line}", flush=True)

    stream = torch.cuda.current_stream().cuda_stream
    results = []
    for b, t, h, d in args.shape or [(16, 1600, 16, 48)]:
        qkv, bias = attention_inputs(b, t, h, d, torch.bfloat16, seed=7)
        sm = 1.0 / math.sqrt(d)
        ref = attention.bias_attention_reference(qkv, bias, heads=h, sm_scale=sm)
        out = torch.empty_like(ref)

        def run(fn):
            rc = fn(qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), b, t, h, d,
                    sm * attention.LOG2E, 0, stream)
            if rc != 0:
                raise RuntimeError(f"bias_attention_fwd failed ({rc})")

        errs = {}
        for label in labels:
            run(built[label][0])
            torch.cuda.synchronize()
            errs[label] = (out.float() - ref.float()).abs().max().item()
        times = {label: [] for label in labels}
        for label in labels + labels[::-1]:
            times[label].append(cuda_ms(lambda: run(built[label][0]), runs=args.runs))
        for label in labels:
            print(f"  B={b} T={t} H={h} d={d}: {label} ms {times[label]} "
                  f"max_abs_err {errs[label]:.3e}", flush=True)
        results.append(dict(shape=[b, t, h, d], ms=times, max_abs_err=errs))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "results": results}))


if __name__ == "__main__":
    main()
