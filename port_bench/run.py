"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``port_bench/``
and the program (``detail_tts_tpu_torch/``).  The cell's inputs and weights
are made from ``--seed``; set-up (import, kernel build or cache hit,
weights, warm-up) is timed from the start of this process; the window
measures for ``--seconds``.  With ``--trace 0`` the result holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics read from a
profiled span of the window.  After the window the output is checked
against the plain reference (``port_bench/reference/``).  The last line of
standard output is one JSON object; the last lines of standard error are
the numbers compared, each beside its limit.

Exits 2 without a result where CUDA is missing or holds fewer cards than
the cell asks for, and 3 where the process has loaded JAX or the JAX
package by the time the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from port_bench import bench

    cell = bench.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    out = bench.driver(cell.traffic["kind"]).run(
        cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        device=torch.device("cuda"), t_start=T_START)
    found = bench.forbidden_modules()
    if found:
        print(f"the process has loaded {found} (JAX or the JAX package): no result",
              file=sys.stderr)
        return 3
    bench.emit(bench.result(cell, out, bool(args.trace)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
