"""Readings that a cell's limits are set from, and the check that its
control and faults fail.

    python3 port_bench/control.py --workload <cell> --seeds <n> ... [--control-seeds <n> ...]
        [--seconds <s>] [--out <file.jsonl>]

For each seed, one short run of the cell (as ``run.py`` runs it, untraced)
gives the program's readings against the plain reference and its verdict;
for each control seed besides, the control's: the reference itself computed
with every product's operands in fp8 (``reference/precision.py``), the step
below the configurations' bf16, read against the fp32 reference through the
cell's own comparison and judged by the cell's own limits.  A serving
control does not decode: at each served position the token that it puts
first (its nucleus and the step's noise) is judged, with the latents and
mel it computes on the same codes and the wav it makes of the same mel.  A
training cell also reads a planted fault, half of each micro-batch left out
and the mean taken over the rest; a step that leaves its state unchanged
reads 1 in ``change_gap`` and needs no run.  Each seed's readings are one JSON line on standard output (and in
``--out``).  The benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the slacks of mass at which the serving control also reads the decode gap
SLACKS = (0.0, 0.005, 0.01, 0.02, 0.05, 0.1)


def judged(cell, readings) -> dict:
    """Readings beside the cell's own limits, and the verdict on them."""
    from port_bench import bench

    compared = bench.limits(cell, readings)
    out = bench.Outcome(attempted=1, failed=0, end_to_end={}, context={}, compared=compared)
    return {"readings": readings, "correct": bench.verdict(out)}


def serve_control(cell, ref, traffic, sample, outs):
    """The fp8 control judged on the program's sample, and the decode gap of
    the program and of the control at each of ``SLACKS``."""
    import torch

    from port_bench.drivers.serve_offline import decode_gaps, judge
    from port_bench.reference.precision import fp8_products
    from port_bench.reference.serve import pick

    top_p = ref.e["top_p"]
    low = []
    for s in sample:
        texts, wavs = traffic.batch(s["batch"])
        with fp8_products():
            q = ref.row(texts, wavs, s["row"], s["codes"], traffic.key(s["batch"]), s["mel"])
        low.append({"text": torch.as_tensor(q["text"]), "refer_mel": q["refer_mel"].cpu(),
                    "codes": pick(q["z"], q["gumbel"], top_p).cpu(),
                    **{k: q[k].float().cpu() for k in ("latents", "cond", "mel", "wav")}})
    by_slack = {which: {str(x): max(decode_gaps(o["z"], o["gumbel"], s["codes"], top_p, x)[0]
                                    for s, o in zip(rows, outs)) for x in SLACKS}
                for which, rows in (("program", sample), ("fp8", low))}
    fp8 = judge(low, outs, ref.e, cell.check["limits"]["nucleus_gap"])
    return {"fp8": judged(cell, fp8), "decode_gap_by_slack": by_slack}


def train_control(cell, ref, rerun):
    """The fp8 control and the half-batch fault, judged by the cell's
    limits, with the spread of their gaps over steps and leaves."""
    from port_bench.drivers.train import compare, spread_of_gaps
    from port_bench.reference.precision import fp8_products

    with fp8_products():
        low = rerun()
    half = rerun(half_batch=True)
    return {"fp8": judged(cell, compare(low, ref)), "half_batch": judged(cell, compare(half, ref)),
            "fp8_spread": spread_of_gaps(low, ref), "half_batch_spread": spread_of_gaps(half, ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from port_bench import bench

    cell = bench.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    drv = bench.driver(cell.traffic["kind"])
    control = functools.partial(
        serve_control if cell.traffic["kind"] == "serve_offline" else train_control, cell)
    for seed in list(dict.fromkeys(args.seeds + args.control_seeds)):
        t0 = time.perf_counter()
        out = drv.run(cell, seed=seed, seconds=args.seconds, trace=False,
                      device=torch.device("cuda"), t_start=t0,
                      calibrate=control if seed in args.control_seeds else None)
        rec = {"workload": cell.name, "seed": seed, "kind": torch.cuda.get_device_name(0),
               "program": {"readings": {k: v for k, (v, _) in out.compared.items()},
                           "correct": bench.verdict(out)},
               **out.context.get("control", {}), "seconds": time.perf_counter() - t0}
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
