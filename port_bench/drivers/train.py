"""Training: a closed loop of whole optimizer steps of ``Trainer.train``
(what ``python -m detail_tts_tpu_torch.train`` runs) on seeded batches made
on the device.

Set-up builds the trainer, loads the weights made from the seed, seeds the
step's generator (its timesteps, noise, unconditioned rows and layer-drop
flags) from the seed, and runs the first ``warmup_steps`` steps through the
window's own call and feed; those are the steps the check follows.  The
window calls ``Trainer.train`` up to each next multiple of its own
``log_every``, so that it reads its metrics back and logs as often as the
training entry point does, until ``seconds`` have passed at such a
boundary; the rate is the frames of all its steps over all its time, after
a synchronisation.  The traced run profiles ``traced_steps`` steps of the
window through the step function with its stages synchronised.
"""
from __future__ import annotations

import gc
import inspect
import json
import shutil
import statistics
import sys
import tempfile
import time
from typing import Dict, List

import torch

from port_bench import bench, roofline, trace as tracing
from port_bench.generator import TrainTraffic
from port_bench.reference.config import Config as RefConfig
from port_bench.reference.synthesizer import SynthesizerTrn as RefSynthesizer
from port_bench.reference.train import follow, meta_step_work
from port_bench.weights import make_weights, structure, weight_normed

STAGES = ("latents", "forward", "backward", "optimizer")
# parameters whose reference gradient is below this share of the median
# leaf's (its root mean square) move under AdamW by round-off alone, as a
# key's bias does under softmax: their change is not compared
NOUGHT = 1e-3


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(cell: bench.Cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, calibrate=None) -> bench.Outcome:
    """One run of the cell.  ``calibrate(readings, rerun)``, when given (the
    control's calibration, never a benchmark run), runs after the check
    with the reference's readings and ``rerun(**fault)``, which runs the
    reference again; what it returns goes under the outcome's
    ``context["control"]``."""
    parts: Dict[str, float] = {}
    t = time.perf_counter()
    from detail_tts_tpu_torch.config import Config
    from detail_tts_tpu_torch.ops import attention
    from detail_tts_tpu_torch.train.trainer import Trainer
    parts["import"] = time.perf_counter() - t

    t = time.perf_counter()
    if device.type == "cuda":
        attention.build_all()
    parts["build"] = time.perf_counter() - t

    t = time.perf_counter()
    tp = cell.traffic
    ref_cfg = RefConfig.from_dict(cell.config)
    traffic = TrainTraffic(tp, seed, ref_cfg.data.hop_length, ref_cfg.data.n_mel_channels,
                           device)
    ref_struct = structure(lambda: RefSynthesizer(ref_cfg))
    parts["structure"] = time.perf_counter() - t
    t = time.perf_counter()
    logs = tempfile.mkdtemp(prefix="port_bench_train_")
    trainer = Trainer(Config.from_dict(cell.config), traffic.batches(), device=device,
                      seed=seed, logs_folder=logs)
    model = trainer.state.model
    parts["trainer"] = time.perf_counter() - t
    t = time.perf_counter()
    weights = make_weights(ref_struct, seed, device)
    model.load_state_dict(weight_normed(weights, model.state_dict().keys()))
    del weights
    trainer.generator.manual_seed(traffic.draw_seed())
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    start = {n: p.detach().to("cpu", copy=True) for n, p in named}
    parts["weights"] = time.perf_counter() - t

    t = time.perf_counter()
    beta1 = float(trainer.state.optimizer.param_groups[0]["betas"][0])
    losses: List[float] = []
    grad: Dict[str, float] = {}
    for k in range(tp["warmup_steps"]):
        trainer.train(max_steps=trainer.state.step + 1)
        losses.append(float(trainer.last_metrics["loss"]))
        if k == 0:  # the first gradient as AdamW got it: exp_avg = (1 - beta1) g
            state = trainer.state.optimizer.state
            grad = {n: float(state[p]["exp_avg"].norm()) / (1.0 - beta1)
                    if "exp_avg" in state.get(p, {}) else 0.0 for n, p in named}
    with torch.no_grad():
        change = {n: p.detach().cpu() - start[n] for n, p in named}
    del start
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    parts["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    _say("setup " + " ".join(f"{k} {v:.3f}" for k, v in parts.items())
         + f" total {setup_s:.3f} s")

    log_every = inspect.signature(Trainer.train).parameters["log_every"].default
    steps, traced = 0, None
    t_w = time.perf_counter()
    while time.perf_counter() - t_w < seconds or (trace and traced is None):
        if trace and traced is None and steps:
            timings: Dict[str, float] = {}
            kept = []
            with tracing.profiled() as box:
                tb = time.perf_counter()
                for _ in range(tp["traced_steps"]):
                    m = trainer.step_fn(trainer.state, trainer.next_batch(), trainer.generator,
                                        timings=timings)
                    kept += m["layers_kept"]
                wall = time.perf_counter() - tb
            traced = (box, wall, kept)
            steps += tp["traced_steps"]
        else:
            first = trainer.state.step
            trainer.train(max_steps=(first // log_every + 1) * log_every)
            steps += trainer.state.step - first
    if device.type == "cuda":
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t_w
    frames = steps * tp["accum"] * tp["micro_batch"] * tp["frames"]
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    _say(f"window {window_s:.3f} s, {steps} steps, losses of the first steps {losses}")

    context: Dict = {}
    if traced is not None:
        box, wall, kept = traced
        t = time.perf_counter()
        calls, flops, on_meta = [], 0.0, ref_struct.to("meta")
        for keep in kept:
            c, f = meta_step_work(on_meta, ref_cfg, tp["micro_batch"], tp["frames"],
                                  tp["text_tokens"], keep)
            calls += c
            flops += f
        info = roofline.device_info()
        untraced = steps - tp["traced_steps"]
        context = {"trace": tracing.Trace(box[0], STAGES, wall), "wall_s": wall,
                   "steps": tp["traced_steps"], "attn_calls": calls, "model_flops": flops,
                   "step_wall_s": (window_s - wall) / untraced if untraced else None,
                   "sfu_per_s": info["sfu_per_s"], "peak_bytes": peak}
        _say(f"trace read in {time.perf_counter() - t:.3f} s")

    trainer.close()
    shutil.rmtree(logs, ignore_errors=True)
    del trainer, model, named
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    def rerun(**fault):
        return reference_readings(ref_cfg, ref_struct, traffic, seed, device,
                                  tp["warmup_steps"], cell.check["block_rows"], **fault)

    ref = rerun()
    prog = {"loss": losses, "grad": grad, "change": change}
    readings = compare(prog, ref)
    _say("worst leaves " + json.dumps(worst_leaves(prog, ref)))
    _say("gaps " + json.dumps(spread_of_gaps(prog, ref)))
    _say(f"check of {tp['warmup_steps']} steps in {time.perf_counter() - t:.3f} s; "
         f"reference losses {ref['loss']}")
    if calibrate is not None:
        context["control"] = calibrate(ref, rerun)
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    if trace and context:
        dev_info.update(busy_s=context["trace"].busy_s(), window_s=wall)
    return bench.Outcome(
        attempted=steps, failed=0,
        end_to_end={"mel_frames_per_s": frames / window_s, "setup_s": setup_s},
        context=context, compared=bench.limits(cell, readings),
        device=dev_info)


def reference_readings(ref_cfg, ref_struct, traffic: TrainTraffic, seed: int, device,
                       steps: int, block_rows: int, **fault) -> Dict:
    """The reference's loss, first gradient and change over the first
    ``steps`` steps, from the same weights, batches and draw seed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    feed = traffic.batches()
    batches = [next(feed) for _ in range(steps)]
    return follow(ref_cfg, make_weights(ref_struct, seed, device), batches,
                  traffic.draw_seed(), device, block_rows=block_rows, **fault)


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers.  A leaf's gap is the gap between the program's
    and the reference's norm of the leaf's first gradient (or of its change
    over the steps), against the larger of the reference's norm of that leaf
    and of the median leaf; the change counts only the parameters whose
    reference gradient reaches ``NOUGHT`` of the median leaf's root mean
    square.  ``change_gap``: the largest leaf's change gap;
    ``grad_median_gap`` and ``change_median_gap``: the median leaf's.  The
    steps' losses are compared by no limit (no control or fault separates
    them from sound runs; ``spread_of_gaps`` records them)."""
    floor = NOUGHT * statistics.median(float(g.norm()) / g.numel() ** 0.5
                                       for g in ref["grad"].values())
    moved = {n: g.abs() >= floor for n, g in ref["grad"].items()}
    c_ref = {n: float(ref["change"][n][m].norm()) for n, m in moved.items() if m.any()}
    c_prog = {n: float(prog["change"][n][moved[n]].norm()) for n in c_ref}
    grad = leaf_gaps(norms(prog["grad"]), norms(ref["grad"]))
    change = leaf_gaps(c_prog, c_ref)
    if len(prog["loss"]) != len(ref["loss"]) or not grad or not change:
        return {"change_gap": float("inf"), "grad_median_gap": float("inf"),
                "change_median_gap": float("inf")}
    return {"change_gap": max(change), "grad_median_gap": statistics.median(grad),
            "change_median_gap": statistics.median(change)}


def leaf_gaps(a: Dict[str, float], b: Dict[str, float]) -> List[float]:
    """Each leaf's |a - b| against the larger of b and the median leaf's b."""
    med = statistics.median(b.values())
    return [abs(a[n] - b[n]) / max(b[n], med) for n in b]


def spread_of_gaps(prog: Dict, ref: Dict) -> Dict[str, List[float]]:
    """For the record: each step's relative loss gap, and the leaf gaps of
    the first gradient and of the whole change (none left out) at the
    quantiles 0.5, 0.9 and 1."""
    out = {"loss": [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]}
    for key in ("grad", "change"):
        gaps = sorted(leaf_gaps(norms(prog[key]), norms(ref[key])))
        out[key] = [gaps[len(gaps) // 2], gaps[int(0.9 * (len(gaps) - 1))], gaps[-1]]
    return out


def norms(leaves: Dict) -> Dict[str, float]:
    return {n: v if isinstance(v, float) else float(v.norm()) for n, v in leaves.items()}


def worst_leaves(prog: Dict, ref: Dict, n: int = 4) -> Dict[str, List]:
    """The leaves whose whole norms differ most, (name, program, reference),
    for the record."""
    out = {}
    for key in ("grad", "change"):
        a, b = norms(prog[key]), norms(ref[key])
        med = statistics.median(b.values())
        worst = sorted(b, key=lambda k: -abs(a[k] - b[k]) / max(b[k], med))[:n]
        out[key] = [(k, a[k], b[k]) for k in worst]
    return out
