"""Offline batch synthesis: a closed loop of whole batches through
``TTSEngine``, in the microbatching server's double-buffered order (batch
N+1's decode, then batch N's finalize, then batch N+1's tail), every item
decoded to the traffic's fixed length (``force_full``).

Set-up: import, the kernel libraries (built once into the checkout's
``build/kernels/``, then found there), the weights made on the device from
the seed, the engine, and one warm-up batch at the cell's own shapes.  The
window dispatches batches until ``seconds`` have passed and finishes the
batch in flight; ``audio_s_per_s`` is all the audio of its batches over all
its time.  The traced run profiles one batch of the window on its own
(its stages synchronised, the batch before it finished first).  After the
window a sample of finished rows drawn from the seed is worked out again by
the plain reference and compared, the decode's sampled tokens with it.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench import bench, roofline, trace as tracing
from port_bench.reference.config import Config as RefConfig
from port_bench.reference.serve import (ServeReference, batch_shapes, meta_work, nucleus,
                                        nucleus_mass, top_token)
from port_bench.reference.synthesizer import SynthesizerTrn as RefSynthesizer
from port_bench.generator import ServeTraffic
from port_bench.weights import make_weights, structure

STAGES = ("prepare", "generate", "diff_cond", "latents", "diffuse", "vocode", "host")
# the traced run profiles batch 1 on its own, then times batch 2's stages on
# its own, without the profiler (whose host cost would double the decode's)
TRACED_BATCH, TIMED_BATCH = 1, 2
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def engine_settings(engine: Dict) -> Dict:
    """The configuration's ``engine`` section as ``EngineConfig`` keywords."""
    out = dict(engine)
    for k in ("cache_dtype", "compute_dtype"):
        if k in out:
            out[k] = DTYPES[out[k]]
    for k in ("text_buckets", "prompt_buckets", "code_buckets"):
        if k in out:
            out[k] = tuple(out[k])
    return out


def rel_err(a, b) -> float:
    """||a - b|| / ||b - mean(b)||, in float64 on the host."""
    a, b = (torch.as_tensor(x).detach().cpu().double() for x in (a, b))
    if a.shape != b.shape:
        return float("inf")
    return float((a - b).norm() / (b - b.mean()).norm().clamp_min(1e-30))


def run(cell: bench.Cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float, calibrate=None) -> bench.Outcome:
    """One run of the cell.  ``calibrate(ref, traffic, sample, outs)``, when
    given (the control's calibration, never a benchmark run), runs after
    the check with its reference, sample and the reference's rows; what it
    returns goes under the outcome's ``context["control"]``."""
    parts: Dict[str, float] = {}
    t = time.perf_counter()
    from detail_tts_tpu_torch.config import Config
    from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
    from detail_tts_tpu_torch.ops import attention
    from detail_tts_tpu_torch.serving.pipeline import EngineConfig, TTSEngine
    parts["import"] = time.perf_counter() - t

    t = time.perf_counter()
    if device.type == "cuda":
        attention.build_all()
    parts["build"] = time.perf_counter() - t

    t = time.perf_counter()
    tp = cell.traffic
    traffic = ServeTraffic(tp, seed)
    ref_cfg = RefConfig.from_dict(cell.config)
    ref_struct = structure(lambda: RefSynthesizer(ref_cfg))
    parts["structure"] = time.perf_counter() - t
    t = time.perf_counter()
    ecfg = EngineConfig(**engine_settings(cell.config["engine"]))
    with torch.device(device):
        model = SynthesizerTrn(Config.from_dict(cell.config))
    parts["program_model"] = time.perf_counter() - t
    t = time.perf_counter()
    model.load_state_dict(make_weights(ref_struct, seed, device))
    parts["weights"] = time.perf_counter() - t
    t = time.perf_counter()
    engine = TTSEngine(model, ecfg, device=device)
    captured: Dict[int, tuple] = {}
    current = [-1]
    _capture(engine, captured, current)
    parts["engine"] = time.perf_counter() - t

    t = time.perf_counter()
    texts, wavs = traffic.batch(-1)
    engine.synthesize_batch(texts, wavs, seed=traffic.key(-1), force_full=True)
    captured.clear()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    parts["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    _say("setup " + " ".join(f"{k} {v:.3f}" for k, v in parts.items())
         + f" total {setup_s:.3f} s")

    records: Dict[int, Dict] = {}

    def finish(i, pending, handle):
        records[i] = {"codes": pending.codes, "text": pending.text,
                      "refer_mel": pending.refer_mel, "outs": engine.finalize_batch(handle),
                      "done": time.perf_counter()}

    traced, timed = None, None
    inflight = None
    i = 0
    t_w = time.perf_counter()
    min_batches = cell.check.get("min_batches", 1)
    while (time.perf_counter() - t_w < seconds or i < min_batches
           or (trace and timed is None)):
        texts, wavs = traffic.batch(i)
        key = traffic.key(i)
        if trace and i in (TRACED_BATCH, TIMED_BATCH):
            if inflight is not None:
                finish(*inflight)
                inflight = None
            timings: Dict[str, float] = {}
            with (tracing.profiled() if i == TRACED_BATCH else contextlib.nullcontext([])) as box:
                tb = time.perf_counter()
                pending = engine.dispatch_decode(texts, wavs, seed=key, force_full=True,
                                                 timings=timings)
                current[0] = i
                finish(i, pending, engine.dispatch_tail(pending))
                wall = time.perf_counter() - tb
            if i == TRACED_BATCH:
                traced = (box, wall, texts, wavs)
            else:
                timed = (timings, wall)
        else:
            pending = engine.dispatch_decode(texts, wavs, seed=key, force_full=True)
            if inflight is not None:
                finish(*inflight)
            current[0] = i
            inflight = (i, pending, engine.dispatch_tail(pending))
        i += 1
    if inflight is not None:
        finish(*inflight)
    window_s = time.perf_counter() - t_w
    n_batches = len(records)
    max_len = ecfg.max_generate_length
    codes_per_item = max(max_len - 1, 1)
    audio = n_batches * traffic.audio_seconds(codes_per_item, ref_cfg.gpt.mel_length_compression)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    done = [t_w] + [records[k]["done"] for k in sorted(records)]
    _say(f"window {window_s:.3f} s, {n_batches} batches, {audio:.3f} s of audio; batches "
         f"finished after {[round(b - a, 3) for a, b in zip(done, done[1:])]} s")

    context: Dict = {}
    if traced is not None:
        box, wall, texts, wavs = traced
        timings, timed_wall = timed
        t = time.perf_counter()
        calls, flops = meta_work(ref_struct.to("meta"), ref_cfg, cell.config["engine"],
                                 batch_shapes(ref_cfg, cell.config["engine"], texts, wavs))
        info = roofline.device_info()
        t1 = time.perf_counter()
        context = {"trace": tracing.Trace(box[0], STAGES, wall), "wall_s": wall,
                   "timings": timings, "batch_wall_s": timed_wall, "decode_steps": max_len,
                   "attn_calls": calls, "model_flops": flops,
                   "sfu_per_s": info["sfu_per_s"], "peak_bytes": peak, "batch": tp["batch"]}
        _say(f"work counted in {t1 - t:.3f} s, trace read in {time.perf_counter() - t1:.3f} s; "
             f"traced batch {wall:.3f} s; timed batch {timed_wall:.3f} s, stages {timings}")

    sample = _draw_sample(records, traffic, cell.check, seed)
    for s in sample:
        rec, (i, r) = records[s["batch"]], (s["batch"], s["row"])
        s.update(text=rec["text"][r].cpu(), refer_mel=rec["refer_mel"][r].float().cpu(),
                 codes=rec["codes"][r].cpu(), wav=np.asarray(rec["outs"][r]),
                 latents=captured[i][0][r].float().cpu(),
                 cond=captured[i][1][r].float().cpu(),
                 mel=captured[i][2][r].float().cpu())
    del engine, model, records, captured, traced, timed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = ServeReference(ref_cfg, cell.config["engine"], make_weights(ref_struct, seed, device),
                         device)
    outs = reference_rows(ref, traffic, sample)
    readings = judge(sample, outs, ref.e, cell.check["limits"]["nucleus_gap"])
    _say(f"check of {len(sample)} rows in {time.perf_counter() - t:.3f} s")
    if calibrate is not None:
        context["control"] = calibrate(ref, traffic, sample, outs)
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    if trace and context:
        dev_info.update(busy_s=context["trace"].busy_s(), window_s=context["wall_s"])
    return bench.Outcome(
        attempted=n_batches * tp["batch"], failed=0,
        end_to_end={"audio_s_per_s": audio / window_s, "setup_s": setup_s},
        context=context, compared=bench.limits(cell, readings),
        device=dev_info)


def _capture(engine, captured: Dict[int, tuple], current: List[int]) -> None:
    """Keep each batch's diffusion input (GPT latents, conditioning) and
    output (mel) for the check, under the batch's index."""
    diffuse = engine.diffuse

    def wrapped(latents, cond_latent, biases, key, rows=None):
        mel = diffuse(latents, cond_latent, biases, key, rows)
        if current[0] >= 0:
            captured[current[0]] = (latents, cond_latent, mel)
        return mel

    engine.diffuse = wrapped


def _draw_sample(records: Dict[int, Dict], traffic: ServeTraffic, check: Dict,
                 seed: int) -> List[Dict]:
    """``sample_rows`` rows of the finished batches, drawn from the seed
    (every item of the traffic is equally long)."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0xC4EC])
    pool, n = sorted(records), traffic.p["batch"]
    picked = set()
    while len(picked) < min(check["sample_rows"], len(pool) * n):
        picked.add((int(rng.choice(pool)), int(rng.integers(n))))
    return [{"batch": i, "row": r} for i, r in sorted(picked)]


def reference_rows(ref: ServeReference, traffic: ServeTraffic,
                   sample: List[Dict]) -> List[Dict[str, torch.Tensor]]:
    """The reference's outputs for each sampled row, teacher-forced on the
    row's served codes and, for the vocoder, on its mel."""
    outs = []
    for s in sample:
        texts, wavs = traffic.batch(s["batch"])
        outs.append(ref.row(texts, wavs, s["row"], s["codes"], traffic.key(s["batch"]), s["mel"]))
    return outs


def decode_gaps(z: torch.Tensor, gumbel: torch.Tensor, tokens: torch.Tensor, top_p: float,
                slack: float) -> tuple:
    """(decode_gap, nucleus_gap) of the served ``tokens`` (S,) against the
    reference's scores ``z`` and noise ``gumbel`` (S, V) at each step.

    ``nucleus_gap``: the largest mass by which a served token lies past the
    reference's nucleus (its mass above, less ``top_p``).  ``decode_gap``:
    the largest amount by which a served token's ``z + gumbel`` lies below
    the best of the tokens that the nucleus keeps with ``slack`` of mass to
    spare, where a program whose scores round otherwise may not cut its
    nucleus (``slack`` is ``nucleus_gap``'s limit: the program may move the
    boundary that far either way)."""
    tokens = tokens.to(z.device).long()[:z.shape[0]]
    rows = torch.arange(z.shape[0], device=z.device)
    mass = nucleus_mass(z)
    past = torch.where(tokens == top_token(z), 0.0, (mass[rows, tokens] - top_p).clamp_min(0.0))
    inner = nucleus(z, top_p - slack, mass)
    score = z + gumbel
    best = score.masked_fill(~inner, float("-inf")).max(-1).values
    race = (best - score[rows, tokens]).clamp_min(0.0)
    return float(race.max()), float(past.max())


def judge(sample: List[Dict], outs: List[Dict[str, torch.Tensor]], engine: Dict,
          slack: float) -> Dict[str, float]:
    """The compared numbers: text ids that differ; the prompt mel's largest
    difference; the decode's two gaps (``decode_gaps``) of the served codes;
    the GPT latents', conditioning's, mel's and wav's relative error (largest
    over the rows).  ``engine``: the reference's serving settings."""
    r = {"text_id_mismatches": 0.0, "prompt_mel_err": 0.0, "decode_gap": 0.0,
         "nucleus_gap": 0.0, "latents_err": 0.0, "cond_err": 0.0, "mel_err": 0.0,
         "wav_err": 0.0}
    for s, out in zip(sample, outs):
        ids = torch.as_tensor(out["text"])
        r["text_id_mismatches"] += (float((s["text"] != ids).sum()) if s["text"].shape == ids.shape
                                    else float("inf"))
        r["prompt_mel_err"] = max(r["prompt_mel_err"],
                                  float((s["refer_mel"] - out["refer_mel"].cpu()).abs().max()))
        race, past = decode_gaps(out["z"], out["gumbel"], s["codes"], engine["top_p"], slack)
        r["decode_gap"] = max(r["decode_gap"], race)
        r["nucleus_gap"] = max(r["nucleus_gap"], past)
        for k in ("latents", "cond", "mel", "wav"):
            r[f"{k}_err"] = max(r[f"{k}_err"], rel_err(s[k], out[k].float().cpu()))
    return r
