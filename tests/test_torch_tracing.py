"""The port's tracer (``detail_tts_tpu_torch/tracing.py``) on the CPU: a
batch's spans on the tiny engine (nesting, parents, one root), roots
carried through the double-buffered order, the decode's step spans and
counter, the wait sites, the profiler's clock, the ring of roots,
recording off, and the trainer's ``train_step`` roots."""
import dataclasses

import numpy as np
import pytest
import torch

from detail_tts_tpu_torch import tracing
from detail_tts_tpu_torch.config import small_test_config
from detail_tts_tpu_torch.serving.pipeline import EngineConfig, random_engine
from detail_tts_tpu_torch.train.step import (make_single_loss_step, make_train_state,
                                             synthetic_batches)
from detail_tts_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)
MAX_LEN = 12
TEXTS = ["你好，世界。", "ni3 hao3"]
STAGES = ("prepare", "generate", "diff_cond", "latents", "diffuse", "vocode", "host")


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.uniform(-0.3, 0.3, n).astype(np.float32) for n in (24000, 12077)]


@pytest.fixture(scope="module")
def engine():
    ecfg = EngineConfig(max_generate_length=MAX_LEN, text_buckets=(16, 32),
                        prompt_buckets=(32, 64), code_buckets=(8, 12),
                        compute_dtype=torch.float32, cache_dtype=torch.float32)
    return random_engine(small_test_config(), engine_cfg=ecfg, device="cpu")


def _since(first_id):
    """Spans recorded after span id ``first_id``, by root id."""
    out = {}
    for s in tracing.snapshot()["spans"]:
        if s["root"] > first_id:
            out.setdefault(s["root"], []).append(s)
    return out


def _last_id():
    spans = tracing.snapshot()["spans"]
    return max((s["id"] for s in spans), default=0)


def _batch(engine, **kw):
    """One batch through the engine; its spans, root first."""
    first = _last_id()
    outs = engine.synthesize_batch(TEXTS, _prompts(), seed=3, **kw)
    (spans,) = _since(first).values()
    return outs, spans


def test_a_batch_is_one_root_with_its_stages_nested(engine):
    _, spans = _batch(engine, force_full=True)
    root = spans[0]
    assert root["name"] == "batch" and root["parent"] is None and root["end_ns"]
    assert {s["root"] for s in spans} == {root["id"]}
    assert root["attrs"]["profiled"] is False and root["attrs"]["synced"] is False
    by_id = {s["id"]: s for s in spans}
    stages = [s for s in spans if s["parent"] == root["id"]]
    assert [s["name"] for s in stages] == ["prepare", "generate", "diff_cond", "generate",
                                           "diff_cond", "latents", "diffuse", "vocode", "host"]
    for s in spans[1:]:  # every span lies inside its parent, and is closed
        p = by_id[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    for s in stages:
        assert s["device_ms"] is None  # CUDA events are for the card only
    steps = [s for s in spans if s["name"] == "decode_step"]
    assert {by_id[s["parent"]]["name"] for s in steps} == {"generate"}


def test_timings_mark_a_batch_synced_and_keep_their_stages(engine):
    timings = {}
    _, spans = _batch(engine, force_full=True, timings=timings)
    assert spans[0]["attrs"]["synced"] is True
    assert set(timings) == set(STAGES) - {"host"}


def test_roots_travel_with_their_batches_in_the_servers_order(engine):
    """Batch N+1's decode is dispatched before batch N is finalized: each
    batch's stages still land under its own root, and the roots overlap."""
    first = _last_id()
    a = engine.dispatch_tail(engine.dispatch_decode(TEXTS, _prompts(), seed=1,
                                                    force_full=True))
    pending = engine.dispatch_decode(TEXTS, _prompts(), seed=2, force_full=True)
    engine.finalize_batch(a)
    engine.finalize_batch(engine.dispatch_tail(pending))
    batches = list(_since(first).values())
    roots = [spans[0] for spans in batches]
    counts = [r["attrs"]["batch"] for r in roots]
    assert counts == [counts[0], counts[0] + 1]
    assert roots[1]["start_ns"] < roots[0]["end_ns"] < roots[1]["end_ns"]
    for spans in batches:
        stages = [s["name"] for s in spans if s["parent"] == spans[0]["id"]]
        assert stages == ["prepare", "generate", "diff_cond", "generate", "diff_cond",
                          "latents", "diffuse", "vocode", "host"]


@pytest.mark.parametrize("force_full", [True, False])
def test_one_decode_step_span_per_executed_step(engine, force_full):
    before = tracing.snapshot()["counters"].get("decode.steps", {"count": 0})["count"]
    _, spans = _batch(engine, force_full=force_full)
    steps = [s for s in spans if s["name"] == "decode_step"]
    kids = {s["id"]: [c["name"] for c in spans if c["parent"] == s["id"]] for s in steps}
    # random weights never stop, so every step runs either way; the last
    # step has no logits to compute
    assert len(steps) == MAX_LEN
    assert [kids[s["id"]] for s in steps] == [["sample", "gpt"]] * (MAX_LEN - 1) + [["sample"]]
    assert tracing.snapshot()["counters"]["decode.steps"]["count"] - before == MAX_LEN


@pytest.mark.parametrize("site, stage, force_full, count", [
    ("text", "prepare", True, 1),
    ("prompt", "prepare", True, 1),          # one copy a padded prompt length
    ("prompt_lengths", "prepare", True, 1),
    ("refer_len", "prepare", True, 1),
    ("cond_rows", "diff_cond", True, 1),     # one a prompt bucket
    ("code_lengths", "latents", True, 1),
    ("mel_lengths", "vocode", True, 1),
    ("fetch", "host", True, 1),
    ("finished", "generate", False, MAX_LEN - 1),
    ("lengths", "generate", False, 1),
])
def test_wait_sites(engine, site, stage, force_full, count):
    before = tracing.snapshot()["counters"].get(f"wait.{site}", {"count": 0, "seconds": 0.0})
    _, spans = _batch(engine, force_full=force_full)
    by_id = {s["id"]: s for s in spans}
    waits = [s for s in spans if s["name"] == "wait" and s["attrs"]["site"] == site]
    assert len(waits) == count
    for w in waits:
        p = by_id[w["parent"]]
        while p["name"] not in STAGES:
            p = by_id[p["parent"]]
        assert p["name"] == stage
    after = tracing.snapshot()["counters"][f"wait.{site}"]
    assert after["count"] - before["count"] == count
    spent = sum(w["end_ns"] - w["start_ns"] for w in waits) / 1e9
    assert 0 < spent == pytest.approx(after["seconds"] - before["seconds"])


def test_spans_lie_on_the_profilers_clock(engine):
    from torch.profiler import ProfilerActivity, profile

    first = _last_id()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.synthesize_batch(TEXTS, _prompts(), seed=3, force_full=True)
    (spans,) = _since(first).values()
    assert spans[0]["attrs"]["profiled"] is True
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    for name in ("prepare", "generate", "diffuse", "vocode", "host"):
        mine = [(s["start_ns"], s["end_ns"]) for s in spans if s["name"] == name]
        assert len(mine) == len(ranges[name])
        for (s0, s1), (r0, r1) in zip(mine, sorted(ranges[name])):
            assert r0 - 1_000_000 <= s0 and s1 <= r1 + 1_000_000, name
    assert len(ranges["decode_step"]) == MAX_LEN


def test_the_ring_keeps_the_last_roots():
    tracer = tracing.Tracer()
    for i in range(tracing.RING_ROOTS + 6):
        with tracer.root("train_step", step=i):
            with tracer.span("forward"):
                tracer.count("things")
    spans = tracer.snapshot()["spans"]
    roots = [s for s in spans if s["parent"] is None]
    assert [r["attrs"]["step"] for r in roots] == list(range(6, tracing.RING_ROOTS + 6))
    assert len(spans) == 2 * tracing.RING_ROOTS
    assert tracer.snapshot()["counters"]["things"]["count"] == tracing.RING_ROOTS + 6


def test_a_span_outside_any_root_is_not_kept():
    tracer = tracing.Tracer()
    with tracer.span("decode_step"):
        tracer.count("decode.steps")
    with tracer.wait("fetch"):
        pass
    snap = tracer.snapshot()
    assert snap["spans"] == []
    assert snap["counters"]["decode.steps"]["count"] == 1
    assert "wait.fetch" not in snap["counters"]  # a wait counts what its kept span timed


def _diff_step_outputs():
    cfg = small_test_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, target="diff"))
    state = make_train_state(cfg, device="cpu", seed=0)
    step = make_single_loss_step(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = next(synthetic_batches(cfg, accum=2, micro_batch=2, mel_frames=48, text_len=8,
                                   generator=gen))
    metrics = step(state, batch, gen)
    return [float(metrics["loss"])] + [p.detach().clone() for p in state.params]


def test_recording_off_keeps_nothing_and_changes_no_output(engine):
    on, _ = _batch(engine, force_full=False)
    diff_on = _diff_step_outputs()
    before = tracing.snapshot()
    tracing.set_enabled(False)
    try:
        off = engine.synthesize_batch(TEXTS, _prompts(), seed=3)
        diff_off = _diff_step_outputs()
        assert tracing.snapshot() == before
    finally:
        tracing.set_enabled(True)
    assert all(np.array_equal(a, b) for a, b in zip(on, off))
    assert diff_on[0] == diff_off[0]
    assert all(torch.equal(a, b) for a, b in zip(diff_on[1:], diff_off[1:]))


def test_trainer_steps_are_roots_with_stages_and_a_log_wait(tmp_path):
    cfg = small_test_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, target="diff", val_freq=10 ** 9, save_freq=10 ** 9))
    data = synthetic_batches(cfg, accum=2, micro_batch=2, mel_frames=48, text_len=8,
                             generator=torch.Generator().manual_seed(1))
    tr = Trainer(cfg, data, device="cpu", logs_folder=str(tmp_path))
    first = _last_id()
    drops = tracing.snapshot()["counters"].get("wait.layer_drop", {"count": 0})["count"]
    try:
        tr.train(max_steps=3, log_every=2)
    finally:
        tr.close()
    roots = list(_since(first).values())
    assert [r[0]["name"] for r in roots] == ["train_step"] * 3
    assert [r[0]["attrs"]["step"] for r in roots] == [1, 2, 3]
    for spans in roots:
        root = spans[0]
        stages = [s["name"] for s in spans if s["parent"] == root["id"] and s["name"] != "wait"]
        assert stages == ["latents", "forward", "backward"] * 2 + ["optimizer"] * 2
        sites = [s["attrs"]["site"] for s in spans if s["name"] == "wait"]
        assert sites.count("batch") == 1 and sites.count("layer_drop") == 2
    assert tracing.snapshot()["counters"]["wait.layer_drop"]["count"] - drops == 6
    # the metrics are read back at step 2 (log_every) and at the last step
    assert [("log" in [s["attrs"].get("site") for s in r]) for r in roots] == [False, True, True]


def _graph_share_reader():
    from pathlib import Path

    from port_bench import bench
    root = Path(__file__).resolve().parent.parent
    return bench.load_reader(root / "port_bench" / "metrics" / "decode_graph_share.serve.py")


@pytest.mark.parametrize("counters,share", [
    ({"decode.steps": 401, "decode.graph_replays": 400, "decode.graph_captures": 1}, 400 / 401),
    ({"decode.steps": 401}, None),  # no replay counted: a program without graphs
    ({"decode.graph_replays": 3}, None),
    ({}, None),
])
def test_graph_share_reads_replays_over_steps(monkeypatch, counters, share):
    snap = {"spans": [], "counters": {k: {"count": n, "seconds": 0.0}
                                      for k, n in counters.items()}}
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    value = _graph_share_reader()({})
    assert value == (None if share is None else pytest.approx(share))


def test_a_cpu_decode_counts_steps_and_no_replay(engine):
    def count(name):
        return tracing.snapshot()["counters"].get(name, {"count": 0})["count"]

    before = [count(k) for k in ("decode.steps", "decode.graph_replays",
                                 "decode.graph_captures")]
    _batch(engine, force_full=True)
    after = [count(k) for k in ("decode.steps", "decode.graph_replays",
                                "decode.graph_captures")]
    assert [a - b for a, b in zip(after, before)] == [MAX_LEN, 0, 0]
