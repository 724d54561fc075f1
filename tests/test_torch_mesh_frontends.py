"""The front ends over a sharded engine (``serving/spmd.py``): rank 0 serves
through a ``LeaderEngine`` and every other rank follows it call for call.
fp32 on the CPU, gloo ranks from ``tests/torch_dist.py``, each spawn under
a deadline, against the same front ends over the one-card engine:

(a) a request that the one-card engine refuses (a prompt shorter than one
    hop on rank 1's row; rows that do not match) raises the same
    ``ValueError`` on both ranks of a (2 x 1) engine, before any collective
    (before the engine checked the whole request, rank 0 waited in the
    prompt bucket's collective until the deadline);
(b) a ``TTSServer`` over the leader at (2 x 1) and (1 x 2): a batch of 4,
    then two back-to-back batches of 2, each future within JAX's mesh
    tolerance for wav (2e-3 of max, ``tests/test_serving_mesh.py``) of the
    one-card server's; at (2 x 1) the codes are equal; the followers run
    the same calls in the same order;
(c) a batch whose call raises on every rank fails only its futures with
    that exception; one that raises on rank 1 only gives a
    ``RuntimeError`` naming rank 1; the next batch resolves in both cases;
(d) ``synthesize_long`` and ``synthesize_long_stream`` over the leader;
(e) ``http_api.serve(leader)``: ``/healthz``, one ``/synthesize``, a bad
    request (400), and shutdown through ``httpd_box``, after which every
    follower returns;
(f) an idle gap of twice the control channel's timeout does not end the
    followers (the leader's keep-alive).
"""
import numpy as np
import pytest
import torch

from detail_tts_tpu_torch.config import small_test_config
from detail_tts_tpu_torch.serving import spmd
from detail_tts_tpu_torch.serving.pipeline import EngineConfig, random_engine
from tests import torch_dist

ECFG = EngineConfig(max_generate_length=12, text_buckets=(16, 32), prompt_buckets=(32, 64),
                    code_buckets=(8, 12), compute_dtype=torch.float32,
                    cache_dtype=torch.float32)
TEXTS = ["你好", "三", "今天天气很好，我们一起去公园散步吧。", "这是第四个请求，长一点。"]
LONG = "今天天气很好。我们一起去公园散步吧！这是第三句。"  # 3 chunks: batches of 2 and 1
WAV_TOL = 2e-3
DEADLINE_S = 240.0


def _requests():
    rng = np.random.default_rng(0)
    return [(t, rng.uniform(-0.3, 0.3, 24000 + 3000 * i).astype(np.float32), 10 + i)
            for i, t in enumerate(TEXTS)]


def _close(got, want, what):
    scale = max(float(np.abs(np.asarray(want)).max()), 1e-3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=WAV_TOL * scale,
                               rtol=0, err_msg=what)


def _codes(logs):
    """Each ``dispatch_tail``'s codes of every row, from the ranks' logs."""
    out = []
    for calls in zip(*(log["codes"] for log in logs)):
        total = calls[0][1].shape[0] if calls[0][0] is None else calls[0][0].total
        full = torch.full((total, calls[0][1].shape[1]), -1, dtype=calls[0][1].dtype)
        for rows, codes in calls:
            full[slice(None) if rows is None else slice(rows.start, rows.stop)] = codes
        out.append(full)
    return out


@pytest.fixture(scope="module")
def one_card():
    """The scenario over the one-card engine, on one intra-op thread as
    each spawned rank runs (the count is restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        eng = random_engine(small_test_config(), engine_cfg=ECFG, device="cpu")
        log = torch_dist.recorded(eng)
        out = torch_dist.frontends_scenario(eng, _requests(), LONG, full=True)
    finally:
        torch.set_num_threads(n)
    out["log"] = log
    return out


@pytest.fixture(scope="module")
def mesh_2x1(tmp_path_factory):
    return torch_dist.spawn(torch_dist.mesh_frontends, 2, tmp_path_factory.mktemp("m21"), 2,
                            1, small_test_config(), ECFG, _requests(), LONG, True,
                            deadline=DEADLINE_S)


@pytest.fixture(scope="module")
def mesh_1x2(tmp_path_factory):
    return torch_dist.spawn(torch_dist.mesh_frontends, 2, tmp_path_factory.mktemp("m12"), 1,
                            2, small_test_config(), ECFG, _requests(), LONG, False,
                            deadline=DEADLINE_S)


def test_refused_request_raises_on_every_rank(tmp_path):
    cfg = small_test_config()
    args = (cfg, ECFG, TEXTS, [w for _, w, _ in _requests()])
    one = torch_dist.refused_requests(None, 1, 1, *args)
    assert all(one.values()), one
    assert one["dispatch_decode"].startswith("prompt wav 3 too short")
    outs = torch_dist.spawn(torch_dist.refused_requests, 2, tmp_path, 2, 1, *args,
                            deadline=120.0)
    assert outs == [one, one]


@pytest.mark.parametrize("mesh", ["mesh_2x1", "mesh_1x2"])
def test_server_over_the_leader_matches_one_card(request, one_card, mesh):
    ranks = request.getfixturevalue(mesh)
    leader = ranks[0]
    for entry in ("four", "pairs"):
        assert len(leader[entry]) == 4
        for i, (a, b) in enumerate(zip(one_card[entry], leader[entry])):
            assert a.shape == b.shape, (entry, i)
            _close(b, a, f"{mesh} {entry} item {i}")
    one, sharded = _codes([one_card["log"]])[:3], _codes([r["log"] for r in ranks])[:3]
    assert [c.shape[0] for c in one] == [c.shape[0] for c in sharded] == [4, 2, 2]
    if mesh == "mesh_2x1":  # the codes of the three batches
        assert all(torch.equal(a, b) for a, b in zip(one, sharded))


@pytest.mark.parametrize("mesh", ["mesh_2x1", "mesh_1x2"])
def test_followers_run_the_leaders_calls_in_order(request, mesh):
    ranks = request.getfixturevalue(mesh)
    calls = [r["log"]["calls"] for r in ranks]
    assert calls[0] == calls[1]
    # the batch of 4, then the two of 2 double-buffered: decode N+1,
    # finalize N, tail N+1
    d, t, f = "dispatch_decode", "dispatch_tail", "finalize_batch"
    assert calls[0][:9] == [d, t, f, d, t, d, f, t, f]
    assert ranks[1]["followed"] >= 9


def test_a_batch_failing_on_every_rank_fails_only_its_futures(mesh_2x1, one_card):
    leader = mesh_2x1[0]
    assert leader["boom"] == [("RuntimeError", "planted on every rank")] * 2
    for a, b in zip(one_card["boom next"], leader["boom next"]):
        _close(b, a, "the batch after the every-rank fault")


def test_a_rank_local_fault_names_its_rank(mesh_2x1, one_card):
    leader = mesh_2x1[0]
    for kind, msg in leader["fault"]:
        assert kind == "RuntimeError"
        assert "some ranks of the mesh only" in msg and "rank 1: RuntimeError: planted on " \
            "rank 1" in msg and "rank 0" not in msg
    for a, b in zip(one_card["fault next"], leader["fault next"]):
        _close(b, a, "the batch after the rank-local fault")


def test_long_form_over_the_leader(mesh_2x1, one_card):
    leader = mesh_2x1[0]
    assert leader["long"].shape == one_card["long"].shape
    _close(leader["long"], one_card["long"], "synthesize_long")
    assert len(leader["stream"]) == len(one_card["stream"]) >= 2
    np.testing.assert_array_equal(np.concatenate(leader["stream"]), leader["long"])


def test_http_over_the_leader(mesh_2x1, one_card):
    leader = mesh_2x1[0]
    assert leader["health"]["ok"] and leader["health"]["requests_served"] == 0
    status, wav = leader["http"]
    assert status == 200 and wav.shape == one_card["http"][1].shape
    _close(wav, one_card["http"][1], "/synthesize")
    assert leader["http bad"] == (400, None)
    assert not leader["http alive"]
    assert mesh_2x1[1]["followed"] > 0  # the follower returned after the shutdown


def test_an_idle_leader_keeps_its_followers(mesh_2x1):
    leader, follower = mesh_2x1
    out = leader["after idle"]
    assert len(out) == 2 and all(np.isfinite(w).all() and len(w) > 0 for w in out)
    assert follower["followed after idle"] == 1


def test_the_leader_refuses_what_is_not_an_engine_call():
    with pytest.raises(ValueError, match="mesh of ranks"):
        spmd.LeaderEngine(random_engine(small_test_config(), engine_cfg=ECFG, device="cpu"))
    assert set(spmd.CALLS) <= set(dir(spmd.LeaderEngine))
