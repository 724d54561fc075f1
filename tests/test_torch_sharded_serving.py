"""Sharded serving of the port (``TTSEngine(mesh=)``) against the one-card
engine, fp32 on the CPU, over gloo process groups of 2 and 4 ranks
(``tests/torch_dist.py``), every rank given the whole request:

(a) the deterministic tail (fixed codes -> latents, mel, wav; JAX's
    ``tests/test_serving_mesh.py`` ``_deterministic_tail`` and its
    tolerances: latents 2e-4, mel 2e-3, wav 2e-3 of the one-card output's
    largest magnitude) at (2 x 1), (1 x 2) and (2 x 2);
(b) a request through ``synthesize_batch`` under ``force_full``, the split
    dispatch with early stop, ``synthesize_vq_batch`` and
    ``synthesize_from_ids``, with texts of other lengths on each data rank
    (the agreed text bucket), at the same tolerances, every item as long as
    on one card.  At (2 x 1) the codes, latents and mel are the one-card
    bits; the wav is not, since the CPU's vocoder convolutions round a
    2-row batch otherwise than a 4-row one (4.4e-6 at most here);
(c) a batch of 3 over a data axis of 2: every rank runs every row, and the
    audio is the one-card audio bit for bit.
"""
import numpy as np
import pytest
import torch

from detail_tts_tpu_torch.config import small_test_config
from detail_tts_tpu_torch.serving.pipeline import EngineConfig
from tests import torch_dist


@pytest.fixture(autouse=True)
def one_thread():
    """The one-card reference on one intra-op thread, as each spawned rank
    runs (torch_dist): the CPU's convolutions round by their thread count.
    The count is restored after the test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ECFG = EngineConfig(max_generate_length=12, text_buckets=(16, 32), prompt_buckets=(32, 64),
                    code_buckets=(8, 12), compute_dtype=torch.float32,
                    cache_dtype=torch.float32)
# rank 0 of a data axis of 2 holds the two short texts (text bucket 16), rank
# 1 the long ones (bucket 32)
TEXTS = ["你好", "三", "今天天气很好，我们一起去公园散步吧。", "这是第四个请求，长一点。"]


def _wavs(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.3, 0.3, 24000 + 3000 * i).astype(np.float32) for i in range(n)]


def _close(got, want, tol, what):
    scale = max(float(np.abs(np.asarray(want)).max()), 1e-3)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol * scale, rtol=0,
                               err_msg=what)


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2), (2, 2)])
def test_deterministic_tail_matches_one_card(tmp_path, data, model):
    cfg = small_test_config()
    rng = np.random.default_rng(1)
    codes = torch.as_tensor(rng.integers(0, 20, size=(4, 8)))
    eff = np.array([6, 8, 5, 8], np.int64)
    args = (cfg, ECFG, TEXTS, _wavs(4, 1), codes, eff)
    one = torch_dist.engine_tail(None, 1, 1, *args)
    outs = torch_dist.spawn(torch_dist.engine_tail, data * model, tmp_path, data, model, *args)
    for r, out in enumerate(outs):
        for name, a, b, tol in zip(("latents", "mel", "wav"), one, out, (2e-4, 2e-3, 2e-3)):
            _close(b, a, tol, f"rank {r} {name} at ({data} x {model})")


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2), (2, 2)])
def test_requests_match_one_card(tmp_path, data, model):
    cfg = small_test_config()
    args = (cfg, ECFG, TEXTS, _wavs(4))
    one = torch_dist.engine_requests(None, 1, 1, *args)
    outs = torch_dist.spawn(torch_dist.engine_requests, data * model, tmp_path, data, model,
                            *args)
    for r, out in enumerate(outs):
        for entry, wavs in one.items():
            assert len(out[entry]) == len(wavs) == 4
            for i, (a, b) in enumerate(zip(wavs, out[entry])):
                assert a.shape == b.shape, (r, entry, i)
                _close(b, a, 2e-3, f"rank {r} {entry} item {i} at ({data} x {model})")


def test_a_batch_the_data_axis_does_not_split_is_replicated(tmp_path):
    cfg = small_test_config()
    args = (cfg, ECFG, TEXTS[1:], _wavs(3, 2))
    one = torch_dist.engine_requests(None, 1, 1, *args)
    outs = torch_dist.spawn(torch_dist.engine_requests, 2, tmp_path, 2, 1, *args)
    for out in outs:
        for entry, wavs in one.items():
            assert all(np.array_equal(a, b) for a, b in zip(wavs, out[entry])), entry
