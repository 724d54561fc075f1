"""The port's threefry keys and draws (``ops/prng.py``, plain versions on the
CPU) against JAX's ``jax.random`` (0.9.0, ``jax_threefry_partitionable``
on), and the serving path's randomness end to end: the JAX ``TTSEngine``
and the port's engine on the same seeded weights give the same codes and
audio for the same seed; the server's batch key and long form's chunk keys
are JAX's.

Tolerances: keys, bits and uniforms are bit-identical.  Normals and Gumbels
come from float32 logarithms, which XLA's CPU lowering computes with its own
approximations and fused multiply-adds, against one rounding an operation in
the port (its kernel and plain version agree bit for bit): they are held
within 4 units of the last place of max(|x|, 1) (read: 3 for normals, 4 for
Gumbels, whose values near 0 make a relative ulp meaningless).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detail_tts_tpu.ops import sampling as jsamp
from detail_tts_tpu.serving import longform as jax_longform
from detail_tts_tpu.serving.pipeline import EngineConfig as JaxEngineConfig
from detail_tts_tpu.serving.pipeline import TTSEngine as JaxEngine
from detail_tts_tpu.serving.server import TTSServer as JaxServer
from detail_tts_tpu_torch.ops import prng
from detail_tts_tpu_torch.ops import sampling as tsamp
from detail_tts_tpu_torch.serving import longform
from detail_tts_tpu_torch.serving.pipeline import EngineConfig, TTSEngine
from detail_tts_tpu_torch.serving.server import TTSServer
from tests.torch_parity import synth_pair

SEEDS = [0, 1, 2 ** 31 - 1]
SHAPES = [(3,), (2, 8194), (2, 28, 128)]
ULPS = 4


def _kd(key) -> tuple:
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def _ulps(ours, ref) -> float:
    """max |ours - ref| in units of the last place of max(|ref|, 1), float32."""
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    scale = np.spacing(np.maximum(np.abs(ref), np.float32(1.0)))
    return float(np.max(np.abs(ours.astype(np.float64) - ref) / scale))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert prng.PRNGKey(seed) == _kd(key)
    for n in (2, 3, 50):
        assert prng.split(prng.PRNGKey(seed), n) == [_kd(k) for k in jax.random.split(key, n)]
    for data in (0, 7, 2 ** 31 - 1):
        assert prng.fold_in(prng.PRNGKey(seed), data) == _kd(jax.random.fold_in(key, data))
    assert prng.as_key(np.asarray(jax.random.key_data(key))) == prng.PRNGKey(seed)
    with pytest.raises(ValueError):
        prng.as_key((1, 2, 3))


@pytest.mark.parametrize("seed", SEEDS)
def test_device_key_buffers_match_jax(seed):
    """The decode's chain ``rng, key = split(rng)`` and ``split(key, n)``."""
    rng, chain = jax.random.PRNGKey(seed), []
    for _ in range(7):
        rng, k = jax.random.split(rng)
        chain.append(_kd(k))
    ours = prng.decode_keys(seed, 7).numpy().view(np.uint32)
    assert [tuple(int(w) for w in r) for r in ours] == chain
    ours = prng.split_keys(seed, 5).numpy().view(np.uint32)
    assert [tuple(int(w) for w in r) for r in ours] == prng.split(prng.PRNGKey(seed), 5)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_draws_match_jax(seed, shape):
    key, pkey = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    bits = prng.draw(pkey, shape, "bits")
    assert bits.dtype == torch.int32 and tuple(bits.shape) == shape
    np.testing.assert_array_equal(bits.numpy().view(np.uint32),
                                  np.asarray(jax.random.bits(key, shape)))
    np.testing.assert_array_equal(prng.draw(pkey, shape, "uniform").numpy(),
                                  np.asarray(jax.random.uniform(key, shape)))
    assert _ulps(prng.draw(pkey, shape, "normal"), jax.random.normal(key, shape)) <= ULPS
    assert _ulps(prng.draw(pkey, shape, "gumbel"), jax.random.gumbel(key, shape)) <= ULPS
    assert _ulps(prng.draw(pkey, shape, "normal", scale=0.7),
                 jax.random.normal(key, shape) * 0.7) <= ULPS


@pytest.mark.parametrize("kind", list(prng.KINDS))
def test_offset_and_prefix_draws_are_rows_of_the_whole(kind):
    """A data rank's rows from their offset, and row 0 of a batch-2 draw as
    the batch-1 draw."""
    key = prng.split(prng.PRNGKey(11))[1]
    whole = prng.draw(key, (5, 3, 41), kind)
    rows = type("Rows", (), {"start": 2})
    part = prng.draw(key, (2, 3, 41), kind, offset=prng.row_offset(rows, (2, 3, 41)))
    assert torch.equal(part, whole[2:4])
    assert torch.equal(prng.draw(key, (1, 3, 41), kind), whole[:1])
    device_key = torch.tensor(np.asarray(key, np.uint32).view(np.int32))
    assert torch.equal(prng.draw(device_key, (5, 3, 41), kind), whole)
    with pytest.raises(ValueError):
        prng.draw(key, (2,), "laplace")


@pytest.mark.parametrize("typical_mass", [1.0, 0.9])
def test_categorical_through_sample_token(typical_mass):
    """``sample_token`` under a key with the warpers on draws JAX's tokens."""
    rng = np.random.default_rng(3)
    for seed in range(6):
        x = (rng.normal(size=(4, 8194)) * 2.0).astype(np.float32)
        seen = rng.random((4, 8194)) < 0.01
        key = jax.random.PRNGKey(seed)
        ref = jsamp.sample_token(key, jnp.asarray(x), seen_mask=jnp.asarray(seen),
                                 typical_mass=typical_mass)
        ours = tsamp.sample_token(torch.from_numpy(x), seen_mask=torch.from_numpy(seen),
                                  typical_mass=typical_mass, key=prng.PRNGKey(seed))
        assert ours.tolist() == np.asarray(ref).tolist()


def test_server_batch_key_is_jax_batch_rng():
    for seeds in ([0], [3, -1], [5, 2 ** 33 + 1, 7, 0]):
        group = [type("R", (), {"seed": s}) for s in seeds]
        assert TTSServer._batch_key(group) == _kd(JaxServer._batch_rng(None, group))


class _Recorder:
    """An engine that records the key of each chunk batch and returns silence."""

    cfg = type("Cfg", (), {"data": type("Data", (), {"sampling_rate": 24000})})

    def __init__(self, port: bool):
        self.port, self.keys = port, []

    def synthesize_batch(self, texts, prompts, rng=None, seed=None):
        self.keys.append(prng.as_key(seed) if self.port else _kd(rng))
        return [np.zeros(480, np.float32) for _ in texts]

    synthesize_vq_batch = synthesize_batch


@pytest.mark.parametrize("vq_only", [False, True])
def test_longform_chunk_keys_are_jax_split_chain(vq_only):
    text = "yi1. er4. san1. si4. wu3. liu4. qi1."
    for seed in (0, 3):
        ours, ref = _Recorder(True), _Recorder(False)
        longform.synthesize_long(ours, text, np.zeros(100, np.float32), seed=seed,
                                 batch_size=2, vq_only=vq_only)
        jax_longform.synthesize_long(ref, text, np.zeros(100, np.float32),
                                     rng=jax.random.PRNGKey(seed), batch_size=2,
                                     vq_only=vq_only)
        assert len(ours.keys) == 4 and ours.keys == ref.keys
        stream = _Recorder(True)
        list(longform.synthesize_long_stream(stream, text, np.zeros(100, np.float32),
                                             seed=seed, batch_size=2, vq_only=vq_only))
        assert stream.keys == ref.keys


# ----------------------------------------------------------- end to end

BUCKETS = dict(max_generate_length=16, text_buckets=(16,), prompt_buckets=(24, 48),
               code_buckets=(8, 16))
TEXTS = ["ni3 hao3", "wo3 men5 hao3 a5"]


@pytest.fixture(scope="module")
def engines():
    """{sampler: (JAX engine, port engine)} on the same seeded weights, fp32
    with an fp32 KV cache; each JAX engine compiles once a static shape."""
    model, jvars, port = synth_pair()
    out = {}
    for sampler in ("ancestral", "dpmpp_2m"):
        jcfg = JaxEngineConfig(diffusion_sampler=sampler, compute_dtype=None,
                               cache_dtype=jnp.float32, **BUCKETS)
        pcfg = EngineConfig(diffusion_sampler=sampler, compute_dtype=torch.float32,
                            cache_dtype=torch.float32, **BUCKETS)
        out[sampler] = (JaxEngine(model.cfg, jvars, jcfg),
                        TTSEngine(port, pcfg, device="cpu"))
    return out


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.uniform(-0.3, 0.3, n).astype(np.float32) for n in (9600, 7277)]


@pytest.mark.parametrize("sampler", ["ancestral", "dpmpp_2m"])
@pytest.mark.parametrize("force_full", [True, False])
def test_engine_matches_jax_engine_for_a_seed(engines, sampler, force_full):
    """Codes equal in every row, and the audio within the slice's 1e-3, at
    seeds 0 and 3 through the split dispatch."""
    jeng, peng = engines[sampler]
    for seed in (0, 3):
        jpend = jeng.dispatch_decode(TEXTS, _prompts(), rng=jax.random.PRNGKey(seed),
                                     force_full=force_full)
        jcodes = np.asarray(jpend.codes)
        jwav = jeng.finalize_batch(jeng.dispatch_tail(jpend))
        ppend = peng.dispatch_decode(TEXTS, _prompts(), seed=seed, force_full=force_full)
        np.testing.assert_array_equal(ppend.codes.numpy(), jcodes)
        pwav = peng.finalize_batch(peng.dispatch_tail(ppend))
        assert [w.shape for w in pwav] == [w.shape for w in jwav]
        for ours, ref in zip(pwav, jwav):
            assert np.max(np.abs(ours - ref)) <= 1e-3
            assert np.std(ref) > 1e-3  # not a constant output


def test_engine_key_argument_is_the_seed_key(engines):
    """An entry point's int seed means PRNGKey(seed); a key is taken as it is."""
    _, peng = engines["ancestral"]
    cfg = dataclasses.replace(peng.ecfg, max_generate_length=4, code_buckets=(4,))
    eng = TTSEngine(peng.model, cfg, device="cpu")
    a = eng.synthesize_batch(TEXTS[:1], _prompts()[:1], seed=5, force_full=True)
    b = eng.synthesize_batch(TEXTS[:1], _prompts()[:1], seed=(0, 5), force_full=True)
    np.testing.assert_array_equal(a[0], b[0])
