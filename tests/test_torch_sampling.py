"""Port sampling warpers vs ``detail_tts_tpu/ops/sampling.py`` on fixed logits
(ties at the top-p boundary included), and the sampled tokens given JAX's
own Gumbel draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detail_tts_tpu.ops import sampling as jsamp
from detail_tts_tpu_torch.ops import sampling as tsamp


def _logits(seed=0, b=4, v=50):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, v)).astype(np.float32) * 2.0
    # ties: repeated values straddling the nucleus boundary
    x[0, :10] = 1.5
    x[1, ::3] = x[1, 0]
    x[2, :] = np.round(x[2, :])
    return x


def _seen(b=4, v=50, seed=1):
    return np.random.default_rng(seed).random((b, v)) < 0.3


def _same(ours, ref):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert np.array_equal(np.isinf(ours), np.isinf(ref))
    np.testing.assert_allclose(ours[~np.isinf(ours)], ref[~np.isinf(ref)],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("top_p", [0.1, 0.5, 0.8, 0.95, 1.0])
def test_top_p_matches(top_p):
    x = _logits()
    _same(tsamp.apply_top_p(torch.from_numpy(x), top_p),
          jsamp.apply_top_p(jnp.asarray(x), top_p))


@pytest.mark.parametrize("mass", [0.2, 0.9, 1.0])
def test_typical_matches(mass):
    x = _logits(3)
    _same(tsamp.apply_typical(torch.from_numpy(x), mass),
          jsamp.apply_typical(jnp.asarray(x), mass))


def test_penalty_and_temperature_match():
    x, seen = _logits(5), _seen()
    _same(tsamp.apply_repetition_penalty(torch.from_numpy(x),
                                         torch.from_numpy(seen), 2.0),
          jsamp.apply_repetition_penalty(jnp.asarray(x), jnp.asarray(seen), 2.0))
    _same(tsamp.apply_temperature(torch.from_numpy(x), 0.8),
          jsamp.apply_temperature(jnp.asarray(x), 0.8))


@pytest.mark.parametrize("typical_mass", [1.0, 0.9])
def test_tokens_match_given_jax_gumbel(typical_mass):
    """jax.random.categorical(key, l) == argmax(l + gumbel(key, l.shape))."""
    for seed in range(8):
        x, seen = _logits(seed), _seen(seed=seed + 10)
        key = jax.random.PRNGKey(seed)
        ref = jsamp.sample_token(key, jnp.asarray(x), seen_mask=jnp.asarray(seen),
                                 typical_mass=typical_mass)
        gumbel = np.asarray(jax.random.gumbel(key, x.shape))
        ours = tsamp.sample_token(torch.from_numpy(x),
                                  seen_mask=torch.from_numpy(seen),
                                  typical_mass=typical_mass,
                                  gumbel=torch.from_numpy(gumbel))
        assert ours.tolist() == np.asarray(ref).tolist()


def test_generator_draws_are_reproducible():
    x, seen = torch.from_numpy(_logits()), torch.from_numpy(_seen())
    a = tsamp.sample_token(x, seen_mask=seen,
                           generator=torch.Generator().manual_seed(3))
    b = tsamp.sample_token(x, seen_mask=seen,
                           generator=torch.Generator().manual_seed(3))
    assert a.tolist() == b.tolist()
