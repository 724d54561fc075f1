"""The decode step's sampler (``ops/sampling.py`` ``sample_step``, whose plain
version runs here on the CPU) against the JAX package: ``sample_token``
(``detail_tts_tpu/ops/sampling.py``) and the bookkeeping of ``body_fn``
(``detail_tts_tpu/models/gpt.py:364-371``) on seeded numpy logits, seen
masks and state, under the same ``jax.random`` key; and the decode loop
(``generate_speech_tokens``) against JAX's with every filter on.

Tokens, codes, seen, lengths and finished are required equal.  The kernel
(``csrc/sample.cu``) is held against this plain version on the card by
``tests/test_torch_kernel_cuda.py`` and ``chip_smoke.py`` phase 3c.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detail_tts_tpu.models.gpt import SamplingConfig as JaxSampling
from detail_tts_tpu.models.gpt import UnifiedVoice
from detail_tts_tpu.models.gpt import generate_speech_tokens as jax_generate
from detail_tts_tpu.ops import sampling as jsamp
from detail_tts_tpu_torch.models.gpt import SamplingConfig, generate_speech_tokens
from detail_tts_tpu_torch.ops import prng
from detail_tts_tpu_torch.ops import sampling as tsamp
from tests.torch_parity import seeded_variables, synth_pair, t

B, V, N, STEP = 4, 257, 12, 3
STOP = V - 1
# (repetition_penalty, temperature, top_p, typical_mass): every combination
SETTINGS = list(itertools.product((1.0, 2.0), (1.0, 0.8), (1.0, 0.8), (1.0, 0.9)))
CASES = ("random", "finished", "force_full", "offset", "ties", "zeros")


def _inputs(case, seed, v=V, b=B):
    """Logits ~ 2 N(0, 1) (``ties``: rounded to integers, so the top-p
    boundary falls in a group of equal values; ``zeros``: a -0.0 / +0.0 pair
    in every row), seen ~10% plus the fake prefix, mid-request state."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, v)) * 2.0).astype(np.float32)
    if case == "ties":
        x = np.round(x)
    elif case == "zeros":
        x[:, 3], x[:, 7] = -0.0, 0.0
    seen = rng.random((b, v)) < 0.1
    seen[:, 1] = True
    codes = np.full((b, N), v - 1, np.int64)
    codes[:, :STEP] = rng.integers(0, v - 1, size=(b, STEP))
    lengths = np.full(b, STEP, np.int64)
    finished = np.zeros(b, bool)
    if case == "finished":
        finished[[0, 2]] = True
        lengths[[0, 2]] = 1
    return x, seen, codes, lengths, finished


def _jax_step(key, x, seen, codes, lengths, finished, setting, force_full, stop=STOP):
    """``sample_token`` then ``body_fn``'s bookkeeping, as the JAX decode
    loop writes them."""
    penalty, temperature, top_p, mass = setting
    tok = jsamp.sample_token(key, jnp.asarray(x), seen_mask=jnp.asarray(seen),
                             temperature=temperature, top_p=top_p,
                             repetition_penalty=penalty, typical_mass=mass)
    finished = jnp.asarray(finished)
    tok = jnp.where(finished, stop, tok)
    codes = jax.lax.dynamic_update_slice(jnp.asarray(codes, jnp.int32), tok[:, None],
                                         (0, STEP))
    seen = jnp.asarray(seen).at[jnp.arange(x.shape[0]), tok].set(True)
    now_finished = finished if force_full else finished | (tok == stop)
    lengths = jnp.where(finished, lengths, lengths + 1)
    return [np.asarray(a) for a in (tok, codes, seen, lengths, now_finished)]


def _keys(seed):
    """Step STEP's key of the decode chain: JAX's ``rng, key = split(rng)``
    and the port's device key buffer row."""
    rng = jax.random.PRNGKey(seed)
    for _ in range(STEP + 1):
        rng, key = jax.random.split(rng)
    return key, prng.decode_keys(seed, STEP + 1)[STEP]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("setting", SETTINGS, ids=lambda s: "p%g-t%g-top%g-typ%g" % s)
def test_plain_step_matches_jax_body(setting, case):
    seed = SETTINGS.index(setting) * len(CASES) + CASES.index(case)
    x, seen, codes, lengths, finished = _inputs(case, seed)
    jkey, key = _keys(seed)
    force_full = case == "force_full"
    want = _jax_step(jkey, x, seen, codes, lengths, finished, setting, force_full)
    # a data rank of a (2 x 1) engine: rows 2-3 of the request, from their offset
    rows = slice(2, 4) if case == "offset" else slice(0, B)
    state = [torch.from_numpy(a[rows].copy()) for a in (seen, codes, lengths, finished)]
    penalty, temperature, top_p, mass = setting
    tok = tsamp.sample_step(torch.from_numpy(x[rows].copy()), *state, STEP, key,
                            temperature=temperature, top_p=top_p,
                            repetition_penalty=penalty, typical_mass=mass, stop_token=STOP,
                            force_full=force_full, offset=rows.start * V)
    seen_t, codes_t, lengths_t, finished_t = state
    for name, ours, ref in zip(("tokens", "codes", "seen", "lengths", "finished"),
                               (tok, codes_t, seen_t, lengths_t, finished_t), want):
        assert ours.dtype in (torch.int64, torch.bool), name
        np.testing.assert_array_equal(ours.numpy(), ref[rows], err_msg=name)


# vocabularies past what one CTA of the kernel held: one more than 12288, a
# 16384-entry codebook's mel codes, the most the kernel's shared-memory path
# takes, and past it (the wide path: one more; an odd V in three rows, whose
# rows 1 and 2 start off every 16-byte boundary; a 131071-entry codebook's)
WIDE = (12289, 16386, 65536, 65537, 65539, 131073)
WIDE_ROWS = {65539: 3}  # rows of the batch where not B


@pytest.mark.parametrize("v", WIDE)
@pytest.mark.parametrize("setting", SETTINGS, ids=lambda s: "p%g-t%g-top%g-typ%g" % s)
def test_plain_step_matches_jax_body_at_wide_vocabularies(setting, v):
    """``sample_step`` takes every vocabulary JAX's ``sample_token`` takes:
    tokens and the step's state equal at V past 12288 and past 65536."""
    seed = 1000 + SETTINGS.index(setting) + v
    x, seen, codes, lengths, finished = _inputs("finished", seed, v, WIDE_ROWS.get(v, B))
    jkey, key = _keys(seed)
    want = _jax_step(jkey, x, seen, codes, lengths, finished, setting, False, stop=v - 1)
    state = [torch.from_numpy(a.copy()) for a in (seen, codes, lengths, finished)]
    penalty, temperature, top_p, mass = setting
    tok = tsamp.sample_step(torch.from_numpy(x), *state, STEP, key, temperature=temperature,
                            top_p=top_p, repetition_penalty=penalty, typical_mass=mass,
                            stop_token=v - 1, force_full=False)
    seen_t, codes_t, lengths_t, finished_t = state
    for name, ours, ref in zip(("tokens", "codes", "seen", "lengths", "finished"),
                               (tok, codes_t, seen_t, lengths_t, finished_t), want):
        np.testing.assert_array_equal(ours.numpy(), ref, err_msg=name)


def test_sample_step_takes_every_vocabulary_up_to_max_vocab():
    """No vocabulary cap is left (the kernel's was 65536, eight CTAs of 8192
    tokens): V one past it and a 131071-entry codebook's are taken."""
    key = prng.decode_keys(2, 1)[0]
    kw = dict(temperature=0.8, top_p=0.8, repetition_penalty=2.0, typical_mass=0.9,
              force_full=False)
    state = (torch.zeros((1, 2), dtype=torch.long), torch.zeros(1, dtype=torch.long),
             torch.zeros(1, dtype=torch.bool))
    assert not hasattr(tsamp, "MAX_VOCAB")
    for v in (65537, 131073):
        x = torch.zeros((1, v))
        seen = torch.zeros_like(x, dtype=torch.bool)
        tok = tsamp.sample_step(x, seen, *state, 0, key, stop_token=v - 1, **kw)
        assert tok.shape == (1,) and 0 <= int(tok) < v and bool(seen[0, tok])


def test_plain_step_breaks_ties_at_the_top_p_boundary_by_index():
    """Equal values straddling the boundary: only the earlier copies (in
    index order) are removed, as HF's stable sort removes them."""
    x = np.full((1, 8), -4.0, np.float32)
    x[0, [1, 4, 6]] = 1.0  # three equal values carrying ~0.99 of the mass
    keep = tsamp.apply_top_p(torch.from_numpy(x), 0.5)
    ref = jsamp.apply_top_p(jnp.asarray(x), 0.5)
    np.testing.assert_array_equal(np.isinf(keep.numpy()), np.isinf(np.asarray(ref)))
    assert np.isinf(keep.numpy()[0, [0, 1, 2, 3, 5, 7]]).all()
    assert np.isfinite(keep.numpy()[0, [4, 6]]).all()


def test_sample_step_raises_on_what_the_kernel_does_not_take():
    x, seen, codes, lengths, finished = (torch.from_numpy(a) for a in _inputs("random", 0))
    key = prng.decode_keys(0, 1)[0]
    kw = dict(temperature=0.8, top_p=0.8, repetition_penalty=2.0, typical_mass=1.0,
              stop_token=STOP, force_full=False)
    with pytest.raises(TypeError):
        tsamp.sample_step(x.half(), seen, codes, lengths, finished, 0, key, **kw)
    with pytest.raises(ValueError):
        tsamp.sample_step(x.t().contiguous().t(), seen, codes, lengths, finished, 0, key, **kw)
    with pytest.raises(ValueError):
        tsamp.sample_step(x, seen, codes, lengths, finished, 0, key.long(), **kw)
    with pytest.raises(ValueError):
        tsamp.sample_step(x, seen, codes, lengths, finished, N, key, **kw)
    with pytest.raises(ValueError):
        tsamp.sample_step(x, seen.long(), codes, lengths, finished, 0, key, **kw)
    with pytest.raises(ValueError):
        tsamp.sample_step(x, seen, codes, lengths, finished, 0, key, **dict(kw, stop_token=V))
    empty = torch.zeros((1, 0))
    with pytest.raises(ValueError, match="vocabulary 0"):
        tsamp.sample_step(empty, torch.zeros_like(empty, dtype=torch.bool), codes[:1],
                          lengths[:1], finished[:1], 0, key, **dict(kw, stop_token=0))


def test_sample_step_on_the_cpu_is_the_plain_version_in_place():
    x, seen, codes, lengths, finished = (torch.from_numpy(a) for a in _inputs("finished", 9))
    key = prng.decode_keys(4, 3)[2]
    kw = dict(temperature=0.8, top_p=0.8, repetition_penalty=2.0, typical_mass=0.9,
              stop_token=STOP, force_full=False)
    before = tsamp.LAUNCHES["sample_step"]
    a = [s.clone() for s in (seen, codes, lengths, finished)]
    b = [s.clone() for s in (seen, codes, lengths, finished)]
    tok = tsamp.sample_step(x, *a, STEP, key, **kw)
    ref = tsamp.sample_step_reference(x, *b, STEP, key, **kw)
    assert tsamp.LAUNCHES["sample_step"] == before  # the CPU never counts a launch
    assert torch.equal(tok, ref)
    for ours, theirs in zip(a, b):
        assert torch.equal(ours, theirs)
    assert (a[1][:, STEP] == tok).all() and a[0][torch.arange(B), tok].all()
    assert a[2].tolist() == [1, STEP + 1, 1, STEP + 1]  # finished rows do not count


@pytest.mark.parametrize("seed", [0, 3])
def test_decode_loop_matches_jax_with_every_filter_on(seed):
    """``generate_speech_tokens`` (a ``sample_step`` a step) against JAX's
    while loop on the same weights and key, penalty, temperature, typical
    and top-p all on, early stop: codes and lengths equal."""
    model, jvars, port = synth_pair()
    rng = np.random.default_rng(seed)
    cond = rng.normal(size=(2, 24, 128)).astype(np.float32)
    clen = np.array([24, 17], np.int32)
    text = rng.integers(3, 200, size=(2, 9)).astype(np.int32)
    kw = dict(temperature=0.8, top_p=0.8, repetition_penalty=2.0, typical_mass=0.9,
              max_generate_length=10)
    jcodes, jlengths = jax_generate(
        UnifiedVoice(model.cfg.gpt), {"params": jvars["params"]["gpt"]},
        jax.random.PRNGKey(seed), jnp.asarray(cond), jnp.asarray(clen), jnp.asarray(text),
        sampling=JaxSampling(**kw), cache_dtype=jnp.float32)
    codes, lengths = generate_speech_tokens(
        port.gpt, t(cond), t(clen, torch.long), t(text, torch.long), SamplingConfig(**kw),
        key=seed, cache_dtype=torch.float32)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlengths))


def _wide_gpt_pair(vocab):
    """(JAX GPT config, its seeded variables, the port's GPT) with ``vocab``
    mel codes (start and stop the last two), on ``synth_pair``'s small
    widths."""
    from detail_tts_tpu.config import small_test_config as jax_small_config
    from detail_tts_tpu.serving.pipeline import variables_template
    from detail_tts_tpu_torch.config import small_test_config
    from detail_tts_tpu_torch.io.weights import from_jax_variables
    from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn

    mel = dict(number_mel_codes=vocab, start_mel_token=vocab - 2, stop_mel_token=vocab - 1)
    jcfg, pcfg = jax_small_config(), small_test_config()
    jcfg = dataclasses.replace(jcfg, gpt=dataclasses.replace(jcfg.gpt, **mel))
    pcfg = dataclasses.replace(pcfg, gpt=dataclasses.replace(pcfg.gpt, **mel))
    np_vars = seeded_variables(variables_template(jcfg), 0)
    port = SynthesizerTrn(pcfg)
    state, _ = from_jax_variables(port, np_vars, jcfg.diffusion.num_layers)
    port.load_state_dict(state)
    port.eval().requires_grad_(False)
    return jcfg.gpt, jax.tree_util.tree_map(jnp.asarray, np_vars["params"]["gpt"]), port.gpt


def test_decode_loop_matches_jax_with_every_filter_on_at_vocabulary_16386():
    """The decode loop's twin at a 16384-entry codebook's V = 16386 mel
    codes: the port's codes and lengths equal JAX's ``generate_speech_tokens``."""
    gcfg, params, gpt = _wide_gpt_pair(16386)
    rng = np.random.default_rng(5)
    cond = rng.normal(size=(2, 24, 128)).astype(np.float32)
    clen = np.array([24, 17], np.int32)
    text = rng.integers(3, 200, size=(2, 9)).astype(np.int32)
    kw = dict(temperature=0.8, top_p=0.8, repetition_penalty=2.0, typical_mass=0.9,
              max_generate_length=10)
    jcodes, jlengths = jax_generate(
        UnifiedVoice(gcfg), {"params": params}, jax.random.PRNGKey(5), jnp.asarray(cond),
        jnp.asarray(clen), jnp.asarray(text), sampling=JaxSampling(**kw),
        cache_dtype=jnp.float32)
    codes, lengths = generate_speech_tokens(
        gpt, t(cond), t(clen, torch.long), t(text, torch.long), SamplingConfig(**kw), key=5,
        cache_dtype=torch.float32)
    assert int(np.asarray(jcodes).max()) > 12288  # a code only the wide vocabulary has
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(jlengths))
