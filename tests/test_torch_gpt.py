"""Port GPT (UnifiedVoice) vs the JAX one: teacher-forced cached decode
logits, the return_latent pass, and the decode loop's contract."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detail_tts_tpu_torch.models.gpt import SamplingConfig, generate_speech_tokens
from tests.torch_parity import close, japply, synth_pair, t

B, N = 2, 6


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    cond = rng.normal(size=(B, 24, 128)).astype(np.float32)
    clen = np.array([24, 17], np.int32)
    text = rng.integers(3, 200, size=(B, 9)).astype(np.int32)
    text[1, 6:] = 0  # stop-padded
    tokens = rng.integers(0, 8192, size=(B, N)).astype(np.int32)
    return cond, clen, text, tokens


def test_teacher_forced_decode_logits_match():
    cond, clen, text, tokens = _inputs()

    def jax_decode(m, cond, clen, text, tokens):
        emb = m.gpt.prefill_embeddings(cond, clen, text)
        cache = m.gpt.init_cache(B, emb.shape[1] + N, jnp.float32)
        logits, cache = m.gpt.decode_prefill(emb, cache)
        out = [logits]
        for i in range(N - 1):
            logits, cache = m.gpt.decode_step(tokens[:, i],
                                              jnp.full((B,), i + 1), cache)
            out.append(logits)
        return jnp.stack(out, axis=1)

    ref = japply(jax_decode, jnp.asarray(cond), jnp.asarray(clen),
                 jnp.asarray(text), jnp.asarray(tokens))
    gpt = synth_pair()[2].gpt
    emb = gpt.prefill_embeddings(t(cond), t(clen, torch.long), t(text, torch.long))
    cache = gpt.init_cache(B, emb.shape[1] + N, torch.float32, "cpu")
    out = [gpt.decode_prefill(emb, cache)]
    for i in range(N - 1):
        out.append(gpt.decode_step(t(tokens[:, i], torch.long),
                                   torch.full((B,), i + 1), cache))
    close(torch.stack(out, dim=1), ref)


def test_latents_pass_matches():
    cond, clen, text, _ = _inputs(1)
    codes = np.random.default_rng(2).integers(0, 8192, size=(B, 12)).astype(np.int32)
    wav_len = np.array([12, 7], np.int32) * 1024
    ref = japply(lambda m, *a: m.gpt(*a[:3], None, *a[3:], return_latent=True,
                                     deterministic=True),
                 jnp.asarray(cond), jnp.asarray(clen), jnp.asarray(text),
                 jnp.asarray(codes), jnp.asarray(wav_len))
    ours = synth_pair()[2].gpt(t(cond), t(clen, torch.long), t(text, torch.long),
                               t(codes, torch.long), t(wav_len, torch.long))
    assert ours.shape == (B, 12, 64)
    close(ours, ref)


def test_generate_stops_and_counts_the_stop_token():
    cond, clen, text, _ = _inputs(3)
    gpt = synth_pair()[2].gpt
    stop = gpt.cfg.stop_mel_token
    with torch.no_grad():
        gpt.mel_head.bias[stop] += 50.0  # make stop certain after 1 token
        try:
            codes, lengths = generate_speech_tokens(
                gpt, t(cond), t(clen, torch.long), t(text, torch.long),
                SamplingConfig(max_generate_length=8, top_p=1.0),
                key=0, cache_dtype=torch.float32)
        finally:
            gpt.mel_head.bias[stop] -= 50.0
    assert codes.shape == (B, 8)
    assert lengths.tolist() == [1, 1]
    assert (codes == stop).all()
    full, full_len = generate_speech_tokens(
        gpt, t(cond), t(clen, torch.long), t(text, torch.long),
        SamplingConfig(max_generate_length=5, force_full_length=True),
        key=0, cache_dtype=torch.float32)
    assert full_len.tolist() == [5, 5]


def _prefix(gpt, seed):
    cond, clen, text, tokens = _inputs(seed)
    return (gpt.prefill_embeddings(t(cond), t(clen, torch.long), t(text, torch.long)),
            t(tokens, torch.long))


@torch.no_grad()
def _teacher_forced(gpt, emb, tokens, cache, stale=None):
    """Logits of the prefill and N - 1 steps; ``stale`` fills the cache past
    the prefix after the prefill."""
    out = [gpt.decode_prefill(emb, cache)]
    if stale is not None:
        for x in cache.k + cache.v:
            stale(x[:, emb.shape[1]:])
    for i in range(N - 1):
        out.append(gpt.decode_step(tokens[:, i], torch.full((B,), i + 1), cache))
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("when,value", [
    ("after the prefill", "normal"),  # the mask
    ("before the prefill", "normal"),  # an earlier decode's cache: the prefill
    ("before the prefill", "nan"),     # zeroes it
    ("before the prefill", "inf"),
])
def test_cache_past_its_length_gets_no_weight(when, value):
    """The static step attends over the whole cache: finite, non-zero
    values past the cache's length give the logits of a zeroed cache, and
    whatever an earlier decode left there (NaN and inf too) is zeroed by the
    prefill."""
    gpt = synth_pair()[2].gpt
    emb, tokens = _prefix(gpt, 4)
    zeroed = gpt.init_cache(B, emb.shape[1] + N + 3, torch.float32, "cpu")
    stale = gpt.init_cache(B, emb.shape[1] + N + 3, torch.float32, "cpu")
    g = torch.Generator().manual_seed(0)

    def fill(x):
        if value == "normal":
            x.normal_(0.0, 10.0, generator=g)
        else:
            x.fill_(float(value))

    ref = _teacher_forced(gpt, emb, tokens, zeroed)
    if when == "before the prefill":
        for x in stale.k + stale.v:
            fill(x)
        stale.length.fill_(3)
    out = _teacher_forced(gpt, emb, tokens, stale, fill if when == "after the prefill" else None)
    assert torch.isfinite(ref).all()
    assert torch.equal(out, ref)
    assert stale.length.shape == () and stale.length.dtype == torch.long
    assert int(stale.length) == emb.shape[1] + N - 1


def _decode(gpt, seed, key, n=5, batch=B):
    cond, clen, text, _ = _inputs(seed)
    return generate_speech_tokens(
        gpt, t(cond[:batch]), t(clen[:batch], torch.long), t(text[:batch], torch.long),
        SamplingConfig(max_generate_length=n, force_full_length=True), key=key,
        cache_dtype=torch.float32)


def test_static_step_reuses_its_cache_at_one_shape():
    """Two decodes at one shape run one step holder: its cache, position and
    length are device tensors it keeps, and a decode after another's gives
    the codes of a fresh holder.  On the CPU nothing is captured or
    replayed."""
    from detail_tts_tpu_torch import tracing
    from detail_tts_tpu_torch.models.gpt import DecodeSteps

    gpt = synth_pair()[2].gpt
    gpt.decode_steps = DecodeSteps()
    counters = tracing.snapshot()["counters"]
    before = {k: counters.get(k, {"count": 0})["count"]
              for k in ("decode.graph_replays", "decode.graph_captures")}
    first, first_len = _decode(gpt, 5, key=0)
    (step,) = gpt.decode_steps._steps.values()
    ptrs = [x.data_ptr() for x in step.cache.k + step.cache.v]
    _decode(gpt, 6, key=1)
    again, again_len = _decode(gpt, 5, key=0)
    assert list(gpt.decode_steps._steps.values()) == [step]
    assert [x.data_ptr() for x in step.cache.k + step.cache.v] == ptrs
    assert torch.equal(again, first) and torch.equal(again_len, first_len)
    assert step.cache.length.shape == () and step.position.shape == (B,)
    prefix = _prefix(gpt, 5)[0].shape[1]
    assert int(step.cache.length) == prefix + 4 and step.position.tolist() == [5] * B
    assert step.graph is None
    gpt.decode_steps = DecodeSteps()
    fresh, fresh_len = _decode(gpt, 5, key=0)
    assert torch.equal(fresh, first) and torch.equal(fresh_len, first_len)
    counters = tracing.snapshot()["counters"]
    for k, n in before.items():
        assert counters.get(k, {"count": 0})["count"] == n


def test_kept_steps_are_the_last_used():
    """At most ``KEPT_STEPS`` step holders, the least recently used dropped
    first; all are dropped when a weight of the model moves."""
    from detail_tts_tpu_torch.models.gpt import KEPT_STEPS, DecodeSteps

    gpt = synth_pair()[2].gpt
    gpt.decode_steps = DecodeSteps()
    lengths = list(range(2, 3 + KEPT_STEPS))
    for n in lengths:
        _decode(gpt, 7, key=n, n=n)
    prefix = _prefix(gpt, 7)[0].shape[1]

    def kept():  # max_generate_length of each kept holder
        return sorted(k[1] - prefix for k in gpt.decode_steps._steps)

    assert kept() == lengths[1:]
    _decode(gpt, 7, key=0, n=lengths[1])  # the oldest kept becomes the newest
    _decode(gpt, 7, key=0, n=1)
    assert kept() == [1] + lengths[1:2] + lengths[3:]
    w = gpt.mel_head.weight
    w.data = w.data.clone()
    _decode(gpt, 7, key=0, n=2, batch=1)
    assert len(gpt.decode_steps._steps) == 1
