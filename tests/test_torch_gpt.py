"""Port GPT (UnifiedVoice) vs the JAX one: teacher-forced cached decode
logits, the return_latent pass, and the decode loop's contract."""
import jax.numpy as jnp
import numpy as np
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
