"""Padding, bucketing and batch invariance of the port's serving engine: the
twin of ``tests/test_serving_invariance.py`` at the same small config, fp32
compute on the CPU.

* prompt padding: masked consumers give equal results for a prompt padded
  up to any bucket;
* per-item diffusion conditioning depends only on the item;
* code padding: the causal GPT's latents at real positions do not depend on
  how far the codes were stop-padded;
* the VQ decode's trimmed mel does not depend on the code bucket;
* the whole request: an item's audio does not depend on the rows batched
  after it (JAX's threefry draws depend on the flat index only;
  ``ops/prng.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from detail_tts_tpu_torch.config import small_test_config
from detail_tts_tpu_torch.serving.pipeline import EngineConfig, TTSEngine, random_engine

# several pytest workers share the host: one intra-op thread each
torch.set_num_threads(1)

ECFG = EngineConfig(max_generate_length=16, text_buckets=(16,), prompt_buckets=(24, 48),
                    code_buckets=(8, 16), compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def eng():
    return random_engine(small_test_config(), engine_cfg=ECFG, device="cpu")


def _prompt(seconds, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.3, 0.3, int(seconds * 24000)).astype(np.float32)


def _codes(seed, eng):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, eng.cfg.vaegan.vq_bins, size=(1, 16)))


def _pad_both(eng, codes, eff, vq_safe=False):
    """(codes, wav lengths) stop-filled at the 8 bucket and at 16 (an engine
    over the same model whose only code bucket is 16)."""
    wide = TTSEngine(eng.model, dataclasses.replace(ECFG, code_buckets=(16,)), device="cpu")
    c8, wl8, b8 = eng._pad_codes(codes[:, :8], eff, vq_safe=vq_safe)
    c16, wl16, b16 = wide._pad_codes(codes, eff, vq_safe=vq_safe)
    assert (b8, b16) == (8, 16)
    return (c8, wl8), (c16, wl16)


@torch.inference_mode()
def test_prepare_prompt_pads_up_with_true_lengths(eng):
    short, long = _prompt(0.05, 0), _prompt(0.45, 1)  # ~4 and ~42 frames
    mel, lens = eng.prepare_prompt([short, long])
    assert mel.shape[1] == 48  # bucket_up(42)
    assert int(lens[0]) == len(short) // 256
    assert int(lens[1]) == len(long) // 256
    assert float(mel[0, int(lens[0]):].abs().max()) == 0.0  # padding is zeros


@torch.inference_mode()
def test_prompt_conditioning_batch_independent(eng):
    """Each item's conditioning equals its value alone, whatever its batch mates."""
    short, long = _prompt(0.2, 2), _prompt(0.45, 3)
    mel_b, len_b = eng.prepare_prompt([short, long])
    cond_b = eng.diffusion_cond(mel_b, len_b).numpy()
    mel_s, len_s = eng.prepare_prompt([short])
    np.testing.assert_array_equal(cond_b[0], eng.diffusion_cond(mel_s, len_s).numpy()[0])
    mel_l, len_l = eng.prepare_prompt([long])
    np.testing.assert_array_equal(cond_b[1], eng.diffusion_cond(mel_l, len_l).numpy()[0])


@torch.inference_mode()
def test_gpt_latents_invariant_to_prompt_padding(eng):
    """Masked GPT conditioning: equal latents for 24- and 48-bucket prompts."""
    text, _ = eng.prepare_text(["ni3 hao3"])
    codes = torch.full((1, 8), 3, dtype=torch.long)
    wav_len = torch.tensor([8 * eng.cfg.gpt.mel_length_compression])
    mel24, len24 = eng.prepare_prompt([_prompt(0.2, 4)])  # 18 frames
    assert mel24.shape[1] == 24
    mel48 = torch.nn.functional.pad(mel24, (0, 0, 0, 24))
    lat24 = eng.model.gpt(mel24, len24, text, codes, wav_len).numpy()
    lat48 = eng.model.gpt(mel48, len24, text, codes, wav_len).numpy()
    np.testing.assert_allclose(lat24, lat48, atol=1e-5, rtol=1e-5)


@torch.inference_mode()
def test_gpt_latents_invariant_to_code_bucket(eng):
    """Causal GPT: latents at real positions equal across code buckets."""
    text, _ = eng.prepare_text(["ni3 hao3"])
    mel, mlen = eng.prepare_prompt([_prompt(0.3, 5)])
    (c8, wl8), (c16, wl16) = _pad_both(eng, _codes(0, eng), np.array([6]))
    np.testing.assert_array_equal(c8.numpy(), c16.numpy()[:, :8])
    lat8 = eng.model.gpt(mel, mlen, text, c8, wl8).numpy()
    lat16 = eng.model.gpt(mel, mlen, text, c16, wl16).numpy()
    np.testing.assert_allclose(lat8[:, :6], lat16[:, :6], atol=1e-5, rtol=1e-5)


@torch.inference_mode()
def test_vq_decode_trimmed_invariance(eng):
    """decode_codes_to_mel: real frames away from the pad boundary match
    across code buckets (masked style encoder, local transposed convs)."""
    mel_p, len_p = eng.prepare_prompt([_prompt(0.3, 6)])
    (c8, _), (c16, _) = _pad_both(eng, _codes(1, eng), np.array([6]), vq_safe=True)
    m8 = eng._codes_to_mel(c8, mel_p, len_p).numpy()
    m16 = eng._codes_to_mel(c16, mel_p, len_p).numpy()
    # 6 real codes -> 24 real mel frames; the vq_dec upsampler's receptive
    # field reaches ~2 codes (8 frames) back from the boundary
    np.testing.assert_allclose(m8[:, :16], m16[:, :16], atol=1e-5, rtol=1e-4)


def test_synthesize_same_buckets_batch_independent(eng):
    """The whole request: the same item gives the same audio alone or batched
    with another text (same buckets, force_full), as JAX's engine does; its
    bound, 5e-4, allows for batch-size-dependent rounding."""
    wav = _prompt(0.4, 7)
    solo = eng.synthesize_batch(["ni3 hao3"], [wav], seed=42, force_full=True)
    pair = eng.synthesize_batch(["ni3 hao3", "wo3 men5 hao3"], [wav, wav], seed=42,
                                force_full=True)
    assert solo[0].shape == pair[0].shape
    np.testing.assert_allclose(solo[0], pair[0], atol=5e-4)
    assert np.std(solo[0]) > 1e-3  # not a constant output
