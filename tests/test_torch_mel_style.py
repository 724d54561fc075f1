"""Port mel frontend and MelStyleEncoder vs the JAX package (CPU, fp32)."""
from operator import attrgetter

import jax.numpy as jnp
import numpy as np
import torch

from detail_tts_tpu.audio.mel import MelFrontend as JaxMel
from detail_tts_tpu.nn.common import sequence_mask as jax_mask
from detail_tts_tpu_torch.audio.mel import MelFrontend, denormalize_mel, normalize_mel
from detail_tts_tpu_torch.nn.common import sequence_mask
from tests.torch_parity import close, japply, synth_pair, t


def test_mel_matches_jax_frontend():
    rng = np.random.default_rng(0)
    wav = rng.uniform(-0.5, 0.5, (2, 12000)).astype(np.float32)
    ref = np.asarray(JaxMel().mel_spectrogram(jnp.asarray(wav)))
    ours = MelFrontend().mel_spectrogram(t(wav))
    assert ours.shape == ref.shape == (2, 46, 128)
    # log-mel: the atol carries the log of small mel energies (~1e-5 floor)
    close(ours, ref, atol=1e-4, rtol=1e-4)
    close(denormalize_mel(normalize_mel(ours)), ours, atol=1e-5)


def test_style_encoders_masked_with_padding():
    _, _, port = synth_pair()
    rng = np.random.default_rng(1)
    mel = rng.normal(size=(3, 40, 128)).astype(np.float32)
    lengths = np.array([40, 23, 1], np.int32)
    jm = jax_mask(jnp.asarray(lengths), 40)
    for name in ("ref_enc", "gpt.conditioning_encoder"):
        enc = attrgetter(name)
        ref = japply(lambda m, x, k: enc(m)(x, k), jnp.asarray(mel), jm)
        ours = enc(port)(t(mel), sequence_mask(t(lengths), 40))
        close(ours, ref)
    unmasked = port.ref_enc(t(mel))
    ref = japply(lambda m, x: m.ref_enc(x), jnp.asarray(mel))
    close(unmasked, ref)
    assert torch.isfinite(unmasked).all()
