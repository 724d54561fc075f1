"""The zero-shot synthesis slice as a whole against the same JAX functions
composed by hand: fixed codes -> GPT latents -> diffusion with matched noise
-> flow-VAE + vocoder with ``noise_scale=0``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from detail_tts_tpu.audio.mel import denormalize_mel as jax_denorm
from detail_tts_tpu.models.diffusion import p_sample_loop as jax_p_sample_loop
from detail_tts_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
from detail_tts_tpu.models.synthesizer import make_infer_schedule as jax_schedule
from detail_tts_tpu_torch.audio.mel import denormalize_mel
from detail_tts_tpu_torch.models.diffusion import p_sample_loop
from detail_tts_tpu_torch.models.synthesizer import make_infer_schedule
from tests.torch_parity import japply, synth_pair, t


def test_slice_matches_composed_jax_functions():
    """fixed codes -> latents -> diffusion (matched noise) -> vocoder."""
    model, jvars, port = synth_pair()
    rng = np.random.default_rng(5)
    b, tc = 2, 7
    prompt = rng.normal(-5, 2, size=(b, 32, 128)).astype(np.float32)
    plen = np.array([32, 21], np.int32)
    text = rng.integers(3, 200, size=(b, 10)).astype(np.int32)
    codes = rng.integers(0, 8192, size=(b, tc)).astype(np.int32)
    eff = np.array([tc, 5], np.int32)
    wav_len = eff * 1024
    steps = port.cfg.diffusion.infer_steps
    noise = rng.normal(size=(b, 4 * tc, 128)).astype(np.float32)
    noise_seq = rng.normal(size=(steps, b, 4 * tc, 128)).astype(np.float32)
    j = jnp.asarray

    def jax_slice():
        lat = japply(lambda m, *a: m.gpt(*a[:3], None, *a[3:], return_latent=True,
                                         deterministic=True),
                     j(prompt), j(plen), j(text), j(codes), j(wav_len))
        cond = japply(JaxSynth.diffusion_conditioning, j(prompt))
        emb = japply(JaxSynth.diffusion_code_embedding, lat, cond)
        biases = japply(lambda m: m.diffusion_attention_biases(4 * tc))

        def fn(x, t_orig, _):
            return model.apply(jvars, x, t_orig, emb, biases,
                               method=JaxSynth.diffusion_cfg_step)

        mel = jax_denorm(jax_p_sample_loop(
            jax_schedule(model.cfg), fn, j(noise), jax.random.PRNGKey(0),
            cond_free_k=2.0, conditioning_free=True, noise_seq=j(noise_seq)))
        wav = japply(lambda m, x, n: m.infer_flowvae(x, n, jax.random.PRNGKey(1),
                                                     noise_scale=0.0),
                     mel, j(eff * 4))
        return np.asarray(mel), np.asarray(wav)

    with torch.no_grad():
        lat = port.gpt(t(prompt), t(plen, torch.long), t(text, torch.long),
                       t(codes, torch.long), t(wav_len, torch.long))
        emb = port.diffusion_code_embedding(lat, port.diffusion_conditioning(t(prompt)))
        biases = port.diffusion_attention_biases(4 * tc)
        mel = denormalize_mel(p_sample_loop(
            make_infer_schedule(port.cfg),
            lambda x, t2: port.diffusion_cfg_step(x, t2, emb, biases),
            t(noise), cond_free_k=2.0, noise_seq=t(noise_seq)))
        wav = port.infer_flowvae(mel, t(eff * 4, torch.long), noise_scale=0.0)

    ref_mel, ref_wav = jax_slice()
    assert np.mean(np.abs(mel.numpy() - ref_mel)) <= 1e-3
    assert np.max(np.abs(wav.numpy() - ref_wav)) <= 1e-3
    assert np.std(ref_wav) > 1e-3  # not a constant output


