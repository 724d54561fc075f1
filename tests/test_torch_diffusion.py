"""Port diffusion refiner vs the JAX one: hoisted T5 biases, the CFG call with
its B+1 integrator-row dedup, the conditioning/code-embedding parts, and the
ancestral sampler with matched noise."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from detail_tts_tpu.models.diffusion import p_sample_loop as jax_p_sample_loop
from detail_tts_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
from detail_tts_tpu.models.synthesizer import make_infer_schedule as jax_schedule
from detail_tts_tpu_torch.models.diffusion import p_sample_loop
from detail_tts_tpu_torch.models.synthesizer import make_infer_schedule
from tests.torch_parity import close, japply, synth_pair, t

B, TC = 2, 6
T = 4 * TC


def _parts(seed=0):
    rng = np.random.default_rng(seed)
    latents = rng.normal(size=(B, TC, 64)).astype(np.float32)
    prompt = rng.normal(size=(B, 32, 128)).astype(np.float32)
    return latents, prompt


def test_biases_conditioning_and_code_embedding_match():
    port = synth_pair()[2]
    latents, prompt = _parts()
    ref_b = japply(lambda m: m.diffusion_attention_biases(T))
    ours_b = port.diffusion_attention_biases(T)
    assert len(ours_b) == 3 + 2
    for a, b in zip(ours_b, ref_b):
        close(a, b)
    ref_c = japply(JaxSynth.diffusion_conditioning, jnp.asarray(prompt))
    ours_c = port.diffusion_conditioning(t(prompt))
    close(ours_c, ref_c)
    ref_e = japply(JaxSynth.diffusion_code_embedding, jnp.asarray(latents), ref_c)
    close(port.diffusion_code_embedding(t(latents), ours_c), ref_e)


def test_cfg_call_matches():
    port = synth_pair()[2]
    rng = np.random.default_rng(1)
    x2 = rng.normal(size=(2 * B, T, 128)).astype(np.float32)
    t2 = np.array([3000, 1200, 3000, 1200], np.int32)
    code_emb = rng.normal(size=(B, T, 64)).astype(np.float32)
    biases = port.diffusion_attention_biases(T)
    ref = japply(JaxSynth.diffusion_cfg_step, jnp.asarray(x2), jnp.asarray(t2),
                 jnp.asarray(code_emb), [jnp.asarray(b.numpy()) for b in biases])
    eps, var = port.diffusion_cfg_step(t(x2), t(t2, torch.long), t(code_emb), biases)
    close(eps, ref[0])
    close(var, ref[1])
    # the unconditioned half does not depend on the conditioning
    eps_b, _ = port.diffusion_cfg_step(t(x2), t(t2, torch.long),
                                       t(code_emb) * 2.0, biases)
    close(eps_b[B:], eps[B:], atol=1e-5)


def test_p_sample_loop_matches_with_matched_noise():
    model, jvars, port = synth_pair()
    rng = np.random.default_rng(2)
    latents, prompt = _parts(3)
    noise = rng.normal(size=(B, T, 128)).astype(np.float32)
    steps = port.cfg.diffusion.infer_steps
    noise_seq = rng.normal(size=(steps, B, T, 128)).astype(np.float32)

    cond = japply(JaxSynth.diffusion_conditioning, jnp.asarray(prompt))
    code_emb = japply(JaxSynth.diffusion_code_embedding, jnp.asarray(latents), cond)
    biases = port.diffusion_attention_biases(T)
    jb = [jnp.asarray(b.numpy()) for b in biases]

    def jax_fn(x, t_orig, _):
        return model.apply(jvars, x, t_orig, code_emb, jb,
                           method=JaxSynth.diffusion_cfg_step)

    ref = jax_p_sample_loop(jax_schedule(model.cfg), jax_fn, jnp.asarray(noise),
                            jax.random.PRNGKey(0), cond_free_k=2.0,
                            conditioning_free=True, noise_seq=jnp.asarray(noise_seq))
    p_emb = t(np.asarray(code_emb))
    ours = p_sample_loop(make_infer_schedule(port.cfg),
                         lambda x, t2: port.diffusion_cfg_step(x, t2, p_emb, biases),
                         t(noise), cond_free_k=2.0, noise_seq=t(noise_seq))
    assert ours.shape == (B, T, 128)
    close(ours, ref)
