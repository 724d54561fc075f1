"""The port's DDIM and the two DPM-Solver++(2M) samplers against the JAX
package's, on the same numpy noise: first with an analytic epsilon model
(the one of ``tests/test_samplers.py``, its unconditioned rows scaled so the
guidance matters), then with the small ``DiffusionTts`` through ``cfg_call``
and carried weights.  ``dpmpp_2m`` runs at 5 steps (its last update first
order, ``lower_order_final``) and at 12 (second order to the end)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detail_tts_tpu.config import small_test_config as jax_small_config
from detail_tts_tpu.models import diffusion as jdiff
from detail_tts_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
from detail_tts_tpu.models.synthesizer import make_infer_schedule as jax_schedule
from detail_tts_tpu_torch.config import small_test_config
from detail_tts_tpu_torch.models import diffusion as tdiff
from detail_tts_tpu_torch.models.synthesizer import make_infer_schedule
from tests.torch_parity import close, japply, synth_pair, t

TARGET = 0.7       # the analytic model's data mode
UNCOND = 0.9       # its unconditioned rows' epsilon scale
K = 2.0            # guidance weight
B0, B1 = 0.1 / 4, 20.0 / 4  # the reference DPM-Solver's VP schedule


def _schedules(steps):
    jcfg, tcfg = (dataclasses.replace(c, diffusion=dataclasses.replace(
        c.diffusion, infer_steps=steps)) for c in (jax_small_config(), small_test_config()))
    return jax_schedule(jcfg), make_infer_schedule(tcfg)


def _analytic_jax(schedule, continuous):
    """eps whose x0 estimate is TARGET; unconditioned rows scaled by UNCOND."""
    acp = schedule.alphas_cumprod
    t_map = jnp.asarray(np.asarray(schedule.timestep_map))

    def fn(x, t_in, conditioning_free):
        if continuous:
            tc = t_in.astype(jnp.float32) / 1000.0
            a = jnp.exp(-0.25 * tc ** 2 * (B1 - B0) - 0.5 * tc * B0)
            a = a.reshape((-1,) + (1,) * (x.ndim - 1))
            eps = (x - a * TARGET) / jnp.sqrt(1.0 - a ** 2)
        else:
            a = acp[jnp.searchsorted(t_map, t_in)].reshape((-1,) + (1,) * (x.ndim - 1))
            eps = (x - jnp.sqrt(a) * TARGET) / jnp.sqrt(1.0 - a)
        scale = jnp.where(conditioning_free, UNCOND, 1.0).reshape(
            (-1,) + (1,) * (x.ndim - 1))
        return eps * scale, -jnp.ones_like(x)

    return fn


def _analytic_port(schedule, continuous):
    acp = schedule.alphas_cumprod
    t_map = schedule.timestep_map

    def fn(x2, t2):
        shape = (-1,) + (1,) * (x2.dim() - 1)
        if continuous:
            tc = t2.float() / 1000.0
            a = torch.exp(-0.25 * tc ** 2 * (B1 - B0) - 0.5 * tc * B0).reshape(shape)
            eps = (x2 - a * TARGET) / torch.sqrt(1.0 - a ** 2)
        else:
            a = acp[torch.searchsorted(t_map, t2.contiguous())].reshape(shape)
            eps = (x2 - torch.sqrt(a) * TARGET) / torch.sqrt(1.0 - a)
        b = x2.shape[0] // 2
        scale = torch.ones(2 * b).index_fill_(0, torch.arange(b, 2 * b), UNCOND)
        return eps * scale.reshape(shape), -torch.ones_like(x2)

    return fn


def _run(name, js, ts, jfn, tfn, noise):
    if name == "ddim":
        ref = jdiff.ddim_sample_loop(js, jfn, jnp.asarray(noise), cond_free_k=K,
                                     conditioning_free=True)
        out = tdiff.ddim_sample_loop(ts, tfn, t(noise), cond_free_k=K)
    elif name == "dpmpp_2m_karras":
        ref = jdiff.dpmpp_2m_sample_loop(js, jfn, jnp.asarray(noise), cond_free_k=K,
                                         conditioning_free=True)
        out = tdiff.dpmpp_2m_sample_loop(ts, tfn, t(noise), cond_free_k=K)
    else:
        ref = jdiff.dpmpp_2m_reference_sample_loop(
            jfn, jnp.asarray(noise), steps=js.num_timesteps, guidance_scale=K)
        out = tdiff.dpmpp_2m_reference_sample_loop(
            tfn, t(noise), steps=ts.num_timesteps, guidance_scale=K)
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("name,steps", [("ddim", 5), ("ddim", 12),
                                        ("dpmpp_2m_karras", 5), ("dpmpp_2m_karras", 12),
                                        ("dpmpp_2m", 5), ("dpmpp_2m", 12)])
def test_sampler_matches_jax_on_the_analytic_model(name, steps):
    js, ts = _schedules(steps)
    cont = name == "dpmpp_2m"
    noise = np.random.default_rng(steps).normal(size=(2, 24, 8)).astype(np.float32)
    out, ref = _run(name, js, ts, _analytic_jax(js, cont), _analytic_port(ts, cont), noise)
    assert np.isfinite(out).all() and out.shape == noise.shape
    close(out, ref, atol=1e-5, rtol=1e-5)
    assert abs(float(out.mean()) - TARGET) < 0.3  # it moved toward the mode


@pytest.mark.parametrize("name,steps", [("ddim", 5), ("dpmpp_2m_karras", 5),
                                        ("dpmpp_2m", 5), ("dpmpp_2m", 12)])
def test_sampler_matches_jax_on_the_small_diffusion_model(name, steps):
    model, jvars, port = synth_pair()
    js, ts = _schedules(steps)
    rng = np.random.default_rng(11)
    b, tc = 2, 7
    lat = rng.normal(size=(b, tc, port.cfg.gpt.model_dim)).astype(np.float32)
    prompt = rng.normal(-5, 2, size=(b, 32, 128)).astype(np.float32)
    noise = rng.normal(size=(b, 4 * tc, 128)).astype(np.float32)

    cond = japply(JaxSynth.diffusion_conditioning, jnp.asarray(prompt))
    emb = japply(JaxSynth.diffusion_code_embedding, jnp.asarray(lat), cond)
    biases = japply(lambda m: m.diffusion_attention_biases(4 * tc))

    def jfn(x, t_in, _):
        return model.apply(jvars, x, t_in, emb, biases, method=JaxSynth.diffusion_cfg_step)

    with torch.no_grad():
        temb = port.diffusion_code_embedding(t(lat), port.diffusion_conditioning(t(prompt)))
        tbiases = port.diffusion_attention_biases(4 * tc)

    def tfn(x2, t2):
        return port.diffusion_cfg_step(x2, t2, temb, tbiases)

    out, ref = _run(name, js, ts, jfn, tfn, noise)
    assert np.isfinite(out).all() and out.shape == noise.shape
    close(out, ref, atol=1e-4, rtol=1e-4)
    assert np.std(ref) > 1e-2  # not a constant output


def test_ddim_is_deterministic_and_dpmpp_2m_needs_two_steps():
    _, ts = _schedules(5)
    fn = _analytic_port(ts, False)
    noise = t(np.random.default_rng(2).normal(size=(1, 16, 4)).astype(np.float32))
    a = tdiff.ddim_sample_loop(ts, fn, noise)
    assert torch.equal(a, tdiff.ddim_sample_loop(ts, fn, noise, eta=0.5))
    with pytest.raises(ValueError):
        tdiff.dpmpp_2m_reference_sample_loop(_analytic_port(ts, True), noise, steps=1)


def test_schedule_helpers_match_jax():
    js, ts = _schedules(5)
    rng = np.random.default_rng(3)
    x, eps, v = (rng.normal(size=(3, 6, 4)).astype(np.float32) for _ in range(3))
    steps = np.array([0, 2, 4])
    close(ts.predict_xstart_from_eps(t(x), t(steps), t(eps)),
          js.predict_xstart_from_eps(jnp.asarray(x), jnp.asarray(steps), jnp.asarray(eps)),
          atol=1e-6, rtol=1e-6)
    close(ts.learned_range_logvar(t(v), t(steps)),
          js.learned_range_logvar(jnp.asarray(v), jnp.asarray(steps)), atol=1e-6, rtol=1e-6)
    close(ts.alphas_cumprod, js.alphas_cumprod, atol=0, rtol=0)
