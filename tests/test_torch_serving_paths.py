"""The port's serving paths beyond the ancestral request: the engine's DDIM
and DPM-Solver++(2M) slices and the VQ decoder paths against the JAX
functions composed by hand, the ``vq_safe`` padding and the int16
conversion against the JAX engine's, the split dispatch against
``synthesize_batch``, and the reference-checkpoint loader against the JAX
package's converter."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detail_tts_tpu.audio.mel import denormalize_mel as jax_denorm
from detail_tts_tpu.io.torch_convert import convert_state_dict
from detail_tts_tpu.models import diffusion as jdiff
from detail_tts_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
from detail_tts_tpu.models.synthesizer import make_infer_schedule as jax_schedule
from detail_tts_tpu.serving.pipeline import EngineConfig as JaxEngineConfig
from detail_tts_tpu.serving.pipeline import TTSEngine as JaxEngine
from detail_tts_tpu.serving.pipeline import variables_template
from detail_tts_tpu_torch.config import small_test_config
from detail_tts_tpu_torch.io.weights import (from_jax_variables,
                                             load_reference_checkpoint,
                                             random_weights_)
from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
from detail_tts_tpu_torch.serving.pipeline import (SAMPLERS, EngineConfig,
                                                   TTSEngine, to_pcm16)
from tests.torch_parity import close, japply, synth_pair, t

F32 = dict(compute_dtype=torch.float32, cache_dtype=torch.float32)
SMALL = dict(max_generate_length=12, text_buckets=(16, 32), prompt_buckets=(32, 64),
             code_buckets=(8, 12), **F32)


@functools.lru_cache(maxsize=None)
def _slice_inputs():
    """Fixed codes -> JAX latents, conditioning and biases (shared by the
    engine slices)."""
    rng = np.random.default_rng(5)
    b, tc = 2, 7
    prompt = rng.normal(-5, 2, size=(b, 32, 128)).astype(np.float32)
    plen = np.array([32, 21], np.int32)
    text = rng.integers(3, 200, size=(b, 10)).astype(np.int32)
    codes = rng.integers(0, 8192, size=(b, tc)).astype(np.int32)
    eff = np.array([tc, 5], np.int32)
    j = jnp.asarray
    lat = japply(lambda m, *a: m.gpt(*a[:3], None, *a[3:], return_latent=True,
                                     deterministic=True),
                 j(prompt), j(plen), j(text), j(codes), j(eff * 1024))
    cond = japply(JaxSynth.diffusion_conditioning, j(prompt))
    emb = japply(JaxSynth.diffusion_code_embedding, lat, cond)
    biases = japply(lambda m: m.diffusion_attention_biases(4 * tc))
    return dict(prompt=prompt, plen=plen, text=text, codes=codes, eff=eff,
                emb=emb, biases=biases)


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp_2m"])
def test_engine_slice_matches_composed_jax_functions(sampler):
    """fixed codes -> latents -> the engine's diffuse (its initial noise
    under key PRNGKey(9), JAX's ``normal(split(key)[0])`` for the JAX side)
    -> vocoder with noise_scale 0, against the JAX functions by hand."""
    model, jvars, port = synth_pair()
    x = _slice_inputs()
    b, tc = x["codes"].shape
    eng = TTSEngine(port, EngineConfig(diffusion_sampler=sampler, **F32), device="cpu")
    n_rng, _ = jax.random.split(jax.random.PRNGKey(9))
    noise = jax.random.normal(n_rng, (b, 4 * tc, 128), jnp.float32)

    def fn(xx, t_in, _):
        return model.apply(jvars, xx, t_in, x["emb"], x["biases"],
                           method=JaxSynth.diffusion_cfg_step)

    sched = jax_schedule(model.cfg)
    if sampler == "ddim":
        ref = jdiff.ddim_sample_loop(sched, fn, noise, cond_free_k=2.0,
                                     conditioning_free=True)
    else:
        ref = jdiff.dpmpp_2m_reference_sample_loop(
            fn, noise, steps=sched.num_timesteps, guidance_scale=2.0)
    ref_mel = jax_denorm(ref)
    ref_wav = japply(lambda m, mel, n: m.infer_flowvae(mel, n, jax.random.PRNGKey(1),
                                                       noise_scale=0.0),
                     ref_mel, jnp.asarray(x["eff"] * 4))

    with torch.no_grad():
        lat = port.gpt(t(x["prompt"]), t(x["plen"], torch.long), t(x["text"], torch.long),
                       t(x["codes"], torch.long), t(x["eff"] * 1024, torch.long))
        mel = eng.diffuse(lat, eng.diffusion_cond(t(x["prompt"]), x["plen"].tolist()),
                          eng.attention_biases(4 * tc), (0, 9))
        wav = port.infer_flowvae(mel, t(x["eff"] * 4, torch.long), noise_scale=0.0)

    assert np.mean(np.abs(mel.numpy() - np.asarray(ref_mel))) <= 1e-3
    assert np.max(np.abs(wav.numpy() - np.asarray(ref_wav))) <= 1e-3
    assert np.std(np.asarray(ref_wav)) > 1e-3  # not a constant output


def test_vq_paths_match_jax():
    model, jvars, port = synth_pair()
    rng = np.random.default_rng(6)
    codes = rng.integers(0, port.cfg.vaegan.vq_bins, size=(2, 9)).astype(np.int32)
    prompt = rng.normal(-5, 2, size=(2, 32, 128)).astype(np.float32)
    plen = np.array([32, 21], np.int32)
    ref = japply(JaxSynth.decode_codes_to_mel, jnp.asarray(codes), jnp.asarray(prompt),
                 jnp.asarray(plen))
    ours = port.decode_codes_to_mel(t(codes, torch.long), t(prompt), t(plen, torch.long))
    assert ours.shape == (2, 36, 128)
    close(ours, ref)

    mel = rng.normal(-6, 2, size=(2, 48, 128)).astype(np.float32)
    recon_ref, _ = model.apply(jvars, jnp.asarray(mel), jax.random.PRNGKey(0),
                               method=JaxSynth.infer_vqvae)
    wav_ref = japply(lambda m, r: m.infer_flowvae(
        r, jnp.full((2,), 48, jnp.int32), jax.random.PRNGKey(1), noise_scale=0.0), recon_ref)
    recon, wav = port.infer_vqvae(
        t(mel), noise=torch.zeros((2, 48, port.cfg.vaegan.inter_channels)))
    close(recon, recon_ref)
    assert wav.shape == (2, 48 * 256, 1)
    assert np.max(np.abs(wav.numpy() - np.asarray(wav_ref))) <= 1e-3
    assert np.std(np.asarray(recon_ref)) > 1e-2


def test_vq_safe_padding_and_pcm16_match_the_jax_engine():
    model, jvars, port = synth_pair()
    jeng = JaxEngine(model.cfg, jvars,
                     JaxEngineConfig(max_generate_length=12, code_buckets=(8, 12),
                                     compute_dtype=None))
    eng = TTSEngine(port, EngineConfig(**SMALL), device="cpu")
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 8194, size=(3, 12)).astype(np.int32)
    codes[:, :4] = rng.integers(0, 64, size=(3, 4))
    eff = np.array([5, 11, 8])
    for vq_safe in (False, True):
        ref_codes, ref_len, ref_bucket = jeng._pad_codes(jnp.asarray(codes), eff,
                                                         vq_safe=vq_safe)
        ours, wav_len, bucket = eng._pad_codes(t(codes, torch.long), eff, vq_safe=vq_safe)
        assert bucket == ref_bucket == 12
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref_codes))
        np.testing.assert_array_equal(wav_len.numpy(), np.asarray(ref_len))
    assert int(ours.max()) < port.cfg.vaegan.vq_bins

    # the JAX engine's int16 conversion on the same floats: out of range,
    # and on the half-way points between int16 steps
    wav = np.concatenate([rng.uniform(-1.5, 1.5, 4000),
                          (np.arange(-200, 200) + 0.5) / 32767.0]).astype(np.float32)
    ref = jnp.round(jnp.clip(jnp.asarray(wav).astype(jnp.float32), -1, 1)
                    * 32767.0).astype(jnp.int16)
    ours = to_pcm16(t(wav))
    assert ours.dtype == torch.int16
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_engine_config_takes_the_samplers_and_refuses_others():
    assert SAMPLERS == ("ancestral", "ddim", "dpmpp_2m", "dpmpp_2m_karras")
    for s in SAMPLERS:
        assert EngineConfig(diffusion_sampler=s, pcm16_output=True).diffusion_sampler == s
    with pytest.raises(ValueError):
        EngineConfig(diffusion_sampler="nope")


@functools.lru_cache(maxsize=None)
def _random_model():
    model = SynthesizerTrn(small_test_config())
    return random_weights_(model, 0)


def _engine(**kw):
    return TTSEngine(_random_model(), EngineConfig(**{**SMALL, **kw}), device="cpu")


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.uniform(-0.3, 0.3, n).astype(np.float32) for n in (24000, 12077)]


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_engine_sampler_request_repeats_and_pcm16_follows_it(sampler):
    """Each sampler through synthesize_batch: the right length, finite,
    bit-identical on repeat; pcm16_output gives the float output's clip,
    scale and round, bit for bit."""
    texts = ["你好，世界。", "ni3 hao3"]
    eng = _engine(diffusion_sampler=sampler)
    timings = {}
    outs = eng.synthesize_batch(texts, _prompts(), seed=3, force_full=True, timings=timings)
    assert [o.shape for o in outs] == [(11 * 1024,)] * 2
    assert all(o.dtype == np.float32 and np.isfinite(o).all() for o in outs)
    assert set(timings) == {"prepare", "generate", "diff_cond", "latents", "diffuse",
                            "vocode"}
    again = eng.synthesize_batch(texts, _prompts(), seed=3, force_full=True)
    assert all(np.array_equal(a, b) for a, b in zip(outs, again))
    pcm = _engine(diffusion_sampler=sampler, pcm16_output=True).synthesize_batch(
        texts, _prompts(), seed=3, force_full=True)
    for p, o in zip(pcm, outs):
        assert p.dtype == np.int16
        np.testing.assert_array_equal(p, to_pcm16(torch.from_numpy(o)).numpy())


def test_dispatch_finalize_pipelining_matches_synthesize_batch():
    """Dispatching batch i+1 before finalizing batch i, whole or split as
    the server does (decode i+1, finalize i, tail i+1), gives the serial
    path's audio bit for bit."""
    eng = _engine(diffusion_sampler="dpmpp_2m")
    texts, prompts = ["yi1 er4", "san1 si4"], _prompts()
    seeds = [100, 101, 102]
    serial = [eng.synthesize_batch(texts, prompts, seed=s) for s in seeds]

    pipelined, prev = [], None
    for s in seeds:
        handle = eng.dispatch_batch(texts, prompts, seed=s)
        if prev is not None:
            pipelined.append(eng.finalize_batch(prev))
        prev = handle
    pipelined.append(eng.finalize_batch(prev))

    split, prev = [], None
    for s in seeds:
        pending = eng.dispatch_decode(texts, prompts, seed=s)
        if prev is not None:
            split.append(eng.finalize_batch(prev))
        prev = eng.dispatch_tail(pending)
    split.append(eng.finalize_batch(prev))

    for ref, a, b in zip(serial, pipelined, split):
        for r, x, y in zip(ref, a, b):
            np.testing.assert_array_equal(r, x)
            np.testing.assert_array_equal(r, y)


def test_vq_batch_roundtrip_from_ids_and_warmup():
    eng = _engine()
    outs = eng.synthesize_vq_batch(["ce4 shi4", "yi1"], _prompts(), seed=1,
                                   force_full=True)
    assert [o.shape for o in outs] == [(11 * 1024,)] * 2
    assert all(np.isfinite(o).all() for o in outs)
    again = eng.synthesize_vq_batch(["ce4 shi4", "yi1"], _prompts(), seed=1,
                                    force_full=True)
    assert all(np.array_equal(a, b) for a, b in zip(outs, again))

    mel = np.full((1, 48, 128), -6.0, np.float32)
    recon, wav = eng.vq_roundtrip(mel)
    assert recon.shape == mel.shape and wav.shape == (1, 48 * 256, 1)
    assert torch.isfinite(recon).all() and torch.isfinite(wav).all()

    text = torch.zeros((1, 16), dtype=torch.long)
    refer = torch.full((1, 32, 128), -6.0)
    for vq_only in (True, False):
        (w,) = eng.synthesize_from_ids(text, refer, torch.tensor([32]), seed=2,
                                       vq_only=vq_only)
        assert w.ndim == 1 and w.shape[0] % 1024 == 0 and np.isfinite(w).all()
    eng.warmup(batch_size=2)
    assert 32 in eng._bias_cache  # the smallest code bucket's biases, 4 x 8


def _split_weight_norm(sd, names, rng):
    """Reference layout: each named weight as (weight_g, weight_v)."""
    for name in names:
        w = sd.pop(name).numpy()
        norm = np.sqrt(np.sum(w ** 2, axis=tuple(range(1, w.ndim)), keepdims=True))
        scale = rng.uniform(0.5, 2.0, size=norm.shape).astype(np.float32)
        sd[name[:-len("weight")] + "weight_v"] = torch.from_numpy(w * scale)
        sd[name[:-len("weight")] + "weight_g"] = torch.from_numpy(norm)


def test_reference_checkpoint_loads_as_the_jax_converter_reads_it(tmp_path):
    cfg = small_test_config()
    rng = np.random.default_rng(8)
    sd = {k: v.clone() for k, v in random_weights_(SynthesizerTrn(cfg), 4).state_dict().items()}
    wn = [k for k in sd if k.endswith(".weight") and sd[k].dim() == 3
          and k.startswith(("dec.ups.", "dec.resblocks.", "flow.flows.", "enc_q.enc."))]
    assert len(wn) > 10
    _split_weight_norm(sd, wn, rng)
    template = variables_template(synth_pair()[0].cfg)
    path = tmp_path / "model-7.pt"
    torch.save({"G": sd, "iteration": 7}, path)

    port = SynthesizerTrn(cfg)
    report = load_reference_checkpoint(str(path), port)
    assert report == {"unused": []}  # every module of the checkpoint is ported

    variables, jreport = convert_state_dict(torch.load(path)["G"], template,
                                            diffusion_layers=cfg.diffusion.num_layers)
    assert jreport["unmapped"] == [] and jreport["unconsumed"] == []
    want, _ = from_jax_variables(SynthesizerTrn(cfg), variables, cfg.diffusion.num_layers)
    got = port.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)

    del sd["vq_dec.7.bias"]
    torch.save({"model": sd}, path)
    with pytest.raises(KeyError, match="vq_dec.7.bias"):
        load_reference_checkpoint(str(path), SynthesizerTrn(cfg))
