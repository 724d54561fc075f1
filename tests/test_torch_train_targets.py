"""The single-loss training targets ``gpt`` and ``vqvae`` against the JAX
package, fp32 on the CPU, at dropout 0:

(a) the GPT's training losses and their gradients against ``jax.grad`` of
    the JAX ``forward_gpt``;
(b) one training call of the quantizer from un-inited and from inited state
    (k-means init, expiry, EMA), with the indices JAX drew: codebook
    buffers, ids, quantized output and commitment loss;
(c) ``forward_vq`` (recon, commit and the gradients) and the posterior
    encoder ``enc_q``;
(d) three whole AdamW steps of each target against JAX's
    ``make_single_loss_step``: losses and grad norms at 1e-4, the parameters
    at atol 0.2 x lr, rtol 1e-5.  ``test_three_adamw_steps_match_optax``'s
    atol 1e-6 holds for the optimizer on fixed gradients; here the
    gradients are computed twice, and Adam turns fp32 noise in a gradient
    near 0 into an update of up to ~lr whatever its size (up to 0.11 lr
    measured).  The key projections' biases, whose gradient is 0 in exact
    arithmetic, are held to moving only;
and the dropout of the new sites, drawn from the step's generator: the same
seed gives a bit-identical step, another seed another loss, ``eval()`` and
the frozen latents pass draw nothing.

JAX's style encoders keep a fixed dropout of 0.1 that no config reaches, so
where its step runs with ``deterministic=False`` flax's ``Dropout`` is made
the identity for the test (the port's dropouts are set to p = 0).  JAX's
VQ draws are read by wrapping ``_sample_vectors`` under
``jax.disable_jit()``.
"""
import contextlib
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detail_tts_tpu.models import quantizer as jquantizer
from detail_tts_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
from detail_tts_tpu.train.optim import make_optimizer as jax_make_optimizer
from detail_tts_tpu.train.step import TrainState as JaxTrainState
from detail_tts_tpu.train.step import make_single_loss_step as jax_single_loss_step
from detail_tts_tpu_torch.config import small_test_config
from detail_tts_tpu_torch.io.weights import from_jax_variables
from detail_tts_tpu_torch.models.quantizer import VQDraws
from detail_tts_tpu_torch.train.optim import trainable_parameters
from detail_tts_tpu_torch.train.step import (dummy_batch, make_single_loss_step,
                                             make_train_state, make_train_step,
                                             synthetic_batches)
from tests.torch_parity import (close, jax_dropout_off, key_bias_mask,  # noqa: F401
                                no_dropout, synth_pair, t)

B, FRAMES, TEXT = 2, 48, 8


def _cfg(cfg, target, **train):
    """``cfg`` for ``target`` in fp32 with folded weights (as synth_pair's),
    dropout 0 and every diffusion layer kept."""
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, target=target, use_bf16=False,
                                       weight_norm=False, **train),
        gpt=dataclasses.replace(cfg.gpt, dropout=0.0),
        vaegan=dataclasses.replace(cfg.vaegan, p_dropout=0.0),
        diffusion=dataclasses.replace(cfg.diffusion, layer_drop=0.0))


def _data(seed, n=B):
    """A 12-key batch: mel = raw_mel ~ N(-6, 2), spec = |N(0, 1)|, random
    text ids, ragged lengths."""
    rng = np.random.default_rng(seed)
    cfg = synth_pair()[2].cfg
    data = {k: v.numpy() for k, v in dummy_batch(cfg, n, FRAMES, TEXT).items()}
    data["mel"] = data["raw_mel"] = rng.normal(-6, 2, data["mel"].shape).astype(np.float32)
    data["spec"] = data["raw_spec"] = np.abs(rng.normal(size=data["spec"].shape)
                                             ).astype(np.float32)
    data["text"] = rng.integers(1, 200, data["text"].shape)
    data["spec_length"][-1] = FRAMES - 12
    return data


def _jnp(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


def _port_tree(port, tree, vq_state):
    """A JAX params-shaped tree -> the port's state-dict names and layouts."""
    state, _ = from_jax_variables(port, {"params": tree, "vq_state": vq_state},
                                  port.cfg.diffusion.num_layers)
    return state


def _record_vq_draws(monkeypatch):
    """Wrap JAX's ``_sample_vectors`` to record the indices it draws (under
    ``jax.disable_jit()`` the rngs are concrete)."""
    calls = []
    orig = jquantizer._sample_vectors

    def rec(rng, samples, num):
        calls.append(np.asarray(jax.random.randint(rng, (num,), 0, samples.shape[0])))
        return orig(rng, samples, num)

    monkeypatch.setattr(jquantizer, "_sample_vectors", rec)
    return calls


def _vq_draws(calls, inited):
    """Recorded JAX draws of one call -> VQDraws (n_q = 1); an inited call
    draws no k-means rows."""
    expire = calls[-1]
    kmeans = np.zeros_like(expire) if inited else calls[-2]
    return VQDraws(t(kmeans[None], torch.long), t(expire[None], torch.long))


def _codebook(vq_state):
    cb = vq_state["quantizer"]["layer_0"]["codebook"]
    return {k: np.asarray(v, np.float32) for k, v in cb.items()}


def _port_codebook(port):
    cb = port.quantizer.vq.layers[0]._codebook
    return {k: getattr(cb, k).numpy().copy() for k in ("inited", "cluster_size",
                                                         "embed", "embed_avg")}


def test_gpt_losses_and_grads_match_jax():
    model, jvars, port0 = synth_pair()
    cfg = model.cfg
    data = _data(0)

    def loss_fn(params):
        lt, lm = model.apply({"params": params, "vq_state": jvars["vq_state"]},
                             _jnp(data), deterministic=True,
                             method=JaxSynth.forward_gpt)
        return cfg.train.text_weight * lt + cfg.train.mel_weight * lm, (lt, lm)

    (_, (lt, lm)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jvars["params"])
    port = no_dropout(copy.deepcopy(port0).train())
    params = dict(trainable_parameters(port, "gpt"))
    plt, plm = port.forward_gpt({k: t(v) for k, v in data.items()})
    (cfg.train.text_weight * plt + cfg.train.mel_weight * plm).backward()
    close(plt.detach(), lt)
    close(plm.detach(), lm)
    ref = _port_tree(port, jax.tree_util.tree_map(np.asarray, grads), jvars["vq_state"])
    assert "gpt.text_head.weight" in params
    for name, p in params.items():
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(grad.numpy(), ref[name].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
    assert float(params["gpt.text_head.weight"].grad.abs().max()) > 0


@pytest.mark.parametrize("inited", [False, True])
def test_quantizer_training_call_matches_jax(monkeypatch, inited):
    model, jvars, port0 = synth_pair()
    dim = port0.cfg.vaegan.inter_channels * 4
    x = np.random.default_rng(3).normal(size=(2, 12, dim)).astype(np.float32)
    vq_state = jvars["vq_state"]
    port = copy.deepcopy(port0)
    if inited:  # the state after one un-inited call
        _, mut = model.apply(jvars, jnp.asarray(x[::-1]), method=lambda m, x: m.quantizer(
            x, train=True), mutable=["vq_state"], rngs={"vq": jax.random.PRNGKey(5)})
        vq_state = mut["vq_state"]
        port.load_state_dict(_port_tree(port, jvars["params"], vq_state))
    calls = _record_vq_draws(monkeypatch)
    with jax.disable_jit():
        (q, ids, commit), mut = model.apply(
            {"params": jvars["params"], "vq_state": vq_state}, jnp.asarray(x),
            method=lambda m, x: m.quantizer(x, train=True), mutable=["vq_state"],
            rngs={"vq": jax.random.PRNGKey(6)})
    assert len(calls) == (1 if inited else 2)
    before = _port_codebook(port)
    with torch.no_grad():
        pq, pids, pcommit = port.quantizer(t(x), _vq_draws(calls, inited))
    np.testing.assert_array_equal(pids.numpy(), np.asarray(ids))
    close(pq, q)
    close(pcommit, commit)
    after, want = _port_codebook(port), _codebook(mut["vq_state"])
    for k in want:
        close(after[k], want[k])
    assert not np.array_equal(after["embed"], before["embed"])
    assert after["inited"] == 1.0 and (before["inited"] == 1.0) == inited


def test_forward_vq_and_grads_match_jax(monkeypatch):
    model, jvars, port0 = synth_pair()
    data = _data(1)
    calls = _record_vq_draws(monkeypatch)

    def loss_fn(params):
        (recon, commit), mut = model.apply(
            {"params": params, "vq_state": jvars["vq_state"]}, jnp.asarray(data["mel"]),
            jnp.asarray(data["spec_length"]), train=True, method=JaxSynth.forward_vq,
            mutable=["vq_state"], rngs={"vq": jax.random.PRNGKey(2)})
        return recon + 0.25 * commit, (recon, commit, mut)

    with jax.disable_jit():
        (_, (recon, commit, mut)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            jvars["params"])
    port = copy.deepcopy(port0).train()
    params = dict(trainable_parameters(port, "vqvae"))
    precon, pcommit = port.forward_vq(t(data["mel"]), t(data["spec_length"], torch.long),
                                      _vq_draws(calls, inited=False))
    (precon + 0.25 * pcommit).backward()
    close(precon.detach(), recon)
    close(pcommit.detach(), commit)
    ref = _port_tree(port, jax.tree_util.tree_map(np.asarray, grads), mut["vq_state"])
    for name, p in params.items():
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(grad.numpy(), ref[name].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
    assert float(params["quantizer.vq.layers.0.project_in.weight"].grad.abs().max()) > 0
    for k, v in _codebook(mut["vq_state"]).items():
        close(_port_codebook(port)[k], v)


def test_posterior_encoder_matches_jax():
    model, jvars, port = synth_pair()
    data = _data(2)
    g = np.random.default_rng(4).normal(size=(B, port.cfg.vaegan.gin_channels)
                                        ).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    z, m, logs = model.apply(jvars, jnp.asarray(data["spec"]),
                             jnp.asarray(data["spec_length"]), rng, g=jnp.asarray(g),
                             method=lambda mod, *a, **k: mod.enc_q(*a, **k))
    noise = t(jax.random.normal(rng, m.shape, jnp.float32))
    with torch.no_grad():
        pz, pm, plogs = port.enc_q(t(data["spec"]), t(data["spec_length"], torch.long),
                                   noise, g=t(g))
    for ours, ref in ((pz, z), (pm, m), (plogs, logs)):
        close(ours, ref)
    assert float(np.abs(np.asarray(z)[-1, FRAMES - 12:]).max()) == 0.0  # masked


def _jax_state(cfg, jvars):
    tx = jax_make_optimizer(cfg, cfg.train.target, clip_norm=1.0)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=jvars["params"],
                         vq_state=jvars["vq_state"], opt_state=tx.init(jvars["params"]))


@pytest.mark.parametrize("target", ["gpt", "vqvae"])
def test_three_adamw_steps_match_jax_step(monkeypatch, jax_dropout_off, target):
    model, jvars, port0 = synth_pair()
    # the shipped LR (1e-4): Adam's update of a gradient near 0 is O(lr)
    # whatever its size, so fp32 noise in such a gradient moves the
    # parameter by a fraction of lr
    jcfg = _cfg(model.cfg, target, lr_decay=0.5, lr_decay_every=2)
    pcfg = _cfg(port0.cfg, target, lr_decay=0.5, lr_decay_every=2)
    accum = 2
    batches = [_data(10 + k, accum * B) for k in range(3)]
    stack = lambda v: v.reshape(accum, B, *v.shape[1:])  # noqa: E731
    jstep = jax_single_loss_step(JaxSynth(jcfg), jcfg, donate=False)
    jstate = _jax_state(jcfg, jvars)
    jmetrics, draws = [], []
    calls = _record_vq_draws(monkeypatch)
    for k, data in enumerate(batches):
        n0 = len(calls)
        with (jax.disable_jit() if target == "vqvae" else contextlib.nullcontext()):
            jstate, m = jstep(jstate, {k2: jnp.asarray(stack(v)) for k2, v in data.items()},
                              jax.random.PRNGKey(20 + k))
        jmetrics.append({k2: float(v) for k2, v in m.items()})
        new = calls[n0:]
        if target == "vqvae":  # k-means on the first microbatch only
            assert len(new) == (3 if k == 0 else 2)
            draws.append([_vq_draws(new[:2], False), _vq_draws(new[2:], True)]
                         if k == 0 else [_vq_draws(new[:1], True),
                                         _vq_draws(new[1:], True)])

    port = no_dropout(copy.deepcopy(port0))
    state = make_train_state(pcfg, device="cpu", model=port)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    step = make_single_loss_step(pcfg, device="cpu")
    for k, data in enumerate(batches):
        m = step(state, {k2: stack(t(v)) for k2, v in data.items()},
                 draws=draws[k] if draws else None)
        for name in ("loss", "grad_norm") + (("loss_text", "loss_mel") if target == "gpt"
                                             else ("loss_recon", "loss_commit")):
            np.testing.assert_allclose(float(m[name]), jmetrics[k][name], rtol=1e-4,
                                       atol=1e-5, err_msg=f"step {k} {name}")
    assert state.step == 3
    ref = _port_tree(port, jax.tree_util.tree_map(np.asarray, jstate.params),
                     jstate.vq_state)
    trainable = {n for n, _ in trainable_parameters(port, target)}
    for name, value in port.state_dict().items():
        if name in trainable:
            assert not torch.equal(value, before[name]), name
            keep = ~key_bias_mask(name, value.shape, port0.cfg)
            np.testing.assert_allclose(value.numpy()[keep], ref[name].numpy()[keep],
                                       atol=0.2 * pcfg.train.learning_rate, rtol=1e-5,
                                       err_msg=name)
        elif "_codebook." in name:  # the EMA state moves under vqvae only
            assert torch.equal(value, before[name]) == (target != "vqvae"), name
            close(value, ref[name])
        else:  # frozen: bit-identical, and JAX left it alone too
            assert torch.equal(value, before[name]), name
            np.testing.assert_array_equal(value.numpy(), ref[name].numpy())


def _gpt_state(dropout):
    cfg = small_test_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, target="gpt"),
                              gpt=dataclasses.replace(cfg.gpt, dropout=dropout))
    state = make_train_state(cfg, device="cpu", seed=0)
    batch = next(synthetic_batches(cfg, accum=1, micro_batch=B, mel_frames=FRAMES,
                                   text_len=TEXT, generator=torch.Generator().manual_seed(1)))
    return cfg, state, batch, make_single_loss_step(cfg, device="cpu")


def test_gpt_dropout_step_is_a_function_of_its_seed():
    cfg, state, batch, step = _gpt_state(0.1)
    snap = state.snapshot()
    runs = []
    for seed in (5, 5, 6):
        state.restore(snap)
        runs.append(step(state, batch, torch.Generator().manual_seed(seed)))
    assert torch.equal(runs[0]["loss"], runs[1]["loss"])
    assert torch.equal(runs[0]["grad_norm"], runs[1]["grad_norm"])
    assert np.isfinite(float(runs[2]["loss"])) and float(runs[0]["loss"]) != float(
        runs[2]["loss"])
    with pytest.raises(ValueError, match="Generator"):
        step(state, batch)  # dropout in train() mode needs the generator


def test_gpt_dropout_draws_nothing_in_eval_mode_or_the_latents_pass():
    cfg, state, batch, _ = _gpt_state(0.1)
    mb = {k: v[0] for k, v in batch.items()}
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state()
    with torch.no_grad():
        latents = state.model.gpt_latents(mb)  # train() mode, deterministic pass
        assert state.model.gpt.training
        losses = state.model.eval().forward_gpt(mb, gen)
    assert torch.equal(gen.get_state(), before)
    assert np.isfinite(latents.numpy()).all() and np.isfinite(float(losses[1]))


@pytest.mark.parametrize("target", ["vqvae", "gpt"])
def test_train_step_dispatches_single_loss_targets(target):
    cfg = _cfg(small_test_config(), target)
    step = make_train_step(cfg, device="cpu")
    state = make_train_state(cfg, device="cpu", seed=0)
    batch = next(synthetic_batches(cfg, accum=2, micro_batch=B, mel_frames=FRAMES,
                                   text_len=TEXT, generator=torch.Generator().manual_seed(1)))
    codebook = state.model.quantizer.vq.layers[0]._codebook.embed.clone()
    m = step(state, batch, torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert not torch.backends.cudnn.deterministic  # set for the step only
    moved = not torch.equal(codebook, state.model.quantizer.vq.layers[0]._codebook.embed)
    assert moved == (target == "vqvae")
