"""The GAN targets ``flowvae`` and ``all`` against the JAX package, fp32 on
the CPU:

(a) the (g, v) weight-norm parametrization: output and the gradients of g, v
    and the bias for one conv of each kind (Conv1d, ConvTranspose1d, whose
    norm runs per input channel, Conv2d) against ``jax.grad`` under
    ``weight_norm_reparam``;
(b) the discriminator's logits and feature maps (weight-normed, T not a
    multiple of periods 3, 7 and 11, so the reflect pad is live);
(c) the four losses;
(d) ``forward_flowvae``'s nine outputs, with JAX's draws, at atol 1e-4 of
    max(1, max |JAX|) (the flow's output reaches |40| on seeded weights);
(e) one whole GAN step of each target against JAX's ``make_gan_step`` at
    dropout 0 with every layer kept and weight norm on: every metric at
    1e-4; for the generator and the discriminator, each tensor's AdamW
    first moment (the gradient) and its new value (see
    ``_check_one_adam_step`` for the tolerances); the codebook under
    ``all`` (rtol 1e-3 for ``embed``, see the test);
and the GAN step's dropout, drawn from the step's generator, the trainer
over a GAN target, and the synthetic GAN batch.
"""
import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax import tree_utils as optax_tree_utils

from detail_tts_tpu.models import quantizer as jquantizer
from detail_tts_tpu.models.discriminator import MultiPeriodDiscriminator as JaxMPD
from detail_tts_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
from detail_tts_tpu.models.synthesizer import make_train_schedule as jax_train_schedule
from detail_tts_tpu.nn import common as jcommon
from detail_tts_tpu.serving.pipeline import variables_template
from detail_tts_tpu.train import losses as jlosses
from detail_tts_tpu.train.optim import make_d_optimizer as jax_d_optimizer
from detail_tts_tpu.train.optim import make_optimizer as jax_make_optimizer
from detail_tts_tpu.train.step import TrainState as JaxTrainState
from detail_tts_tpu.train.step import make_gan_step as jax_gan_step
from detail_tts_tpu_torch.audio.mel import MelFrontend
from detail_tts_tpu_torch.config import small_test_config
from detail_tts_tpu_torch.io.torch_convert import translate_discriminator
from detail_tts_tpu_torch.io.weights import from_jax_variables
from detail_tts_tpu_torch.models.discriminator import MultiPeriodDiscriminator
from detail_tts_tpu_torch.models.quantizer import VQDraws
from detail_tts_tpu_torch.models.synthesizer import (DiffDraws, FlowDraws,
                                                     SynthesizerTrn, draw_flow)
from detail_tts_tpu_torch.nn.common import Conv1d, Conv2d, ConvTranspose1d, weight_norm_
from detail_tts_tpu_torch.train import losses
from detail_tts_tpu_torch.train.optim import trainable_parameters
from detail_tts_tpu_torch.train.step import (GanDraws, make_gan_step, make_train_state,
                                             synthetic_batches)
from detail_tts_tpu_torch.train.trainer import Trainer
from tests.torch_parity import (close, jax_dropout_off, key_bias_mask,  # noqa: F401
                                no_dropout, seeded_variables, synth_pair, t)

B, FRAMES, TEXT = 2, 48, 8


@pytest.mark.parametrize("kind", ["conv1d", "conv_transpose1d", "conv2d"])
def test_weight_norm_gradients_match_jax(kind):
    rng = np.random.default_rng(0)
    if kind == "conv1d":
        jmod = jcommon.Conv1d(8, 5, dilation=2, padding=4, weight_norm=True)
        port = Conv1d(6, 8, 5, dilation=2, padding=4, wn=True)
        x, to_port, to_jax_out = rng.normal(size=(2, 20, 6)), (2, 1, 0), lambda y: y
    elif kind == "conv_transpose1d":
        jmod = jcommon.ConvTranspose1d(6, 8, stride=4, padding=2, weight_norm=True)
        port = ConvTranspose1d(8, 6, 8, 4, padding=2, wn=True)
        x, to_port, to_jax_out = rng.normal(size=(2, 10, 8)), (2, 1, 0), lambda y: y
    else:
        jmod = jcommon.Conv2d(6, (5, 1), strides=(3, 1), padding=((2, 2), (0, 0)),
                              weight_norm=True)
        port = Conv2d(4, 6, (5, 1), (3, 1), padding=(2, 0), wn=True)
        x, to_port = rng.normal(size=(2, 17, 3, 4)), (3, 2, 0, 1)
        to_jax_out = lambda y: y.permute(0, 2, 3, 1)  # noqa: E731
    x = x.astype(np.float32)
    with jcommon.weight_norm_reparam():
        template = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda leaf: rng.normal(size=leaf.shape).astype(np.float32), template)["params"]
    leaves = params.get("conv", params)
    leaves["g"] = np.abs(leaves["g"]) + 0.5

    def loss(p, r):
        with jcommon.weight_norm_reparam():
            y = jmod.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(y * r), y

    r = rng.normal(size=loss(params, 0.0)[1].shape).astype(np.float32)
    (_, y), grads = jax.value_and_grad(loss, has_aux=True)(params, r)
    grads = grads.get("conv", grads)
    weight_norm_(port)
    assert set(dict(port.named_parameters())) == {"bias", "weight_g", "weight_v"}
    with torch.no_grad():
        port.weight_v.copy_(t(np.transpose(leaves["v"], to_port)))
        port.weight_g.copy_(t(leaves["g"]).reshape(port.weight_g.shape))
        port.bias.copy_(t(leaves["bias"]))
    xin = t(x).permute(0, 3, 1, 2) if kind == "conv2d" else t(x)
    ours = port(xin)
    (to_jax_out(ours) * t(r)).sum().backward()
    close(to_jax_out(ours).detach(), y)
    close(port.weight_v.grad, np.transpose(np.asarray(grads["v"]), to_port))
    close(port.weight_g.grad.flatten(), grads["g"])
    close(port.bias.grad, grads["bias"])


def _seeded_wn(template_fn, seed):
    """Seeded JAX variables in the (g, v) parametrization: a folded template
    filled by ``seeded_variables``, unfolded (g = ||kernel||, v = kernel),
    then g scaled by U(0.5, 2) so that g and ||v|| differ."""
    folded = seeded_variables(template_fn(), seed)
    with jcommon.weight_norm_reparam():
        wn_template = template_fn()
    tree = jax.tree_util.tree_map(np.asarray, jcommon.unfold_weight_norm_tree(
        folded, wn_template))
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (x * rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
                         if str(getattr(path[-1], "key", "")) == "g" else x), tree)


def _disc_template():
    y = jnp.zeros((1, 1000, 1))
    return jax.eval_shape(JaxMPD().init, jax.random.PRNGKey(0), y, y)


@pytest.fixture(scope="module")
def disc_pair():
    """(JAX discriminator variables (g, v), the port's weight-normed copy)."""
    jvars = _seeded_wn(_disc_template, 7)
    port = weight_norm_(MultiPeriodDiscriminator())
    state, unused = from_jax_variables(port, jvars, translate_fn=translate_discriminator)
    assert unused == []
    port.load_state_dict(state)
    return jvars, port


def test_discriminator_matches_jax(disc_pair):
    jvars, port = disc_pair
    rng = np.random.default_rng(1)
    y, y_hat = (rng.uniform(-0.5, 0.5, (B, 1000, 1)).astype(np.float32) for _ in range(2))
    with jcommon.weight_norm_reparam():
        ref = JaxMPD().apply(jvars, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        ours = port(t(y), t(y_hat))
    for i in range(6):  # disc_s, then the periods 2, 3, 5, 7, 11
        close(ours[0][i], ref[0][i])
        close(ours[1][i], ref[1][i])
        for fo, fr in zip(ours[3][i], ref[3][i]):
            close(fo if i == 0 else fo.permute(0, 2, 3, 1), fr)
    assert [len(f) for f in ours[2]] == [7] + [6] * 5


def test_losses_match_jax():
    rng = np.random.default_rng(2)

    def lists(*shapes):
        return [rng.normal(size=s).astype(np.float32) for s in shapes]

    d_r, d_g = lists((2, 30), (2, 12)), lists((2, 30), (2, 12))
    fmap_r = [lists((2, 5, 3), (2, 4)), lists((2, 6))]
    fmap_g = [lists((2, 5, 3), (2, 4)), lists((2, 6))]
    tt = lambda xs: [t(x) for x in xs]  # noqa: E731
    close(losses.feature_loss([tt(f) for f in fmap_r], [tt(f) for f in fmap_g]),
          jlosses.feature_loss(fmap_r, fmap_g))
    ours, ref = losses.discriminator_loss(tt(d_r), tt(d_g)), jlosses.discriminator_loss(d_r, d_g)
    close(ours[0], ref[0])
    for a, b in zip(ours[1] + ours[2], ref[1] + ref[2]):
        close(a, b)
    ours, ref = losses.generator_loss(tt(d_g)), jlosses.generator_loss(d_g)
    close(ours[0], ref[0])
    for a, b in zip(ours[1], ref[1]):
        close(a, b)
    z_p, logs_q, m_p, logs_p = lists(*[(2, 9, 4)] * 4)
    mask = (np.arange(9)[None, :, None] < np.array([9, 6])[:, None, None]).astype(np.float32)
    close(losses.kl_loss(*tt([z_p, logs_q, m_p, logs_p, mask])),
          jlosses.kl_loss(z_p, logs_q, m_p, logs_p, mask))


def _batch(cfg, seed, lengths=(FRAMES, FRAMES - 8)):
    """A consistent GAN batch as numpy (the port's synthetic one), ragged."""
    gcfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, target="flowvae"))
    batch = next(synthetic_batches(gcfg, 1, B, FRAMES, TEXT,
                                   generator=torch.Generator().manual_seed(seed)))
    data = {k: v.numpy() for k, v in batch.items()}
    data["spec_length"] = data["raw_spec_length"] = np.array(lengths)
    return data


def _flow_draws(cfg, rng, lengths):
    """The draws of JAX forward_flowvae (synthesizer.py:244-250)."""
    q_rng, s_rng = jax.random.split(rng)
    noise = jax.random.normal(q_rng, (B, FRAMES, cfg.vaegan.inter_channels), jnp.float32)
    seg = cfg.train.segment_size // cfg.data.hop_length
    starts = jcommon.rand_slice_starts(s_rng, jnp.asarray(lengths), seg)
    return FlowDraws(t(noise), t(starts, torch.long))


def test_forward_flowvae_matches_jax():
    model, jvars, port = synth_pair()
    data = _batch(port.cfg, 3)
    rng = jax.random.PRNGKey(4)
    ref = model.apply(jvars, jnp.asarray(data["mel"]), jnp.asarray(data["spec"]),
                      jnp.asarray(data["spec_length"]), rng, deterministic=True,
                      method=JaxSynth.forward_flowvae)
    draws = _flow_draws(port.cfg, rng, data["spec_length"])
    with torch.no_grad():
        ours = port.forward_flowvae(t(data["mel"]), t(data["spec"]),
                                    t(data["spec_length"], torch.long), draws)
    assert ours._fields == ref._fields and len(ours) == 9
    np.testing.assert_array_equal(ours.ids_slice.numpy(), np.asarray(ref.ids_slice))
    for name, a, b in zip(ours._fields, ours, ref):
        # z_p reaches |40| after four couplings: atol 1e-4 of max(1, max |JAX|)
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(np.asarray(a, np.float32), b, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(np.abs(b).max())),
                                   err_msg=name)
    assert ours.y_hat_slice.shape == (B, port.cfg.train.segment_size, 1)


def _gan_cfg(cfg, target):
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, target=target, use_bf16=False,
                                       weight_norm=True),
        gpt=dataclasses.replace(cfg.gpt, dropout=0.0),
        vaegan=dataclasses.replace(cfg.vaegan, p_dropout=0.0),
        diffusion=dataclasses.replace(cfg.diffusion, layer_drop=0.0))


def _record_vq(monkeypatch, model, variables, data, vq_rng):
    """JAX's draws of forward_vq under ``vq_rng`` (as make_gan_step calls it)."""
    calls = []
    orig = jquantizer._sample_vectors

    def rec(rng, samples, num):
        calls.append(np.asarray(jax.random.randint(rng, (num,), 0, samples.shape[0])))
        return orig(rng, samples, num)

    monkeypatch.setattr(jquantizer, "_sample_vectors", rec)
    with jax.disable_jit():
        model.apply(variables, jnp.asarray(data["mel"]), jnp.asarray(data["spec_length"]),
                    train=True, method=JaxSynth.forward_vq, mutable=["vq_state"],
                    rngs={"vq": vq_rng})
    monkeypatch.setattr(jquantizer, "_sample_vectors", orig)
    assert len(calls) == 2  # un-inited: k-means rows, then expiry rows
    return VQDraws(t(calls[0][None], torch.long), t(calls[1][None], torch.long))


def _jax_gan_draws(cfg, rng, data, monkeypatch, model, variables):
    """The draws of JAX make_gan_step under ``rng`` (step.py:274-317)."""
    g_rng, _ = jax.random.split(rng)
    f_rng, d_rng, _, vq_rng = jax.random.split(g_rng, 4)
    flow = _flow_draws(cfg, f_rng, data["spec_length"])
    if cfg.train.target != "all":
        return GanDraws(flow)
    schedule = jax_train_schedule(cfg)
    t_rng, n_rng, u_rng, _ = jax.random.split(d_rng, 4)
    d = DiffDraws(
        t(jax.random.randint(t_rng, (B,), 0, schedule.num_timesteps), torch.long),
        t(jax.random.normal(n_rng, data["raw_mel"].shape, jnp.float32)),
        t(jax.random.uniform(u_rng, (B,)) < cfg.diffusion.unconditioned_percentage),
        (True,) * (cfg.diffusion.num_layers + 3))
    return GanDraws(flow, d, _record_vq(monkeypatch, model, variables, data, vq_rng))


def _jax_first_moments(opt_state, params):
    """optax's Adam first moments (0.2 x the gradient after one step) as a
    params-shaped tree, zeros for the frozen subtrees."""
    masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    return jax.tree_util.tree_map(
        lambda m, p: jax.tree_util.tree_map(np.zeros_like, p) if masked(m) else m,
        optax_tree_utils.tree_get(opt_state, "mu"), params, is_leaf=masked)


def _check_one_adam_step(module, before, optimizer, cfg, jax_after, jax_moments,
                         trainable, to_port):
    """After one step: the AdamW first moment (0.2 x the gradient) of every
    trainable tensor against optax's at rtol 1e-4, atol 2e-3 of the
    tensor's largest (measured worst 5.2e-4: the scale discriminator's first
    conv, on raw audio, reads the same on identical inputs), and its new
    value at ``test_three_adamw_steps_match_optax``'s atol 1e-6, rtol 1e-5
    where the gradient is at least 1e-4 of the tensor's largest (one Adam
    step moves an element by ~lr whatever its gradient's size, so below
    that fp32 noise decides the direction); the key projections' biases,
    whose gradient is 0 in exact arithmetic, are held to moving only.
    Frozen tensors stay bit-identical."""
    after, moments = to_port(module, jax_after), to_port(module, jax_moments)
    names = {id(p): n for n, p in module.named_parameters()}
    ours = {names[id(p)]: s["exp_avg"] for p, s in optimizer.state.items()}
    assert set(ours) == trainable
    for name, value in module.state_dict().items():
        if name not in trainable:
            if "_codebook." not in name:
                assert torch.equal(value, before[name]), name
            continue
        assert not torch.equal(value, before[name]), name
        keep = ~key_bias_mask(name, value.shape, cfg)
        m_ref = moments[name].numpy()
        scale = float(np.abs(m_ref[keep]).max()) if keep.any() else 0.0
        np.testing.assert_allclose(ours[name].numpy()[keep], m_ref[keep], rtol=1e-4,
                                   atol=2e-3 * scale, err_msg=f"{name} first moment")
        sure = keep & (np.abs(m_ref) >= 1e-4 * scale)
        np.testing.assert_allclose(value.numpy()[sure], after[name].numpy()[sure],
                                   atol=1e-6, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("target", ["flowvae", "all"])
def test_gan_step_matches_jax(monkeypatch, jax_dropout_off, disc_pair, target):
    jcfg = _gan_cfg(synth_pair()[0].cfg, target)
    model = JaxSynth(jcfg)
    jvars = _seeded_wn(lambda: variables_template(jcfg), 5)
    # the seeded posterior's log-std reaches 11.5 (z up to 3.5e4), where the
    # decoder turns fp32 rounding (7e-6 of z in either framework) into 2.5e-3
    # of y_hat; a tenth of its proj kernel keeps z within O(10)
    jvars["params"]["enc_q"]["proj"]["conv"]["kernel"] *= 0.1
    d_vars, disc0 = disc_pair
    data = _batch(jcfg, 6)
    rng = jax.random.PRNGKey(9)
    draws = _jax_gan_draws(jcfg, rng, data, monkeypatch, model, jvars)

    tx = jax_make_optimizer(jcfg, target, clip_norm=None)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=jvars["params"],
                          vq_state=jvars["vq_state"], opt_state=tx.init(jvars["params"]),
                          d_params=d_vars["params"],
                          d_opt_state=jax_d_optimizer(jcfg).init(d_vars["params"]))
    jstep = jax_gan_step(model, JaxMPD(), jcfg, donate=False)
    new, jm = jstep(state, {k: jnp.asarray(v) for k, v in data.items()}, rng)

    pcfg = _gan_cfg(small_test_config(), target)
    port = weight_norm_(SynthesizerTrn(pcfg))
    port.load_state_dict(from_jax_variables(port, jvars, pcfg.diffusion.num_layers)[0])
    pstate = make_train_state(pcfg, device="cpu", model=no_dropout(port),
                              disc=copy.deepcopy(disc0))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    d_before = {k: v.clone() for k, v in pstate.disc.state_dict().items()}
    step = make_gan_step(pcfg, device="cpu")
    m = step(pstate, {k: t(v) for k, v in data.items()}, draws=draws)

    names = ("loss_gen_all", "loss_gen", "loss_fm", "loss_mel", "loss_kl", "loss_commit",
             "loss_diff", "loss_gpt", "loss_disc_all", "grad_norm_g", "grad_norm_d")
    for name in names:
        np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert (float(m["loss_diff"]) != 0.0) == (target == "all")
    jax_moments = _jax_first_moments(new.opt_state, jvars["params"])
    _check_one_adam_step(port, before, pstate.optimizer, pcfg,
                         {"params": new.params, "vq_state": new.vq_state},
                         {"params": jax_moments, "vq_state": new.vq_state},
                         set(n for n, _ in trainable_parameters(port, target)),
                         lambda m, v: from_jax_variables(m, v, pcfg.diffusion.num_layers)[0])
    to_disc = lambda m, v: from_jax_variables(  # noqa: E731
        m, v, translate_fn=translate_discriminator)[0]
    _check_one_adam_step(pstate.disc, d_before, pstate.d_optimizer, pcfg,
                         {"params": new.d_params},
                         {"params": _jax_first_moments(new.d_opt_state, d_vars["params"])},
                         set(d_before), to_disc)
    jax_codebook = from_jax_variables(port, {"params": new.params, "vq_state": new.vq_state},
                                      pcfg.diffusion.num_layers)[0]
    for name, value in port.state_dict().items():
        if "_codebook." in name:  # the EMA state moves under all only
            assert torch.equal(value, before[name]) == (target != "all"), name
            # a code no vector chose has embed = embed_avg / ~1e-5 (the Laplace
            # floor), in JAX too: rtol 1e-3 there (measured 6.8e-4)
            close(value, jax_codebook[name],
                  rtol=1e-3 if name.endswith("._codebook.embed") else 1e-4)
    assert all(p.grad is None for p in pstate.params + pstate.d_params)


def _flowvae_state(p_dropout):
    cfg = small_test_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, target="flowvae"),
                              vaegan=dataclasses.replace(cfg.vaegan, p_dropout=p_dropout))
    state = make_train_state(cfg, device="cpu", seed=0)
    batch = next(synthetic_batches(cfg, 1, B, FRAMES, TEXT,
                                   generator=torch.Generator().manual_seed(1)))
    return cfg, state, batch, make_gan_step(cfg, device="cpu")


def test_gan_dropout_step_is_a_function_of_its_seed():
    cfg, state, batch, step = _flowvae_state(0.1)
    snap = state.snapshot()
    runs = []
    for seed in (5, 5):
        state.restore(snap)
        runs.append(step(state, batch, torch.Generator().manual_seed(seed)))
    for name in runs[0]:
        assert torch.equal(runs[0][name], runs[1][name]), name
    # the same draws with another generator: only the dropout masks differ
    draws = GanDraws(draw_flow(cfg, batch["spec_length"], FRAMES,
                               torch.Generator().manual_seed(9), torch.device("cpu")))
    out = []
    for seed in (5, 6):
        state.restore(snap)
        out.append(float(step(state, batch, torch.Generator().manual_seed(seed),
                              draws=draws)["loss_gen_all"]))
    assert np.isfinite(out).all() and out[0] != out[1]
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state()
    with torch.no_grad():
        state.model.eval().forward_flowvae(batch["mel"], batch["spec"], batch["spec_length"],
                                           draws.flow, gen)
    assert torch.equal(gen.get_state(), before)


def test_trainer_runs_gan_targets_and_logs_jax_metrics(tmp_path):
    cfg = small_test_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, target="all"))
    data = synthetic_batches(cfg, 1, B, FRAMES, TEXT,
                             generator=torch.Generator().manual_seed(1))
    with_axis = ({k: v[None] for k, v in b.items()} for b in data)  # accum axis of 1
    trainer = Trainer(cfg, with_axis, device="cpu", seed=0, logs_folder=str(tmp_path))
    codebook = trainer.state.model.quantizer.vq.layers[0]._codebook.embed.clone()
    d_before = {k: v.clone() for k, v in trainer.state.disc.state_dict().items()}
    logged = trainer.train(max_steps=1, log_every=1)
    line = json.loads((tmp_path / "metrics.jsonl").read_text().splitlines()[-1])
    assert set(line) == {"step", "steps_per_sec", "loss_gen_all", "loss_gen", "loss_fm",
                         "loss_mel", "loss_kl", "loss_commit", "loss_diff", "loss_gpt",
                         "loss_disc_all", "grad_norm_g", "grad_norm_d"}
    assert all(np.isfinite(v) for v in logged.values())
    assert not torch.equal(codebook, trainer.state.model.quantizer.vq.layers[0]._codebook.embed)
    assert all(not torch.equal(v, d_before[k])
               for k, v in trainer.state.disc.state_dict().items())
    assert trainer.state.disc.discriminators[1].convs[0].weight_v.requires_grad


def test_synthetic_gan_batch_is_consistent():
    cfg = small_test_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, target="flowvae"))
    batch = next(synthetic_batches(cfg, 1, B, FRAMES, TEXT,
                                   generator=torch.Generator().manual_seed(2)))
    assert batch["wav"].shape == (B, FRAMES * 256, 1) and batch["mel"].shape == (B, FRAMES, 128)
    mel = MelFrontend().mel_spectrogram(batch["wav"][..., 0])
    assert torch.equal(mel, batch["mel"]) and torch.equal(batch["mel"], batch["raw_mel"])
    assert batch["spec"].shape == (B, FRAMES, 513) and batch["text"].min() >= 1
    with pytest.raises(ValueError, match="accum 1"):
        next(synthetic_batches(cfg, 2, B, FRAMES, TEXT))
