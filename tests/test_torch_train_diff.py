"""The diffusion training slice against the JAX package, fp32 on the CPU:

(a) ``forward_diff``'s loss and the gradient of every ``diffusion``
    parameter against ``jax.value_and_grad`` of the JAX ``forward_diff``,
    with JAX's own draws (timesteps, noise, unconditioned rows, layer-drop
    flags) handed to the port;
(b) three AdamW steps of the port against optax's ``make_optimizer`` on fixed
    gradient trees, one of them clipped, across an LR staircase boundary;
(c) one whole ``train_step`` with two microbatches, and ``Trainer.train``
    with its metrics log;
and ``DiffResBlock``'s dropout, drawn from the step's explicit generator: a
step with dropout is a function of its seed.
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

from detail_tts_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
from detail_tts_tpu.models.synthesizer import make_train_schedule as jax_train_schedule
from detail_tts_tpu.train.optim import make_optimizer as jax_make_optimizer
from detail_tts_tpu_torch.config import small_test_config
from detail_tts_tpu_torch.io.weights import from_jax_variables
from detail_tts_tpu_torch.models.synthesizer import (DiffDraws, draw_diff,
                                                     make_train_schedule)
from detail_tts_tpu_torch.nn.diff_blocks import DiffResBlock
from detail_tts_tpu_torch.ops import attention as port_attn
from detail_tts_tpu_torch.train.optim import (make_optimizer, optimizer_step,
                                              trainable_parameters)
from detail_tts_tpu_torch.train.step import (dummy_batch, make_single_loss_step,
                                             make_train_state, synthetic_batches)
from detail_tts_tpu_torch.train.trainer import Trainer
from tests.torch_parity import synth_pair, t

B, FRAMES, TEXT = 2, 48, 8


def _with_target(cfg, **train):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, target="diff",
                                                              **train))


def _data(seed):
    """A 12-key batch: mel = raw_mel ~ N(-6, 2), random text ids."""
    rng = np.random.default_rng(seed)
    cfg = synth_pair()[2].cfg
    data = {k: v.numpy() for k, v in dummy_batch(cfg, B, FRAMES, TEXT).items()}
    data["mel"] = data["raw_mel"] = rng.normal(-6, 2, data["mel"].shape).astype(np.float32)
    data["text"] = rng.integers(1, 200, data["text"].shape)
    return data


def _jax_draws(cfg, schedule, rng, shape):
    """The draws of JAX forward_diff (synthesizer.py:209, diffusion_model.py:233)."""
    t_rng, n_rng, u_rng, ld_rng = jax.random.split(rng, 4)
    d = cfg.diffusion
    n_layers = d.num_layers + 3
    keep = [True] + [bool(jax.random.bernoulli(jax.random.fold_in(ld_rng, i),
                                               1.0 - d.layer_drop))
                     for i in range(1, n_layers - 1)] + [True]
    return DiffDraws(
        t(jax.random.randint(t_rng, (shape[0],), 0, schedule.num_timesteps), torch.long),
        t(jax.random.normal(n_rng, shape, jnp.float32)),
        t(jax.random.uniform(u_rng, (shape[0],)) < d.unconditioned_percentage),
        tuple(keep))


def _port_grads_as_jax(port, tree):
    """A JAX params-shaped tree -> the port's state-dict names and layouts."""
    _, jvars, _ = synth_pair()
    state, _ = from_jax_variables(port, {"params": tree, "vq_state": jvars["vq_state"]},
                                  port.cfg.diffusion.num_layers)
    return state


def test_forward_diff_loss_and_grads_match_jax():
    model, jvars, port0 = synth_pair()
    cfg = model.cfg
    schedule = jax_train_schedule(cfg)
    data = _data(0)
    # a key whose draws hold an unconditioned row and a dropped layer
    for seed in range(200):
        rng = jax.random.PRNGKey(seed)
        draws = _jax_draws(cfg, schedule, rng, (B, FRAMES, 128))
        if draws.uncond.any() and not all(draws.keep):
            break
    assert draws.uncond.any() and not all(draws.keep)

    def loss_fn(params):
        return model.apply({"params": params, "vq_state": jvars["vq_state"]},
                           {k: jnp.asarray(v) for k, v in data.items()}, schedule, rng,
                           deterministic=False, method=JaxSynth.forward_diff,
                           rngs={"dropout": rng})

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(jvars["params"])

    port = copy.deepcopy(port0).train()
    params = dict(trainable_parameters(port, "diff"))
    loss = port.forward_diff({k: t(v) for k, v in data.items()},
                             make_train_schedule(port.cfg), draws)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-4)

    ref = _port_grads_as_jax(port, jax.tree_util.tree_map(np.asarray, ref_grads))
    dropped = [i for i, k in enumerate(draws.keep) if not k]
    assert params and all(n.startswith("diffusion.") for n in params)
    for name, p in params.items():
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        if any(name.startswith(f"diffusion.layers.{i}.") for i in dropped):
            assert p.grad is None  # the dropped layer was skipped
            assert np.abs(ref[name].numpy()).max() == 0.0
        np.testing.assert_allclose(grad.numpy(), ref[name].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
    table = params["diffusion.layers.0.attn.relative_pos_embeddings."
                   "relative_attention_bias.weight"]
    assert float(table.grad.abs().max()) > 1e-4  # the bias gradient reached it
    assert float(params["diffusion.unconditioned_embedding"].grad.abs().max()) > 0


def test_three_adamw_steps_match_optax():
    model, jvars, port0 = synth_pair()
    jcfg = _with_target(model.cfg, learning_rate=1e-2, lr_decay=0.5, lr_decay_every=2)
    pcfg = _with_target(port0.cfg, learning_rate=1e-2, lr_decay=0.5, lr_decay_every=2)
    rng = np.random.default_rng(7)

    def tree(norm):
        """A gradient tree whose diffusion subtree has global norm ``norm``."""
        g = jax.tree_util.tree_map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), jvars["params"])
        cur = np.sqrt(sum(float(np.sum(x ** 2))
                          for x in jax.tree_util.tree_leaves(g["diffusion"])))
        return jax.tree_util.tree_map(lambda x: x * (norm / cur), g)

    trees = [tree(0.5), tree(3.0), tree(0.8)]  # the second one is clipped

    tx = jax_make_optimizer(jcfg, "diff", clip_norm=1.0)
    params, opt_state = jvars["params"], tx.init(jvars["params"])
    for g in trees:
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)

    port = copy.deepcopy(port0)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    trainable = trainable_parameters(port, "diff")
    opt = make_optimizer([p for _, p in trainable], pcfg)
    norms = []
    for k, g in enumerate(trees):
        grads = _port_grads_as_jax(port, g)
        for name, p in trainable:
            p.grad = grads[name].clone()
        norms.append(float(optimizer_step(opt, [p for _, p in trainable], pcfg, k)))
        opt.zero_grad(set_to_none=True)
    np.testing.assert_allclose(norms, [0.5, 3.0, 0.8], rtol=1e-5)

    ref = _port_grads_as_jax(port, jax.tree_util.tree_map(np.asarray, params))
    names = dict(trainable)
    for name, value in port.state_dict().items():
        if name in names:
            assert not torch.equal(value, before[name]), name
            np.testing.assert_allclose(value.numpy(), ref[name].numpy(), atol=1e-6,
                                       rtol=1e-5, err_msg=name)
        else:  # frozen: bit-identical, and optax left it alone too
            assert torch.equal(value, before[name]), name
            np.testing.assert_array_equal(value.numpy(), ref[name].numpy())


def test_train_step_on_cpu_moves_trainable_parameters():
    port0 = synth_pair()[2]
    cfg = _with_target(port0.cfg)
    state = make_train_state(cfg, device="cpu", model=copy.deepcopy(port0))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    step = make_single_loss_step(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    batch = next(synthetic_batches(cfg, accum=2, micro_batch=B, mel_frames=FRAMES,
                                   text_len=TEXT, generator=gen))
    launches = dict(port_attn.TRAIN_LAUNCHES)
    timings = {}
    metrics = step(state, batch, gen, timings=timings)
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    assert len(metrics["layers_kept"]) == 2 and state.step == 1
    assert set(timings) == {"latents", "forward", "backward", "optimizer"}
    assert port_attn.TRAIN_LAUNCHES == launches  # the CPU runs the plain versions
    moved = {k for k, v in state.model.state_dict().items() if not torch.equal(v, before[k])}
    trainable = {n for n, p in state.model.named_parameters() if p.requires_grad}
    assert moved == trainable and all(n.startswith("diffusion.") for n in moved)
    for p in state.params:
        assert p.grad is None  # cleared for the next step


def test_trainer_logs_each_step(tmp_path):
    cfg = _with_target(synth_pair()[2].cfg, gradient_accumulate_every=2)
    data = synthetic_batches(cfg, accum=2, micro_batch=B, mel_frames=FRAMES,
                             text_len=TEXT, generator=torch.Generator().manual_seed(1))
    trainer = Trainer(cfg, data, device="cpu", seed=0, logs_folder=str(tmp_path))
    logged = trainer.train(max_steps=2, log_every=1)
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2] and trainer.state.step == 2
    assert lines[-1]["loss"] == logged["loss"] and np.isfinite(logged["grad_norm"])


def test_untrained_targets_raise():
    cfg = synth_pair()[2].cfg
    for target in ("gpt", "vqvae", "flowvae", "all"):
        with pytest.raises(NotImplementedError, match="not ported"):
            make_train_state(dataclasses.replace(
                cfg, train=dataclasses.replace(cfg.train, target=target)), device="cpu")


def test_diff_resblock_dropout_only_in_train_mode():
    torch.manual_seed(0)
    blk = DiffResBlock(64, 64, dropout=0.5)
    x, emb = torch.randn(2, 10, 64), torch.randn(2, 64)
    with torch.no_grad():
        blk.out_layers[3].weight.normal_()  # a non-zero out conv
        blk.eval()
        a, b = blk(x, emb), blk(x, emb)
        blk.train()
        c = blk(x, emb, torch.Generator().manual_seed(0))
    assert isinstance(blk.out_layers[2], torch.nn.Dropout)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    plain = DiffResBlock(64, 64)
    plain.load_state_dict(blk.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(plain.eval()(x, emb), a)


def _dropout_state(p):
    """A seeded train state of ``small_test_config()`` with diffusion dropout
    ``p``, a one-microbatch batch and the step function, on the CPU."""
    cfg = small_test_config()
    cfg = _with_target(dataclasses.replace(
        cfg, diffusion=dataclasses.replace(cfg.diffusion, dropout=p)))
    state = make_train_state(cfg, device="cpu", seed=0)
    batch = next(synthetic_batches(cfg, accum=1, micro_batch=B, mel_frames=FRAMES,
                                   text_len=TEXT, generator=torch.Generator().manual_seed(1)))
    return cfg, state, batch, make_single_loss_step(cfg, device="cpu")


def test_dropout_step_is_a_function_of_its_seed():
    cfg, state, batch, step = _dropout_state(0.1)
    snap = state.snapshot()
    runs = []
    for seed in (5, 5):
        state.restore(snap)
        runs.append(step(state, batch, torch.Generator().manual_seed(seed)))
    assert torch.equal(runs[0]["loss"], runs[1]["loss"])
    assert torch.equal(runs[0]["grad_norm"], runs[1]["grad_norm"])
    # the same draws (timesteps, noise, rows, layers) with another generator:
    # only the dropout masks differ, and the loss with them
    draws = [draw_diff(cfg, make_train_schedule(cfg), batch["raw_mel"][0].shape,
                       torch.Generator().manual_seed(9), torch.device("cpu"))]
    losses = []
    for seed in (5, 6):
        state.restore(snap)
        losses.append(float(step(state, batch, torch.Generator().manual_seed(seed),
                                 draws=draws)["loss"]))
    assert np.isfinite(losses).all() and losses[0] != losses[1]


@pytest.mark.parametrize("p,mode", [(0.1, "eval"), (0.0, "train")])
def test_dropout_draws_nothing_in_eval_mode_or_at_zero(p, mode):
    cfg, state, batch, _ = _dropout_state(p)
    model = getattr(state.model, mode)()
    mb = {k: v[0] for k, v in batch.items()}
    schedule = make_train_schedule(cfg)
    draws = draw_diff(cfg, schedule, mb["raw_mel"].shape, torch.Generator().manual_seed(2),
                      torch.device("cpu"), train=False)
    gen = torch.Generator().manual_seed(3)
    before = gen.get_state()
    with torch.no_grad():
        loss = model.forward_diff(mb, schedule, draws, generator=gen)
    assert np.isfinite(float(loss)) and torch.equal(gen.get_state(), before)


def test_dropout_in_train_mode_without_a_generator_raises():
    cfg, state, batch, _ = _dropout_state(0.1)
    mb = {k: v[0] for k, v in batch.items()}
    schedule = make_train_schedule(cfg)
    draws = draw_diff(cfg, schedule, mb["raw_mel"].shape, torch.Generator().manual_seed(2),
                      torch.device("cpu"))
    with pytest.raises(ValueError, match="Generator"):
        state.model.train().forward_diff(mb, schedule, draws)
