"""``TrainConfig.remat_gpt`` in the port (``models/gpt.py``: each GPT block
of a training forward under ``torch.utils.checkpoint``, its dropout masks
replayed from the step's generator), fp32 on the CPU:

(a) a ``gpt`` step with remat on matches JAX's step with ``remat_gpt=True``
    at dropout 0 (``test_torch_parallel.assert_one_step``'s tolerances);
(b) at dropout 0.1 remat on is bit-identical to remat off: the loss, every
    gradient, the step's new tensors and the generator's state after it;
    a ``checkpoint`` whose recompute does not replay the generator fails
    that check (a negative control);
(c) remat keeps fewer activations for the backward, and neither the frozen
    latents pass nor a cached decode goes through ``checkpoint``.
"""
import contextlib
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detail_tts_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
from detail_tts_tpu.train.step import make_single_loss_step as jax_single_loss_step
from detail_tts_tpu_torch.config import small_test_config
from detail_tts_tpu_torch.models import gpt as gpt_mod
from detail_tts_tpu_torch.train.optim import trainable_parameters
from detail_tts_tpu_torch.train.step import (make_single_loss_step, make_train_state,
                                             synthetic_batches)
from tests import torch_dist
from tests.test_torch_gan import _jax_first_moments
from tests.test_torch_parallel import assert_metrics, assert_one_step
from tests.test_torch_train_targets import _cfg, _data, _jax_state, _port_tree
from tests.torch_parity import jax_dropout_off, synth_pair, t  # noqa: F401

B, FRAMES, TEXT, ACCUM = 2, 48, 8, 2


def test_remat_step_matches_jax_remat_gpt(jax_dropout_off):
    model, jvars, port0 = synth_pair()
    jcfg = _cfg(model.cfg, "gpt", remat_gpt=True)
    cfg = _cfg(port0.cfg, "gpt", remat_gpt=True)
    data = _data(70, ACCUM * B)
    stack = lambda v: v.reshape(ACCUM, B, *v.shape[1:])  # noqa: E731
    new, jm = jax_single_loss_step(JaxSynth(jcfg), jcfg, donate=False)(
        _jax_state(jcfg, jvars), {k: jnp.asarray(stack(v)) for k, v in data.items()},
        jax.random.PRNGKey(71))
    sd = {k: v.clone() for k, v in port0.state_dict().items()}
    calls = []
    checkpoint = gpt_mod.checkpoint

    def counted(*args, **kwargs):
        calls.append(1)
        return checkpoint(*args, **kwargs)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(gpt_mod, "checkpoint", counted)
        out = torch_dist.train_steps(None, cfg, sd, [{k: stack(t(v)) for k, v in data.items()}])
    assert len(calls) == ACCUM * cfg.gpt.layers  # every block of each micro-batch
    assert_metrics(out["metrics"][0], {k: float(v) for k, v in jm.items()})
    trainable = {n for n, _ in trainable_parameters(copy.deepcopy(port0), "gpt")}
    assert_one_step(out["model"], out["moments"],
                    _port_tree(port0, jax.tree_util.tree_map(np.asarray, new.params),
                               new.vq_state),
                    _port_tree(port0, _jax_first_moments(new.opt_state, jvars["params"]),
                               new.vq_state),
                    sd, trainable, cfg)


def _dropout_run(remat: bool, seed: int = 5):
    """Loss, every gradient and the generator's state after one GPT
    forward and backward at dropout 0.1, then a whole step's metrics, new
    tensors and generator state; from seeded weights."""
    cfg = small_test_config()
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, target="gpt", use_bf16=False,
                                       remat_gpt=remat),
        gpt=dataclasses.replace(cfg.gpt, dropout=0.1))
    state = make_train_state(cfg, device="cpu", seed=0)
    assert state.model.gpt.gpt.remat == remat
    batch = next(synthetic_batches(cfg, ACCUM, B, FRAMES, TEXT,
                                   generator=torch.Generator().manual_seed(1)))
    gen = torch.Generator().manual_seed(seed)
    lt, lm = state.model.forward_gpt({k: v[0] for k, v in batch.items()}, gen)
    (lt + lm).backward()
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters() if p.grad is not None}
    forward = ((lt + lm).detach(), grads, gen.get_state())
    state.model.zero_grad(set_to_none=True)
    m = make_single_loss_step(cfg, device="cpu")(state, batch, gen)
    return forward, ({k: v for k, v in m.items() if torch.is_tensor(v)},
                     state.model.state_dict(), gen.get_state())


def _assert_same(a, b):
    (loss_a, grads_a, gen_a), (metrics_a, sd_a, step_gen_a) = a
    (loss_b, grads_b, gen_b), (metrics_b, sd_b, step_gen_b) = b
    assert torch.equal(loss_a, loss_b)
    assert grads_a.keys() == grads_b.keys() and len(grads_a) > 10
    for name, g in grads_a.items():
        assert torch.equal(g, grads_b[name]), name
    assert torch.equal(gen_a, gen_b) and torch.equal(step_gen_a, step_gen_b)
    for name, v in metrics_a.items():
        assert torch.equal(v, metrics_b[name]), name
    for name, v in sd_a.items():
        assert torch.equal(v, sd_b[name]), name


def test_remat_is_bit_identical_at_dropout():
    _assert_same(_dropout_run(remat=True), _dropout_run(remat=False))


def test_remat_without_the_generator_replay_is_caught(monkeypatch):
    plain = _dropout_run(remat=False)
    # a recompute that leaves the generator where it is
    monkeypatch.setattr(gpt_mod, "_replay", lambda generator, state: contextlib.nullcontext())
    with pytest.raises(AssertionError):
        _assert_same(_dropout_run(remat=True), plain)


def _saved_bytes(model, mb, gen):
    """Bytes the autograd graph keeps outside checkpointed regions."""
    total = []

    def pack(x):
        total.append(x.numel() * x.element_size())
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        loss = sum(model.forward_gpt(mb, gen))
    loss.backward()
    return sum(total)


def test_remat_keeps_fewer_activations_and_skips_frozen_and_cached_passes(monkeypatch):
    cfg = small_test_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, target="gpt",
                                                             use_bf16=False))
    assert cfg.train.remat_gpt
    state = make_train_state(cfg, device="cpu", seed=0)
    batch = next(synthetic_batches(cfg, 1, B, FRAMES, TEXT,
                                   generator=torch.Generator().manual_seed(1)))
    mb = {k: v[0] for k, v in batch.items()}
    with_remat = _saved_bytes(state.model, mb, torch.Generator().manual_seed(0))
    state.model.gpt.gpt.remat = False
    without = _saved_bytes(state.model, mb, torch.Generator().manual_seed(0))
    assert with_remat < 0.8 * without
    state.model.gpt.gpt.remat = True
    monkeypatch.setattr(gpt_mod, "checkpoint", lambda *a, **k: pytest.fail("checkpoint ran"))
    with torch.no_grad():
        state.model.gpt_latents(mb)
    gpt = state.model.gpt.eval()  # a cached decode, grad mode on
    cache = gpt.init_cache(B, 4, torch.float32, "cpu")
    with torch.enable_grad():
        gpt.decode_prefill(torch.zeros(B, 2, cfg.gpt.model_dim), cache)
