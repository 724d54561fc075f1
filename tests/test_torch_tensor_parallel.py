"""Tensor parallelism of the port's GPT (``parallel/mesh.py``'s model axis)
against its world-1 step and the JAX package, fp32 on the CPU, over gloo
process groups of 2 and 4 ranks (``tests/torch_dist.py``):

(a) a ``gpt`` step at (1 x 2) and (2 x 2) and a ``diff`` step at (1 x 2)
    (its frozen latents pass runs the sharded GPT) on a global batch of
    4 x accum 2, dropout 0, equals the port's world-1 step and JAX's step
    on an unsharded state and on a (data, model) mesh of the virtual CPU
    devices through ``shard_tree`` (JAX's own partition rules), with
    ``_assert_step_matches``' tolerances; the ranks' replicated tensors are
    bit-identical;
(b) negative controls: without the model-group sum of the grad norm the
    norm and the replicas part; with the step's collectives (the
    quantizer's) over the world rather than the data group, ``vqvae`` at
    (1 x 2) from a fresh codebook misses world 1's codebook;
(c) the region operators and the vocab-parallel cross-entropy, forward and
    gradient, against the unsharded ops, with a target in each shard, and
    the demotions of the partition rules (the 257-wide text head);
(d) a (1 x 2) checkpoint restores at world 1 and back, with the same
    parameters and moments, and the next step agrees;
and ``check_mesh``'s model-axis refusals.
"""
import dataclasses

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detail_tts_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
from detail_tts_tpu.parallel.mesh import make_mesh as jax_make_mesh
from detail_tts_tpu.parallel.mesh import replicate_tree as jax_replicate_tree
from detail_tts_tpu.parallel.mesh import shard_batch as jax_shard_batch
from detail_tts_tpu.parallel.mesh import shard_tree as jax_shard_tree
from detail_tts_tpu.train.step import make_single_loss_step as jax_single_loss_step
from detail_tts_tpu_torch.config import Config, small_test_config
from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
from detail_tts_tpu_torch.parallel import mesh
from detail_tts_tpu_torch.train import checkpoint as ckpt
from detail_tts_tpu_torch.train.optim import trainable_parameters
from tests import torch_dist
from tests.test_torch_gan import _jax_first_moments
from tests.test_torch_parallel import (ACCUM, B, _assert_step_matches, _jax_reference,
                                       _port_case, assert_one_step)
from tests.test_torch_train_targets import _cfg, _data, _jax_state, _port_tree
from tests.torch_parity import close, synth_pair, t

_JAX_MESH = {}


def _on_mesh(cfg, data, model):
    return dataclasses.replace(cfg, mesh=dataclasses.replace(
        cfg.mesh, data_parallel=data, model_parallel=model))


def _jax_mesh_reference(target, data, model):
    """JAX's step of ``target`` on a (data, model) mesh of the virtual CPU
    devices, state through ``shard_tree``, batch through ``shard_batch``:
    (metrics, parameters, AdamW first moments) in the port's names
    (cached).  The batch and rng are ``_jax_reference``'s."""
    key = (target, data, model)
    if key in _JAX_MESH:
        return _JAX_MESH[key]
    jmodel, jvars, port0 = synth_pair()
    jcfg = _cfg(jmodel.cfg, target)
    batch = {k: jnp.asarray(v.reshape(ACCUM, B, *v.shape[1:]))
             for k, v in _data(50, ACCUM * B).items()}
    jstep = jax_single_loss_step(JaxSynth(jcfg), jcfg, donate=False)
    jmesh = jax_make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    state = _jax_state(jcfg, jvars)
    state = state.replace(params=jax_shard_tree(state.params, jmesh),
                          opt_state=jax_shard_tree(state.opt_state, jmesh),
                          vq_state=jax_replicate_tree(state.vq_state, jmesh))
    # the mel head's kernel is split over the model axis: JAX's own rules ran
    assert "model" in str(state.params["gpt"]["mel_head"]["dense"]["kernel"].sharding.spec)
    with pytest.MonkeyPatch.context() as patch, jmesh:
        patch.setattr(flax_nn.Dropout, "__call__",
                      lambda self, inputs, deterministic=None, rng=None: inputs)
        new, m = jstep(state, jax_shard_batch(batch, jmesh, batch_axis=1),
                       jax.random.PRNGKey(60))
    params = _port_tree(port0, jax.tree_util.tree_map(np.asarray, new.params), new.vq_state)
    moments = _port_tree(port0, _jax_first_moments(new.opt_state, jvars["params"]),
                         new.vq_state)
    _JAX_MESH[key] = ({k: float(v) for k, v in m.items()}, params, moments)
    return _JAX_MESH[key]


def _assert_replicas_identical(outs):
    for r, out in enumerate(outs[1:], 1):
        for name, value in out["replicated"].items():
            assert torch.equal(value, outs[0]["replicated"][name]), f"rank {r}: {name}"
        for name, value in out["model"].items():
            assert torch.equal(value, outs[0]["model"][name]), f"rank {r}: {name}"


@pytest.mark.parametrize("target,data,model", [("gpt", 1, 2), ("gpt", 2, 2), ("diff", 1, 2)])
def test_tp_step_equals_world_1_and_jax(tmp_path, target, data, model):
    batch, draws, jmetrics, jparams, jmoments = _jax_reference(target)
    cfg, sd = _port_case(target)
    one = torch_dist.train_steps(None, cfg, sd, [batch], [draws])
    outs = torch_dist.spawn(torch_dist.tp_train_steps, data * model, tmp_path,
                            _on_mesh(cfg, data, model), sd, [batch], [draws])
    _assert_replicas_identical(outs)
    # the sharded tensors really are slices: the mel head is split at M = 2
    assert "gpt.mel_head.weight" not in outs[0]["replicated"]
    assert "gpt.text_head.weight" in outs[0]["replicated"]
    _assert_step_matches(outs[0], jmetrics, jparams, jmoments, cfg, target, sd)
    mmetrics, mparams, mmoments = _jax_mesh_reference(target, data, model)
    _assert_step_matches(outs[0], mmetrics, mparams, mmoments, cfg, target, sd)
    world1 = {k: float(v) for k, v in one["metrics"][0].items()}
    _assert_step_matches(outs[0], world1, one["model"], one["moments"], cfg, target, sd)


def test_without_the_model_sum_of_the_grad_norm_the_replicas_part(tmp_path):
    batch, draws, jmetrics = _jax_reference("gpt")[:3]
    cfg, sd = _port_case("gpt")
    outs = torch_dist.spawn(torch_dist.tp_train_steps, 2, tmp_path, _on_mesh(cfg, 1, 2), sd,
                            [batch], [draws], False)
    norms = [float(o["metrics"][0]["grad_norm"]) for o in outs]
    assert all(abs(n - jmetrics["grad_norm"]) > 1e-3 * jmetrics["grad_norm"] for n in norms)
    assert norms[0] != norms[1]  # each rank clips by another factor
    apart = [n for n, v in outs[0]["replicated"].items()
             if n.startswith("gpt.") and not torch.equal(v, outs[1]["replicated"][n])]
    assert len(apart) > 10


def test_quantizer_over_the_world_misses_the_codebook(tmp_path):
    batch, draws, _, jparams = _jax_reference("vqvae")[:4]
    cfg, sd = _port_case("vqvae")
    assert float(sd["quantizer.vq.layers.0._codebook.inited"]) == 0.0  # a fresh codebook
    embed = "quantizer.vq.layers.0._codebook.embed"
    for step_group, same in (("data", True), ("world", False)):
        outs = torch_dist.spawn(torch_dist.tp_train_steps, 2, tmp_path, _on_mesh(cfg, 1, 2),
                                sd, [batch], [draws], True, step_group)
        for key in (embed, "quantizer.vq.layers.0._codebook.cluster_size"):
            ok = np.allclose(outs[0]["model"][key].numpy(), jparams[key].numpy(),
                             rtol=1e-4, atol=1e-4)
            assert ok == same, (step_group, key)


def test_region_operators_and_vocab_parallel_cross_entropy(tmp_path):
    rng = np.random.default_rng(7)
    x = t(rng.normal(size=(5, 6)).astype(np.float32))
    w_col = t(rng.normal(size=(6, 8)).astype(np.float32))
    w_row = t(rng.normal(size=(8, 3)).astype(np.float32))
    logits = t(rng.normal(size=(6, 10)).astype(np.float32) * 3)
    targets = torch.tensor([0, 4, 5, 9, 2, 7])  # both halves of the vocab
    outs = torch_dist.spawn(torch_dist.region_ops_call, 2, tmp_path, x, w_col, w_row,
                            logits, targets)
    xr, wc, wr = (v.clone().requires_grad_(True) for v in (x, w_col, w_row))
    y = torch.tanh(xr @ wc) @ wr
    y.square().sum().backward()
    lg = logits.clone().requires_grad_(True)
    ce = torch.nn.functional.cross_entropy(lg, targets)
    ce.backward()
    for out in outs:
        close(out["y"], y.detach(), atol=1e-5, rtol=1e-5)
        close(out["dx"], xr.grad, atol=1e-5, rtol=1e-5)
        close(out["dw_col"], wc.grad, atol=1e-5, rtol=1e-5)
        close(out["dw_row"], wr.grad, atol=1e-5, rtol=1e-5)
        close(out["ce"], ce.detach(), atol=1e-6, rtol=1e-6)
        close(out["dlogits"], lg.grad, atol=1e-7, rtol=1e-6)
        assert torch.equal(out["gathered"], logits)
        assert torch.equal(out["dgathered"], torch.arange(10.0).expand(6, 10))


def test_partition_rules_demote_what_does_not_split():
    cfg = Config()
    text, mel = (cfg.gpt.number_text_tokens + 1, cfg.gpt.model_dim), \
        (cfg.gpt.number_mel_codes, cfg.gpt.model_dim)
    for m in (2, 4):
        assert mesh.partition_spec("gpt.text_head.weight", text, m) is None
        assert mesh.partition_spec("gpt.gpt.h.3.attn.c_attn.weight", (768, 2304), m) == (1, 3)
        assert mesh.partition_spec("gpt.gpt.h.3.mlp.c_proj.weight", (3072, 768), m) == (0, 1)
        assert mesh.partition_spec("gpt.gpt.h.3.ln_1.weight", (768,), m) is None
    assert mesh.partition_spec("gpt.mel_head.weight", mel, 2) == (0, 1)
    assert mesh.partition_spec("gpt.mel_embedding.weight", mel, 2) == (0, 1)
    assert mesh.partition_spec("gpt.mel_head.weight", mel, 4) is None
    assert mesh.partition_spec("gpt.mel_embedding.weight", mel, 4) is None
    # c_attn by head of q, k and v: this rank's heads of each, and back
    full = torch.arange(2 * 12).reshape(2, 12)
    halves = [mesh.shard_tensor(full, mesh.Shard(None, r, 2, 1, 3)) for r in range(2)]
    assert halves[1][0].tolist() == [2, 3, 6, 7, 10, 11]


@pytest.mark.parametrize("model", [2, 4])
def test_describe_shards_names_each_resolved_spec(model):
    """The line a run prints once: each rule's tensor at its full shape,
    split or demoted; the 257-wide text head stays whole, the 8194-wide
    mel tables split over 2 and not over 4."""
    cfg = small_test_config()
    synth = SynthesizerTrn(cfg)
    m = mesh.Mesh(1, model, model - 1)
    line = mesh.describe_shards(mesh.shard_module_(synth, m), m)
    d, layers = cfg.gpt.model_dim, cfg.gpt.layers
    assert line.startswith(f"mesh (1 x {model}): ")
    assert (f"gpt.gpt.h.N.attn.c_attn.weight ({d}, {3 * d}): axis 1 over 'model' by head "
            f"of q, k and v (x{layers})") in line
    assert f"gpt.text_head.weight (257, {d}): replicated (does not split over {model})" in line
    mel = (f"axis 0 over 'model'" if model == 2
           else f"replicated (does not split over {model})")
    assert f"gpt.mel_head.weight (8194, {d}): {mel}" in line
    assert f"gpt.mel_embedding.weight (8194, {d}): {mel}" in line


def _eval_batch(cfg):
    from detail_tts_tpu_torch.train.step import synthetic_batches

    return next(synthetic_batches(cfg, 1, 2, 48, 16, generator=torch.Generator().manual_seed(3)))


def test_eval_dump_runs_on_data_rank_0s_model_group(tmp_path):
    """A (2 x 2) ``gpt`` Trainer's synthesized eval dump: data rank 0's two
    ranks run it over the split GPT, data rank 1 does not, and rank 0
    writes the world-1 Trainer's audio within JAX's mesh tolerance."""
    from scipy.io import wavfile

    from tests.test_torch_trainer_cli import _cfg as cli_cfg

    cfg = cli_cfg("gpt", val_freq=1, save_freq=10 ** 9)
    batch = _eval_batch(cfg)
    one = torch_dist.tp_eval_dump(None, cfg, batch, str(tmp_path / "one"))
    outs = torch_dist.spawn(torch_dist.tp_eval_dump, 4, tmp_path, _on_mesh(cfg, 2, 2),
                            batch, str(tmp_path / "mesh"))
    assert one["synthesized"] == 1
    assert [o["synthesized"] for o in outs] == [1, 1, 0, 0]
    want, got = (wavfile.read(tmp_path / run / "sample-0.wav")[1].astype(np.float32)
                 for run in ("one", "mesh"))
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * np.abs(want).max())


def test_eval_dump_failing_on_a_model_peer_ends_the_run(tmp_path):
    """A model peer whose synthesis fails raises out of the eval dump (its
    peer would wait in the split GPT's collectives), so the run ends."""
    from tests.test_torch_trainer_cli import _cfg as cli_cfg

    cfg = cli_cfg("gpt", val_freq=1, save_freq=10 ** 9)
    with pytest.raises(Exception, match="eval exploded"):
        torch_dist.spawn(torch_dist.tp_eval_dump, 2, tmp_path, _on_mesh(cfg, 1, 2),
                         _eval_batch(cfg), str(tmp_path / "mesh"), 1)


def test_tp_checkpoint_restores_at_world_1_and_back(tmp_path):
    batch = _jax_reference("gpt")[0]
    cfg, sd = _port_case("gpt")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, lr_decay_every=1,
                                                             lr_decay=0.5))
    saved = str(tmp_path / "tp")
    (a, _) = torch_dist.spawn(torch_dist.tp_checkpoint_call, 2, tmp_path,
                              _on_mesh(cfg, 1, 2), sd, batch, saved, None)
    # at world 1: the (1 x 2) file holds full tensors, restored exactly
    plain = torch_dist.build_state(cfg, sd)
    ckpt.restore_checkpoint(saved, plain, partial=False, verbose=False)
    assert all(torch.equal(v, a["model"][k]) for k, v in plain.model.state_dict().items())
    moments = ckpt.optimizer_state_by_name(plain.optimizer, plain.model)
    assert moments.keys() == a["moments"].keys()
    assert all(torch.equal(v, a["moments"][n][k]) for n, s in moments.items()
               for k, v in s.items())
    one = torch_dist.tp_checkpoint_call(None, cfg, sd, batch, str(tmp_path / "w1"), saved)
    # and back: the world-1 file restores at (1 x 2), the next step agrees
    (b, _) = torch_dist.spawn(torch_dist.tp_checkpoint_call, 2, tmp_path,
                              _on_mesh(cfg, 1, 2), sd, batch, None, saved)
    assert all(torch.equal(v, b["restored"][0][k]) for k, v in a["model"].items())
    (c, _) = torch_dist.spawn(torch_dist.tp_checkpoint_call, 2, tmp_path,
                              _on_mesh(cfg, 1, 2), sd, batch, None, str(tmp_path / "w1"))
    assert all(torch.equal(v, c["restored"][0][k]) for k, v in one["model"].items())
    for name in ("loss", "grad_norm"):
        close(b["metrics"][name], one["metrics"][name], atol=0, rtol=1e-5)
    first = lambda moments: {n: s["exp_avg"] for n, s in moments.items()}  # noqa: E731
    trainable = {n for n, _ in trainable_parameters(SynthesizerTrn(cfg), "gpt")}
    assert_one_step(b["model"], first(b["moments"]), one["model"], first(one["moments"]),
                    a["model"], trainable, cfg)


def test_check_mesh_model_axis(monkeypatch):
    cfg = small_test_config()
    mesh.check_mesh(_on_mesh(cfg, -1, 1))
    with pytest.raises(ValueError, match="model_parallel=2 does not divide the world"):
        mesh.check_mesh(_on_mesh(cfg, -1, 2))
    for world, data, model in ((4, 2, 2), (8, -1, 4), (2, 1, 2)):
        monkeypatch.setattr(mesh, "world", lambda group=None: world)
        mesh.check_mesh(_on_mesh(cfg, data, model), "group")
    monkeypatch.setattr(mesh, "world", lambda group=None: 3)
    with pytest.raises(ValueError, match="gpt.heads"):
        mesh.check_mesh(_on_mesh(cfg, 1, 3), "group")
    narrow = dataclasses.replace(cfg, gpt=dataclasses.replace(cfg.gpt, heads=6, model_dim=64))
    with pytest.raises(ValueError, match="gpt.model_dim"):
        mesh.check_mesh(_on_mesh(narrow, 1, 3), "group")


def test_training_cli_on_a_model_axis(tmp_path):
    """The training CLI on two ranks in torchrun's environment with
    ``--model-parallel 2``: one data rank whose corpus batches model rank 0
    decodes and sends to its peer, the GPT split; one metric line, and a
    checkpoint of full tensors."""
    import json

    from tests.test_torch_trainer_cli import _cfg as cli_cfg
    from tests.test_torch_trainer_cli import _corpus

    cfg = cli_cfg("vqvae", save_freq=1, val_freq=10 ** 9)
    config = tmp_path / "small.json"
    config.write_text(json.dumps(cfg.to_dict()))
    logs = tmp_path / "logs"
    outs = torch_dist.run_cli_as_torchrun(
        2, tmp_path, ["--config", str(config), "--data", _corpus(tmp_path), "--steps", "1",
                      "--logs-folder", str(logs), "--num-workers", "1", "--device", "cpu",
                      "--model-parallel", "2"])
    assert outs[0]["loss"] == outs[1]["loss"] and np.isfinite(outs[0]["loss"])
    assert len((logs / "metrics.jsonl").read_text().splitlines()) == 1
    saved = ckpt.load_checkpoint(logs / "ckpt")
    assert saved["step"] == 1 and "dropout" not in saved["rng"]
    assert saved["model"]["gpt.mel_head.weight"].shape[0] == cfg.gpt.number_mel_codes
    assert saved["model"]["gpt.gpt.h.0.attn.c_attn.weight"].shape[1] == 3 * cfg.gpt.model_dim
