"""Data-parallel training of the port (``parallel/mesh.py``) against its
world-1 step and the JAX package, fp32 on the CPU, over gloo process groups
of 1, 2 and 4 ranks (``tests/torch_dist.py``):

(a) a step of ``diff`` (worlds 2 and 4) and ``vqvae`` (world 2) on a global
    batch of 4 x accum 2 equals the port's world-1 step on it and JAX's
    ``make_single_loss_step`` with JAX's draws handed in, at dropout 0: the
    ranks' tensors bit-identical to each other, the metrics at 1e-4 and the
    parameters at ``test_torch_train_targets``' tolerances;
(b) the quantizer's world-2 training call against JAX's shard_map path
    (``axis_name``, as ``test_vq_psum`` runs it) and its global call, from
    un-inited and inited state;
(c) negative controls: without the gradient all-reduce the ranks' tensors
    part; a per-rank ``kl_loss`` misses the global ratio on rows of unequal
    length, where the group's hits it, gradient included;
(d) the loader's padding agreed across the ranks, the metrics averaged in
    one collective, a missing gradient all-reduced as zeros;
(e) dropout at 0.1: the ranks draw other masks, a repeated world-2 step is
    bit-identical, and a world-1 group gives the plain step bit for bit;
(f) a world-2 checkpoint resumes bit-identically (every rank's generator
    state is in it), and a ``batch_size`` the world does not divide is
    refused;
(g) the training CLI on two ranks in torchrun's environment;
and ``check_mesh``'s refusals (tensor parallelism: ``test_torch_tensor_parallel``).
"""
import dataclasses

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from detail_tts_tpu.models import quantizer as jquantizer
from detail_tts_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
from detail_tts_tpu.models.synthesizer import make_train_schedule as jax_train_schedule
from detail_tts_tpu.train.step import make_single_loss_step as jax_single_loss_step
from detail_tts_tpu_torch.config import small_test_config
from detail_tts_tpu_torch.io.weights import random_weights_
from detail_tts_tpu_torch.models.discriminator import MultiPeriodDiscriminator
from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
from detail_tts_tpu_torch.nn.common import weight_norm_
from detail_tts_tpu_torch.parallel import mesh
from detail_tts_tpu_torch.train.optim import trainable_parameters
from detail_tts_tpu_torch.train.step import synthetic_batches
from tests import torch_dist
from tests.test_torch_gan import _jax_first_moments
from tests.test_torch_train_diff import _jax_draws
from tests.test_torch_train_targets import (_cfg, _data, _jax_state, _port_tree,
                                            _record_vq_draws, _vq_draws)
from tests.torch_parity import close, key_bias_mask, synth_pair, t

B, FRAMES, ACCUM = 4, 48, 2
_JAX = {}


def _jax_reference(target):
    """(global batch, JAX's draws, JAX's metrics, JAX's parameters and AdamW
    first moments in the port's names) of one JAX step of ``target``
    (cached)."""
    if target in _JAX:
        return _JAX[target]
    model, jvars, port0 = synth_pair()
    jcfg = _cfg(model.cfg, target)
    data = _data(50, ACCUM * B)
    stack = lambda v: v.reshape(ACCUM, B, *v.shape[1:])  # noqa: E731
    jstep = jax_single_loss_step(JaxSynth(jcfg), jcfg, donate=False)
    rng = jax.random.PRNGKey(60)
    with pytest.MonkeyPatch.context() as patch:
        # JAX's style encoders keep a fixed dropout of 0.1 (torch_parity.jax_dropout_off)
        patch.setattr(flax_nn.Dropout, "__call__",
                      lambda self, inputs, deterministic=None, rng=None: inputs)
        batch = {k: jnp.asarray(stack(v)) for k, v in data.items()}
        if target == "vqvae":
            calls = _record_vq_draws(patch)
            with jax.disable_jit():
                new, m = jstep(_jax_state(jcfg, jvars), batch, rng)
            assert len(calls) == 3  # k-means and expiry, then expiry
            draws = [_vq_draws(calls[:2], False), _vq_draws(calls[2:], True)]
        else:
            new, m = jstep(_jax_state(jcfg, jvars), batch, rng)
            schedule = jax_train_schedule(jcfg)
            draws = [_jax_draws(jcfg, schedule, jax.random.split(key)[0],
                                data["raw_mel"][:B].shape)
                     for key in jax.random.split(rng, ACCUM)]
    params = _port_tree(port0, jax.tree_util.tree_map(np.asarray, new.params), new.vq_state)
    moments = _port_tree(port0, _jax_first_moments(new.opt_state, jvars["params"]),
                         new.vq_state)
    _JAX[target] = ({k: stack(t(v)) for k, v in data.items()}, draws,
                    {k: float(v) for k, v in m.items()}, params, moments)
    return _JAX[target]


def _port_case(target):
    port0 = synth_pair()[2]
    return _cfg(port0.cfg, target), {k: v.clone() for k, v in port0.state_dict().items()}


def _assert_ranks_identical(outs):
    for r, out in enumerate(outs[1:], 1):
        for name, value in out["model"].items():
            assert torch.equal(value, outs[0]["model"][name]), f"rank {r}: {name}"
        for name, m in out["metrics"][-1].items():
            assert torch.equal(m, outs[0]["metrics"][-1][name]), f"rank {r}: {name}"


def assert_one_step(values, moments, ref_values, ref_moments, before, trainable, cfg,
                    moment_atol=2e-3, sure=1e-4):
    """One AdamW step against a reference, with
    ``test_torch_gan._check_one_adam_step``'s tolerances: each trainable
    tensor's first moment (0.2 x the gradient) at rtol 1e-4, atol
    ``moment_atol`` of its largest, and its new value at atol 1e-6, rtol
    1e-5 where the gradient is at least ``sure`` of the largest (one Adam
    step moves an element by ~lr whatever its gradient's size, so below that
    fp32 noise decides the direction); the key projections' biases only
    moved; frozen tensors but the codebook bit-identical."""
    assert set(moments) == trainable
    for name, value in values.items():
        if name not in trainable:
            if "_codebook." not in name:
                assert torch.equal(value, before[name]), name
            continue
        assert not torch.equal(value, before[name]), name
        keep = ~key_bias_mask(name, value.shape, cfg)
        m_ref = ref_moments[name].numpy()
        scale = float(np.abs(m_ref[keep]).max()) if keep.any() else 0.0
        np.testing.assert_allclose(moments[name].numpy()[keep], m_ref[keep], rtol=1e-4,
                                   atol=moment_atol * scale, err_msg=f"{name} first moment")
        big = keep & (np.abs(m_ref) >= sure * scale)
        np.testing.assert_allclose(value.numpy()[big], ref_values[name].numpy()[big],
                                   atol=1e-6, rtol=1e-5, err_msg=name)


def assert_metrics(metrics, want):
    """Every metric of a step against ``want``'s at 1e-4."""
    for name, value in metrics.items():
        np.testing.assert_allclose(float(value), float(want[name]), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def _assert_step_matches(out, metrics, params, moments, cfg, target, before):
    """One single-loss step against a reference: the metrics at 1e-4, the
    update (:func:`assert_one_step`), the codebook at 1e-4, moved under
    ``vqvae`` only."""
    assert_metrics(out["metrics"][0], metrics)
    trainable = {n for n, _ in trainable_parameters(SynthesizerTrn(cfg), target)}
    assert_one_step(out["model"], out["moments"], params, moments, before, trainable, cfg)
    for name, value in out["model"].items():
        if "_codebook." in name:
            assert torch.equal(value, before[name]) == (target != "vqvae"), name
            close(value, params[name])


@pytest.mark.parametrize("target,world", [("diff", 2), ("diff", 4), ("vqvae", 2)])
def test_world_step_equals_world_1_and_jax(tmp_path, target, world):
    batch, draws, jmetrics, jparams, jmoments = _jax_reference(target)
    cfg, sd = _port_case(target)
    one = torch_dist.train_steps(None, cfg, sd, [batch], [draws])
    outs = torch_dist.spawn(torch_dist.train_steps, world, tmp_path, cfg, sd, [batch], [draws])
    _assert_ranks_identical(outs)
    _assert_step_matches(one, jmetrics, jparams, jmoments, cfg, target, sd)
    _assert_step_matches(outs[0], jmetrics, jparams, jmoments, cfg, target, sd)
    # world W against world 1: the same update up to the order of the sums
    world1 = {k: float(v) for k, v in one["metrics"][0].items()}
    _assert_step_matches(outs[0], world1, one["model"], one["moments"], cfg, target, sd)


def test_without_the_gradient_all_reduce_the_ranks_part(tmp_path):
    batch, draws = _jax_reference("diff")[:2]
    cfg, sd = _port_case("diff")
    outs = torch_dist.spawn(torch_dist.train_steps, 2, tmp_path, cfg, sd, [batch], [draws],
                            None, 0, True, False)
    trainable = {n for n, _ in trainable_parameters(SynthesizerTrn(cfg), "diff")}
    apart = [n for n in trainable if not torch.equal(outs[0]["model"][n], outs[1]["model"][n])]
    assert len(apart) > len(trainable) // 2


def _codebook_state(rng, size, dim, inited):
    if not inited:
        return {"inited": jnp.zeros((), bool), "cluster_size": jnp.zeros((size,)),
                "embed": jnp.zeros((size, dim)), "embed_avg": jnp.zeros((size, dim))}
    return {"inited": jnp.ones((), bool),
            "cluster_size": jnp.asarray(rng.uniform(0.5, 8.0, (size,)).astype(np.float32)),
            "embed": jnp.asarray(rng.normal(0, 1, (size, dim)).astype(np.float32)),
            "embed_avg": jnp.asarray(rng.normal(0, 1, (size, dim)).astype(np.float32))}


@pytest.mark.parametrize("inited", [False, True])
def test_quantizer_world_2_matches_jax_shard_map_and_global(tmp_path, monkeypatch, inited):
    dim, size, n = 8, 32, 64
    rng = np.random.default_rng(31)
    x = rng.normal(0, 1, (n, dim)).astype(np.float32)
    state0 = _codebook_state(rng, size, dim, inited)
    module = jquantizer.EuclideanCodebook(codebook_size=size, dim=dim, kmeans_iters=5,
                                          threshold_ema_dead_code=2.0)
    calls = _record_vq_draws(monkeypatch)
    with jax.disable_jit():  # the global call, its draws recorded
        (_, ids_g), mut = module.apply({"vq_state": state0}, jnp.asarray(x), train=True,
                                       mutable=["vq_state"], rngs={"vq": jax.random.PRNGKey(0)})
    monkeypatch.undo()
    assert len(calls) == (1 if inited else 2)
    kmeans = np.zeros_like(calls[-1]) if inited else calls[0]

    def shard_fn(state, xs):
        (_, ids), m = module.apply({"vq_state": state}, xs, train=True, axis_name="data",
                                   mutable=["vq_state"], rngs={"vq": jax.random.PRNGKey(0)})
        return m["vq_state"], ids

    jmesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    sharded = jax.jit(jax.shard_map(shard_fn, mesh=jmesh, in_specs=(P(), P("data")),
                                    out_specs=(P(), P("data"))))
    state_sh, ids_sh = sharded(jax.device_put(state0, NamedSharding(jmesh, P())),
                               jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P("data"))))

    buffers = {k: t(v, torch.float32) for k, v in state0.items()}
    outs = torch_dist.spawn(torch_dist.codebook_call, 2, tmp_path, buffers, t(x),
                            t(kmeans, torch.long), t(calls[-1], torch.long),
                            {"kmeans_iters": 5, "threshold_ema_dead_code": 2.0})
    ids = torch.cat([o["ids"] for o in outs]).numpy()
    np.testing.assert_array_equal(ids, np.asarray(ids_g))
    np.testing.assert_array_equal(ids, np.asarray(ids_sh))
    for key in ("cluster_size", "embed_avg", "embed"):
        assert torch.equal(outs[0][key], outs[1][key]), key
        for ref in (mut["vq_state"][key], state_sh[key]):
            np.testing.assert_allclose(outs[0][key].numpy(), np.asarray(ref), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    assert float(outs[0]["inited"]) == 1.0


def test_kl_loss_takes_the_global_mask_sum(tmp_path):
    rng = np.random.default_rng(5)
    tensors = [t(rng.normal(size=(4, 9, 3)).astype(np.float32)) for _ in range(4)]
    lengths = torch.tensor([9, 8, 3, 5])  # rank 0's rows hold 17 frames, rank 1's 8
    mask = (torch.arange(9)[None, :] < lengths[:, None]).float()[..., None]
    from detail_tts_tpu_torch.train.losses import kl_loss

    z_p = tensors[0].clone().requires_grad_(True)
    want = kl_loss(z_p, *tensors[1:], mask)
    want.backward()
    want = want.detach()
    outs = torch_dist.spawn(torch_dist.kl_call, 2, tmp_path, tensors, mask)
    # the ranks' average is the global ratio, and the average of their
    # gradients its gradient (rows in rank order)
    ours = sum(o["global"][0] for o in outs) / 2
    close(ours, want, rtol=1e-6, atol=0)
    close(torch.cat([o["global"][1] for o in outs]) / 2, z_p.grad, rtol=1e-5, atol=1e-7)
    # the negative control: a per-rank ratio is another loss
    per_rank = sum(o["per_rank"][0] for o in outs) / 2
    assert abs(float(per_rank) - float(want)) > 1e-2 * abs(float(want))
    assert not torch.allclose(torch.cat([o["per_rank"][1] for o in outs]) / 2, z_p.grad,
                              rtol=1e-3)


def _loader_batch(crop, raw, text, hop, seed):
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.normal(size=(1, 1) + shape).astype(np.float32)

    return {"spec": arr(crop, 3), "mel": arr(crop, 2), "wav": arr(crop * hop, 1),
            "raw_spec": arr(raw, 3), "raw_mel": arr(raw, 2), "raw_wav": arr(raw * hop, 1),
            "text": rng.integers(1, 9, (1, 1, text)).astype(np.int32),
            "spec_length": np.full((1, 1), crop, np.int32)}


def test_loader_padding_metrics_and_grads_over_two_ranks(tmp_path):
    hop = 4
    batches = [_loader_batch(8, 12, 4, hop, 0), _loader_batch(12, 8, 6, hop, 1)]
    outs = torch_dist.spawn(torch_dist.loader_and_metrics_call, 2, tmp_path, batches, hop)
    for r, out in enumerate(outs):
        got, own = out["batch"], batches[r]
        for key, n in (("spec", 12), ("mel", 12), ("wav", 12 * hop), ("raw_spec", 12),
                       ("raw_mel", 12), ("raw_wav", 12 * hop), ("text", 6)):
            assert got[key].shape[2] == n, (r, key)
            k = own[key].shape[2]
            np.testing.assert_array_equal(got[key][:, :, :k], own[key])
            assert not got[key][:, :, k:].any()
        np.testing.assert_array_equal(got["spec_length"], own["spec_length"])
        assert torch.equal(out["grads"][0], torch.full((3,), 1.5))
        assert torch.equal(out["grads"][1], torch.zeros(2, 2))
        assert float(out["metrics"]["loss"]) == 0.5
        assert float(out["metrics"]["grad_norm"]) == r and out["metrics"]["layers_kept"] == [r]


def _dropout_cfg(target, **train):
    cfg = small_test_config()
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, target=target, use_bf16=False, **train),
        gpt=dataclasses.replace(cfg.gpt, dropout=0.1),
        vaegan=dataclasses.replace(cfg.vaegan, p_dropout=0.1))


def _random_sd(cfg):
    model = SynthesizerTrn(cfg)
    random_weights_(model, 0)
    if cfg.train.weight_norm:
        weight_norm_(model)
    return model.state_dict()


def test_dropout_masks_differ_by_rank_and_a_step_repeats(tmp_path):
    cfg = _dropout_cfg("gpt")
    one = next(synthetic_batches(cfg, 1, 1, FRAMES, 8,
                                 generator=torch.Generator().manual_seed(2)))
    batch = {k: torch.cat([v, v], dim=1) for k, v in one.items()}  # one row on each rank
    outs = torch_dist.spawn(torch_dist.dropout_call, 2, tmp_path, cfg, _random_sd(cfg), batch)
    assert not torch.equal(outs[0]["local_loss"][1], outs[1]["local_loss"][1])
    for out in outs:
        (m0, sd0, g0), (m1, sd1, g1) = out["runs"]
        assert all(torch.equal(m0[k], m1[k]) for k in m0)
        assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
        assert torch.equal(g0, g1)
    assert all(torch.equal(v, outs[1]["runs"][0][1][k]) for k, v in outs[0]["runs"][0][1].items())


@pytest.mark.parametrize("target", ["gpt", "flowvae"])
def test_world_1_group_is_the_plain_step_bit_for_bit(tmp_path, target):
    gan = target == "flowvae"
    cfg = _dropout_cfg(target, gradient_accumulate_every=1 if gan else 2)
    data = synthetic_batches(cfg, 1 if gan else 2, 2, FRAMES, 8,
                             generator=torch.Generator().manual_seed(3))
    batches = [next(data) for _ in range(2)]
    disc = None
    if gan:
        disc = MultiPeriodDiscriminator()
        random_weights_(disc, 1)
        for b in batches:
            b["spec_length"] = b["raw_spec_length"] = torch.tensor([FRAMES, FRAMES - 12])
    sd = _random_sd(cfg)
    plain = torch_dist.train_steps(None, cfg, sd, batches, None, disc, 5, False)
    (grouped,) = torch_dist.spawn(torch_dist.train_steps, 1, tmp_path, cfg, sd, batches,
                                  None, disc, 5, False)
    for k, m in enumerate(plain["metrics"]):
        assert all(torch.equal(v, grouped["metrics"][k][n]) for n, v in m.items()), k
    for part in ("model", "moments") + (("disc", "d_moments") if gan else ()):
        assert all(torch.equal(v, grouped[part][n]) for n, v in plain[part].items()), part


def test_world_2_checkpoint_resumes_bit_identically(tmp_path):
    cfg = _dropout_cfg("gpt", batch_size=2, gradient_accumulate_every=1, save_freq=2,
                       val_freq=10 ** 9)
    data = synthetic_batches(cfg, 1, 2, FRAMES, 8, generator=torch.Generator().manual_seed(4))
    batches = [next(data) for _ in range(3)]
    outs = torch_dist.spawn(torch_dist.resume_call, 2, tmp_path, cfg, batches,
                            str(tmp_path / "logs"))
    for out in outs:
        (loss_a, sd_a, mom_a), (loss_r, sd_r, mom_r) = out["a"], out["r"]
        assert torch.equal(loss_a, loss_r)
        assert all(torch.equal(v, sd_r[k]) for k, v in sd_a.items())
        assert mom_a.keys() == mom_r.keys()
        assert all(torch.equal(v, mom_r[n][k]) for n, s in mom_a.items()
                   for k, v in s.items() if torch.is_tensor(v))
        assert out["odd_refused"]
    assert all(torch.equal(v, outs[1]["a"][1][k]) for k, v in outs[0]["a"][1].items())


def test_check_mesh_refuses_what_is_not_ported(monkeypatch):
    cfg = small_test_config()
    mesh.check_mesh(cfg)
    with pytest.raises(ValueError, match="data_parallel"):
        mesh.check_mesh(dataclasses.replace(cfg, mesh=dataclasses.replace(
            cfg.mesh, data_parallel=2)))
    # a mesh that does not multiply to the world
    monkeypatch.setattr(mesh, "world", lambda group=None: 4)
    with pytest.raises(ValueError, match="is not the world of 4"):
        mesh.check_mesh(dataclasses.replace(cfg, mesh=dataclasses.replace(
            cfg.mesh, data_parallel=3, model_parallel=2)), "group")
    # a model axis that does not divide the GPT's heads
    monkeypatch.setattr(mesh, "world", lambda group=None: 3)
    with pytest.raises(ValueError, match="does not divide gpt.heads"):
        mesh.check_mesh(dataclasses.replace(cfg, mesh=dataclasses.replace(
            cfg.mesh, data_parallel=1, model_parallel=3)), "group")
    monkeypatch.setattr(mesh, "world", lambda group=None: 2)
    monkeypatch.setattr(mesh, "rank", lambda group=None: 1)
    assert torch.equal(mesh.shard_rows(torch.arange(4), "group"), torch.tensor([2, 3]))
    with pytest.raises(ValueError, match="split"):
        mesh.shard_rows(torch.zeros(3), "group")


def test_training_cli_under_torchrun(tmp_path):
    """The training CLI on two ranks from a corpus on disk, each rank with
    its rows and one clip a micro-batch, padded to the same lengths: one
    reduced metric line and a checkpoint from rank 0, holding both ranks'
    dropout generator states."""
    import json

    from detail_tts_tpu_torch.train import checkpoint as ckpt
    from tests.test_torch_trainer_cli import _cfg as cli_cfg
    from tests.test_torch_trainer_cli import _corpus

    cfg = cli_cfg("vqvae", save_freq=1, val_freq=10 ** 9)
    assert cfg.train.batch_size == 2
    config = tmp_path / "small.json"
    config.write_text(json.dumps(cfg.to_dict()))
    logs = tmp_path / "logs"
    outs = torch_dist.run_cli_as_torchrun(
        2, tmp_path, ["--config", str(config), "--data", _corpus(tmp_path), "--steps", "1",
                      "--logs-folder", str(logs), "--num-workers", "1", "--device", "cpu"])
    assert outs[0]["loss"] == outs[1]["loss"] and np.isfinite(outs[0]["loss"])
    lines = (logs / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["loss"] == outs[0]["loss"]
    saved = ckpt.load_checkpoint(logs / "ckpt")
    assert saved["step"] == 1 and saved["rng"]["dropout"].shape[0] == 2
