"""The port's checkpoints and code extraction against the JAX package's:
``encode_masked``, the checkpoint round trip and keep-N, a staged partial
restore (a ``vqvae`` checkpoint into a ``gpt`` trainer of a grown config,
across the weight-norm parametrizations) against ``graft_pytree``, a
bit-identical resume, and serving from a trainer checkpoint.

Tolerances: exact unless stated; a tensor carried across the weight-norm
parametrizations ``rtol = 1e-6, atol = 1e-7`` (the port takes norms over
torch's dims 1.., JAX over all axes but the last of its layout, so the fp32
sums run in other orders).
"""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detail_tts_tpu.config import small_test_config as jax_small_config
from detail_tts_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
from detail_tts_tpu.nn import common as jcommon
from detail_tts_tpu.serving.pipeline import variables_template
from detail_tts_tpu.train.checkpoint import graft_pytree
from detail_tts_tpu_torch.config import small_test_config
from detail_tts_tpu_torch.io.weights import from_jax_variables, load_reference_checkpoint
from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
from detail_tts_tpu_torch.nn.common import weight_norm_
from detail_tts_tpu_torch.serving.api import build_engine
from detail_tts_tpu_torch.serving.pipeline import EngineConfig
from detail_tts_tpu_torch.train import checkpoint as ckpt
from detail_tts_tpu_torch.train.step import make_train_state, synthetic_batches
from detail_tts_tpu_torch.train.trainer import Trainer

from torch_parity import seeded_variables, synth_pair, t

WN_TOL = dict(rtol=1e-6, atol=1e-7)


def _with(cfg, *, target=None, gpt=None, **train):
    if target is not None:
        train["target"] = target
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))
    if gpt:
        cfg = dataclasses.replace(cfg, gpt=dataclasses.replace(cfg.gpt, **gpt))
    return cfg


def _mel(batch, frames, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, frames, 128)) * 2.0 - 6.0).astype(np.float32)


# ----------------------------------------------------------- encode_masked


@functools.lru_cache(maxsize=None)
def varied_pair():
    """``synth_pair``'s JAX variables and a copy of its port model whose
    codebook is 64 encoder outputs of other mels, so that codes vary from
    frame to frame (the seeded codebook gives the same few everywhere)."""
    _, jvars, port = synth_pair()
    port = copy.deepcopy(port)
    layer = port.quantizer.vq.layers[0]
    with torch.no_grad():
        z = layer.project_in(port.vq_encode_features(t(_mel(4, 64, 9))))
        z = z.reshape(-1, z.shape[-1])
        embed = z[torch.randperm(len(z), generator=torch.Generator().manual_seed(0))[:64]]
        layer._codebook.embed.copy_(embed)
    jvars = jax.tree_util.tree_map_with_path(
        lambda path, x: (jnp.asarray(embed.numpy()) if str(getattr(path[-1], "key", ""))
                         == "embed" else x), jvars)
    return jvars, port


def test_encode_masked_matches_jax():
    jvars, port = varied_pair()
    mel, lengths = _mel(3, 64, 0), np.array([64, 37, 9], np.int32)
    ref_codes, ref_len = JaxSynth(jax_small_config()).apply(
        jvars, jnp.asarray(mel), jnp.asarray(lengths), method=JaxSynth.encode_masked)
    codes, code_len = port.encode_masked(t(mel), t(lengths, torch.long))
    assert len(set(codes.flatten().tolist())) > 10
    np.testing.assert_array_equal(code_len.numpy(), np.asarray(ref_len))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))


@pytest.mark.parametrize("n", [37, 64, 9])
def test_encode_masked_bucketed_equals_exact_length(n):
    """Codes within the length do not depend on the pad, whatever it holds;
    without the masks a loud pad reaches the last codes."""
    _, port = varied_pair()
    mel = _mel(1, 128, 1)
    exact, _ = port.encode_masked(t(mel[:, :n]), torch.tensor([n]))
    padded = mel.copy()
    padded[:, n:] = _mel(1, 128 - n, 2) + 8.0  # loud frames
    codes, code_len = port.encode_masked(t(padded), torch.tensor([n]))
    m = -(-n // 4)
    assert int(code_len) == m == exact.shape[1]
    np.testing.assert_array_equal(codes[:, :m].numpy(), exact.numpy())
    with torch.no_grad():
        leaked = port.vq_encode_features(t(padded))[:, :m]
        clean = port.vq_encode_features(t(mel[:, :n]))
    assert n == 64 or (leaked[:, -1] - clean[:, -1]).abs().max() > 1e-3


# ------------------------------------------------------- save and restore


def _trained_state(target, seed, steps=1, **train):
    cfg = _with(small_test_config(), target=target, **train)
    state = make_train_state(cfg, device="cpu", seed=seed)
    if steps:
        from detail_tts_tpu_torch.train.step import make_train_step
        step = make_train_step(cfg, device="cpu")
        data = synthetic_batches(cfg, 1, 2, 48, 8, generator=torch.Generator().manual_seed(seed))
        gen = torch.Generator().manual_seed(seed)
        for _ in range(steps):
            step(state, next(data), gen)
    return cfg, state


def _moments(state, optimizer="optimizer", module="model"):
    return ckpt.optimizer_state_by_name(getattr(state, optimizer), getattr(state, module))


def _assert_same_state(a, b, disc=False):
    assert a.step == b.step
    for mod in ("model", "disc") if disc else ("model",):
        sa, sb = getattr(a, mod).state_dict(), getattr(b, mod).state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    pairs = [("optimizer", "model")] + ([("d_optimizer", "disc")] if disc else [])
    for opt, mod in pairs:
        ma, mb = _moments(a, opt, mod), _moments(b, opt, mod)
        assert ma.keys() == mb.keys() and ma
        for name in ma:
            for k in ma[name]:
                assert torch.equal(ma[name][k], mb[name][k]), (name, k)


def _fake_moments(state, seed):
    """AdamW state for every trainable tensor (generator and discriminator)
    from one update on random gradients, without a GAN step's cost."""
    gen = torch.Generator().manual_seed(seed)
    for params, opt in ((state.params, state.optimizer), (state.d_params, state.d_optimizer)):
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
        opt.zero_grad(set_to_none=True)
    state.step = 1


@pytest.mark.parametrize("target", ["vqvae", "flowvae"])
def test_checkpoint_round_trip_is_bit_identical(tmp_path, target):
    cfg, state = _trained_state(target, seed=1, steps=int(target == "vqvae"))
    if target == "vqvae":  # the codebook moved in the step
        assert state.model.quantizer.vq.layers[0]._codebook.inited.item() == 1
    else:
        _fake_moments(state, 1)
    path = ckpt.save_checkpoint(tmp_path / "ckpt", state)
    assert path == tmp_path / "ckpt" / "1" and ckpt.latest_step(tmp_path / "ckpt") == 1
    other = make_train_state(cfg, device="cpu", seed=2)
    assert ckpt.restore_checkpoint(tmp_path / "ckpt", other, partial=False) == []
    _assert_same_state(state, other, disc=target == "flowvae")
    if target != "vqvae":
        return
    # restored moments drive the next step exactly as the saved ones do
    from detail_tts_tpu_torch.train.step import make_train_step
    step = make_train_step(cfg, device="cpu")
    batch = next(synthetic_batches(cfg, 1, 2, 48, 8, generator=torch.Generator().manual_seed(5)))
    for s in (state, other):
        step(s, batch, torch.Generator().manual_seed(6))
    _assert_same_state(state, other, disc=target == "flowvae")


def test_keep_newest_checkpoints(tmp_path):
    _, state = _trained_state("vqvae", seed=1, steps=0)
    for step in range(1, 6):
        state.step = step
        ckpt.save_checkpoint(tmp_path, state, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["4", "5"]
    assert ckpt.latest_step(tmp_path) == 5 and ckpt.load_checkpoint(tmp_path, 4)["step"] == 4
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(tmp_path / "nothing")


@functools.lru_cache(maxsize=None)
def _template(wn):
    if not wn:
        return variables_template(jax_small_config())
    with jcommon.weight_norm_reparam():
        return variables_template(jax_small_config())


@functools.lru_cache(maxsize=None)
def _jax_vars(wn, seed):
    """Seeded JAX variables of the small config; under ``wn`` unfolded to
    (g, v), g scaled so that g and ||v|| differ."""
    folded = seeded_variables(_template(False), seed)
    if not wn:
        return folded
    tree = jax.tree_util.tree_map(np.asarray, jcommon.unfold_weight_norm_tree(
        folded, _template(True)))
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (x * rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
                         if str(getattr(path[-1], "key", "")) == "g" else x), tree)


def _port_model(cfg, jvars, wn):
    model = SynthesizerTrn(cfg)
    if wn:
        weight_norm_(model)
    model.load_state_dict(from_jax_variables(model, jvars, cfg.diffusion.num_layers)[0])
    return model


def _shrink(tree, pos_path):
    """A copy of a JAX variables tree without GPT block 1 and with 8 text
    positions fewer: the checkpoint of a smaller earlier stage."""
    tree = copy.deepcopy(tree)
    del tree["params"]["gpt"]["gpt"]["h_1"]
    *parents, leaf = pos_path.split("/")
    node = tree
    for k in parents:
        node = node[k]
    node[leaf] = node[leaf][:-8]
    return tree


@pytest.mark.parametrize("ckpt_wn", [False, True], ids=["unfold", "fold"])
def test_staged_partial_restore_matches_jax_graft(tmp_path, ckpt_wn):
    """A ``vqvae`` checkpoint of a smaller stage (no GPT block 1, 8 text
    positions fewer) restored into a ``gpt`` trainer in the other
    weight-norm parametrization: every model tensor as JAX's
    ``graft_pytree`` gives it (kept, missing, of another shape, crossed),
    and no moment grafted."""
    from detail_tts_tpu_torch.io.torch_convert import translate

    cfg_a = _with(small_test_config(), target="vqvae", weight_norm=ckpt_wn)
    cfg_b = _with(small_test_config(), target="gpt", weight_norm=not ckpt_wn)
    jvars_b = _jax_vars(not ckpt_wn, 4)
    state_a = make_train_state(cfg_a, device="cpu",
                               model=_port_model(cfg_a, _jax_vars(ckpt_wn, 3), ckpt_wn))
    path = ckpt.save_checkpoint(tmp_path, state_a) / ckpt.STATE_FILE
    data = torch.load(path, weights_only=True)
    pos = next(k for k in data["model"] if "text_pos_embedding" in k)
    data["model"] = {k: v[:-8] if k == pos else v for k, v in data["model"].items()
                     if not k.startswith("gpt.gpt.h.1.")}
    torch.save(data, path)
    jvars_a = _shrink(_jax_vars(ckpt_wn, 3), translate(pos, cfg_a.diffusion.num_layers)[0])

    state_b = make_train_state(cfg_b, device="cpu",
                               model=_port_model(cfg_b, jvars_b, not ckpt_wn))
    before = {k: v.clone() for k, v in state_b.model.state_dict().items()}
    skipped = ckpt.restore_checkpoint(tmp_path, state_b, verbose=False)

    grafted = graft_pytree(jvars_b, jvars_a)
    want = _port_model(cfg_b, jax.tree_util.tree_map(np.asarray, grafted),
                       not ckpt_wn).state_dict()
    got, saved = state_b.model.state_dict(), data["model"]
    crossed = {k for k in got if k.endswith(("weight", "weight_g", "weight_v"))
               and k not in saved}
    for k, v in got.items():
        if k in crossed:
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **WN_TOL)
        else:
            assert torch.equal(v, want[k]), k
    name = lambda s: s.split(":", 1)[1].split(" ")[0]  # noqa: E731
    model_missed = {name(s) for s in skipped if s.startswith(("missing:", "shape:"))}
    unchanged = {k for k in got if torch.equal(got[k], before[k])}
    ambiguous = {k for k in unchanged if k in saved and torch.equal(saved[k], before[k])}
    assert model_missed == unchanged - ambiguous
    assert pos in model_missed and any(k.startswith("gpt.gpt.h.1.") for k in model_missed)
    trainable = {n for n, p in state_b.model.named_parameters() if p.requires_grad}
    moments = {name(s) for s in skipped if s.startswith("optimizer.missing:")}
    assert moments == trainable and len(skipped) == len(model_missed) + len(moments)
    assert state_b.step == 0


def test_crosswalk_matches_jax():
    """(g, v) -> folded and folded -> (g, v), tensor by tensor, against
    JAX's ``_wn_crosswalk`` through ``translate``."""
    from detail_tts_tpu.train.checkpoint import _wn_crosswalk as jax_crosswalk
    from detail_tts_tpu_torch.io.torch_convert import translate

    cfg = small_test_config()
    flat_wn, flat_folded = _flat(_jax_vars(True, 5)), _flat(_jax_vars(False, 5))
    wn = _port_model(cfg, _jax_vars(True, 5), True).state_dict()
    folded = _port_model(cfg, _jax_vars(False, 5), False).state_dict()
    pairs = [k[: -len("_v")] for k in wn if k.endswith(".weight_v")]
    assert pairs
    for name in pairs:
        path, fn = translate(name, cfg.diffusion.num_layers)
        stem = path[: -len("kernel")]
        w = ckpt._wn_crosswalk(name, wn)  # fold
        ref = np.asarray(fn(np.asarray(jax_crosswalk(path, flat_wn), np.float32)))
        np.testing.assert_allclose(w.numpy(), ref, err_msg=name, **WN_TOL)
        v = ckpt._wn_crosswalk(name + "_v", folded)  # unfold
        g = ckpt._wn_crosswalk(name + "_g", folded)
        np.testing.assert_array_equal(v.numpy(), np.asarray(fn(np.asarray(
            jax_crosswalk(stem + "v", flat_folded)))))
        np.testing.assert_allclose(g.numpy().reshape(-1), np.asarray(
            jax_crosswalk(stem + "g", flat_folded)).reshape(-1), err_msg=name, **WN_TOL)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ------------------------------------------------------------- resume


def test_resume_is_bit_identical(tmp_path):
    cfg = _with(small_test_config(), target="diff", save_freq=2, val_freq=10 ** 9)
    data = synthetic_batches(cfg, 1, 2, 48, 8, generator=torch.Generator().manual_seed(1))
    a = Trainer(cfg, data, device="cpu", seed=0, logs_folder=str(tmp_path / "a"))
    a.train(max_steps=2, log_every=1)
    batch, gen_state = a.next_batch(), a.generator.get_state()
    want = a.step_fn(a.state, batch, a.generator)

    r = Trainer(cfg, None, device="cpu", seed=7, logs_folder=str(tmp_path / "r"))
    r.load(str(tmp_path / "a" / "ckpt"))
    assert r.state.step == 2
    r.generator.set_state(gen_state)
    got = r.step_fn(r.state, batch, r.generator)
    for k in ("loss", "grad_norm"):
        assert torch.equal(got[k], want[k]), k
    _assert_same_state(a.state, r.state)


# ------------------------------------------------------------- serving


def test_build_engine_from_a_trainer_checkpoint(tmp_path):
    import json

    cfg, state = _trained_state("vqvae", seed=3, weight_norm=True)
    assert any(k.endswith("weight_g") for k in state.model.state_dict())
    ckpt.save_checkpoint(tmp_path / "ckpt", state)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg.to_dict()))
    ecfg = EngineConfig(max_generate_length=12, text_buckets=(16, 32), prompt_buckets=(32, 64),
                        code_buckets=(8, 12), compute_dtype=torch.float32,
                        cache_dtype=torch.float32)
    eng = build_engine(str(tmp_path / "cfg.json"), str(tmp_path / "ckpt"), engine_cfg=ecfg,
                       device="cpu")
    folded = ckpt.restore_variables(tmp_path / "ckpt", cfg)
    served = eng.model.state_dict()
    assert served.keys() == folded.keys() and not any(k.endswith("weight_g") for k in served)
    for k in served:
        assert torch.equal(served[k], folded[k]), k
    # the folded weights compute what the (g, v) pairs do
    mel = t(_mel(1, 48, 2))
    with torch.no_grad():
        np.testing.assert_allclose(eng.model.vq_encode_features(mel).numpy(),
                                   state.model.vq_encode_features(mel).numpy(),
                                   rtol=1e-5, atol=1e-5)
    wav = eng.synthesize_vq_batch(["你好"], [np.full(12000, 0.1, np.float32)], seed=0)[0]
    assert wav.ndim == 1 and len(wav) and np.all(np.isfinite(wav))

    # serving weights written once load as a reference checkpoint does
    ckpt.save_variables(tmp_path / "model.pt", state.model.state_dict())
    model = SynthesizerTrn(cfg)
    assert load_reference_checkpoint(str(tmp_path / "model.pt"), model) == {"unused": []}
    for k, v in model.state_dict().items():
        assert torch.equal(v, folded[k]), k
    with pytest.raises(ValueError, match="does not fit"):
        ckpt.restore_variables(tmp_path / "ckpt", _with(cfg, gpt=dict(layers=3)))
