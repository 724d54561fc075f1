"""Training state and steps: the single-loss step (targets ``vqvae``, ``gpt``,
``diff``) and the two-phase GAN step (targets ``flowvae``, ``all``).

Counterpart of ``detail_tts_tpu/train/step.py`` (``dummy_batch``,
``TrainState``, ``make_train_state``, ``make_single_loss_step``,
``make_gan_step``, ``make_train_step``).

* Single-loss targets: gradient accumulation is a loop over the batch's
  leading microbatch axis; the gradients are summed over it and divided by
  its length, clipped by global norm 1.0 over the target's trainable
  subtree and AdamW-updated at the staircase LR.  ``vqvae``'s codebook state
  carries from microbatch to microbatch, as JAX's scan carries ``vq_state``.
* GAN targets (batches without the microbatch axis): one generator forward;
  the discriminator is updated first on its detached output, then the
  generator's loss (LSGAN + feature matching + ``c_mel`` x mel L1 + ``c_kl``
  x KL, plus under ``all`` the VQ, diffusion and GPT losses, in that JAX
  order: diffusion, GPT, VQ) runs against the updated discriminator
  (train.py:294-320).  JAX runs the generator forward twice with one rng,
  identical both times; the port runs it once.  The discriminator's
  parameters take no gradient from the generator's backward, and neither
  update is clipped.

On the card the forwards run under ``torch.autocast(dtype=torch.bfloat16)``
(the reference's ``accelerator.autocast()``, ``TrainConfig.use_bf16``);
master weights, AdamW state, the losses, the mel frontend of the generated
audio and the schedule math are fp32, as are norm and softmax statistics.
On the CPU the steps run in fp32 without autocast.  Every random draw comes
from the ``torch.Generator`` passed in, or from the draws handed in, and
each step runs with cuDNN's deterministic algorithms, so a step is a
function of its state and its generator's state.
``TrainConfig.weight_norm`` trains the reference's weight-normed convs in
their (g, v) parametrization.

Each stage of a step is a span (``tracing.stage``; a ``torch.profiler``
range of its name while a profiler runs): ``latents`` (VQ codes
and GPT latents), ``forward``, ``backward`` and ``optimizer``, and in the
GAN step ``discriminator`` (its forward, backward and update) and
``gen_loss`` (the generator's loss against the updated discriminator);
with a process group also ``allreduce`` (the gradients' all-reduce).

Data parallelism (``group``, the data group of a ``parallel.mesh.Mesh``,
one process a card; ``parallel/mesh.py``): a step over D data ranks on a
global batch computes the world-1 step's update on that batch, as JAX's
step does on any ``data`` factorisation.  Each rank holds its rows
(batch / D); under tensor parallelism its model peers hold the same rows
and other shards of the GPT (``make_train_state(mesh=)``), whose own
collectives run inside the GPT's forward and backward and in the grad norm
(``train/optim.py``), so every collective named here runs over the data
group only.  The random draws are made for the global
batch from ``generator``, identical on every rank, and each rank keeps its
rows; the GAN step gathers the lengths its segment draw needs.  The
gradients are averaged over the ranks once a backward, after the division
by ``accum`` and before the clip and AdamW (the discriminator's before its
update, the generator's before its own).  The masked KL divides by the
global mask sum; the quantizer sums its EMA statistics over the ranks.
The loss metrics are averaged in one collective.  At D > 1 the dropout
masks come from ``dropout_generator``, this data rank's own
(``parallel.mesh.rank_generator`` keyed by the data rank, so model peers
draw alike), since one seed on every rank would give row i of every rank
the same mask; at D = 1 they come from ``generator`` as without a group, so
a world-1 step is the plain step bit for bit and a (1 x M) step draws the
one-card step's masks.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn

from detail_tts_tpu_torch import tracing
from detail_tts_tpu_torch.audio.mel import MelFrontend
from detail_tts_tpu_torch.config import Config
from detail_tts_tpu_torch.io.weights import random_weights_
from detail_tts_tpu_torch.models.discriminator import MultiPeriodDiscriminator
from detail_tts_tpu_torch.models.quantizer import VQDraws
from detail_tts_tpu_torch.models.synthesizer import (DiffDraws, FlowDraws,
                                                     SynthesizerTrn, draw_diff,
                                                     draw_flow, draw_vq,
                                                     make_train_schedule, shard_draws)
from detail_tts_tpu_torch.nn.common import slice_segments, weight_norm_
from detail_tts_tpu_torch.parallel import mesh
from detail_tts_tpu_torch.parallel.mesh import Mesh, replicate_tree, shard_module_
from detail_tts_tpu_torch.serving.pipeline import resolve_device
from detail_tts_tpu_torch.train.losses import (discriminator_loss, feature_loss,
                                               generator_loss, kl_loss)
from detail_tts_tpu_torch.train.optim import (make_d_optimizer, make_optimizer,
                                              optimizer_step, trainable_parameters)

SINGLE_LOSS_TARGETS = ("vqvae", "gpt", "diff")
GAN_TARGETS = ("flowvae", "all")


def check_target(target: str) -> None:
    if target not in SINGLE_LOSS_TARGETS + GAN_TARGETS:
        raise ValueError(f"unknown training target {target!r}; one of "
                         f"{SINGLE_LOSS_TARGETS + GAN_TARGETS}")


def dummy_batch(cfg: Config, batch_size: int = 1, mel_frames: int = 48,
                text_len: int = 8, device="cpu") -> Dict[str, torch.Tensor]:
    """A zero batch with the 12-key dataset contract (dataset_24k.py:258-272);
    the raw_* sequences are as long as the cropped ones."""
    d = cfg.data
    b, t = batch_size, mel_frames
    assert t % 4 == 0
    f32, i64 = torch.float32, torch.long

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(v):
        return torch.full((b,), v, dtype=i64, device=device)

    return {
        "spec": z(b, t, d.spec_channels), "spec_length": full(t),
        "raw_spec": z(b, t, d.spec_channels), "raw_spec_length": full(t),
        "mel": z(b, t, d.n_mel_channels), "raw_mel": z(b, t, d.n_mel_channels),
        "wav": z(b, t * d.hop_length, 1), "wav_length": full(t * d.hop_length),
        "raw_wav": z(b, t * d.hop_length, 1),
        "raw_wav_length": full(t * d.hop_length),
        "text": z(b, text_len, dtype=i64), "text_length": full(text_len),
    }


def synthetic_batches(cfg: Config, accum: int, micro_batch: int,
                      mel_frames: int = 496, text_len: int = 64,
                      generator: Optional[torch.Generator] = None,
                      device="cpu") -> Iterator[Dict[str, torch.Tensor]]:
    """Endless seeded batches made on ``device``, in the layout of the
    config's target.

    Single-loss targets: (accum, micro, ...) leaves, the 12 keys of
    :func:`dummy_batch` with mel = raw_mel ~ N(-6, 2) (as ``bench_train.py``
    fills its batch).  GAN targets (accum must be 1): (micro, ...) leaves
    with a waveform uniform in [-0.5, 0.5], its linear spectrogram and
    log-mel from :class:`MelFrontend` (raw_* the same), so the mel loss and
    the discriminator see matching pairs, and text ids in [1, 200)."""
    gan = cfg.train.target in GAN_TARGETS
    if gan and accum != 1:
        raise ValueError(f"GAN targets take accum 1, not {accum}")
    d = cfg.data
    frontend = MelFrontend(d.sampling_rate, d.filter_length, d.hop_length,
                           d.win_length, d.n_mel_channels, d.mel_fmin, d.mel_fmax,
                           device=device) if gan else None
    while True:
        batch = dummy_batch(cfg, accum * micro_batch, mel_frames, text_len,
                            device=device)
        if gan:
            wav = torch.rand(batch["wav"].shape, generator=generator,
                             device=device) - 0.5
            spec = frontend.linear_spectrogram(wav[..., 0])
            mel = frontend.spec_to_mel(spec)
            batch.update(wav=wav, raw_wav=wav, spec=spec, raw_spec=spec, mel=mel,
                         raw_mel=mel, text=torch.randint(1, 200, batch["text"].shape,
                                                         generator=generator,
                                                         device=device))
        else:
            batch["mel"] = batch["raw_mel"] = torch.randn(
                batch["mel"].shape, generator=generator, device=device) * 2.0 - 6.0
            batch = {k: v.reshape(accum, micro_batch, *v.shape[1:])
                     for k, v in batch.items()}
        yield batch


@dataclasses.dataclass
class TrainState:
    """Model, its trainable parameters and their optimizer; for the GAN
    targets the discriminator, its parameters and optimizer.  ``step``
    counts optimizer updates (the LR schedule's step)."""

    model: SynthesizerTrn
    params: List[nn.Parameter]
    optimizer: torch.optim.Optimizer
    step: int = 0
    disc: Optional[MultiPeriodDiscriminator] = None
    d_params: Optional[List[nn.Parameter]] = None
    d_optimizer: Optional[torch.optim.Optimizer] = None

    def snapshot(self) -> dict:
        """A copy of everything a step changes, buffers (the codebook)
        included, to repeat a step exactly."""
        snap = {"step": self.step, "model": _clone_state(self.model.state_dict()),
                "optimizer": _clone_optimizer_state(self.optimizer.state_dict())}
        if self.disc is not None:
            snap["disc"] = _clone_state(self.disc.state_dict())
            snap["d_optimizer"] = _clone_optimizer_state(self.d_optimizer.state_dict())
        return snap

    def restore(self, snap: dict) -> None:
        self.model.load_state_dict(snap["model"])
        # load_state_dict may keep the given tensors: hand it copies
        self.optimizer.load_state_dict(_clone_optimizer_state(snap["optimizer"]))
        if self.disc is not None:
            self.disc.load_state_dict(snap["disc"])
            self.d_optimizer.load_state_dict(_clone_optimizer_state(snap["d_optimizer"]))
        self.step = snap["step"]


def _clone_state(sd: dict) -> dict:
    return {k: v.clone() for k, v in sd.items()}


def _clone_optimizer_state(sd: dict) -> dict:
    clone = lambda x: x.clone() if torch.is_tensor(x) else x  # noqa: E731
    return {"state": {i: {k: clone(v) for k, v in s.items()}
                      for i, s in sd["state"].items()},
            "param_groups": [dict(g) for g in sd["param_groups"]]}


def make_train_state(cfg: Config, device="cuda", seed: int = 0,
                     model: Optional[SynthesizerTrn] = None,
                     disc: Optional[MultiPeriodDiscriminator] = None,
                     mesh: Optional[Mesh] = None) -> TrainState:
    """Model (seeded random weights made on ``device`` unless ``model`` is
    given), the target's trainable mask and AdamW over that subtree; for the
    GAN targets also the discriminator (seeded from ``seed + 1`` unless
    given) and its AdamW.  Under ``TrainConfig.weight_norm`` the
    weight-normed convs switch to (g, v) first.  ``mesh``: the state
    becomes rank 0's on every rank (JAX's ``replicate_tree``), then the GPT
    is sharded over the model group (``shard_module_``), then AdamW is made,
    so that it holds shards."""
    dev = resolve_device(device)
    target = cfg.train.target
    check_target(target)
    if model is None:
        with torch.device(dev):
            model = SynthesizerTrn(cfg)
        random_weights_(model, seed)
    model = model.to(dev).train()
    if cfg.train.weight_norm:
        weight_norm_(model)
    if mesh is not None:
        replicate_tree(model, mesh.world_group)
        shard_module_(model, mesh)
    params = [p for _, p in trainable_parameters(model, target)]
    state = TrainState(model, params, make_optimizer(params, cfg))
    if target in GAN_TARGETS:
        if disc is None:
            with torch.device(dev):
                disc = MultiPeriodDiscriminator()
            random_weights_(disc, seed + 1)
        disc = disc.to(dev).train()
        if cfg.train.weight_norm:
            weight_norm_(disc)
        if mesh is not None:
            replicate_tree(disc, mesh.world_group)
        state.disc, state.d_params = disc, list(disc.parameters())
        state.d_optimizer = make_d_optimizer(state.d_params, cfg)
    return state


def _deterministic(step: Callable) -> Callable:
    """``step`` with ``torch.backends.cudnn.deterministic`` on while it runs
    (restored after): with cuDNN's default choice the generator's gradients
    differed between two runs of one GAN step at the last bits (an H100 at
    ``small_test_config()``'s widths)."""
    @functools.wraps(step)
    def run(*args, **kwargs):
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            return step(*args, **kwargs)
        finally:
            torch.backends.cudnn.deterministic = prev
    return run


def _stages(timings: Optional[Dict[str, float]], dev: torch.device):
    """A context factory: ``stage(name)`` is the step's stage span (under
    the training step's root, where one is open); with ``timings`` it ends
    in a device synchronisation and adds its wall time under its name."""
    return lambda name: tracing.stage(name, timings, dev)


def _dropout_generator(group, generator, dropout_generator):
    """The generator of a step's dropout masks: ``generator`` at world 1,
    this rank's ``dropout_generator`` above."""
    if mesh.world(group) == 1:
        return generator
    if dropout_generator is None:
        raise ValueError(f"a step over a world of {mesh.world(group)} needs this rank's "
                         "dropout_generator (parallel.mesh.rank_generator)")
    return dropout_generator


def _global_shape(shape, group):
    return (shape[0] * mesh.world(group),) + tuple(shape[1:])


def make_single_loss_step(cfg: Config, device="cuda", group=None) -> Callable:
    """Returns ``step(state, batch, generator, draws=None, timings=None,
    dropout_generator=None) -> metrics`` for target ``vqvae``, ``gpt`` or
    ``diff``; ``group``: the data-parallel process group (see above).

    ``batch`` leaves have shape (accum, micro_batch, ...), this rank's rows.
    ``draws``: optional per-microbatch draws for the global micro-batch,
    :class:`DiffDraws` (``diff``) or ``VQDraws`` (``vqvae``) (the tests
    hand in JAX's); else each microbatch draws from ``generator``, which
    also gives the dropout masks at world 1.
    ``timings``: optional dict; each stage then ends in a device
    synchronisation and its wall time is added under its name.  Metrics
    (0-d tensors, means over microbatches): ``loss``, ``loss_text`` and
    ``loss_mel`` (``gpt``), ``loss_recon`` and ``loss_commit`` (``vqvae``),
    ``grad_norm`` (before clipping); for ``diff`` also ``layers_kept`` (the
    layer-drop flags of each microbatch)."""
    dev = resolve_device(device)
    target = cfg.train.target
    check_target(target)
    if target not in SINGLE_LOSS_TARGETS:
        raise ValueError(f"target {target!r} takes the GAN step")
    schedule = make_train_schedule(cfg, device=dev)
    autocast = dev.type == "cuda" and cfg.train.use_bf16
    t = cfg.train

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[Sequence] = None,
             timings: Optional[Dict[str, float]] = None,
             dropout_generator: Optional[torch.Generator] = None) -> Dict[str, object]:
        stage = _stages(timings, dev)
        model = state.model
        drop_gen = _dropout_generator(group, generator, dropout_generator)
        accum = next(iter(batch.values())).shape[0]
        parts: Dict[str, List[torch.Tensor]] = {}
        kept = []
        for i in range(accum):
            mb = {k: v[i] for k, v in batch.items()}
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
                if target == "diff":
                    with stage("latents"):
                        latents = model.gpt_latents(mb)
                    with stage("forward"):
                        d = draws[i] if draws is not None else draw_diff(
                            cfg, schedule, _global_shape(mb["raw_mel"].shape, group),
                            generator, dev, train=model.training)
                        loss = model.forward_diff(mb, schedule, shard_draws(d, group),
                                                  latents=latents, generator=drop_gen)
                    kept.append(d.keep)
                    terms = {}
                elif target == "gpt":
                    with stage("forward"):
                        loss_text, loss_mel = model.forward_gpt(mb, drop_gen)
                        loss = t.text_weight * loss_text + t.mel_weight * loss_mel
                    terms = {"loss_text": loss_text, "loss_mel": loss_mel}
                else:  # vqvae
                    with stage("forward"):
                        d = draws[i] if draws is not None else draw_vq(
                            cfg, _global_shape(mb["mel"].shape, group), generator, dev)
                        recon, commit = model.forward_vq(mb["mel"], mb["spec_length"], d,
                                                         group)
                        loss = recon + 0.25 * commit  # model_24k.py:665
                    terms = {"loss_recon": recon, "loss_commit": commit}
            with stage("backward"):
                loss.backward()
            for k, v in {"loss": loss, **terms}.items():
                parts.setdefault(k, []).append(v.detach())
        with stage("optimizer"):
            with torch.no_grad():
                grads = [p.grad for p in state.params if p.grad is not None]
                torch._foreach_div_(grads, float(accum))
        if group is not None:
            with stage("allreduce"):
                mesh.all_reduce_grads(state.params, group)
        with stage("optimizer"):
            grad_norm = optimizer_step(state.optimizer, state.params, cfg, state.step)
            state.optimizer.zero_grad(set_to_none=True)
            state.step += 1
        metrics: Dict[str, object] = {k: torch.stack(v).mean() for k, v in parts.items()}
        metrics = mesh.reduce_metrics(metrics, list(parts), group)
        metrics["grad_norm"] = grad_norm
        if target == "diff":
            metrics["layers_kept"] = kept
        return metrics

    return _deterministic(step)


class GanDraws(NamedTuple):
    """The random draws of one GAN step (``diff`` and ``vq`` under ``all``)."""

    flow: FlowDraws
    diff: Optional[DiffDraws] = None
    vq: Optional[VQDraws] = None


def make_gan_step(cfg: Config, device="cuda", group=None) -> Callable:
    """Returns ``step(state, batch, generator, draws=None, timings=None,
    dropout_generator=None) -> metrics`` for target ``flowvae`` or ``all``
    (train.py:259-447); ``group`` as in :func:`make_single_loss_step`.

    ``batch`` leaves have shape (batch, ...), this rank's rows.  ``draws``:
    an optional :class:`GanDraws` for the global batch (the tests hand in
    JAX's); else the step draws from ``generator`` (enc_q's noise and the
    segment starts, the dropout masks at world 1, then under ``all`` the
    diffusion and VQ draws).  ``timings`` as in
    :func:`make_single_loss_step`.  Metrics, JAX's names, 0-d tensors:
    ``loss_gen_all``, ``loss_gen``, ``loss_fm``, ``loss_mel``, ``loss_kl``,
    ``loss_commit``, ``loss_diff``, ``loss_gpt`` (0 under ``flowvae``),
    ``loss_disc_all``, ``grad_norm_g``, ``grad_norm_d``; under ``all`` also
    ``layers_kept`` (one microbatch's layer-drop flags)."""
    dev = resolve_device(device)
    target = cfg.train.target
    check_target(target)
    if target not in GAN_TARGETS:
        raise ValueError(f"target {target!r} takes the single-loss step")
    d, t = cfg.data, cfg.train
    hop, seg = d.hop_length, t.segment_size
    seg_frames = seg // hop
    frontend = MelFrontend(d.sampling_rate, d.filter_length, hop, d.win_length,
                           d.n_mel_channels, d.mel_fmin, d.mel_fmax, device=dev)
    schedule = make_train_schedule(cfg, device=dev)
    autocast = dev.type == "cuda" and t.use_bf16

    def amp():
        return torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[GanDraws] = None,
             timings: Optional[Dict[str, float]] = None,
             dropout_generator: Optional[torch.Generator] = None) -> Dict[str, object]:
        stage = _stages(timings, dev)
        model, disc = state.model, state.disc
        drop_gen = _dropout_generator(group, generator, dropout_generator)
        zero = torch.zeros((), device=dev)
        aux = {"loss_commit": zero, "loss_diff": zero, "loss_gpt": zero}
        kept = None
        with amp():
            with stage("forward"):
                fd = draws.flow if draws is not None else draw_flow(
                    cfg, mesh.all_gather_rows(batch["spec_length"], group),
                    batch["mel"].shape[1], generator, dev)
                outs = model.forward_flowvae(batch["mel"], batch["spec"],
                                             batch["spec_length"], shard_draws(fd, group),
                                             drop_gen)
            if target == "all":  # model_24k.py:749-772, JAX's order
                with stage("latents"):
                    latents = model.gpt_latents(batch)
                with stage("forward"):
                    dd = draws.diff if draws is not None else draw_diff(
                        cfg, schedule, _global_shape(batch["raw_mel"].shape, group),
                        generator, dev, train=model.training)
                    loss_diff = model.forward_diff(batch, schedule, shard_draws(dd, group),
                                                   latents=latents, generator=drop_gen)
                    loss_text, loss_mel_ce = model.forward_gpt(batch, drop_gen)
                    vd = draws.vq if draws is not None else draw_vq(
                        cfg, _global_shape(batch["mel"].shape, group), generator, dev)
                    recon, commit = model.forward_vq(batch["mel"], batch["spec_length"], vd,
                                                     group)
                aux = {"loss_commit": recon + 0.25 * commit, "loss_diff": loss_diff,
                       "loss_gpt": t.text_weight * loss_text + t.mel_weight * loss_mel_ce}
                kept = dd.keep
        y_slice = slice_segments(batch["wav"], outs.ids_slice * hop, seg)

        # phase 1: the discriminator on the detached generated segment
        with stage("discriminator"):
            with amp():
                d_r, d_g, _, _ = disc(y_slice, outs.y_hat_slice.detach())
            loss_disc, _, _ = discriminator_loss(d_r, d_g)
            loss_disc.backward()
        if group is not None:
            with stage("allreduce"):
                mesh.all_reduce_grads(state.d_params, group)
        with stage("discriminator"):
            grad_norm_d = optimizer_step(state.d_optimizer, state.d_params, cfg,
                                         state.step, clip_norm=None)
            state.d_optimizer.zero_grad(set_to_none=True)

        # phase 2: the generator against the updated discriminator, whose
        # parameters take no gradient
        disc.requires_grad_(False)
        try:
            with stage("gen_loss"):
                with torch.autocast(dev.type, enabled=False):
                    y_hat_mel = frontend.mel_spectrogram(
                        outs.y_hat_slice[..., 0].float())[:, :seg_frames]
                y_mel = slice_segments(batch["mel"], outs.ids_slice, seg_frames)
                with amp():
                    _, d_g, fmap_r, fmap_g = disc(y_slice, outs.y_hat_slice)
                losses = {
                    "loss_gen": generator_loss(d_g)[0],
                    "loss_fm": feature_loss(fmap_r, fmap_g),
                    "loss_mel": (y_mel.float() - y_hat_mel).abs().mean() * t.c_mel,
                    "loss_kl": kl_loss(outs.z_p, outs.logs_q, outs.m_p, outs.logs_p,
                                       outs.y_mask, group) * t.c_kl,
                    **aux}
                total = sum(losses.values())
            with stage("backward"):
                total.backward()
        finally:
            disc.requires_grad_(True)
        if group is not None:
            with stage("allreduce"):
                mesh.all_reduce_grads(state.params, group)
        with stage("optimizer"):
            grad_norm_g = optimizer_step(state.optimizer, state.params, cfg,
                                         state.step, clip_norm=None)
            state.optimizer.zero_grad(set_to_none=True)
            state.step += 1
        metrics: Dict[str, object] = {k: v.detach() for k, v in losses.items()}
        metrics.update(loss_gen_all=total.detach(), loss_disc_all=loss_disc.detach())
        metrics = mesh.reduce_metrics(metrics, list(metrics), group)
        metrics.update(grad_norm_g=grad_norm_g, grad_norm_d=grad_norm_d)
        if kept is not None:
            metrics["layers_kept"] = [kept]
        return metrics

    return _deterministic(step)


def make_train_step(cfg: Config, device="cuda", group=None) -> Callable:
    """Dispatch on ``cfg.train.target`` (model_24k.py:738-748)."""
    check_target(cfg.train.target)
    if cfg.train.target in GAN_TARGETS:
        return make_gan_step(cfg, device, group)
    return make_single_loss_step(cfg, device, group)
