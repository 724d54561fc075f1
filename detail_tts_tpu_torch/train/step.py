"""Training state and the single-loss step, target ``diff``.

Counterpart of ``detail_tts_tpu/train/step.py`` (``dummy_batch``,
``TrainState``, ``make_train_state``, ``make_single_loss_step``): gradient
accumulation is a loop over the batch's leading microbatch axis; the
gradients are summed over it and divided by its length, clipped by global
norm 1.0 over the target's trainable subtree and AdamW-updated at the
staircase LR.  The other targets (``gpt``, ``vqvae``, the GAN targets
``flowvae`` and ``all``) come with later slices of the port.

On the card the forward runs under ``torch.autocast(dtype=torch.bfloat16)``
(the reference's ``accelerator.autocast()``, ``TrainConfig.use_bf16``);
master weights, AdamW state, the loss and the schedule math are fp32, as
are norm statistics and softmax statistics.  The frozen VQ codes and GPT
latents run under ``no_grad``.  On the CPU the step runs in fp32 without
autocast.  Every random draw comes from the ``torch.Generator`` passed in.

Each stage of a step is a ``torch.profiler`` range: ``latents`` (VQ codes
and GPT latents), ``forward``, ``backward`` (one each per microbatch) and
``optimizer``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch
import torch.nn as nn

from detail_tts_tpu_torch.config import Config
from detail_tts_tpu_torch.io.weights import random_weights_
from detail_tts_tpu_torch.models.synthesizer import (DiffDraws, SynthesizerTrn,
                                                     draw_diff, make_train_schedule)
from detail_tts_tpu_torch.serving.pipeline import resolve_device
from detail_tts_tpu_torch.train.optim import (make_optimizer, optimizer_step,
                                              trainable_parameters)

PORTED_TARGETS = ("diff",)


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
    """Endless seeded batches in the step's layout (accum, micro, ...): the
    12 keys of :func:`dummy_batch` with mel = raw_mel ~ N(-6, 2), made on
    ``device`` (as ``bench_train.py`` fills its batch)."""
    while True:
        batch = dummy_batch(cfg, accum * micro_batch, mel_frames, text_len,
                            device=device)
        mel = torch.randn(batch["mel"].shape, generator=generator,
                          device=device) * 2.0 - 6.0
        batch["mel"] = batch["raw_mel"] = mel
        yield {k: v.reshape(accum, micro_batch, *v.shape[1:]) for k, v in batch.items()}


@dataclasses.dataclass
class TrainState:
    """Model, its trainable parameters and their optimizer; ``step`` counts
    optimizer updates (the LR schedule's step)."""

    model: SynthesizerTrn
    params: List[nn.Parameter]
    optimizer: torch.optim.Optimizer
    step: int = 0

    def snapshot(self) -> dict:
        """A copy of everything a step changes (to repeat a step exactly)."""
        return {"step": self.step,
                "model": {k: v.clone() for k, v in self.model.state_dict().items()},
                "optimizer": _clone_optimizer_state(self.optimizer.state_dict())}

    def restore(self, snap: dict) -> None:
        self.model.load_state_dict(snap["model"])
        # load_state_dict may keep the given tensors: hand it copies
        self.optimizer.load_state_dict(_clone_optimizer_state(snap["optimizer"]))
        self.step = snap["step"]


def _clone_optimizer_state(sd: dict) -> dict:
    clone = lambda x: x.clone() if torch.is_tensor(x) else x  # noqa: E731
    return {"state": {i: {k: clone(v) for k, v in s.items()}
                      for i, s in sd["state"].items()},
            "param_groups": [dict(g) for g in sd["param_groups"]]}


def make_train_state(cfg: Config, device="cuda", seed: int = 0,
                     model: Optional[SynthesizerTrn] = None) -> TrainState:
    """Model (seeded random weights made on ``device`` unless ``model`` is
    given), the target's trainable mask and AdamW over that subtree."""
    dev = resolve_device(device)
    target = cfg.train.target
    if target not in PORTED_TARGETS:
        raise NotImplementedError(
            f"target {target!r} is not ported yet: the port trains 'diff'; "
            "'gpt' and 'vqvae' come with the next training slice, the GAN "
            "targets 'flowvae' and 'all' after it")
    if model is None:
        with torch.device(dev):
            model = SynthesizerTrn(cfg)
        random_weights_(model, seed)
    model = model.to(dev).train()
    params = [p for _, p in trainable_parameters(model, target)]
    return TrainState(model, params, make_optimizer(params, cfg))


def make_single_loss_step(cfg: Config, device="cuda") -> Callable:
    """Returns ``step(state, batch, generator, draws=None, timings=None)
    -> metrics``.

    ``batch`` leaves have shape (accum, micro_batch, ...).  ``draws``:
    optional per-microbatch :class:`DiffDraws` (the tests hand in JAX's);
    else each microbatch draws from ``generator``, which also gives the
    diffusion net's dropout masks, after the draws.  ``timings``: optional
    dict; each stage then ends in a device synchronisation and its wall time
    is added under its name.  Metrics: ``loss`` (mean over microbatches, a
    0-d tensor), ``grad_norm`` (before clipping, a 0-d tensor) and
    ``layers_kept`` (the layer-drop flags of each microbatch)."""
    dev = resolve_device(device)
    target = cfg.train.target
    if target not in PORTED_TARGETS:
        raise NotImplementedError(f"target {target!r} is not ported yet")
    schedule = make_train_schedule(cfg, device=dev)
    autocast = dev.type == "cuda" and cfg.train.use_bf16

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[Sequence[DiffDraws]] = None,
             timings: Optional[Dict[str, float]] = None) -> Dict[str, object]:

        @contextlib.contextmanager
        def stage(name):
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                yield
                if timings is not None:
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0

        model = state.model
        accum = next(iter(batch.values())).shape[0]
        losses, kept = [], []
        for i in range(accum):
            mb = {k: v[i] for k, v in batch.items()}
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
                with stage("latents"):
                    latents = model.gpt_latents(mb)
                with stage("forward"):
                    d = draws[i] if draws is not None else draw_diff(
                        cfg, schedule, mb["raw_mel"].shape, generator, dev,
                        train=model.training)
                    loss = model.forward_diff(mb, schedule, d, latents=latents,
                                              generator=generator)
            with stage("backward"):
                loss.backward()
            losses.append(loss.detach())
            kept.append(d.keep)
        with stage("optimizer"):
            with torch.no_grad():
                grads = [p.grad for p in state.params if p.grad is not None]
                torch._foreach_div_(grads, float(accum))
            grad_norm = optimizer_step(state.optimizer, state.params, cfg, state.step)
            state.optimizer.zero_grad(set_to_none=True)
            state.step += 1
        return {"loss": torch.stack(losses).mean(), "grad_norm": grad_norm,
                "layers_kept": kept}

    return step
