"""The plain training computation: the ``diff`` target's first optimizer
steps from the benchmark's weights, batches and draw seed.

Each micro-batch draws its timesteps, noise, unconditioned rows and
layer-drop flags from one ``torch.Generator`` seeded with the draw seed, in
the step's order; the rows are then run in blocks (the loss is a mean over
rows, so a block's loss weighted by its share of the rows adds up to the
micro-batch's), the gradients summed over the micro-batches and divided by
their number, clipped by global norm and applied by AdamW at the step's
learning rate.  ``half_batch`` plants a fault: each micro-batch's first half
alone, the mean taken over it.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from port_bench.reference.config import Config
from port_bench.reference.optim import (CLIP_NORM, clip_by_global_norm_, lr_at,
                                        make_optimizer, trainable_parameters)
from port_bench.reference.synthesizer import (DiffDraws, SynthesizerTrn, draw_diff,
                                              make_train_schedule)


def follow(cfg: Config, weights: Dict[str, torch.Tensor],
           batches: Sequence[Dict[str, torch.Tensor]], draw_seed: int, device,
           block_rows: int = 16, half_batch: bool = False) -> Dict[str, object]:
    """Run ``len(batches)`` steps; returns ``loss`` (each step's mean loss),
    ``grad`` (each trainable leaf's first gradient as AdamW gets it, after
    the clip) and ``change`` (each leaf's change over the steps), leaves by
    name, the tensors on the host."""
    dev = torch.device(device)
    with torch.device("meta"):
        model = SynthesizerTrn(cfg)
    model = model.to_empty(device=dev)
    model.load_state_dict(weights)
    model = model.float().train()
    named = trainable_parameters(model, cfg.train.target)
    params = [p for _, p in named]
    start = {n: p.detach().clone() for n, p in named}
    opt = make_optimizer(params, cfg)
    schedule = make_train_schedule(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(draw_seed))
    losses: List[float] = []
    grad: Dict[str, torch.Tensor] = {}
    for step, batch in enumerate(batches):
        accum = next(iter(batch.values())).shape[0]
        parts = []
        for i in range(accum):
            mb = {k: v[i] for k, v in batch.items()}
            d = draw_diff(cfg, schedule, mb["raw_mel"].shape, gen, dev, train=True)
            rows = mb["raw_mel"].shape[0] // (2 if half_batch else 1)
            total = 0.0
            for a in range(0, rows, block_rows):
                b = min(a + block_rows, rows)
                block = {k: v[a:b] for k, v in mb.items()}
                db = DiffDraws(d.t[a:b], d.noise[a:b], d.uncond[a:b], d.keep)
                latents = model.gpt_latents(block)
                loss = model.forward_diff(block, schedule, db, latents=latents,
                                          generator=gen) * ((b - a) / rows)
                loss.backward()
                total += float(loss.detach())
            parts.append(total)
        losses.append(sum(parts) / accum)
        with torch.no_grad():
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                p.grad.div_(accum)
            clip_by_global_norm_([p.grad for p in params], CLIP_NORM)
            if step == 0:
                grad = {n: p.grad.detach().cpu() for n, p in named}
            for group in opt.param_groups:
                group["lr"] = lr_at(cfg, step)
        opt.step()
        opt.zero_grad(set_to_none=True)
    with torch.no_grad():
        change = {n: (p - start[n]).cpu() for n, p in named}
    return {"loss": losses, "grad": grad, "change": change}


def meta_step_work(model: SynthesizerTrn, cfg: Config, micro: int, frames: int,
                   text_tokens: int, keep: Sequence[bool]):
    """(the bias-attention calls (B, T, H, d) of one micro-batch's forward,
    each with its backward, and the model FLOPs of its forward and backward)
    from the reference run on the ``meta`` device with layer-drop ``keep``."""
    from port_bench.reference.diff_blocks import AttentionBlock
    from port_bench.roofline import attention_calls, count_flops

    dev = torch.device("meta")
    model = model.train()
    trainable_parameters(model, cfg.train.target)
    schedule = make_train_schedule(cfg, device=dev)
    hop, n_mels = cfg.data.hop_length, cfg.data.n_mel_channels
    mel = torch.zeros((micro, frames, n_mels), device=dev)

    def full(v):
        return torch.full((micro,), v, dtype=torch.long, device=dev)

    mb = {"mel": mel, "raw_mel": mel, "spec_length": full(frames),
          "raw_spec_length": full(frames), "wav_length": full(frames * hop),
          "raw_wav_length": full(frames * hop),
          "text": torch.zeros((micro, text_tokens), dtype=torch.long, device=dev),
          "text_length": full(text_tokens)}
    d = DiffDraws(torch.zeros((micro,), dtype=torch.long, device=dev), torch.zeros_like(mel),
                  torch.zeros((micro,), dtype=torch.bool, device=dev), tuple(keep))
    calls: List = []

    def step():
        # the frozen pass of ``gpt_latents`` with the codes' shape (the
        # codebook's nearest-neighbour search is no matrix product to count)
        with torch.no_grad():
            model.vq_encode_features(mel)
            codes = torch.zeros((micro, frames // 4), dtype=torch.long, device=dev)
            latents = model.gpt.eval()(mel, mb["raw_spec_length"], mb["text"], codes,
                                       mb["raw_wav_length"])
        loss = model.forward_diff(mb, schedule, d, latents=latents)
        loss.backward()

    flops = count_flops(lambda: calls.extend(attention_calls(model, AttentionBlock, step)))
    return calls, flops
