"""Optimizer, LR schedule and per-target trainable parameters.

Counterpart of ``detail_tts_tpu/train/optim.py``: AdamW with the config's
betas and eps and weight decay 0.01 over the target's trainable subtree only
(train.py:123-131), a staircase exponential LR ``lr * gamma ** (step //
lr_decay_every)`` (train.py:455-457) and, on the single-loss targets, a clip
by global norm 1.0 over the same subtree (train.py:223).  Parameters outside
the subtree have ``requires_grad`` False and are never in the optimizer.

Against optax's ``adamw``: torch multiplies a parameter by ``1 - lr * wd``
before the Adam step, optax adds ``wd * p`` to the Adam direction; both give
``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.  optax still updates a
leaf whose gradient is zero (its moments decay, weight decay applies) while
torch skips a parameter whose ``.grad`` is None, so :func:`optimizer_step`
gives every trainable parameter a zero gradient first (a layer-dropped
layer, an unused unconditioned embedding).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from detail_tts_tpu_torch.config import Config

# Top-level parameter names trained per target (model_24k.py:620-651; 'all'
# trains everything).  The port's VQ encoder is one ``vq_enc`` sequential.
_VQ_KEYS = ("quantizer", "vq_enc", "vq_enc_norm", "vq_enc_conv0", "vq_enc_conv1",
            "vq_enc_conv2", "vq_dec", "vq_dec_norm", "vq_dec_up0", "vq_dec_up1",
            "vq_dec_conv", "vq_ref_enc")
_FLOWVAE_KEYS = ("dec", "in_proj", "enc_p", "enc_q", "flow", "ref_enc")

TARGET_TRAINABLE = {
    "vqvae": set(_VQ_KEYS),
    "gpt": {"gpt"},
    "diff": {"diffusion"},
    "flowvae": set(_FLOWVAE_KEYS),
    "all": None,  # everything
}

WEIGHT_DECAY = 0.01
CLIP_NORM = 1.0


def trainable_parameters(model: nn.Module, target: str
                         ) -> List[Tuple[str, nn.Parameter]]:
    """Mark the target's subtree trainable and everything else frozen;
    returns the trainable (name, parameter) pairs."""
    keys = TARGET_TRAINABLE[target]
    out = []
    for name, p in model.named_parameters():
        train = keys is None or name.split(".")[0] in keys
        p.requires_grad_(train)
        if train:
            out.append((name, p))
    return out


def lr_at(cfg: Config, step: int) -> float:
    """base * gamma ** (step // lr_decay_every): staircase exponential decay."""
    t = cfg.train
    return t.learning_rate * t.lr_decay ** (step // t.lr_decay_every)


def make_optimizer(params: Sequence[nn.Parameter], cfg: Config
                   ) -> torch.optim.AdamW:
    t = cfg.train
    return torch.optim.AdamW(list(params), lr=t.learning_rate,
                             betas=tuple(t.betas), eps=t.eps,
                             weight_decay=WEIGHT_DECAY)


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` when their global norm
    reaches ``max_norm`` (optax.clip_by_global_norm); returns the norm
    before clipping.  No host synchronisation."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    coef = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(list(grads), coef)
    return norm


def optimizer_step(optimizer: torch.optim.Optimizer,
                   params: Sequence[nn.Parameter], cfg: Config, step: int
                   ) -> torch.Tensor:
    """One AdamW update at the LR of ``step`` (0-based, as optax counts),
    after clipping by global norm ``CLIP_NORM``.

    Missing gradients become zeros; the global norm of the gradients (before
    clipping) is returned."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    norm = clip_by_global_norm_([p.grad for p in params], CLIP_NORM)
    for group in optimizer.param_groups:
        group["lr"] = lr_at(cfg, step)
    optimizer.step()
    return norm
