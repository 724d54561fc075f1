"""GAN and VAE losses (vqvae/modules/losses.py:4-58), all in fp32.

Counterpart of ``detail_tts_tpu/train/losses.py``.  Feature maps and logits
come as lists, one entry per discriminator (``MultiPeriodDiscriminator``'s
return structure); every operand is cast to fp32, as the reference's
``.float()`` calls do.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def feature_loss(fmap_r: Sequence[Sequence[torch.Tensor]],
                 fmap_g: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """Feature-matching L1 summed over every layer, times 2; the real maps
    are detached."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + (rl.detach().float() - gl.float()).abs().mean()
    return loss * 2.0


def discriminator_loss(disc_real: Sequence[torch.Tensor],
                       disc_fake: Sequence[torch.Tensor]
                       ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """Least-squares D loss: sum of mean (1 - D(y))^2 + mean D(y_hat)^2."""
    loss, r_losses, g_losses = 0.0, [], []
    for dr, dg in zip(disc_real, disc_fake):
        r = (1.0 - dr.float()).square().mean()
        g = dg.float().square().mean()
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(disc_fake: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Least-squares G loss: sum of mean (1 - D(y_hat))^2."""
    per = [(1.0 - dg.float()).square().mean() for dg in disc_fake]
    return sum(per), per


def kl_loss(z_p: torch.Tensor, logs_q: torch.Tensor, m_p: torch.Tensor,
            logs_p: torch.Tensor, z_mask: torch.Tensor) -> torch.Tensor:
    """Masked KL between the flowed posterior and the prior; (B, T, C)
    tensors, mask (B, T, 1)."""
    z_p, logs_q, m_p, logs_p = (x.float() for x in (z_p, logs_q, m_p, logs_p))
    z_mask = z_mask.float()
    kl = logs_p - logs_q - 0.5 + 0.5 * (z_p - m_p).square() * torch.exp(-2.0 * logs_p)
    return (kl * z_mask).sum() / z_mask.sum()
