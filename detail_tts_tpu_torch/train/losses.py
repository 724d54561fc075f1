"""GAN and VAE losses (vqvae/modules/losses.py:4-58), all in fp32.

Counterpart of ``detail_tts_tpu/train/losses.py``.  Feature maps and logits
come as lists, one entry per discriminator (``MultiPeriodDiscriminator``'s
return structure); every operand is cast to fp32, as the reference's
``.float()`` calls do.

Under data parallelism every loss of a step is averaged over the ranks.
For an unmasked mean over equally sized shards that average is the
global-batch value (these losses, the GPT's cross-entropies, the diffusion
``mean_flat``, the recon, commitment and mel L1); a masked mean is not,
because the ranks' masks differ: :func:`kl_loss` divides by the global
mask sum, and so must any masked loss added later.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from detail_tts_tpu_torch.parallel.mesh import world


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
            logs_p: torch.Tensor, z_mask: torch.Tensor, group=None) -> torch.Tensor:
    """Masked KL between the flowed posterior and the prior; (B, T, C)
    tensors, mask (B, T, 1): sum(kl * mask) / sum(mask).

    ``group``: the data group (model peers hold the same rows, so not the
    world).  The mask sum is then the
    global batch's (all-reduced, no gradient) and the local sum is scaled
    by the world, so the ranks' average, and its gradient, is the global
    ratio."""
    z_p, logs_q, m_p, logs_p = (x.float() for x in (z_p, logs_q, m_p, logs_p))
    z_mask = z_mask.float()
    kl = logs_p - logs_q - 0.5 + 0.5 * (z_p - m_p).square() * torch.exp(-2.0 * logs_p)
    den = z_mask.sum()
    if group is None:
        return (kl * z_mask).sum() / den
    den = den.detach().clone()
    dist.all_reduce(den, group=group)
    return (kl * z_mask).sum() / den * float(world(group))
