"""Token sampling with HF ``generate`` semantics (counterpart of ``ops/sampling.py``).

Repetition penalty -> temperature -> typical -> top-p, all on fp32 logits,
then ``argmax(logits + gumbel)``, which is a draw from the categorical:
``jax.random.categorical(key, l)`` is ``argmax(gumbel(key, l.shape) + l)``.
The Gumbel noise is drawn under a JAX key (``ops/prng.py``: a host key, or
a row of the decode's device key buffer) or is passed in.
"""
from __future__ import annotations

from typing import Optional

import torch

from detail_tts_tpu_torch.ops import prng
from detail_tts_tpu_torch.parallel.mesh import Rows


def apply_repetition_penalty(logits: torch.Tensor, seen_mask: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor: score > 0 -> /p, else *p."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen_mask, penalized, logits)


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return logits if temperature == 1.0 else logits / temperature


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """HF TopPLogitsWarper (min_tokens_to_keep=1) with its tie semantics.

    Removal in ascending stable-sorted order is a prefix, so the kept set is:
    value > boundary value, or equal to it with an original index at or after
    the boundary's (the stable sort orders ties by index).
    """
    if top_p >= 1.0:
        return logits
    v = logits.shape[-1]
    sorted_logits, order = torch.sort(logits, dim=-1, stable=True)
    cum = torch.softmax(sorted_logits.float(), dim=-1).cumsum(dim=-1)
    k = (cum <= (1.0 - top_p)).sum(dim=-1, keepdim=True).clamp_max(v - 1)
    boundary_val = sorted_logits.gather(-1, k)
    boundary_idx = order.gather(-1, k)
    idx = torch.arange(v, device=logits.device)
    remove = (logits < boundary_val) | ((logits == boundary_val)
                                        & (idx < boundary_idx))
    return logits.masked_fill(remove, float("-inf"))


def apply_typical(logits: torch.Tensor, mass: float = 0.9) -> torch.Tensor:
    """Entropy-typical filtering (gpt/modules/typical_sampling.py:1-33)."""
    if mass >= 1.0:
        return logits
    logp = torch.log_softmax(logits.float(), dim=-1)
    p = logp.exp()
    entropy = -torch.where(p > 0, p * logp, 0.0).sum(dim=-1, keepdim=True)
    shifted = (-logp - entropy).abs()
    sorted_shifted, order = torch.sort(shifted, dim=-1, stable=True)
    cum = p.gather(-1, order).cumsum(dim=-1)
    last_ind = (cum < mass).sum(dim=-1, keepdim=True).clamp_max(p.shape[-1] - 1)
    remove = shifted > sorted_shifted.gather(-1, last_ind)
    return logits.masked_fill(remove, float("-inf"))


def sample_token(logits: torch.Tensor, *, seen_mask: torch.Tensor,
                 temperature: float = 0.8, top_p: float = 0.8,
                 repetition_penalty: float = 2.0, typical_mass: float = 1.0,
                 key=None, gumbel: Optional[torch.Tensor] = None,
                 rows: Optional[Rows] = None) -> torch.Tensor:
    """One decode-step sample, (B, V) -> (B,) int64.  The Gumbel noise is
    ``gumbel``, else drawn under ``key`` (``prng.draw``), where ``rows``: the
    logits are these rows of the request's (B, V) draw."""
    logits = logits.float()
    logits = apply_repetition_penalty(logits, seen_mask, repetition_penalty)
    logits = apply_temperature(logits, temperature)
    logits = apply_typical(logits, typical_mass)
    logits = apply_top_p(logits, top_p)
    if gumbel is None:
        gumbel = prng.draw(key, logits.shape, "gumbel",
                           offset=prng.row_offset(rows, logits.shape), device=logits.device)
    return torch.argmax(gumbel + logits, dim=-1)
