"""Plain bias attention: ``softmax(q k^T * sm_scale + bias[h]) v`` on the
(B, T, 3C) output of the qkv projection (channel order [head][q|k|v][ch]),
(H, T, T) bias shared over the batch, the softmax in base 2.  A row whose
every logit lies below ``FLOOR`` gives 0.  Autograd differentiates the
trainable version; nothing here is a kernel."""
from __future__ import annotations


from typing import List, Tuple

import torch

LOG2E = 1.4426950408889634
FLOOR = -1.0e4
MASKED_LSE = 1.0e30


def _split_heads(x: torch.Tensor, heads: int, parts: int) -> List[torch.Tensor]:
    """(B, T, parts*H*D) -> ``parts`` fp32 tensors (B, H, T, D)."""
    b, t, c = x.shape
    d = c // (parts * heads)
    return [y.float().permute(0, 2, 1, 3)
            for y in x.reshape(b, t, heads, parts, d).unbind(3)]


def _attend(qkv: torch.Tensor, bias_log2: torch.Tensor, heads: int,
            sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, T, C) in qkv's dtype, l > 0 mask) from a log2-domain bias."""
    b, t, _ = qkv.shape
    q, k, v = _split_heads(qkv, heads, 3)
    z = torch.einsum("bhtd,bhsd->bhts", q, k) * (sm_scale * LOG2E) + bias_log2.float()[None]
    m = z.amax(dim=-1, keepdim=True).clamp_min(FLOOR)
    p = torch.exp2(z - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhts,bhsd->bhtd", p, v)
    o = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    return o.permute(0, 2, 1, 3).reshape(b, t, -1).to(qkv.dtype)


def bias_attention(qkv: torch.Tensor, bias: torch.Tensor, *, heads: int,
                   sm_scale: float, bias_log2: bool = True) -> torch.Tensor:
    """Serving form: ``bias`` in the log2 domain unless ``bias_log2`` is
    False.  fp32 logits and softmax, autocast off."""
    bias2 = bias.float() if bias_log2 else bias.float() * LOG2E
    return _attend(qkv, bias2, heads, sm_scale)


def bias_attention_train(qkv: torch.Tensor, bias: torch.Tensor, *, heads: int,
                         sm_scale: float) -> torch.Tensor:
    """Trainable form: a natural-domain fp32 bias; gradients reach both
    inputs by autograd."""
    return _attend(qkv, bias.float() * LOG2E, heads, sm_scale)
