"""Diffusion-net building blocks (diff_util.py, diff_model.py), NTC.

Counterpart of ``detail_tts_tpu/nn/diff_blocks.py``:

* :class:`T5RelativePositionBias` - bucketed relative attention bias;
* :class:`AttentionBlock` - GroupNorm32 -> qkv 1x1 -> bias attention -> proj_out,
  residual.  Two routes with the same math: serving (no gradient) through
  ``ops.attention.bias_attention``, and training through
  ``ops.attention.bias_attention_train`` (the trainable kernels on the card),
  taken when grad mode is on, the block computes its own T5 bias and a
  parameter requires grad;
* :class:`DiffResBlock` - scale-shift GroupNorm FiLM residual block with
  dropout (``DiffusionConfig.dropout``, active in ``train()`` mode only, its
  mask drawn from the step's explicit ``torch.Generator``);
* :class:`DiffusionLayer` - DiffResBlock + AttentionBlock.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from detail_tts_tpu_torch.nn.common import Conv1d, Dense, GroupNorm32, SeededDropout
from detail_tts_tpu_torch.ops.attention import (LOG2E, bias_attention,
                                                bias_attention_train)


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Non-causal T5 bucketing (xtransformers.py:155-175)."""
    n = -relative_position
    num_buckets //= 2
    ret = (n < 0).long() * num_buckets
    n = n.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.clamp_min(1).float() / max_exact)
        / math.log(max_distance / max_exact) * (num_buckets - max_exact)).long()
    val_if_large = val_if_large.clamp_max(num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


@functools.lru_cache(maxsize=4)
def _bucket_onehot(length: int, num_buckets: int, max_distance: int,
                   device: torch.device) -> torch.Tensor:
    """(L*L, NB) fp32 one-hot of the buckets at one length, built once."""
    pos = torch.arange(length, device=device)
    buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                       num_buckets, max_distance)
    return F.one_hot(buckets.reshape(-1), num_buckets).float()


class _BucketGather(torch.autograd.Function):
    """table (NB, H) gathered at buckets (L, L) -> (H, L, L).

    The backward sums the (H, L, L) gradient into the NB buckets with one
    product by the buckets' one-hot matrix, built once per length:
    deterministic, and on the card faster than the gather's own backward
    (an index_put that at L = 496 repeats each of 32 indices ~7,700 times
    and serialises on them) and than ``nn.Embedding``'s sort-based one."""

    @staticmethod
    def forward(ctx, table, buckets, max_distance):
        ctx.key = (buckets.shape[0], table.shape[0], max_distance, buckets.device)
        return table.t()[:, buckets]

    @staticmethod
    def backward(ctx, grad):
        onehot = _bucket_onehot(*ctx.key)
        with torch.autocast(grad.device.type, enabled=False):
            dtable = grad.float().reshape(grad.shape[0], -1) @ onehot
        return dtable.t().contiguous(), None, None


class T5RelativePositionBias(nn.Module):
    def __init__(self, scale: float, heads: int, num_buckets: int = 32,
                 max_distance: int = 64):
        super().__init__()
        self.scale = scale
        self.num_buckets, self.max_distance = num_buckets, max_distance
        self.relative_attention_bias = nn.Embedding(num_buckets, heads)

    def forward(self, length: int) -> torch.Tensor:
        """(H, L, L) natural-domain bias, fp32."""
        pos = torch.arange(length, device=self.relative_attention_bias.weight.device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           self.num_buckets, self.max_distance)
        table = self.relative_attention_bias.weight.float()
        return _BucketGather.apply(table, buckets, self.max_distance) * self.scale


class AttentionBlock(nn.Module):
    """diff_util.AttentionBlock (diff_util.py:172-215) with T5 rel-pos bias.

    qkv channel order is [head][q|k|v][ch] (QKVAttentionLegacy), which is what
    the kernel reads.  The reference's legacy scaling of q and k by
    ch**-1/4 each is the same as one ch**-1/2 on the logits.
    """

    def __init__(self, channels: int, num_heads: int = 1):
        super().__init__()
        self.channels, self.num_heads = channels, num_heads
        ch = channels // num_heads
        self.norm = GroupNorm32(channels)
        self.qkv = Conv1d(channels, 3 * channels, 1)
        self.proj_out = Conv1d(channels, channels, 1)
        self.relative_pos_embeddings = T5RelativePositionBias(
            scale=ch ** 0.5, heads=num_heads, num_buckets=32, max_distance=64)

    def bias_log2(self, length: int) -> torch.Tensor:
        """(H, L, L) log2-domain bias (fp32): t-independent, hoistable."""
        return self.relative_pos_embeddings(length) * LOG2E

    def forward(self, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, C); ``bias``: a precomputed LOG2-domain (H, T, T) bias
        (serving), else it is computed here from the T5 table.

        Under autograd the natural-domain fp32 bias goes into the trainable
        function, so its gradient reaches ``relative_attention_bias``
        through the gather's backward."""
        t = x.shape[1]
        qkv = self.qkv(self.norm(x))
        sm_scale = 1.0 / math.sqrt(self.channels // self.num_heads)
        if bias is None and torch.is_grad_enabled() and (
                qkv.requires_grad
                or self.relative_pos_embeddings.relative_attention_bias.weight.requires_grad):
            a = bias_attention_train(qkv, self.relative_pos_embeddings(t),
                                     heads=self.num_heads, sm_scale=sm_scale)
        else:
            if bias is None:
                bias = self.bias_log2(t)
            a = bias_attention(qkv, bias.to(qkv.dtype), heads=self.num_heads,
                               sm_scale=sm_scale, bias_log2=True)
        return x + self.proj_out(a)


class DiffResBlock(nn.Module):
    """diff_model.ResBlock with use_scale_shift_norm (diff_model.py:59-119).

    Reference layout: in_layers = [norm, SiLU, 1x1 conv], emb_layers =
    [SiLU, Linear], out_layers = [norm, SiLU, dropout, k-conv].
    """

    def __init__(self, channels: int, emb_channels: int, kernel_size: int = 3,
                 dropout: float = 0.0):
        super().__init__()
        pad = {1: 0, 3: 1, 5: 2}[kernel_size]
        self.in_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(),
                                       Conv1d(channels, channels, 1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Dense(emb_channels, 2 * channels))
        self.out_layers = nn.Sequential(
            GroupNorm32(channels), nn.SiLU(), SeededDropout(dropout),
            Conv1d(channels, channels, kernel_size, padding=pad))

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: the dropout mask's source, required in ``train()``
        mode when dropout > 0 (see :class:`SeededDropout`)."""
        h = self.in_layers(x)
        scale, shift = self.emb_layers(emb)[:, None, :].chunk(2, dim=-1)
        h = self.out_layers[0](h) * (1 + scale) + shift
        h = self.out_layers[3](self.out_layers[2](F.silu(h), generator))
        return x + h


class DiffusionLayer(nn.Module):
    """ResBlock + rel-pos AttentionBlock (diff_model.py:122-130)."""

    def __init__(self, model_channels: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.resblk = DiffResBlock(model_channels, model_channels, dropout=dropout)
        self.attn = AttentionBlock(model_channels, num_heads)

    def forward(self, x, time_emb, attn_bias=None, generator=None):
        return self.attn(self.resblk(x, time_emb, generator), attn_bias)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding (diff_model.py:20-38); fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
