"""Diffusion-net building blocks (diff_util.py, diff_model.py), NTC.

Counterpart of ``detail_tts_tpu/nn/diff_blocks.py``:

* :class:`T5RelativePositionBias` - bucketed relative attention bias;
* :class:`AttentionBlock` - GroupNorm32 -> qkv 1x1 -> bias attention through
  ``ops.attention.bias_attention`` (the CUDA kernel on the card) -> proj_out,
  residual;
* :class:`DiffResBlock` - scale-shift GroupNorm FiLM residual block;
* :class:`DiffusionLayer` - DiffResBlock + AttentionBlock.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from detail_tts_tpu_torch.nn.common import Conv1d, Dense, GroupNorm32
from detail_tts_tpu_torch.ops.attention import LOG2E, bias_attention


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
        return table.t()[:, buckets] * self.scale


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
        """x (B, T, C); ``bias``: a precomputed LOG2-domain (H, T, T) bias,
        else it is computed here from the T5 table."""
        t = x.shape[1]
        if bias is None:
            bias = self.bias_log2(t)
        qkv = self.qkv(self.norm(x))
        a = bias_attention(qkv, bias.to(qkv.dtype), heads=self.num_heads,
                           sm_scale=1.0 / math.sqrt(self.channels // self.num_heads),
                           bias_log2=True)
        return x + self.proj_out(a)


class DiffResBlock(nn.Module):
    """diff_model.ResBlock with use_scale_shift_norm (diff_model.py:59-119).

    Reference layout: in_layers = [norm, SiLU, 1x1 conv], emb_layers =
    [SiLU, Linear], out_layers = [norm, SiLU, dropout, k-conv].
    """

    def __init__(self, channels: int, emb_channels: int, kernel_size: int = 3):
        super().__init__()
        pad = {1: 0, 3: 1, 5: 2}[kernel_size]
        self.in_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(),
                                       Conv1d(channels, channels, 1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Dense(emb_channels, 2 * channels))
        self.out_layers = nn.Sequential(
            GroupNorm32(channels), nn.SiLU(), nn.Identity(),
            Conv1d(channels, channels, kernel_size, padding=pad))

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers(x)
        scale, shift = self.emb_layers(emb)[:, None, :].chunk(2, dim=-1)
        h = self.out_layers[0](h) * (1 + scale) + shift
        h = self.out_layers[3](F.silu(h))
        return x + h


class DiffusionLayer(nn.Module):
    """ResBlock + rel-pos AttentionBlock (diff_model.py:122-130)."""

    def __init__(self, model_channels: int, num_heads: int):
        super().__init__()
        self.resblk = DiffResBlock(model_channels, model_channels)
        self.attn = AttentionBlock(model_channels, num_heads)

    def forward(self, x, time_emb, attn_bias=None):
        return self.attn(self.resblk(x, time_emb), attn_bias)


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
