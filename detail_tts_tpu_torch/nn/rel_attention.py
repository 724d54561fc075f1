"""VITS relative-position transformer encoder (attentions.py), NTC.

Counterpart of ``detail_tts_tpu/nn/rel_attention.py``: learned windowed
relative key/value embeddings (window 4, shared across heads), the
relative<->absolute skew functions, masked logits at -1e4, fp32 softmax.
Dropout (``p_dropout``) on the attention weights, after the FFN's ReLU and
on each sublayer's output, in the JAX module's order, its masks drawn from
``generator`` in ``train()`` mode.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from detail_tts_tpu_torch.nn.common import Conv1d, SeededDropout, layer_norm


def relative_to_absolute(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, 2L-1) -> (B, H, L, L) (attentions.py:274-289)."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, l * 2 * l)
    x = F.pad(x, (0, l - 1))
    return x.reshape(b, h, l + 1, 2 * l - 1)[:, :, :l, l - 1:]


def absolute_to_relative(x: torch.Tensor) -> torch.Tensor:
    """(B, H, L, L) -> (B, H, L, 2L-1) (attentions.py:291-303)."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1)).reshape(b, h, l * l + l * (l - 1))
    x = F.pad(x, (l, 0))
    return x.reshape(b, h, l, 2 * l)[:, :, :, 1:]


def _relative_embeddings(emb: torch.Tensor, length: int, window: int) -> torch.Tensor:
    """Slice/pad the (1, 2w+1, d) table to (1, 2L-1, d) (attentions.py:259-272)."""
    pad_len = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    if pad_len > 0:
        emb = F.pad(emb, (0, 0, pad_len, pad_len))
    return emb[:, start:start + 2 * length - 1]


class RelPosMultiHeadAttention(nn.Module):
    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: int = 4, p_dropout: float = 0.0):
        super().__init__()
        self.drop = SeededDropout(p_dropout)
        self.channels, self.n_heads, self.window_size = channels, n_heads, window_size
        k_ch = channels // n_heads
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, out_channels, 1)
        self.emb_rel_k = nn.Parameter(torch.randn(1, 2 * window_size + 1, k_ch) * k_ch ** -0.5)
        self.emb_rel_v = nn.Parameter(torch.randn(1, 2 * window_size + 1, k_ch) * k_ch ** -0.5)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Self-attention; x (B, T, C), attn_mask (B, 1, T, T) bool keep."""
        b, t, _ = x.shape
        h = self.n_heads
        k_ch = self.channels // h

        def heads(y):
            return y.reshape(b, t, h, k_ch).transpose(1, 2)  # (B, H, T, k_ch)

        q = heads(self.conv_q(x)) * (1.0 / math.sqrt(k_ch))
        k, v = heads(self.conv_k(x)), heads(self.conv_v(x))
        key_rel = _relative_embeddings(self.emb_rel_k, t, self.window_size)
        scores = q.float() @ k.float().transpose(-1, -2)
        rel_logits = torch.einsum("bhld,mrd->bhlr", q.float(), key_rel.float())
        scores = scores + relative_to_absolute(rel_logits)
        scores = scores.masked_fill(~attn_mask, -1e4)
        p = self.drop(torch.softmax(scores, dim=-1).to(x.dtype), generator)
        value_rel = _relative_embeddings(self.emb_rel_v, t, self.window_size)
        out = (p @ v).float() + torch.einsum(
            "bhlr,mrd->bhld", absolute_to_relative(p).float(), value_rel.float())
        out = out.to(x.dtype).transpose(1, 2).reshape(b, t, self.channels)
        return self.conv_o(out)


class FFN(nn.Module):
    """Conv feed-forward with 'same' padding (attentions.py:317-363)."""

    def __init__(self, in_channels: int, out_channels: int, filter_channels: int,
                 kernel_size: int, p_dropout: float = 0.0):
        super().__init__()
        self.kernel_size = kernel_size
        self.drop = SeededDropout(p_dropout)
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size)

    def _pad(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        return x if k == 1 else F.pad(x, (0, 0, (k - 1) // 2, k // 2))

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.drop(torch.relu(self.conv_1(self._pad(x * x_mask))), generator)
        return self.conv_2(self._pad(y * x_mask)) * x_mask


class VitsLayerNorm(nn.Module):
    """VITS ``LayerNorm`` over channels (``gamma``/``beta``), fp32 statistics."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.gamma, self.beta, self.eps)


class RelPosTransformerEncoder(nn.Module):
    """attentions.Encoder (attentions.py:73-107)."""

    def __init__(self, hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int = 1, window_size: int = 4,
                 p_dropout: float = 0.0):
        super().__init__()
        self.drop = SeededDropout(p_dropout)
        self.attn_layers = nn.ModuleList([
            RelPosMultiHeadAttention(hidden_channels, hidden_channels, n_heads,
                                     window_size, p_dropout) for _ in range(n_layers)])
        self.norm_layers_1 = nn.ModuleList([
            VitsLayerNorm(hidden_channels) for _ in range(n_layers)])
        self.ffn_layers = nn.ModuleList([
            FFN(hidden_channels, hidden_channels, filter_channels, kernel_size,
                p_dropout) for _ in range(n_layers)])
        self.norm_layers_2 = nn.ModuleList([
            VitsLayerNorm(hidden_channels) for _ in range(n_layers)])

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, T, C); x_mask (B, T, 1) bool."""
        m = x_mask[..., 0]
        attn_mask = m[:, None, :, None] & m[:, None, None, :]
        x = x * x_mask
        for attn, norm1, ffn, norm2 in zip(self.attn_layers, self.norm_layers_1,
                                           self.ffn_layers, self.norm_layers_2):
            x = norm1(x + self.drop(attn(x, attn_mask, generator), generator))
            x = norm2(x + self.drop(ffn(x, x_mask, generator), generator))
        return x * x_mask
