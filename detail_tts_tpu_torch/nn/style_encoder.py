"""MelStyleEncoder: a global style vector from a mel (modules.py:642-720).

Counterpart of ``detail_tts_tpu/nn/style_encoder.py``: spectral MLP (Mish)
-> 2x Conv1dGLU -> MHA with softmax temperature sqrt(hidden_dim), not
sqrt(d_k) (a reference quirk, PARITY C10) -> linear -> masked temporal mean
with a denominator of at least 1.  Masked keys get -inf; softmax is fp32.
Dropout (p = ``dropout``, 0.1 as in the JAX module) follows each spectral
Mish, each GLU, the attention weights and the attention output, its masks
drawn from ``generator`` in that order in ``train()`` mode.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from detail_tts_tpu_torch.nn.common import Conv1d, Dense, SeededDropout, mish


class LinearNorm(nn.Module):
    """Reference ``LinearNorm``: a Linear under ``.fc``."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.fc = Dense(in_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x)


class ConvNorm(nn.Module):
    """Reference ``ConvNorm``: a Conv1d under ``.conv``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int):
        super().__init__()
        self.conv = Conv1d(in_ch, out_ch, kernel_size,
                           padding=(kernel_size - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Conv1dGLU(nn.Module):
    """Conv + GLU with residual (modules.py:505-523)."""

    def __init__(self, channels: int, kernel_size: int, dropout: float = 0.0):
        super().__init__()
        self.conv1 = ConvNorm(channels, 2 * channels, kernel_size)
        self.dropout = SeededDropout(dropout)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        a, b = self.conv1(x).chunk(2, dim=-1)
        return x + self.dropout(a * torch.sigmoid(b), generator)


class StyleSelfAttention(nn.Module):
    """Post-residual MHA with temperature sqrt(hidden_dim) (modules.py:562-616)."""

    def __init__(self, hidden_dim: int, n_head: int, dropout: float = 0.0):
        super().__init__()
        self.hidden_dim, self.n_head = hidden_dim, n_head
        self.dropout = SeededDropout(dropout)
        d = (hidden_dim // n_head) * n_head
        self.w_qs = Dense(hidden_dim, d)
        self.w_ks = Dense(hidden_dim, d)
        self.w_vs = Dense(hidden_dim, d)
        self.fc = Dense(d, hidden_dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, t, _ = x.shape
        h = self.n_head
        q = self.w_qs(x).reshape(b, t, h, -1)
        k = self.w_ks(x).reshape(b, t, h, -1)
        v = self.w_vs(x).reshape(b, t, h, -1)
        scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) \
            / math.sqrt(self.hidden_dim)
        if mask is not None:  # (B, T), True = valid key
            scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
        p = self.dropout(torch.softmax(scores, dim=-1).to(x.dtype), generator)
        out = torch.einsum("bhts,bshd->bthd", p, v).reshape(b, t, -1)
        return self.dropout(self.fc(out), generator) + x


class MelStyleEncoder(nn.Module):
    def __init__(self, n_mel_channels: int = 80, style_hidden: int = 128,
                 style_vector_dim: int = 256, style_kernel_size: int = 5,
                 style_head: int = 2, dropout: float = 0.1):
        super().__init__()
        self.spectral = nn.ModuleDict({
            "0": LinearNorm(n_mel_channels, style_hidden),
            "3": LinearNorm(style_hidden, style_hidden)})
        self.dropout = SeededDropout(dropout)
        self.temporal = nn.ModuleList([
            Conv1dGLU(style_hidden, style_kernel_size, dropout) for _ in range(2)])
        self.slf_attn = StyleSelfAttention(style_hidden, style_head, dropout)
        self.fc = LinearNorm(style_hidden, style_vector_dim)

    def forward(self, mel: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mel (B, T, n_mels), mask (B, T) bool -> (B, style_vector_dim)."""
        x = self.dropout(mish(self.spectral["0"](mel)), generator)
        x = self.dropout(mish(self.spectral["3"](x)), generator)
        for layer in self.temporal:
            x = layer(x, generator)
        if mask is not None:
            x = x * mask[..., None]
        x = self.fc(self.slf_attn(x, mask, generator))
        if mask is None:
            return x.mean(dim=1)
        denom = torch.clamp(mask.sum(dim=1, keepdim=True).float(), min=1.0)
        return (x * mask[..., None]).sum(dim=1) / denom.to(x.dtype)
