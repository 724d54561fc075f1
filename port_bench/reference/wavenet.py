"""Gated WaveNet stack (VITS ``WN``, modules.py:152-229), NTC.

Counterpart of ``detail_tts_tpu/nn/wavenet.py``.  Every conv is one the
reference wraps in ``weight_norm`` (``wn=True``): folded for serving, (g, v)
in training.  Dropout (``p_dropout``, 0 in every live config) follows the
gate, its mask drawn from ``generator`` in ``train()`` mode.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from port_bench.reference.common import Conv1d, SeededDropout


class WN(nn.Module):
    def __init__(self, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 p_dropout: float = 0.0):
        super().__init__()
        self.hidden_channels, self.n_layers = hidden_channels, n_layers
        hc = hidden_channels
        if gin_channels:
            self.cond_layer = Conv1d(gin_channels, 2 * hc * n_layers, 1, wn=True)
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            dilation = dilation_rate ** i
            self.in_layers.append(Conv1d(
                hc, 2 * hc, kernel_size, dilation=dilation,
                padding=(kernel_size * dilation - dilation) // 2, wn=True))
            self.res_skip_layers.append(Conv1d(
                hc, hc if i == n_layers - 1 else 2 * hc, 1, wn=True))
        self.drop = SeededDropout(p_dropout)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, T, H); x_mask (B, T, 1); g (B, gin) global conditioning."""
        hc = self.hidden_channels
        output = torch.zeros_like(x)
        g_all = self.cond_layer(g[:, None, :]) if g is not None else None
        for i, (conv_in, res_skip) in enumerate(zip(self.in_layers,
                                                     self.res_skip_layers)):
            x_in = conv_in(x)
            if g_all is not None:
                x_in = x_in + g_all[:, :, 2 * hc * i:2 * hc * (i + 1)]
            a, b = x_in.chunk(2, dim=-1)
            rs = res_skip(self.drop(torch.tanh(a) * torch.sigmoid(b), generator))
            if i < self.n_layers - 1:
                x = (x + rs[..., :hc]) * x_mask
                output = output + rs[..., hc:]
            else:
                output = output + rs
        return output * x_mask
