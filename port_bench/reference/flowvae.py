"""Flow-VAE encoders (model_24k.py:71-218), NTC.

Counterpart of ``SpecEncoder`` (the prior over mel features) and
``PosteriorEncoder`` (the training-only posterior over the linear
spectrogram) in ``detail_tts_tpu/models/flowvae.py``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from port_bench.reference.common import Conv1d, sequence_mask
from port_bench.reference.rel_attention import RelPosTransformerEncoder
from port_bench.reference.wavenet import WN


class SpecEncoder(nn.Module):
    def __init__(self, out_channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int, p_dropout: float = 0.0):
        super().__init__()
        self.encoder = RelPosTransformerEncoder(
            hidden_channels, filter_channels, n_heads, n_layers, kernel_size,
            p_dropout=p_dropout)
        self.out_proj = Conv1d(hidden_channels, out_channels, 1)
        self.proj = Conv1d(out_channels, 2 * out_channels, 1)

    def forward(self, y: torch.Tensor, y_lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """y (B, T, hidden) -> (y, m, logs), each (B, T, out_channels)."""
        y_mask = sequence_mask(y_lengths, y.shape[1])[..., None]
        y = self.out_proj(self.encoder(y * y_mask, y_mask, generator))
        m, logs = (self.proj(y) * y_mask).chunk(2, dim=-1)
        return y, m, logs


class PosteriorEncoder(nn.Module):
    """WaveNet posterior over the linear spectrogram (model_24k.py:172-218)."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 kernel_size: int = 5, dilation_rate: int = 1, n_layers: int = 16,
                 gin_channels: int = 0):
        super().__init__()
        self.pre = Conv1d(in_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.proj = Conv1d(hidden_channels, 2 * out_channels, 1)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor,
                noise: torch.Tensor, g: Optional[torch.Tensor] = None):
        """x (B, T, in_channels), ``noise`` (B, T, out_channels) standard
        normal -> (z, m, logs).  ``g`` is detached, as the reference does
        (model_24k.py:207)."""
        x_mask = sequence_mask(x_lengths, x.shape[1])[..., None]
        x = self.pre(x) * x_mask
        x = self.enc(x, x_mask, g=None if g is None else g.detach())
        m, logs = (self.proj(x) * x_mask).chunk(2, dim=-1)
        z = (m + noise.to(m.dtype) * torch.exp(logs)) * x_mask
        return z, m, logs
