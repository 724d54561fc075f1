"""Flow-VAE prior encoder (``SpecEncoder``, model_24k.py:71-124), NTC.

Counterpart of ``SpecEncoder`` in ``detail_tts_tpu/models/flowvae.py``
(the posterior encoder is training-only and not ported yet).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from detail_tts_tpu_torch.nn.common import Conv1d, sequence_mask
from detail_tts_tpu_torch.nn.rel_attention import RelPosTransformerEncoder


class SpecEncoder(nn.Module):
    def __init__(self, out_channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int):
        super().__init__()
        self.encoder = RelPosTransformerEncoder(
            hidden_channels, filter_channels, n_heads, n_layers, kernel_size)
        self.out_proj = Conv1d(hidden_channels, out_channels, 1)
        self.proj = Conv1d(out_channels, 2 * out_channels, 1)

    def forward(self, y: torch.Tensor, y_lengths: torch.Tensor):
        """y (B, T, hidden) -> (y, m, logs), each (B, T, out_channels)."""
        y_mask = sequence_mask(y_lengths, y.shape[1])[..., None]
        y = self.out_proj(self.encoder(y * y_mask, y_mask))
        m, logs = (self.proj(y) * y_mask).chunk(2, dim=-1)
        return y, m, logs
