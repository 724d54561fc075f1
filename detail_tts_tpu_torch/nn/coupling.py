"""Normalizing flow: mean-only affine coupling + flip (modules.py:393-475), NTC.

Counterpart of ``detail_tts_tpu/nn/coupling.py``: the forward pass (the
GAN step's z -> z_p) and the reverse pass (serving).  The reference's ``flows`` list alternates couplings (even
indices, with parameters) and ``Flip`` (odd indices, none).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from detail_tts_tpu_torch.nn.common import Conv1d
from detail_tts_tpu_torch.nn.wavenet import WN


class ResidualCouplingLayer(nn.Module):
    """Mean-only affine coupling (modules.py:421-475)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels)
        self.post = Conv1d(hidden_channels, self.half, 1)

    def _mean(self, x0, x_mask, g):
        return self.post(self.enc(self.pre(x0) * x_mask, x_mask, g=g)) * x_mask

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        x0, x1 = x[..., :self.half], x[..., self.half:]
        return torch.cat([x0, (self._mean(x0, x_mask, g) + x1) * x_mask], dim=-1)

    def reverse(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        x0, x1 = x[..., :self.half], x[..., self.half:]
        return torch.cat([x0, (x1 - self._mean(x0, x_mask, g)) * x_mask], dim=-1)


class Flip(nn.Module):
    """Channel flip (modules.py:393); no parameters."""


class ResidualCouplingBlock(nn.Module):
    """n_flows x (coupling + flip) (vqvae/model_24k.py:127-169)."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, n_flows: int = 4,
                 gin_channels: int = 0):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, dilation_rate,
                n_layers, gin_channels=gin_channels))
            self.flows.append(Flip())

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        for flow in self.flows:
            x = torch.flip(x, dims=[-1]) if isinstance(flow, Flip) \
                else flow(x, x_mask, g=g)
        return x

    def reverse(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        for flow in reversed(self.flows):
            x = torch.flip(x, dims=[-1]) if isinstance(flow, Flip) \
                else flow.reverse(x, x_mask, g=g)
        return x
