"""HiFi-GAN residual blocks (modules.py:240-379), NTC.

Counterpart of ``detail_tts_tpu/nn/resblocks.py``.  Every conv is one the
reference wraps in ``weight_norm`` (``wn=True``): folded for serving, (g, v)
in training.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from detail_tts_tpu_torch.nn.common import Conv1d, get_padding, leaky_relu


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList([
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=get_padding(kernel_size, d), wn=True) for d in dilation])
        self.convs2 = nn.ModuleList([
            Conv1d(channels, channels, kernel_size,
                   padding=get_padding(kernel_size, 1), wn=True) for _ in dilation])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(leaky_relu(c1(leaky_relu(x))))
        return x


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList([
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=get_padding(kernel_size, d), wn=True) for d in dilation])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = x + c(leaky_relu(x))
        return x
