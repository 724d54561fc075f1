"""HiFi-GAN V1-style generator (model_24k.py:221-295), NTC.

Counterpart of ``detail_tts_tpu/models/vocoder.py``: conv_pre, a 1x1 global
speaker conditioning, transposed-conv upsampling 8*4*2*2*2 (padding
(k - u) // 2), averaged ResBlock branches per stage, then leaky ReLU with
torch's default slope 0.01 (not 0.1), conv_post and tanh.  The upsampling
convs and the resblocks' convs are weight-normed in training (``wn=True``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference.common import Conv1d, ConvTranspose1d, leaky_relu
from port_bench.reference.resblocks import ResBlock1, ResBlock2


class HiFiGANGenerator(nn.Module):
    def __init__(self, initial_channel: int, resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 upsample_rates: Sequence[int] = (8, 4, 2, 2, 2),
                 upsample_initial_channel: int = 400,
                 upsample_kernel_sizes: Sequence[int] = (16, 8, 2, 2, 2),
                 gin_channels: int = 0):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        res_cls = ResBlock1 if resblock == "1" else ResBlock2
        self.conv_pre = Conv1d(initial_channel, upsample_initial_channel, 7, padding=3)
        if gin_channels:
            self.cond = Conv1d(gin_channels, upsample_initial_channel, 1)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = upsample_initial_channel
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            out_ch = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(ConvTranspose1d(ch, out_ch, k, u, padding=(k - u) // 2,
                                            wn=True))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(res_cls(out_ch, rk, tuple(rd)))
            ch = out_ch
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False)

    def forward(self, x: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, C); g (B, gin) -> wav (B, T * prod(rates), 1)."""
        x = self.conv_pre(x)
        if g is not None:
            x = x + self.cond(g[:, None, :])
        nk = self.num_kernels
        for i, up in enumerate(self.ups):
            x = up(leaky_relu(x))
            xs = self.resblocks[i * nk](x)
            for j in range(1, nk):
                xs = xs + self.resblocks[i * nk + j](x)
            x = xs / nk
        return torch.tanh(self.conv_post(F.leaky_relu(x, 0.01)))
