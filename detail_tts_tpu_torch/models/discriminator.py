"""Multi-period and scale discriminators (vqvae/model_24k.py:298-431).

Counterpart of ``detail_tts_tpu/models/discriminator.py``, under the
reference's state-dict names (``discriminators.0`` the scale discriminator,
``discriminators.1..5`` the period discriminators of periods 2, 3, 5, 7,
11; ``convs.i`` and ``conv_post`` in each).  Every conv is weight-normed in
training (``wn=True``), as the reference wraps each one.  Waveforms are
(B, T, 1).  The scale discriminator keeps time-major feature maps (B, T, C);
a period discriminator folds time into (T / p, p) and keeps torch's
(B, C, T / p, p) layout.  Logits are flat (B, -1) in the JAX order.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from detail_tts_tpu_torch.nn.common import Conv1d, Conv2d, get_padding, leaky_relu

# (out channels, kernel, stride, groups, padding) of DiscriminatorS
_S_SPECS = ((16, 15, 1, 1, 7), (64, 41, 4, 4, 20), (256, 41, 4, 16, 20),
            (1024, 41, 4, 64, 20), (1024, 41, 4, 256, 20), (1024, 5, 1, 1, 2))


class DiscriminatorP(nn.Module):
    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (get_padding(kernel_size, 1), 0)
        chans = (1, 32, 128, 512, 1024)
        self.convs = nn.ModuleList([
            Conv2d(cin, cout, (kernel_size, 1), (stride, 1), padding=pad, wn=True)
            for cin, cout in zip(chans[:-1], chans[1:])])
        self.convs.append(Conv2d(1024, 1024, (kernel_size, 1), 1, padding=pad, wn=True))
        self.conv_post = Conv2d(1024, 1, (3, 1), 1, padding=(1, 0), wn=True)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x (B, T, 1) -> (logits (B, -1), feature maps)."""
        b, t, _ = x.shape
        x = x[..., 0]
        if t % self.period:  # reflect pad at the end, as a flip (exact backward)
            n_pad = self.period - t % self.period
            x = torch.cat([x, x[:, -n_pad - 1:-1].flip(1)], dim=1)
        x = x.reshape(b, 1, -1, self.period)
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class DiscriminatorS(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 1
        self.convs = nn.ModuleList()
        for cout, k, s, g, p in _S_SPECS:
            self.convs.append(Conv1d(cin, cout, k, s, padding=p, groups=g, wn=True))
            cin = cout
        self.conv_post = Conv1d(1024, 1, 3, 1, padding=1, wn=True)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.discriminators = nn.ModuleList(
            [DiscriminatorS()] + [DiscriminatorP(p) for p in periods])

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """Real and generated (B, T, 1) waveforms -> (real logits, generated
        logits, real feature maps, generated feature maps), one entry per
        discriminator."""
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            r, fr = d(y)
            g, fg = d(y_hat)
            y_d_rs.append(r)
            y_d_gs.append(g)
            fmap_rs.append(fr)
            fmap_gs.append(fg)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
