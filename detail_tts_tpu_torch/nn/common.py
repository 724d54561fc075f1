"""Common layers on NTC tensors (batch, time, channels), torch parameter names.

Counterpart of ``detail_tts_tpu/nn/common.py``.  Convolutions keep torch's
weight layouts (Conv1d (out, in/g, k), ConvTranspose1d (in, out, k), Linear
(out, in)) so a reference ``state_dict`` loads as it is; activations stay
time-major at every public function, as in the JAX package, and the convs
transpose inside.  Weights follow the activation dtype at the call (a bf16
model's fp32 tail casts its weights up, as JAX's dtype promotion does).
Norm statistics are always fp32.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1  # vqvae/modules/modules.py:13


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths -> (B, T) bool mask."""
    pos = torch.arange(max_length, device=lengths.device)
    return pos[None, :] < lengths[:, None]


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LRELU_SLOPE)


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` on (B, T, C) tensors; 1x1 convs run as one matmul."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if (self.kernel_size[0] == 1 and self.stride[0] == 1
                and self.groups == 1 and self.padding[0] == 0):
            return F.linear(x, w[:, :, 0], b)
        y = F.conv1d(x.transpose(1, 2), w, b, self.stride, self.padding,
                     self.dilation, self.groups)
        return y.transpose(1, 2)


class ConvTranspose1d(nn.ConvTranspose1d):
    """``nn.ConvTranspose1d`` on (B, T, C) tensors."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight.to(x.dtype), b,
                               self.stride, self.padding, self.output_padding,
                               self.groups, self.dilation)
        return y.transpose(1, 2)


class Dense(nn.Linear):
    """``nn.Linear`` whose weights follow the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last dim in fp32, back to the input dtype."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(),
                        bias.float(), eps).to(x.dtype)


class TorchLayerNorm(nn.LayerNorm):
    """LayerNorm over channels with fp32 statistics (``weight``/``bias``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def group_norm_groups(channels: int) -> int:
    """Reference ``normalization`` group count rule (diff_util.py:118-133)."""
    groups = 32
    if channels <= 16:
        groups = 8
    elif channels <= 64:
        groups = 16
    while channels % groups != 0:
        groups = int(groups / 2)
    assert groups > 2
    return groups


class GroupNorm32(nn.Module):
    """GroupNorm on (B, T, C) with fp32 statistics.

    As in the JAX package, the normalisation folds into one per-(batch,
    channel) multiply-add applied in the input dtype:
    ``y = x * (inv * w) + (b - mean * inv * w)``.
    """

    def __init__(self, channels: int, groups=None, eps: float = 1e-5):
        super().__init__()
        self.groups = groups or group_norm_groups(channels)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        g = self.groups
        x32 = x.float()
        n = t * (c // g)
        mean = x32.sum(1).reshape(b, g, c // g).sum(-1) / n
        mean_sq = x32.square().sum(1).reshape(b, g, c // g).sum(-1) / n
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
        inv = torch.rsqrt(var + self.eps)
        w = self.weight.float()
        mul = inv.repeat_interleave(c // g, dim=-1) * w
        add = self.bias.float() - (mean * inv).repeat_interleave(c // g, dim=-1) * w
        return x * mul.to(x.dtype)[:, None, :] + add.to(x.dtype)[:, None, :]
