"""Common layers on NTC tensors (batch, time, channels), torch parameter names.

Counterpart of ``detail_tts_tpu/nn/common.py``.  Convolutions keep torch's
weight layouts (Conv1d (out, in/g, k), ConvTranspose1d (in, out, k), Linear
(out, in)) so a reference ``state_dict`` loads as it is; activations stay
time-major at every public function, as in the JAX package, and the convs
transpose inside.  Weights follow the activation dtype at the call (a bf16
model's fp32 tail casts its weights up, as JAX's dtype promotion does).
Norm statistics are always fp32.

Training pieces: :class:`SeededDropout` (masks from the step's explicit
generator), the reference's weight-norm (g, v) parametrization of the convs
it wraps (:func:`weight_norm_`), and the GAN step's random segment slices
(:func:`rand_slice_starts`, :func:`slice_segments`).
"""
from __future__ import annotations

import contextlib
from typing import Optional

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


class SeededDropout(nn.Dropout):
    """``nn.Dropout`` whose mask is drawn from an explicit generator.

    In ``train()`` mode with p > 0 the keep mask comes from ``generator``
    (on the activation's device) and the kept values are scaled by
    1 / (1 - p), as ``nn.Dropout`` scales them.  A missing generator raises
    instead of falling back to torch's global one, so a training step stays
    a function of its seed.  In ``eval()`` mode or at p = 0 nothing is drawn.
    The JAX modules' threefry masks cannot be matched bit for bit: the port
    is held to determinism from its seed."""

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if generator is None:
            raise ValueError(f"dropout {self.p} in train() mode needs the step's "
                             "torch.Generator; none was given")
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.p
        scale = 1.0 / (1.0 - self.p) if self.p < 1.0 else 0.0
        return x * keep.to(x.dtype) * scale


@contextlib.contextmanager
def eval_mode(module: nn.Module):
    """``module`` in ``eval()`` mode inside the block (no dropout is drawn),
    each submodule's train/eval flag restored after it: the frozen passes
    that JAX runs with ``deterministic=True`` in a training step."""
    flags = [(m, m.training) for m in module.modules()]
    module.eval()
    try:
        yield module
    finally:
        for m, flag in flags:
            m.training = flag


def _norm_except_dim0(v: torch.Tensor) -> torch.Tensor:
    """fp32 L2 norm over every axis but torch's dim 0, keepdim."""
    return v.float().square().sum(tuple(range(1, v.dim())), keepdim=True).sqrt()


class WeightNorm:
    """Mixin for the convs the reference wraps in torch ``weight_norm``
    (constructed with ``wn=True``).

    After :func:`weight_norm_` the module holds ``weight_g`` (the norm's
    shape, (C, 1, ...)) and ``weight_v`` in place of ``weight``, under the
    reference's state-dict names, and the effective weight is
    ``g * v / max(||v||, 1e-12)`` in fp32, the norm over every axis but
    torch's dim 0 (per output channel; per input channel for
    ``ConvTranspose1d``, whose weight is (in, out, k)).  Serving keeps the
    folded ``weight``."""

    def __init__(self, *args, wn: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.wn = wn

    def to_weight_norm(self) -> None:
        """weight -> (g = ||weight||, v = weight): the same effective weight."""
        w = self.weight.detach()
        del self.weight
        self.weight_g = nn.Parameter(_norm_except_dim0(w).to(w.dtype))
        self.weight_v = nn.Parameter(w.clone())

    def effective_weight(self) -> torch.Tensor:
        if "weight_v" not in self._parameters:
            return self.weight
        v = self.weight_v.float()
        return v * (self.weight_g.float() / _norm_except_dim0(v).clamp_min(1e-12))


def weight_norm_(model: nn.Module) -> nn.Module:
    """Switch every conv of ``model`` built with ``wn=True`` to its (g, v)
    parametrization (training under ``TrainConfig.weight_norm``); modules
    already switched are left as they are."""
    for m in model.modules():
        if isinstance(m, WeightNorm) and m.wn and "weight" in m._parameters:
            m.to_weight_norm()
    return model


class Conv1d(WeightNorm, nn.Conv1d):
    """``nn.Conv1d`` on (B, T, C) tensors; 1x1 convs run as one matmul."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.effective_weight().to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if (self.kernel_size[0] == 1 and self.stride[0] == 1
                and self.groups == 1 and self.padding[0] == 0):
            return F.linear(x, w[:, :, 0], b)
        y = F.conv1d(x.transpose(1, 2), w, b, self.stride, self.padding,
                     self.dilation, self.groups)
        return y.transpose(1, 2)


class ConvTranspose1d(WeightNorm, nn.ConvTranspose1d):
    """``nn.ConvTranspose1d`` on (B, T, C) tensors."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv_transpose1d(x.transpose(1, 2), self.effective_weight().to(x.dtype),
                               b, self.stride, self.padding, self.output_padding,
                               self.groups, self.dilation)
        return y.transpose(1, 2)


class Conv2d(WeightNorm, nn.Conv2d):
    """``nn.Conv2d`` on (B, C, H, W) tensors, torch's own layout (the
    discriminator's period convs); weights follow the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.effective_weight().to(x.dtype), b, self.stride,
                        self.padding, self.dilation, self.groups)


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


def rand_slice_starts(lengths: torch.Tensor, segment_size: int,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Random per-row slice starts in [0, max(length - segment + 1, 1))
    (commons.py:76-84), one uniform draw a row from ``generator``."""
    max_starts = torch.clamp(lengths - segment_size + 1, min=1).float()
    u = torch.rand(lengths.shape, generator=generator, device=lengths.device)
    return (u * max_starts).long()


def slice_segments(x: torch.Tensor, starts: torch.Tensor,
                   segment_size: int) -> torch.Tensor:
    """(B, T, C) -> (B, segment_size, C) from each row's start, clamped to
    [0, T - segment_size] as JAX's ``dynamic_slice_in_dim`` clamps it."""
    starts = starts.clamp(0, x.shape[1] - segment_size)
    idx = starts[:, None] + torch.arange(segment_size, device=x.device)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
