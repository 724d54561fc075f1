"""Seeded random weights, made by the benchmark on the device in one draw.

The benchmark makes the weights, hands the same tensors to the program and
to the plain reference, and can make them again from the seed after the
window (the same seed on the same device gives the same bits).  Scales: norm
scales near 1, weights ~ N(0, 1/fan_in), small biases, embeddings at 0.02
(the T5 tables at 1), VQ codebooks ~ N(0, 1) and marked initialised.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn as nn
from torch.overrides import TorchFunctionMode

CODEBOOK = "._codebook."


class _NoInitialValues(TorchFunctionMode):
    """Constructors' initial draws skipped: ``torch.nn.init`` and the
    tensors' in-place draws return their tensor, ``torch.randn`` is
    ``torch.empty``."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__module__", None) == "torch.nn.init" or func in (
                torch.Tensor.normal_, torch.Tensor.uniform_):
            return args[0] if args else kwargs["tensor"]
        if func is torch.randn:
            return torch.empty(*args, **kwargs)
        return func(*args, **kwargs)


def structure(build: Callable[[], nn.Module]) -> nn.Module:
    """``build()`` on the host with its memory left unset: the names, shapes
    and module types that :func:`make_weights` reads.  (On the ``meta``
    device a few constructors' draws and products run Python decompositions
    that import the compiler stack: seconds of every run's set-up.)"""
    with torch.device("cpu"), _NoInitialValues():
        return build()


def _fan_in(module: nn.Module, weight: torch.Tensor) -> int:
    if isinstance(module, nn.ConvTranspose1d):  # (in, out, k) over stride
        return max(weight.shape[0] * weight.shape[2] // module.stride[0], 1)
    if isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Linear)):
        return weight[0].numel()
    return weight.shape[0]  # GPT-2's Conv1D keeps (in, out)


def _scaled(mod_name: str, module: nn.Module, name: str, p: torch.Tensor,
            noise: torch.Tensor) -> torch.Tensor:
    if isinstance(module, nn.Embedding):
        return noise * (1.0 if mod_name.endswith("relative_attention_bias") else 0.02)
    if name in ("weight", "gamma") and p.dim() == 1:
        return 1.0 + 0.1 * noise
    if name in ("bias", "beta"):
        return 0.02 * noise
    if name == "weight":
        return noise / _fan_in(module, p) ** 0.5
    return noise / p.shape[-1] ** 0.5


@torch.no_grad()
def make_weights(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """fp32 state dict for ``model`` (its names and shapes; its values are
    not read) from ``seed``: one ``randn`` on ``device`` cut into
    every parameter and codebook, the other codebook buffers derived."""
    slots = []
    for mod_name, module in model.named_modules():
        prefix = mod_name + "." if mod_name else ""
        for name, p in module.named_parameters(recurse=False):
            slots.append((prefix + name, mod_name, module, name, p))
    buffers = dict(model.named_buffers())
    embeds = [n for n in buffers if n.endswith(CODEBOOK + "embed")]
    total = sum(p.numel() for *_, p in slots) + sum(buffers[n].numel() for n in embeds)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for key, mod_name, module, name, p in slots:
        noise = flat[at:at + p.numel()].view(p.shape)
        at += p.numel()
        out[key] = _scaled(mod_name, module, name, p, noise)
    for key in embeds:
        b = buffers[key]
        out[key] = flat[at:at + b.numel()].view(b.shape)
        at += b.numel()
        stem = key[: -len("embed")]
        out[stem + "embed_avg"] = out[key].clone()
        out[stem + "cluster_size"] = torch.ones(buffers[stem + "cluster_size"].shape,
                                                device=device)
        out[stem + "inited"] = torch.ones(buffers[stem + "inited"].shape, device=device)
    missing = [k for k in model.state_dict() if k not in out]
    if missing:
        raise KeyError(f"no seeded value for {missing[:5]}")
    return out


def weight_normed(state: Dict[str, torch.Tensor], keys) -> Dict[str, torch.Tensor]:
    """``state`` in the names ``keys`` asks for: where a key is a weight-norm
    pair ``<m>.weight_g`` / ``<m>.weight_v``, g = the norm of ``<m>.weight``
    over every axis but the first and v = the weight."""
    out = {}
    for key in keys:
        if key.endswith(".weight_v"):
            out[key] = state[key[: -len("_v")]]
        elif key.endswith(".weight_g"):
            w = state[key[: -len("_g")]]
            out[key] = w.flatten(1).norm(dim=1).reshape(-1, *([1] * (w.dim() - 1)))
        else:
            out[key] = state[key]
    return out
