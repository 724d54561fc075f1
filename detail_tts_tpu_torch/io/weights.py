"""Weights for the port: from a reference checkpoint, carried over from JAX
variables, or seeded random.

``load_reference_checkpoint`` loads a reference torch ``SynthesizerTrn``
checkpoint (``model-*.pt``) into a port model: the port keeps the
reference's state-dict names, so after the weight-norm fold the keys match
one to one.

``from_jax_variables`` fills every key of a port module's ``state_dict()``
from the JAX package's variables tree (nested dicts of numpy arrays, e.g.
``{"params": ..., "vq_state": ...}``) through ``translate`` (or
``translate_discriminator``): key -> (JAX path, transpose to the port's
layout).  It
is strict on both sides: a port key with no JAX leaf raises, and so does a
JAX leaf that no port key reads.  Weight norm is carried either way: a
folded port ``weight`` from a JAX (g, v) pair (folded), a port
``weight_g``/``weight_v`` pair from JAX's (g, v) or from a folded kernel
(g = ||kernel||, v = kernel).

``random_weights_`` fills a module in place from a seeded generator: norm
scales near 1, weights ~ N(0, 1/fan_in), small biases, VQ codebooks
(``embed`` buffers) ~ N(0, 1).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from detail_tts_tpu_torch.io.torch_convert import IGNORED, translate

# JAX leaves with no counterpart in the port: none, every module is ported
UNPORTED: Tuple[str, ...] = ()

# Modules drawn after all others by ``random_weights_``: added to an earlier
# module after seeded serving weights were fixed, so drawing them last keeps
# every other weight of a seed as it was
DRAWN_LAST = ("gpt.text_head",)


def _fold_jax(v: np.ndarray, g: np.ndarray) -> np.ndarray:
    """JAX (v, g) -> kernel = v * g / max(||v||, 1e-12), the norm over all
    axes but the last (the weight-norm channel in every JAX layout)."""
    v = np.asarray(v, np.float32)
    norm = np.sqrt(np.sum(v ** 2, axis=tuple(range(v.ndim - 1))))
    return v * (np.asarray(g, np.float32) / np.maximum(norm, 1e-12))


def fold_weight_norm(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Merge reference (weight_g, weight_v) pairs into plain weights:
    weight = g * v / ||v||, the norm over every axis but the first."""
    out: Dict[str, np.ndarray] = {}
    for name, value in sd.items():
        if name.endswith(".weight_g"):
            continue
        if name.endswith(".weight_v"):
            base = name[: -len(".weight_v")]
            g = np.asarray(sd[base + ".weight_g"], np.float32)
            v = np.asarray(value, np.float32)
            norm = np.sqrt(np.sum(v ** 2, axis=tuple(range(1, v.ndim)),
                                  keepdims=True))
            out[base + ".weight"] = g * v / np.maximum(norm, 1e-12)
        else:
            out[name] = np.asarray(value)
    return out


def load_reference_checkpoint(path: str, model: nn.Module
                              ) -> Dict[str, List[str]]:
    """Load a reference torch checkpoint into ``model`` in place.

    The file is read with ``torch.load`` onto the CPU; a ``"G"`` or
    ``"model"`` entry is unwrapped, weight-norm pairs are folded.  Strict on
    the port's side: every key of ``model.state_dict()`` must be there with
    its shape.  Returns ``{"unused": [...]}``, the checkpoint keys that no
    port key reads, apart from the reference's derived copies that are
    never loaded (``IGNORED``).  The model gets folded weights: to train in
    the (g, v) parametrization, ``weight_norm_`` it afterwards.
    """
    data = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("G", "model"):
        if isinstance(data, dict) and key in data:
            data = data[key]
            break
    sd = fold_weight_norm({k: _numpy(v) for k, v in data.items()})
    state: Dict[str, torch.Tensor] = {}
    for key, ref in model.state_dict().items():
        if key not in sd:
            raise KeyError(f"port key {key} is not in the checkpoint")
        value = np.asarray(sd.pop(key))
        # a one-element buffer (the codebook's ``inited``) may be 0-d or (1,)
        if value.shape != tuple(ref.shape) and not value.size == 1 == ref.numel():
            raise ValueError(f"{key}: checkpoint shape {value.shape}, port "
                             f"expects {tuple(ref.shape)}")
        state[key] = torch.from_numpy(value.reshape(tuple(ref.shape))).to(ref.dtype)
    model.load_state_dict(state)
    return {"unused": sorted(k for k in sd if not k.startswith(IGNORED))}


def _numpy(v) -> np.ndarray:
    if torch.is_tensor(v):
        v = v.detach().cpu()
        return (v.float() if v.is_floating_point() else v).numpy()
    return np.asarray(v)


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, x in tree.items():
        path = f"{prefix}{k}"
        if isinstance(x, dict):
            out.update(_flatten(x, path + "/"))
        else:
            out[path] = x
    return out


def _jax_leaf(flat: Dict[str, Any], used: set, key: str,
              tr: Callable[[str], Optional[Tuple[str, Callable]]]) -> np.ndarray:
    """The port layout of port key ``key`` from the flat JAX leaves."""
    wn_part = key.rsplit(".", 1)[-1] if key.endswith((".weight_g", ".weight_v")) else None
    t = tr(key[: -len(wn_part)] + "weight" if wn_part else key)
    if t is None:
        raise KeyError(f"port key {key} has no JAX leaf (no translation)")
    path, fn = t
    stem = path[: -len("kernel")] if path.endswith("kernel") else None
    pair = stem is not None and stem + "v" in flat and stem + "g" in flat

    def take(p):
        used.add(p)
        return np.asarray(flat[p], np.float32)

    if wn_part is None and path in flat:
        return np.array(fn(take(path)))
    if wn_part is None and pair:  # fold JAX's (g, v)
        return np.array(fn(_fold_jax(take(stem + "v"), take(stem + "g"))))
    if wn_part == "weight_v":
        return np.array(fn(take(stem + "v") if pair else take(path)))
    if wn_part == "weight_g":
        if pair:
            return take(stem + "g")  # reshaped to the port's (C, 1, ...) below
        w = np.array(fn(take(path)))  # unfold: g = ||kernel||
        return np.sqrt(np.sum(w ** 2, axis=tuple(range(1, w.ndim)), keepdims=True))
    raise KeyError(f"port key {key} has no JAX leaf ({path})")


def from_jax_variables(model: nn.Module, variables, diffusion_layers: int = 10,
                       translate_fn: Optional[Callable] = None
                       ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """JAX variables -> (state_dict for ``model``, JAX paths left unused,
    which is empty: a JAX leaf that no port key reads raises).

    ``translate_fn``: name -> (JAX path, transform); the synthesizer's
    ``translate`` at ``diffusion_layers`` unless given (pass
    ``translate_discriminator`` for a ``MultiPeriodDiscriminator``)."""
    flat = _flatten(variables)
    tr = translate_fn or (lambda name: translate(name, diffusion_layers=diffusion_layers))
    used: set = set()
    state: Dict[str, torch.Tensor] = {}
    for key, ref in model.state_dict().items():
        value = _jax_leaf(flat, used, key, tr)
        if key.endswith(".weight_g") and value.size == ref.numel():
            value = value.reshape(tuple(ref.shape))
        if value.shape != tuple(ref.shape):
            raise ValueError(f"{key}: JAX leaf has shape {value.shape}, "
                             f"port expects {tuple(ref.shape)}")
        state[key] = torch.from_numpy(np.ascontiguousarray(value))
    unused = sorted(set(flat) - used)
    stray = [p for p in unused if not p.startswith(UNPORTED)]
    if stray:
        raise KeyError(f"JAX leaves with no port key: {stray[:5]}")
    return state, unused


def _fan_in(module: nn.Module, weight: torch.Tensor) -> int:
    if isinstance(module, nn.ConvTranspose1d):  # (in, out, k) over stride
        return max(weight.shape[0] * weight.shape[2] // module.stride[0], 1)
    if isinstance(module, (nn.Conv1d, nn.Conv2d, nn.Linear)):
        return weight[0].numel()
    return weight.shape[0]  # HF Conv1D (in, out)


def _draw_order(model: nn.Module):
    """``model.named_modules()`` with the ``DRAWN_LAST`` subtrees moved to
    the end."""
    last = lambda name: any(name == p or name.startswith(p + ".")  # noqa: E731
                            for p in DRAWN_LAST)
    mods = list(model.named_modules())
    return [m for m in mods if not last(m[0])] + [m for m in mods if last(m[0])]


@torch.no_grad()
def random_weights_(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and VQ codebook of ``model`` in place from
    ``seed``, module by module in registration order (``DRAWN_LAST``
    after the rest)."""
    gen = None
    for mod_name, module in _draw_order(model):
        for name, p in module.named_parameters(recurse=False):
            if gen is None:
                gen = torch.Generator(device=p.device).manual_seed(seed)
            noise = torch.randn(p.shape, generator=gen, device=p.device)
            if isinstance(module, (nn.Embedding,)):
                std = 1.0 if mod_name.endswith("relative_attention_bias") else 0.02
                p.copy_(noise * std)
            elif name in ("weight", "gamma") and p.dim() == 1:  # norm scales
                p.copy_(1.0 + 0.1 * noise)
            elif name in ("bias", "beta"):
                p.copy_(0.02 * noise)
            elif name == "weight":
                p.copy_(noise / _fan_in(module, p) ** 0.5)
            else:  # free tables: unconditioned embedding, rel-pos key/value
                p.copy_(noise / p.shape[-1] ** 0.5)
        for name, buf in module.named_buffers(recurse=False):
            if name == "embed":
                buf.copy_(torch.randn(buf.shape, generator=gen, device=buf.device))
    return model
