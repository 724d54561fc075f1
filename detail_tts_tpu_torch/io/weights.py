"""Weights for the port: carried over from JAX variables, or seeded random.

``from_jax_variables`` fills every key of a port module's ``state_dict()``
from the JAX package's variables tree (nested dicts of numpy arrays, e.g.
``{"params": ..., "vq_state": ...}``) through ``translate``: key -> (JAX
path, self-inverse transpose).  It is strict on the port's side (a key with
no JAX leaf raises); JAX leaves of modules the port does not have yet are
returned as a list.  A (g, v) weight-norm tree is folded first.

``random_weights_`` fills a module in place from a seeded generator: norm
scales near 1, weights ~ N(0, 1/fan_in), small biases.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from detail_tts_tpu_torch.io.torch_convert import translate

# JAX leaves with no counterpart in the port yet (VQ, posterior encoder,
# the GPT's training text head)
UNPORTED = ("params/quantizer/", "vq_state/", "params/enc_q/", "params/vq_",
            "params/gpt/text_head/")


def fold_weight_norm_tree(tree):
    """Replace every {v, g} conv entry with the folded ``kernel``:
    kernel = v * g / ||v||, the norm over all axes but the last."""
    if not isinstance(tree, dict):
        return tree
    if "v" in tree and "g" in tree and "kernel" not in tree:
        v = np.asarray(tree["v"], np.float32)
        norm = np.sqrt(np.sum(v ** 2, axis=tuple(range(v.ndim - 1))))
        kernel = v * (np.asarray(tree["g"], np.float32) / np.maximum(norm, 1e-12))
        rest = {k: fold_weight_norm_tree(x) for k, x in tree.items()
                if k not in ("v", "g")}
        return {"kernel": kernel, **rest}
    return {k: fold_weight_norm_tree(x) for k, x in tree.items()}


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, x in tree.items():
        path = f"{prefix}{k}"
        if isinstance(x, dict):
            out.update(_flatten(x, path + "/"))
        else:
            out[path] = x
    return out


def from_jax_variables(model: nn.Module, variables, diffusion_layers: int
                       ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """JAX variables -> (state_dict for ``model``, JAX paths left unused)."""
    flat = _flatten(fold_weight_norm_tree(variables))
    state: Dict[str, torch.Tensor] = {}
    for key, ref in model.state_dict().items():
        tr = translate(key, diffusion_layers=diffusion_layers)
        if tr is None or tr[0] not in flat:
            raise KeyError(f"port key {key} has no JAX leaf "
                           f"({tr[0] if tr else 'no translation'})")
        path, fn = tr
        value = np.array(fn(np.asarray(flat.pop(path), np.float32)))
        if value.shape != tuple(ref.shape):
            raise ValueError(f"{key}: JAX {path} has shape {value.shape}, "
                             f"port expects {tuple(ref.shape)}")
        state[key] = torch.from_numpy(value)
    unused = sorted(flat)
    stray = [p for p in unused if not p.startswith(UNPORTED)]
    if stray:
        raise KeyError(f"JAX leaves with no port key: {stray[:5]}")
    return state, unused


def _fan_in(module: nn.Module, weight: torch.Tensor) -> int:
    if isinstance(module, nn.ConvTranspose1d):  # (in, out, k) over stride
        return max(weight.shape[0] * weight.shape[2] // module.stride[0], 1)
    if isinstance(module, (nn.Conv1d, nn.Linear)):
        return weight[0].numel()
    return weight.shape[0]  # HF Conv1D (in, out)


@torch.no_grad()
def random_weights_(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter of ``model`` in place from ``seed``."""
    gen = None
    for mod_name, module in model.named_modules():
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
    return model
