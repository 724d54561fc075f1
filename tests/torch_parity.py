"""Shared fixtures for the PyTorch port's parity tests (tests/test_torch_*.py).

One set of seeded weights feeds both sides: every leaf of the JAX
``SynthesizerTrn`` variables (small config) is drawn from a seeded numpy
generator, then carried into the port with ``from_jax_variables``.  Filling
from numpy rather than from init matters: ``proj_out`` is zero-initialised,
which would make every ``AttentionBlock`` an identity.
"""
from __future__ import annotations

import functools
import re

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detail_tts_tpu.config import small_test_config
from detail_tts_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
from detail_tts_tpu.serving.pipeline import variables_template
from detail_tts_tpu_torch.config import small_test_config as port_small_config
from detail_tts_tpu_torch.io.weights import from_jax_variables
from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
from detail_tts_tpu_torch.nn.common import SeededDropout

LOG2E = 1.4426950408889634

# The suite runs several pytest workers at once, each beside JAX's own thread
# pool: one intra-op thread per worker keeps the small torch ops from
# oversubscribing the host's cores.
torch.set_num_threads(1)


def _leaf_name(path) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in path)


def seeded_variables(template, seed: int = 0):
    """Numpy leaves for a JAX variables template: norm scales near 1, small
    biases, kernels ~ N(0, 1/fan_in), T5 tables and VQ codebooks ~ N(0, 1);
    the rest of ``vq_state`` (EMA statistics, ``inited``) is 0."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = _leaf_name(path)
        shape, dtype = leaf.shape, np.dtype(leaf.dtype)
        if not np.issubdtype(dtype, np.floating) or (
                name.startswith("vq_state") and not name.endswith("/embed")):
            return np.zeros(shape, dtype)
        z = rng.standard_normal(shape).astype(np.float32)
        if name.startswith("vq_state"):  # the codebook: distinct rows
            return z
        if name.endswith("scale"):
            return 1.0 + 0.1 * z
        if name.endswith("bias"):
            return 0.1 * z
        if name.endswith("rel_pos/embedding") or "unconditioned" in name:
            return z
        if name.endswith("embedding"):
            return 0.3 * z
        if name.endswith("kernel"):
            return z / np.sqrt(max(int(np.prod(shape[:-1])), 1))
        return z / np.sqrt(shape[-1])  # rel-pos key/value tables

    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.asarray(fill(path, leaf), leaf.dtype), template)


@functools.lru_cache(maxsize=None)
def synth_pair(seed: int = 0):
    """(JAX module, JAX variables as jnp, port SynthesizerTrn fp32 on CPU)."""
    cfg = small_test_config()
    np_vars = seeded_variables(variables_template(cfg), seed)
    port = SynthesizerTrn(port_small_config())
    state, _ = from_jax_variables(port, np_vars, cfg.diffusion.num_layers)
    port.load_state_dict(state)
    port.eval().requires_grad_(False)
    jvars = jax.tree_util.tree_map(jnp.asarray, np_vars)
    return JaxSynth(cfg), jvars, port


def japply(fn, *args, **kwargs):
    """Run ``fn(synth_module, *args)`` inside the JAX synthesizer."""
    model, jvars, _ = synth_pair()
    return model.apply(jvars, *args, method=fn, **kwargs)


def t(x, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def close(port_out, jax_out, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(np.asarray(port_out, np.float32),
                               np.asarray(jax_out, np.float32),
                               atol=atol, rtol=rtol)


def no_dropout(model):
    """Every ``SeededDropout`` of ``model`` at p = 0 (nothing is drawn)."""
    for m in model.modules():
        if isinstance(m, SeededDropout):
            m.p = 0.0
    return model


@pytest.fixture
def jax_dropout_off(monkeypatch):
    """flax's ``Dropout`` as the identity: JAX's style encoders keep a fixed
    dropout of 0.1 that no config reaches."""
    monkeypatch.setattr(flax_nn.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)


def key_bias_mask(name, shape, cfg) -> np.ndarray:
    """The elements of a key projection's bias in port parameter ``name``:
    a softmax is invariant to them, so their gradient is 0 in exact
    arithmetic and fp32 noise in either framework, which Adam turns into an
    update of up to ~lr."""
    mask = np.zeros(shape, bool)
    if name.endswith("slf_attn.w_ks.bias") or re.search(r"attn_layers\.\d+\.conv_k\.bias$",
                                                         name):
        mask[:] = True
    elif name.endswith("attn.c_attn.bias"):  # GPT-2: [q | k | v]
        mask[cfg.gpt.model_dim:2 * cfg.gpt.model_dim] = True
    elif name.startswith("diffusion.") and name.endswith("qkv.bias"):  # [q, k, v] a head
        mask.reshape(cfg.diffusion.num_heads, 3, -1)[:, 1] = True
    return mask
