"""Shared fixtures for the PyTorch port's parity tests (tests/test_torch_*.py).

One set of seeded weights feeds both sides: every leaf of the JAX
``SynthesizerTrn`` variables (small config) is drawn from a seeded numpy
generator, then carried into the port with ``from_jax_variables``.  Filling
from numpy rather than from init matters: ``proj_out`` is zero-initialised,
which would make every ``AttentionBlock`` an identity.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from detail_tts_tpu.config import small_test_config
from detail_tts_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
from detail_tts_tpu.serving.pipeline import variables_template
from detail_tts_tpu_torch.config import small_test_config as port_small_config
from detail_tts_tpu_torch.io.weights import from_jax_variables
from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn

LOG2E = 1.4426950408889634

# The suite runs several pytest workers at once, each beside JAX's own thread
# pool: one intra-op thread per worker keeps the small torch ops from
# oversubscribing the host's cores.
torch.set_num_threads(1)


def _leaf_name(path) -> str:
    return "/".join(str(getattr(k, "key", k)) for k in path)


def seeded_variables(template, seed: int = 0):
    """Numpy leaves for a JAX variables template: norm scales near 1, small
    biases, kernels ~ N(0, 1/fan_in), T5 tables ~ N(0, 1)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = _leaf_name(path)
        shape, dtype = leaf.shape, np.dtype(leaf.dtype)
        if not np.issubdtype(dtype, np.floating) or name.startswith("vq_state"):
            return np.zeros(shape, dtype)
        z = rng.standard_normal(shape).astype(np.float32)
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
