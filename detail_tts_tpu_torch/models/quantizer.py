"""Residual vector quantizer, encode/decode subset (quantize.py, core_vq.py).

Counterpart of ``detail_tts_tpu/models/quantizer.py`` for frozen code
extraction: nearest-codebook ids after a ``project_in`` bottleneck (dim ->
codebook_dim) and the lookup back through ``project_out``.  The codebook
``embed`` and its EMA state (``cluster_size``, ``embed_avg``, ``inited``) are
registered buffers under the reference's state-dict names, so they carry
across with the weights.  k-means init, the EMA update and dead-code expiry
belong to the VQ-VAE training target and are not ported yet.  ``inited`` is
a 0-d buffer, as the JAX package's ``vq_state`` keeps it.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from detail_tts_tpu_torch.nn.common import Dense


class EuclideanCodebook(nn.Module):
    def __init__(self, codebook_size: int, dim: int):
        super().__init__()
        self.codebook_size, self.dim = codebook_size, dim
        self.register_buffer("inited", torch.zeros(()))
        self.register_buffer("cluster_size", torch.zeros(codebook_size))
        self.register_buffer("embed", torch.zeros(codebook_size, dim))
        self.register_buffer("embed_avg", torch.zeros(codebook_size, dim))

    def quantize_ids(self, x: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (...,) nearest-codebook indices, distances in fp32
        (autocast off: the JAX package keeps this product in fp32)."""
        flat = x.reshape(-1, self.dim).float()
        embed = self.embed.float()
        with torch.autocast(device_type=flat.device.type, enabled=False):
            dist = (flat.square().sum(-1, keepdim=True) - 2.0 * flat @ embed.t()
                    + embed.square().sum(-1)[None, :])
        return dist.argmin(dim=-1).reshape(x.shape[:-1])

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embed[ids]


class VectorQuantization(nn.Module):
    """One VQ layer with its projection bottleneck (core_vq.py:234-323)."""

    def __init__(self, dim: int, codebook_size: int, codebook_dim: int = 8):
        super().__init__()
        needs_proj = codebook_dim != dim
        self.project_in = Dense(dim, codebook_dim) if needs_proj else nn.Identity()
        self.project_out = Dense(codebook_dim, dim) if needs_proj else nn.Identity()
        self._codebook = EuclideanCodebook(codebook_size, codebook_dim)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self._codebook.quantize_ids(self.project_in(x))

    def decode(self, ids: torch.Tensor) -> torch.Tensor:
        return self.project_out(self._codebook.lookup(ids))


class ResidualVectorQuantization(nn.Module):
    def __init__(self, n_q: int, **kwargs):
        super().__init__()
        self.layers = nn.ModuleList([VectorQuantization(**kwargs) for _ in range(n_q)])


class ResidualVectorQuantizer(nn.Module):
    """RVQ over n_q layers (n_q = 1 in the live config) (quantize.py:28-120)."""

    def __init__(self, dimension: int, n_q: int = 1, bins: int = 8192,
                 codebook_dim: int = 8):
        super().__init__()
        self.vq = ResidualVectorQuantization(n_q, dim=dimension, codebook_size=bins,
                                             codebook_dim=codebook_dim)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, dimension) -> ids (n_q, B, T)."""
        residual, all_ids = x, []
        for layer in self.vq.layers:
            ids = layer.encode(residual)
            residual = residual - layer.decode(ids).to(residual.dtype)
            all_ids.append(ids)
        return torch.stack(all_ids)

    def decode(self, ids: torch.Tensor) -> torch.Tensor:
        """ids (n_q, B, T) -> (B, T, dimension)."""
        out = None
        for i, layer in enumerate(self.vq.layers):
            q = layer.decode(ids[i])
            out = q if out is None else out + q
        return out
