"""Residual vector quantizer with an EMA codebook (quantize.py, core_vq.py).

Counterpart of ``detail_tts_tpu/models/quantizer.py``: nearest-codebook ids
after a ``project_in`` bottleneck (dim -> codebook_dim) and the lookup back
through ``project_out`` (``encode``/``decode``, frozen code extraction and
serving), and the training call (``forward``, target ``vqvae`` and ``all``):
k-means initialisation on the first batch (at most 500 samples), dead-code
expiry, the EMA of ``cluster_size``/``embed_avg`` (decay 0.99, Laplace
smoothing 1e-5), the straight-through estimator and the commitment MSE.
The returned vectors come from the codebook before the update, as in the
reference.  The codebook ``embed`` and its EMA state (``cluster_size``,
``embed_avg``, ``inited``, a 0-d buffer as the JAX package's ``vq_state``
keeps it) are registered buffers under the reference's state-dict names,
updated in place.  Distances and k-means run in fp32 with autocast off.

The random draws of a training call (the k-means initial rows and the
expiry replacements) come in a :class:`VQDraws` drawn from the step's
generator by :func:`draw_codebook`, or handed in (the tests hand in JAX's).

Under data parallelism the training call takes the process group where the
JAX module takes ``axis_name`` (quantizer.py:108-170): the mesh's **data**
group, over which every collective here runs (the k-means gather, the
expiry rows, the EMA sums).  Model peers of a (D x M) mesh hold the same
rows, so a collective over the world would count each row M times and
misplace the expiry rows.  The draws index
the *global* flattened vectors, rank r's local rows at offsets [r n, (r+1) n):
the k-means samples are every rank's first 500 rows gathered in rank order
and cut to 500 (the global batch's first 500), so every rank runs the same
k-means; the expiry rows are the global rows, each rank filling its own
share into one sum (the EMA write overwrites them, core_vq.py:217-229, as
JAX's replica-0 rows are); the EMA ``counts`` and ``embed_sum`` are summed
over the ranks in one collective before the update.  Every rank then holds
the world-1 codebook of the global batch, up to the order of that sum.
"""
from __future__ import annotations


from typing import NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.distributed as dist
import torch.nn.functional as F

from port_bench.reference.common import Dense
from port_bench.reference.mesh import all_gather_rows, rank

KMEANS_SAMPLE_CAP = 500


class VQDraws(NamedTuple):
    """Row indices into one training call's flattened vectors, one row of
    each per RVQ layer."""

    kmeans: torch.Tensor   # (n_q, bins) in [0, min(N, 500)): k-means initial means
    expire: torch.Tensor   # (n_q, bins) in [0, N): dead-code replacements


def draw_codebook(n_q: int, bins: int, n_vectors: int, generator,
                  device) -> VQDraws:
    """Draw the k-means and then the expiry indices for a call on
    ``n_vectors`` flattened vectors (both with replacement)."""
    cap = min(n_vectors, KMEANS_SAMPLE_CAP)
    kmeans = torch.randint(0, cap, (n_q, bins), generator=generator, device=device)
    expire = torch.randint(0, n_vectors, (n_q, bins), generator=generator,
                           device=device)
    return VQDraws(kmeans, expire)


def _sq_dist(x: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
    """(N, D), (C, D) -> (N, C) squared L2 distances, fp32."""
    return (x.square().sum(-1, keepdim=True) - 2.0 * x @ means.t()
            + means.square().sum(-1)[None, :])


def _kmeans(samples: torch.Tensor, init_idx: torch.Tensor,
            num_iters: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) samples, initial means ``samples[init_idx]`` -> (means (C, D),
    bins (C,)) after ``num_iters`` Lloyd steps; a cluster left empty keeps
    its mean (core_vq.py:71-93).  Sums go through one-hot products, as in
    JAX, so a repeated call is bit-identical on the card."""
    means = samples[init_idx]
    c = init_idx.shape[0]
    for _ in range(num_iters):
        onehot = F.one_hot(_sq_dist(samples, means).argmin(-1), c).to(samples.dtype)
        bins = onehot.sum(0)
        new_means = onehot.t() @ samples / bins.clamp_min(1.0)[:, None]
        means = torch.where((bins == 0)[:, None], means, new_means)
    bins = F.one_hot(_sq_dist(samples, means).argmin(-1), c).to(samples.dtype).sum(0)
    return means, bins


def _global_rows(flat: torch.Tensor, idx: torch.Tensor, group=None) -> torch.Tensor:
    """Rows ``idx`` of the vectors of every rank stacked in rank order: each
    rank fills the rows it holds, zeros elsewhere, and one sum joins them."""
    if group is None:
        return flat[idx]
    n = flat.shape[0]
    local = idx - rank(group) * n
    mine = (local >= 0) & (local < n)
    rows = torch.where(mine[:, None], flat[local.clamp(0, n - 1)], 0.0)
    dist.all_reduce(rows, group=group)
    return rows


class EuclideanCodebook(nn.Module):
    def __init__(self, codebook_size: int, dim: int, decay: float = 0.99,
                 epsilon: float = 1e-5, threshold_ema_dead_code: float = 2.0,
                 kmeans_iters: int = 50):
        super().__init__()
        self.codebook_size, self.dim = codebook_size, dim
        self.decay, self.epsilon = decay, epsilon
        self.threshold_ema_dead_code, self.kmeans_iters = threshold_ema_dead_code, kmeans_iters
        self.register_buffer("inited", torch.zeros(()))
        self.register_buffer("cluster_size", torch.zeros(codebook_size))
        self.register_buffer("embed", torch.zeros(codebook_size, dim))
        self.register_buffer("embed_avg", torch.zeros(codebook_size, dim))

    def quantize_ids(self, x: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (...,) nearest-codebook indices, distances in fp32
        (autocast off: the JAX package keeps this product in fp32)."""
        flat = x.reshape(-1, self.dim).float()
        dist = _sq_dist(flat, self.embed.float())
        return dist.argmin(dim=-1).reshape(x.shape[:-1])

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embed[ids]

    @torch.no_grad()
    def forward(self, x: torch.Tensor, kmeans_idx: torch.Tensor,
                expire_idx: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The training call on (..., D): (quantized from the codebook before
        the update, ids), then the codebook state updated in place
        (core_vq.py:96-231).  Whether to initialise is read from ``inited``
        on the host.  ``group``: the data-parallel process group (the
        indices are then into the global vectors)."""
        flat = x.reshape(-1, self.dim).float()
        if not bool(self.inited):
            samples = all_gather_rows(flat[:KMEANS_SAMPLE_CAP], group)
            embed, bins = _kmeans(samples[:KMEANS_SAMPLE_CAP], kmeans_idx,
                                  self.kmeans_iters)
            self.embed.copy_(embed)
            self.embed_avg.copy_(embed)
            self.cluster_size.copy_(bins)
            self.inited.fill_(1.0)
        ids = self.quantize_ids(flat)
        quantized = self.lookup(ids)
        # dead-code expiry, read from the counts before this update; the
        # EMA write below overwrites the replaced rows, as the reference's
        # does (core_vq.py:217-229)
        expired = self.cluster_size < self.threshold_ema_dead_code
        self.embed.copy_(torch.where(expired[:, None], _global_rows(flat, expire_idx, group),
                                     self.embed))
        onehot = F.one_hot(ids, self.codebook_size).float()
        counts, embed_sum = onehot.sum(0), onehot.t() @ flat
        if group is not None:  # one sum over the ranks: JAX's psum
            stats = torch.cat([counts[:, None], embed_sum], dim=1)
            dist.all_reduce(stats, group=group)
            counts, embed_sum = stats[:, 0], stats[:, 1:]
        d = self.decay
        self.cluster_size.mul_(d).add_(counts * (1 - d))
        self.embed_avg.mul_(d).add_(embed_sum * (1 - d))
        n = self.cluster_size.sum()
        smoothed = ((self.cluster_size + self.epsilon)
                    / (n + self.codebook_size * self.epsilon) * n)
        self.embed.copy_(self.embed_avg / smoothed[:, None])
        return quantized.reshape(x.shape), ids.reshape(x.shape[:-1])


class VectorQuantization(nn.Module):
    """One VQ layer with its projection bottleneck (core_vq.py:234-323)."""

    def __init__(self, dim: int, codebook_size: int, codebook_dim: int = 8, **codebook):
        super().__init__()
        needs_proj = codebook_dim != dim
        self.project_in = Dense(dim, codebook_dim) if needs_proj else nn.Identity()
        self.project_out = Dense(codebook_dim, dim) if needs_proj else nn.Identity()
        self._codebook = EuclideanCodebook(codebook_size, codebook_dim, **codebook)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self._codebook.quantize_ids(self.project_in(x))

    def decode(self, ids: torch.Tensor) -> torch.Tensor:
        return self.project_out(self._codebook.lookup(ids))

    def forward(self, x: torch.Tensor, kmeans_idx: torch.Tensor,
                expire_idx: torch.Tensor, group=None):
        """Training call: (quantized through the straight-through estimator
        and ``project_out``, ids, commitment MSE in fp32)."""
        z = self.project_in(x)
        q, ids = self._codebook(z, kmeans_idx, expire_idx, group)
        commit = (q - z.float()).square().mean()
        return self.project_out(z + (q.to(z.dtype) - z).detach()), ids, commit


class ResidualVectorQuantization(nn.Module):
    def __init__(self, n_q: int, **kwargs):
        super().__init__()
        self.layers = nn.ModuleList([VectorQuantization(**kwargs) for _ in range(n_q)])


class ResidualVectorQuantizer(nn.Module):
    """RVQ over n_q layers (n_q = 1 in the live config) (quantize.py:28-120)."""

    def __init__(self, dimension: int, n_q: int = 1, bins: int = 8192,
                 codebook_dim: int = 8, decay: float = 0.99,
                 threshold_ema_dead_code: float = 2.0, kmeans_iters: int = 50):
        super().__init__()
        self.n_q, self.bins = n_q, bins
        self.vq = ResidualVectorQuantization(
            n_q, dim=dimension, codebook_size=bins, codebook_dim=codebook_dim,
            decay=decay, threshold_ema_dead_code=threshold_ema_dead_code,
            kmeans_iters=kmeans_iters)

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

    def forward(self, x: torch.Tensor, draws: VQDraws, group=None):
        """Training call on (B, T, dimension): (quantized, ids (n_q, B, T),
        commitment loss averaged over the layers).  ``group``: the
        data-parallel process group, ``draws`` then index the global
        vectors."""
        residual, out, all_ids, losses = x, torch.zeros_like(x), [], []
        for i, layer in enumerate(self.vq.layers):
            q, ids, commit = layer(residual, draws.kmeans[i], draws.expire[i], group)
            residual = residual - q
            out = out + q
            all_ids.append(ids)
            losses.append(commit)
        return out, torch.stack(all_ids), torch.stack(losses).mean()
