"""Data parallelism: one process a card, an explicit gradient all-reduce.

Counterpart of ``detail_tts_tpu/parallel/mesh.py``'s ``data`` axis (the
reference's Accelerate DDP, train.py:88,132-133).  Under ``jax.jit`` the
JAX step sees the global batch and XLA inserts the collectives; here each
rank sees only its rows, so every place where the step reads the whole
batch is a collective of its own, named in the step and the modules:

* the gradients, summed over the ranks and divided by the world *before*
  the clip and the update (:func:`all_reduce_grads`, bucketed; a missing
  gradient counts as zeros), once a backward;
* the step's loss scalars, averaged in one collective
  (:func:`reduce_metrics`); every loss but the masked KL is an unmasked
  mean over equally sized shards, so the average is the global value;
* the random draws: every rank draws for the global batch from the step's
  generator, identical on every rank, and keeps its rows
  (:func:`shard_rows`); rows that a draw needs from every rank (the GAN
  step's lengths, the quantizer's k-means samples) come through
  :func:`all_gather_rows`.

``group=None`` everywhere means no process group: rank 0 of world 1, no
collective.  A world-1 group runs every collective and gives the same bits.
Collectives of host values (padding sizes, generator states) run on the
backend's device: the current card under NCCL, the CPU under gloo.  gloo
carries CUDA tensors for ``all_reduce`` and ``broadcast`` only, so a gather
is an ``all_reduce`` of zero-filled per-rank slots, and nothing here needs
another collective: two ranks can share one card over gloo.

Tensor parallelism over ``MeshConfig.model_parallel`` (JAX's ``model``
axis, ``mesh.py:42-58``) is not ported.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from detail_tts_tpu_torch.config import Config

# Gradient elements a bucket of the all-reduce holds (128 MB of fp32).
BUCKET_ELEMENTS = 32 * 1024 * 1024


def init_distributed(init_method: Optional[str] = None, backend: Optional[str] = None,
                     device="cuda", rank: Optional[int] = None,
                     world_size: Optional[int] = None):
    """Join the default process group; returns ``(group, device)``.

    Rank and world come from torchrun's ``RANK`` and ``WORLD_SIZE`` unless
    given, and ``init_method`` defaults to torchrun's ``env://`` rendezvous.
    On ``device`` ``cuda`` the rank takes ``cuda:LOCAL_RANK`` (a device
    with an index keeps it) and the backend defaults to ``nccl``; on the
    CPU to ``gloo``."""
    dev = torch.device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass device='cpu' to train on "
                               "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    # NCCL is told its card (else it guesses it from the global rank)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size,
                            device_id=dev if backend == "nccl" else None)
    return dist.group.WORLD, dev


def rank(group=None) -> int:
    return 0 if group is None else dist.get_rank(group)


def world(group=None) -> int:
    return 1 if group is None else dist.get_world_size(group)


def check_mesh(cfg: Config, group=None) -> None:
    """``cfg.mesh`` against the world: ``data_parallel`` is -1 (every
    rank) or the world; ``model_parallel`` above 1 is not ported."""
    m = cfg.mesh
    if m.model_parallel > 1:
        raise NotImplementedError(
            f"model_parallel={m.model_parallel}: tensor parallelism of the GPT is not "
            "ported yet (ROADMAP A7); train with model_parallel=1")
    if m.data_parallel not in (-1, world(group)):
        raise ValueError(f"mesh.data_parallel={m.data_parallel} but the world is "
                         f"{world(group)} processes (-1 takes them all)")


def rank_generator(seed: int, device, group=None) -> torch.Generator:
    """This rank's dropout generator, seeded from (``seed``, rank): each
    rank draws its own masks, as one mask over JAX's global array does."""
    state = np.random.SeedSequence([seed, rank(group)]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def _collective_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_rows(x: torch.Tensor, group=None, axis: int = 0) -> torch.Tensor:
    """This rank's contiguous share of ``x`` along ``axis`` (rank r of W
    takes rows [r n/W, (r+1) n/W)); raises if W does not divide n."""
    w = world(group)
    if w == 1:
        return x
    n = x.shape[axis]
    if n % w:
        raise ValueError(f"{n} rows do not split over a world of {w}")
    return x.narrow(axis, rank(group) * (n // w), n // w)


def shard_batch(batch: Mapping[str, torch.Tensor], group=None,
                batch_axis: int = 0) -> Dict[str, torch.Tensor]:
    """Every leaf's share along ``batch_axis`` (JAX's ``shard_batch``)."""
    return {k: shard_rows(v, group, batch_axis) for k, v in batch.items()}


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, ...) on every rank -> (W n, ...) in rank order, as one
    ``all_reduce`` of zero-filled per-rank slots (exact: each element is a
    sum of one value and zeros)."""
    w = world(group)
    if w == 1:
        return x
    slots = x.new_zeros((w,) + tuple(x.shape))
    slots[rank(group)] = x
    dist.all_reduce(slots, group=group)
    return slots.reshape((w * x.shape[0],) + tuple(x.shape[1:]))


def all_gather_host(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's small CPU tensor ``x`` (a generator state, a few
    readings) stacked in rank order, (W, ...) on the CPU, through the
    backend's device (summed as int64 or float64, so exactly)."""
    wide = torch.float64 if x.is_floating_point() else torch.int64
    out = all_gather_rows(x.to(_collective_device(group), wide)[None], group)
    return out.to("cpu", x.dtype)


def all_reduce_max_host(values: Iterable[int], group) -> List[int]:
    """The elementwise max over the ranks of a few host integers."""
    t = torch.tensor(list(values), dtype=torch.int64, device=_collective_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.tolist()


def _buckets(tensors: List[torch.Tensor]) -> List[List[int]]:
    """Indices of ``tensors`` in buckets of one dtype and device, each of
    at most :data:`BUCKET_ELEMENTS` unless one tensor alone is larger."""
    out: List[List[int]] = []
    open_: Dict[Tuple, Tuple[List[int], int]] = {}
    for i, t in enumerate(tensors):
        key = (t.dtype, t.device)
        idx, n = open_.get(key, ([], 0))
        if idx and n + t.numel() > BUCKET_ELEMENTS:
            out.append(idx)
            idx, n = [], 0
        idx.append(i)
        open_[key] = (idx, n + t.numel())
    out.extend(idx for idx, _ in open_.values())
    return out


def _coalesced(tensors: List[torch.Tensor], collective) -> None:
    """Run ``collective(flat)`` on each bucket of ``tensors`` flattened,
    then copy the result back in place."""
    for idx in _buckets(tensors):
        part = [tensors[i] for i in idx]
        flat = torch.cat([t.reshape(-1) for t in part])
        collective(flat)
        for t, f in zip(part, flat.split([t.numel() for t in part])):
            t.copy_(f.view_as(t))


@torch.no_grad()
def all_reduce_grads(params: List[torch.nn.Parameter], group=None) -> None:
    """Average the gradients of ``params`` over the ranks in place, in
    buckets; a parameter without a gradient gets zeros first (it counts as
    zeros, as optax treats it).  Nothing happens without a group."""
    if group is None:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    w = float(world(group))

    def average(flat):
        dist.all_reduce(flat, group=group)
        flat.div_(w)

    _coalesced([p.grad for p in params], average)


@torch.no_grad()
def replicate_tree(module: torch.nn.Module, group=None) -> None:
    """Rank 0's parameters and buffers of ``module`` on every rank, in place,
    in buckets (the counterpart of JAX's ``replicate_tree``, which makes one
    replicated state for all)."""
    if group is None:
        return
    tensors = [t for t in module.state_dict().values() if t.numel()]
    src = dist.get_global_rank(group, 0)
    _coalesced(tensors, lambda flat: dist.broadcast(flat, src, group=group))


@torch.no_grad()
def reduce_metrics(metrics: Dict[str, object], names: Iterable[str],
                   group=None) -> Dict[str, object]:
    """The 0-d tensors ``metrics[name]`` for ``names`` averaged over the
    ranks in one collective; other entries are returned as they are."""
    names = [n for n in names if torch.is_tensor(metrics.get(n))]
    if group is None or not names:
        return metrics
    flat = torch.stack([metrics[n].detach().float() for n in names])
    dist.all_reduce(flat, group=group)
    flat.div_(float(world(group)))
    return {**metrics, **dict(zip(names, flat.unbind()))}


def barrier(group=None) -> None:
    if group is not None:
        dist.barrier(group=group)
