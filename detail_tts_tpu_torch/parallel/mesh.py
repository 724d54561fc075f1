"""The (data, model) mesh: one process a card, explicit collectives.

Counterpart of ``detail_tts_tpu/parallel/mesh.py`` (the reference's
Accelerate DDP, train.py:88,132-133, plus JAX's ``model`` axis).  Rank r of
a (D x M) mesh sits at (r // M, r % M), as JAX's
``np.asarray(devices).reshape(data, model)`` places its devices, and
:class:`Mesh` holds two process groups: the ``data`` group of its column
(the ranks that hold other rows and the same shard) and the ``model`` group
of its row (the ranks that hold the same rows and other shards of the GPT).
Under ``jax.jit`` the JAX step sees global arrays and XLA inserts the
collectives; here each rank holds only its rows and its shard, so every
place where the step reads a whole tensor is a collective of its own.

Over the **data** group (the rows):

* the gradients, summed over the ranks and divided by D *before* the clip
  and the update (:func:`all_reduce_grads`, bucketed; a missing gradient
  counts as zeros), once a backward;
* the step's loss scalars, averaged in one collective
  (:func:`reduce_metrics`); every loss but the masked KL is an unmasked
  mean over equally sized shards, so the average is the global value;
* the training step's random draws: every rank draws for the global batch
  from the step's generator, identical on every rank, and keeps its rows
  (:func:`shard_rows`; serving draws a rank's rows alone, from JAX's
  threefry keys, ``ops/prng.py``); rows that a draw needs from
  every rank (the GAN step's lengths, the quantizer's k-means samples)
  come through :func:`all_gather_rows`.  Model peers hold the same rows, so
  a collective over the world would count them M times.

Over the **model** group (Megatron tensor parallelism of the GPT, JAX's
``PARTITION_RULES``): :func:`shard_module_` keeps this rank's slice of
every tensor that :data:`PARTITION_RULES` splits, and the GPT's forward
runs the region operators (:func:`copy_to_model`,
:func:`reduce_from_model`, :func:`gather_from_model`) and the
vocab-parallel cross-entropy (:func:`vocab_parallel_cross_entropy`), each
an autograd function whose backward is the matching collective; the grad
norm sums each sharded tensor's squares over it (``train/optim.py``).

``group=None`` (and a ``None`` group of a mesh axis of size 1) means no
collective.  A world-1 group runs every collective and gives the same bits.
Collectives of host values (padding sizes, generator states) run on the
backend's device: the current card under NCCL, the CPU under gloo.  gloo
carries CUDA tensors for ``all_reduce`` and ``broadcast`` only, so a gather
is an ``all_reduce`` of zero-filled per-rank slots (exact: each element is
a sum of one value and zeros), and nothing here needs another collective:
two ranks can share one card over gloo.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, Iterable, List, Mapping, NamedTuple, Optional, Tuple

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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (``data`` x ``model``) mesh of the world's ranks.  ``rank`` is this
    process's rank in ``world_group``; ``data_group`` is the column of its
    model rank (``None`` when ``data`` is 1), ``model_group`` the row of its
    data rank (``None`` when ``model`` is 1)."""

    data: int = 1
    model: int = 1
    rank: int = 0
    world_group: Any = None
    data_group: Any = None
    model_group: Any = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    def rows(self, n: int) -> "Rows":
        """This data rank's contiguous share of ``n`` rows; every row when
        ``data`` does not divide ``n`` (JAX's ``shard_batch`` replicates a
        leaf it cannot split)."""
        if n % self.data:
            return Rows(0, n, n)
        k = n // self.data
        return Rows(self.data_rank * k, (self.data_rank + 1) * k, n)


def _data_axis(data: int, model: int, w: int) -> int:
    """The data axis of a (``data`` x ``model``) mesh over ``w`` processes
    (``data`` -1 takes what ``model`` leaves); raises, naming the config
    field, where the two do not make the world."""
    if model < 1:
        raise ValueError(f"mesh.model_parallel={model} must be at least 1")
    if data == -1:
        if w % model:
            raise ValueError(f"mesh.model_parallel={model} does not divide the world of "
                             f"{w} processes")
        return w // model
    if data * model != w:
        raise ValueError(f"mesh.data_parallel={data} x mesh.model_parallel={model} is not "
                         f"the world of {w} processes (data_parallel -1 takes them all)")
    return data


def make_mesh(data: int = -1, model: int = 1, group=None) -> Mesh:
    """The (data, model) mesh over ``group``'s ranks (``data`` -1 takes all
    that ``model`` leaves).  Every rank of ``group`` must call it, in the
    same order, since it makes the axes' process groups (one
    ``dist.new_group`` a row and a column, every rank making every group).
    An axis of size 1 has no group; a data axis of the whole world is
    ``group`` itself, and so is a model axis of the whole world."""
    w = world(group)
    data = _data_axis(data, model, w)
    if group is None:
        return Mesh()
    me = rank(group)
    ranks = [dist.get_global_rank(group, i) for i in range(w)]
    data_group = model_group = None
    if data > 1:
        if model == 1:
            data_group = group
        else:
            for m in range(model):
                g = dist.new_group([ranks[d * model + m] for d in range(data)])
                if me % model == m:
                    data_group = g
    if model > 1:
        if data == 1:
            model_group = group
        else:
            for d in range(data):
                g = dist.new_group([ranks[d * model + m] for m in range(model)])
                if me // model == d:
                    model_group = g
    return Mesh(data, model, me, group, data_group, model_group)


def check_mesh(cfg: Config, group=None) -> None:
    """``cfg.mesh`` against the world and the GPT: ``data_parallel`` x
    ``model_parallel`` is the world (``data_parallel`` -1 takes what
    ``model_parallel`` leaves), and ``model_parallel`` divides the GPT's
    heads, width and MLP width (the trunk is always split; only the heads
    and the mel embedding may be demoted to replication)."""
    m, g = cfg.mesh, cfg.gpt
    _data_axis(m.data_parallel, m.model_parallel, world(group))
    for field, size in (("gpt.heads", g.heads), ("gpt.model_dim", g.model_dim),
                        ("4 x gpt.model_dim", 4 * g.model_dim)):
        if size % m.model_parallel:
            raise ValueError(f"mesh.model_parallel={m.model_parallel} does not divide "
                             f"{field} = {size}")


def rank_generator(seed: int, device, group=None) -> torch.Generator:
    """This rank's dropout generator, seeded from (``seed``, its rank in
    ``group``): each rank draws its own masks, as one mask over JAX's global
    array does.  The trainer passes the data group, so model peers, whose
    activations outside the GPT's sharded heads must stay equal, draw the
    same masks."""
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


# ---------------------------------------------------------------------------
# A data rank's rows of a global batch
# ---------------------------------------------------------------------------


class Rows(NamedTuple):
    """Rows [start, stop) of a global batch of ``total`` rows."""

    start: int
    stop: int
    total: int


# ---------------------------------------------------------------------------
# Tensor parallelism of the GPT over the model axis
# ---------------------------------------------------------------------------

# (port parameter name, the axis split over the model group, blocks): the
# port's copy of JAX's PARTITION_RULES (mesh.py:46-60), first match wins,
# every other tensor replicated.  HF ``Conv1D`` keeps (in, out) weights, so
# JAX's column split of a kernel is axis 1 of c_attn/c_fc and its row split
# axis 0 of the projections; the heads are ``nn.Linear`` (out, in).  c_attn
# is split by head across each of q, k and v (blocks 3: this rank's heads of
# each), where JAX's layout takes one contiguous column block; under
# ``jax.jit`` that is a layout only, so both are the same function.  The
# heads' biases follow their weights (JAX replicates them, a layout again):
# each rank adds its slice to its own logits.
PARTITION_RULES: Tuple[Tuple[str, int, int], ...] = (
    (r"gpt\.gpt\.h\.\d+\.attn\.c_attn\.weight", 1, 3),
    (r"gpt\.gpt\.h\.\d+\.attn\.c_attn\.bias", 0, 3),
    (r"gpt\.gpt\.h\.\d+\.attn\.c_proj\.weight", 0, 1),
    (r"gpt\.gpt\.h\.\d+\.mlp\.c_fc\.weight", 1, 1),
    (r"gpt\.gpt\.h\.\d+\.mlp\.c_fc\.bias", 0, 1),
    (r"gpt\.gpt\.h\.\d+\.mlp\.c_proj\.weight", 0, 1),
    (r"gpt\.mel_head\.(weight|bias)", 0, 1),
    (r"gpt\.text_head\.(weight|bias)", 0, 1),
    (r"gpt\.mel_embedding\.weight", 0, 1),
)


class Shard(NamedTuple):
    """This rank's place in the model group: (group, rank, size), and for a
    sharded tensor the axis it is split on and its blocks (each block split
    alike: c_attn's q, k and v)."""

    group: Any
    rank: int
    size: int
    axis: int = 0
    blocks: int = 1


def partition_spec(name: str, shape, model: int) -> Optional[Tuple[int, int]]:
    """(axis, blocks) of a tensor under :data:`PARTITION_RULES` at a model
    axis of ``model``, or None (replicated).  An axis that ``model`` does not
    split evenly per block is demoted to replication, as JAX's
    ``partition_specs`` does (mesh.py:84-93): at ``Config()`` the 257-wide
    ``text_head`` under M = 2 and 4, the 8194-wide ``mel_head`` and
    ``mel_embedding`` under M = 4."""
    for pattern, axis, blocks in PARTITION_RULES:
        if re.fullmatch(pattern, name):
            if model == 1 or len(shape) <= axis or shape[axis] % (blocks * model):
                return None
            return axis, blocks
    return None


def shard_tensor(full: torch.Tensor, shard: Shard) -> torch.Tensor:
    """This rank's slice of ``full`` (a contiguous copy)."""
    n = full.shape[shard.axis]
    blocks = full.unflatten(shard.axis, (shard.blocks, shard.size,
                                         n // (shard.blocks * shard.size)))
    return blocks.select(shard.axis + 1, shard.rank).flatten(
        shard.axis, shard.axis + 1).contiguous()


def gather_tensor(local: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The full tensor from every rank's ``local`` slice (a collective over
    the model group; the inverse of :func:`shard_tensor`)."""
    slots = _gather_slots(local, shard)  # (size, *local.shape)
    a, k = shard.axis, local.shape[shard.axis] // shard.blocks
    parts = slots.unflatten(a + 1, (shard.blocks, k)).movedim(0, a + 1)
    return parts.flatten(a, a + 2).contiguous()


def shard_module_(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Keep this rank's slice of every parameter that
    :data:`PARTITION_RULES` splits over ``mesh.model`` (in place: the
    ``Parameter`` objects stay, so build the optimizer after, and it holds
    shards), mark it with its :class:`Shard` (``param.model_shard``), and
    hand the model group to every submodule that declares a ``tp`` class
    attribute (the GPT's attention, MLP and ``UnifiedVoice``).  Nothing
    happens at ``mesh.model`` 1.  :func:`describe_shards` says what it
    did."""
    if mesh.model == 1:
        return module
    with torch.no_grad():
        for name, p in module.named_parameters():
            if getattr(p, "model_shard", None) is not None:
                raise ValueError(f"{name} is sharded already")
            spec = partition_spec(name, tuple(p.shape), mesh.model)
            if spec is not None:
                p.model_shard = Shard(mesh.model_group, mesh.model_rank, mesh.model, *spec)
                p.data = shard_tensor(p.data, p.model_shard)
    tp = Shard(mesh.model_group, mesh.model_rank, mesh.model)
    for m in module.modules():
        if hasattr(type(m), "tp"):
            m.tp = tp
    return module


def describe_shards(module: torch.nn.Module, mesh: Mesh) -> str:
    """One line: the resolved spec of each tensor of ``module`` that a rule
    of :data:`PARTITION_RULES` names, at its full shape (a layer's tensors
    once, with their count), so that the demotions to replication show.
    The run's owner (the trainer, a serving script) prints it once."""
    specs: Dict[str, int] = {}
    for name, p in module.named_parameters():
        if not any(re.fullmatch(rule[0], name) for rule in PARTITION_RULES):
            continue
        shard = getattr(p, "model_shard", None)
        shape = list(p.shape)
        if shard is None:
            what = f"replicated (does not split over {mesh.model})"
        else:
            shape[shard.axis] *= shard.size
            what = f"axis {shard.axis} over 'model'" + (" by head of q, k and v"
                                                        if shard.blocks > 1 else "")
        key = f"{re.sub(r'[.]h[.][0-9]+[.]', '.h.N.', name)} {tuple(shape)}: {what}"
        specs[key] = specs.get(key, 0) + 1
    return f"mesh ({mesh.data} x {mesh.model}): " + "; ".join(
        key + (f" (x{n})" if n > 1 else "") for key, n in specs.items())


def model_shards(module: torch.nn.Module) -> Dict[str, Shard]:
    """The :class:`Shard` of each sharded parameter of ``module`` by name."""
    return {n: p.model_shard for n, p in module.named_parameters()
            if getattr(p, "model_shard", None) is not None}


def gather_state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every sharded tensor gathered whole (a
    collective over the model group: every model peer calls it)."""
    sd = module.state_dict()
    for name, shard in model_shards(module).items():
        sd[name] = gather_tensor(sd[name], shard)
    return sd


def localize_tensor(t: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """This rank's slice of ``t`` where ``param`` is sharded and ``t`` has
    its full shape; else ``t``."""
    shard = getattr(param, "model_shard", None)
    if shard is None:
        return t
    full = list(param.shape)
    full[shard.axis] *= shard.size
    return shard_tensor(t, shard) if list(t.shape) == full else t


def localize(tensors: Mapping[str, torch.Tensor], module: torch.nn.Module
             ) -> Dict[str, torch.Tensor]:
    """Full tensors keyed by ``module``'s names -> this rank's slices of the
    sharded parameters' (:func:`localize_tensor`); the rest as they are."""
    out = dict(tensors)
    for name, p in module.named_parameters():
        if name in out:
            out[name] = localize_tensor(out[name], p)
    return out


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over ``group`` (a new tensor); half types are summed in
    fp32, as a matmul's accumulator sums, and cast back."""
    y = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def _gather_slots(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """(size, *x.shape): every model peer's ``x`` in rank order, as one sum
    of zero-filled slots."""
    wide = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
    slots = x.new_zeros((shard.size,) + tuple(x.shape), dtype=wide)
    slots[shard.rank] = x
    dist.all_reduce(slots, group=shard.group)
    return slots.to(x.dtype)


def _gather_last(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    slots = _gather_slots(x, shard)
    return slots.movedim(0, -2).reshape(tuple(x.shape[:-1]) + (-1,))


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _gather_last(x, shard)

    @staticmethod
    def backward(ctx, grad):
        s = ctx.shard
        n = grad.shape[-1] // s.size
        return grad.narrow(-1, s.rank * n, n).contiguous(), None


def copy_to_model(x: torch.Tensor, tp: Optional[Shard]) -> torch.Tensor:
    """Megatron's f: identity forward, sum over the model group backward
    (the input of a column-parallel layer, whose replicated input gets a
    partial gradient from each shard)."""
    return x if tp is None else _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: Optional[Shard]) -> torch.Tensor:
    """Megatron's g: sum over the model group forward, identity backward
    (the output of a row-parallel layer or a vocab-parallel lookup)."""
    return x if tp is None else _ReduceFromModel.apply(x, tp.group)


def gather_from_model(x: torch.Tensor, tp: Optional[Shard]) -> torch.Tensor:
    """Every peer's last-axis slice concatenated in rank order (vocab-sharded
    logits made whole); the backward keeps this rank's slice."""
    return x if tp is None else _GatherFromModel.apply(x, tp)


class _VocabParallelCE(torch.autograd.Function):
    """Mean cross-entropy of (N, V / M) vocab-sharded fp32 logits: the row
    max and the sum of exponentials over the model group, the target's logit
    from the rank that holds it; the backward is softmax - one-hot on this
    rank's columns, exact, with no gather of the logits."""

    @staticmethod
    def forward(ctx, logits, targets, tp):
        n, v = logits.shape
        row_max = _gather_last(logits.max(-1).values[:, None], tp).max(-1).values
        shifted = logits - row_max[:, None]
        exp = shifted.exp()
        local = targets - tp.rank * v
        mine = (local >= 0) & (local < v)
        picked = shifted.gather(1, local.clamp(0, v - 1)[:, None])[:, 0]
        sums = _sum(torch.stack([exp.sum(-1), torch.where(mine, picked, 0.0)]), tp.group)
        ctx.save_for_backward(exp / sums[0][:, None], local, mine)
        return (sums[0].log() - sums[1]).mean()

    @staticmethod
    def backward(ctx, grad):
        probs, local, mine = ctx.saved_tensors
        out = probs.clone()
        rows = torch.arange(out.shape[0], device=out.device)[mine]
        out[rows, local[mine]] -= 1.0
        return out * (grad / out.shape[0]), None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 tp: Shard) -> torch.Tensor:
    """``F.cross_entropy(full_logits, targets)`` (mean) from this rank's
    (N, V / M) columns of fp32 logits; ``targets`` (N,) are full-vocab ids."""
    return _VocabParallelCE.apply(logits, targets, tp)
