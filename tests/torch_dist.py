"""Data-parallel runs for the port's tests: world-W gloo process groups on
the CPU, started with ``torch.multiprocessing`` (spawn) on a ``file://``
store, and the training-step worker they run.

Kept apart from the test modules so that a spawned rank imports torch and
the port only, not JAX.  A rank's failure raises in the parent.
"""
from __future__ import annotations

import copy
import itertools
import os
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
from detail_tts_tpu_torch.nn.common import SeededDropout, weight_norm_
from detail_tts_tpu_torch.parallel import mesh
from detail_tts_tpu_torch.train.step import GAN_TARGETS, make_train_state, make_train_step

_runs = itertools.count()


def spawn(fn: Callable, world: int, tmp_path, *args) -> List[object]:
    """``fn(group, *args)`` on ranks 0..world-1, one process each; returns
    each rank's result in rank order."""
    path = Path(tmp_path) / f"dist{os.getpid()}_{next(_runs)}"
    path.mkdir(parents=True)
    mp.start_processes(_entry, args=(fn, world, str(path), args), nprocs=world,
                       join=True, start_method="spawn")
    return [torch.load(path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _entry(rank: int, fn: Callable, world: int, path: str, args) -> None:
    torch.set_num_threads(1)
    group, _ = mesh.init_distributed(f"file://{path}/store", device="cpu", rank=rank,
                                     world_size=world)
    try:
        torch.save(fn(group, *args), f"{path}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def build_state(cfg, model_sd, disc=None, no_dropout=True):
    """A training state on the CPU from a model state dict (weight-normed
    under ``cfg.train.weight_norm``) and, for the GAN targets, a
    discriminator module; every dropout at p = 0 when ``no_dropout``."""
    model = SynthesizerTrn(cfg)
    if cfg.train.weight_norm:
        weight_norm_(model)
    model.load_state_dict(model_sd)
    if no_dropout:
        for m in model.modules():
            if isinstance(m, SeededDropout):
                m.p = 0.0
    return make_train_state(cfg, device="cpu", model=model,
                            disc=None if disc is None else copy.deepcopy(disc))


def moments(optimizer, module) -> Dict[str, torch.Tensor]:
    """AdamW's first moments keyed by ``module``'s parameter names."""
    names = {id(p): n for n, p in module.named_parameters()}
    return {names[id(p)]: s["exp_avg"].clone() for p, s in optimizer.state.items()}


def train_steps(group, cfg, model_sd, batches: Sequence[Dict[str, torch.Tensor]],
                draws: Optional[Sequence] = None, disc=None, seed: int = 0,
                no_dropout: bool = True, all_reduce: bool = True) -> dict:
    """One step a batch of ``batches`` (global batches, this rank takes
    its rows) from the same initial state on every rank; ``draws``: the
    global draws of each step, else the step draws from a generator seeded
    ``seed + k``.  ``all_reduce=False`` drops the gradient all-reduce (a
    negative control).  Returns the metrics of each step, the model (and
    discriminator) state and the AdamW first moments after the last."""
    state = build_state(cfg, model_sd, disc, no_dropout)
    if not all_reduce:  # this process only: a spawned rank
        mesh.all_reduce_grads = lambda params, group=None: None
    step = make_train_step(cfg, "cpu", group)
    axis = 0 if cfg.train.target in GAN_TARGETS else 1
    drop_gen = (mesh.rank_generator(seed, "cpu", group) if mesh.world(group) > 1
                else None)
    metrics = []
    for k, batch in enumerate(batches):
        m = step(state, mesh.shard_batch(batch, group, axis),
                 torch.Generator().manual_seed(seed + k),
                 draws=None if draws is None else draws[k], dropout_generator=drop_gen)
        metrics.append({n: v.clone() for n, v in m.items() if torch.is_tensor(v)})
    out = {"metrics": metrics, "model": copy.deepcopy(state.model.state_dict()),
           "moments": moments(state.optimizer, state.model)}
    if state.disc is not None:
        out["disc"] = copy.deepcopy(state.disc.state_dict())
        out["d_moments"] = moments(state.d_optimizer, state.disc)
    return out


def codebook_call(group, buffers: Dict[str, torch.Tensor], x: torch.Tensor,
                  kmeans: torch.Tensor, expire: torch.Tensor, codebook: Dict) -> dict:
    """One training call of an ``EuclideanCodebook(**codebook)`` holding
    ``buffers`` on this rank's rows of the global vectors ``x`` (N, D),
    with global draws; returns its buffers and ids after."""
    from detail_tts_tpu_torch.models.quantizer import EuclideanCodebook

    cb = EuclideanCodebook(buffers["embed"].shape[0], buffers["embed"].shape[1], **codebook)
    cb.load_state_dict(buffers)
    _, ids = cb(mesh.shard_rows(x, group), kmeans, expire, group)
    return {"ids": ids, **{k: v.clone() for k, v in cb.state_dict().items()}}


def kl_call(group, tensors: Sequence[torch.Tensor], mask: torch.Tensor) -> dict:
    """``kl_loss`` on this rank's rows with the group (the global ratio's
    share) and without (a per-rank ratio), and the gradient of each with
    respect to this rank's ``z_p`` rows."""
    from detail_tts_tpu_torch.train.losses import kl_loss

    out = {}
    for name, g in (("global", group), ("per_rank", None)):
        z_p, logs_q, m_p, logs_p = (mesh.shard_rows(x, group).clone().requires_grad_(i == 0)
                                    for i, x in enumerate(tensors))
        loss = kl_loss(z_p, logs_q, m_p, logs_p, mesh.shard_rows(mask, group), g)
        loss.backward()
        out[name] = (loss.detach(), z_p.grad)
    return out


def loader_and_metrics_call(group, batches: Sequence[Dict], hop: int) -> dict:
    """Rank r's loader batch ``batches[r]`` padded to the ranks' agreed
    lengths, the step's metric reduction and the gradient all-reduce with a
    missing gradient, on values that differ by rank."""
    from detail_tts_tpu_torch.data.dataset import pad_to_agreed

    r = mesh.rank(group)
    batch = batches[r]
    params = [torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2, 2))]
    params[0].grad = torch.full((3,), float(r + 1))  # params[1] has no gradient
    mesh.all_reduce_grads(params, group)
    metrics = mesh.reduce_metrics({"loss": torch.tensor(float(r)), "grad_norm":
                                   torch.tensor(float(r)), "layers_kept": [r]},
                                  ["loss"], group)
    return {"batch": pad_to_agreed(batch, hop, group), "grads": [p.grad for p in params],
            "metrics": metrics}


def dropout_call(group, cfg, model_sd, batch: Dict[str, torch.Tensor]) -> dict:
    """At the config's dropout: this rank's loss of its rows through the
    GPT with its own dropout generator (before any reduction), and a
    repeated world-W step from the same state and generator states."""
    state = build_state(cfg, model_sd, no_dropout=False)
    step = make_train_step(cfg, "cpu", group)
    local = mesh.shard_batch(batch, group, 1)
    with torch.no_grad():
        loss = state.model.forward_gpt({k: v[0] for k, v in local.items()},
                                       mesh.rank_generator(3, "cpu", group))
    drop_gen = mesh.rank_generator(3, "cpu", group)
    snap, d_state = state.snapshot(), drop_gen.get_state()
    runs = []
    for _ in range(2):
        state.restore(snap)
        drop_gen.set_state(d_state)
        m = step(state, local, torch.Generator().manual_seed(4), dropout_generator=drop_gen)
        runs.append(({k: v for k, v in m.items() if torch.is_tensor(v)},
                     copy.deepcopy(state.model.state_dict()), drop_gen.get_state()))
    return {"local_loss": loss, "runs": runs}


def resume_call(group, cfg, batches: Sequence[Dict[str, torch.Tensor]], logs: str) -> dict:
    """Trainer A takes two steps (a checkpoint at 2), then step 3; trainer R,
    built from another seed, restores A's checkpoint and takes step 3 on
    the same batch.  Returns both step-3 results and whether ``batch_size``
    that the world does not divide is refused."""
    import dataclasses

    from detail_tts_tpu_torch.train.checkpoint import optimizer_state_by_name
    from detail_tts_tpu_torch.train.trainer import Trainer

    def local(it):
        return (mesh.shard_batch(b, group, 1) for b in it)

    out = {}
    for name, seed, data in (("a", 0, batches), ("r", 7, batches[2:])):
        tr = Trainer(cfg, local(data), device="cpu", seed=seed, logs_folder=logs, group=group)
        if name == "r":
            tr.load(f"{logs}/ckpt")
            assert tr.state.step == 2
        tr.train(max_steps=3, log_every=1)
        out[name] = (tr.last_metrics["loss"], copy.deepcopy(tr.state.model.state_dict()),
                     optimizer_state_by_name(tr.state.optimizer, tr.state.model))
        tr.close()
    odd = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=3))
    try:
        Trainer(odd, device="cpu", logs_folder=logs + "/odd", group=group).default_data(
            "unread.jsonl")
        out["odd_refused"] = False
    except ValueError:
        out["odd_refused"] = True
    return out


def run_cli_as_torchrun(world: int, tmp_path, argv: Sequence[str]) -> List[dict]:
    """``python -m detail_tts_tpu_torch.train argv`` on ``world`` ranks
    that see the environment torchrun sets (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); returns each rank's
    last logged scalars."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    path = Path(tmp_path) / f"cli{os.getpid()}_{next(_runs)}"
    path.mkdir(parents=True)
    mp.start_processes(_cli_rank, args=(world, port, list(argv), str(path)), nprocs=world,
                       join=True, start_method="spawn")
    return [torch.load(path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _cli_rank(rank: int, world: int, port: int, argv: List[str], path: str) -> None:
    from detail_tts_tpu_torch.train import __main__ as train_cli

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.save(train_cli.main(argv), f"{path}/rank{rank}.pt")
