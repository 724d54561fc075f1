"""Checkpoints of the training state, and serving weights from them.

Counterpart of ``detail_tts_tpu/train/checkpoint.py`` in a format of the
port's own: one ``torch.save`` of a dict a step, ``<dir>/<step>/state.pt``,
written under a temporary name and renamed into place, the newest
``keep`` steps kept (the reference's keep-3, train.py:139-175).  The dict
holds ``step``, the model's ``state_dict`` (the VQ codebook buffers are
JAX's ``vq_state``), the AdamW state keyed by parameter name and, for the
GAN targets, the discriminator and its AdamW state.  Moments are keyed by
name, not by ``torch.optim``'s index into the trainable list, because each
target trains another subset: a staged restore (a ``vqvae`` checkpoint
into a ``gpt`` trainer) grafts them by name.  The trainer also saves its
generators' states under ``rng`` (the step generator, and under data
parallelism every rank's dropout generator, one row a rank), so that a
resume draws what the run would have drawn; JAX's ``TrainState`` holds no
rng.  Under data parallelism rank 0 writes and every rank restores.  Under
tensor parallelism (a ``parallel.mesh.Mesh`` with a model axis) the file
still holds full tensors: the saving ranks gather the GPT's shards and
AdamW's moments over the model group, and a restore cuts them again, so
the format does not depend on the mesh and a (D x M) checkpoint restores at
world 1 and back, as JAX's Orbax checkpoints are layout-free.

``restore_checkpoint(partial=True)`` is the reference's lax loader made
explicit: every tensor whose name and shape match is restored, every other
keeps its current value and is reported.  Model tensors cross between the
weight-norm (g, v) parametrization and the folded weight, both ways
(:func:`graft_state`); optimizer moments never do.
"""
from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from detail_tts_tpu_torch.io.weights import fold_weight_norm
from detail_tts_tpu_torch.parallel.mesh import (Mesh, gather_state_dict, gather_tensor,
                                                localize, localize_tensor)

STATE_FILE = "state.pt"


def _steps(directory) -> List[int]:
    d = Path(directory)
    if not d.is_dir():
        return []
    return sorted(int(p.name) for p in d.iterdir()
                  if p.name.isdigit() and (p / STATE_FILE).is_file())


def latest_step(directory) -> Optional[int]:
    """The newest step saved under ``directory``; None if there is none."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def _cpu(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}


def _param_names(module: nn.Module) -> Dict[int, str]:
    return {id(p): n for n, p in module.named_parameters()}


def optimizer_state_by_name(optimizer: torch.optim.Optimizer, module: nn.Module,
                            gather: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """The optimizer's per-parameter state keyed by ``module``'s parameter
    names, on the CPU.  ``gather``: the moments of a sharded parameter are
    gathered whole over its model group (every model peer calls it)."""
    names = _param_names(module)
    out = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p in optimizer.state:
                state = optimizer.state[p]
                shard = getattr(p, "model_shard", None)
                if gather and shard is not None:
                    state = {k: gather_tensor(v, shard)
                             if torch.is_tensor(v) and v.shape == p.shape else v
                             for k, v in state.items()}
                out[names[id(p)]] = _cpu(state)
    return out


def load_optimizer_state_by_name(optimizer: torch.optim.Optimizer, module: nn.Module,
                                 saved: Mapping[str, Mapping[str, torch.Tensor]],
                                 partial: bool = True) -> List[str]:
    """Load moments saved by :func:`optimizer_state_by_name` into
    ``optimizer`` by parameter name and shape.  A parameter with no saved
    moments (or moments of another shape) keeps its current state and is
    reported; ``partial=False`` raises instead.  Hyperparameters stay the
    optimizer's own (the step sets the LR)."""
    names = _param_names(module)
    params = dict(module.named_parameters())
    saved = {n: {k: localize_tensor(v, params[n]) if torch.is_tensor(v) and n in params
                 else v for k, v in s.items()} for n, s in saved.items()}
    sd = optimizer.state_dict()
    order = [names[id(p)] for g in optimizer.param_groups for p in g["params"]]
    shapes = {names[id(p)]: tuple(p.shape) for g in optimizer.param_groups
              for p in g["params"]}
    state, skipped = {}, []
    for i, name in enumerate(order):
        s = saved.get(name)
        if s is None:
            skipped.append(f"missing:{name}")
        elif any(torch.is_tensor(v) and v.dim() and tuple(v.shape) != shapes[name]
                 for v in s.values()):
            skipped.append(f"shape:{name}")
            s = None
        if s is None:
            if i in sd["state"]:
                state[i] = sd["state"][i]
            continue
        state[i] = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
    if skipped and not partial:
        raise KeyError(f"optimizer state without a match: {skipped[:5]}")
    sd["state"] = state
    optimizer.load_state_dict(sd)
    return skipped


def save_checkpoint(directory, state, keep: int = 3,
                    rng: Optional[Mapping[str, torch.Tensor]] = None,
                    mesh: Optional[Mesh] = None) -> Optional[Path]:
    """Save a ``TrainState`` as ``directory/<state.step>/state.pt``, then
    delete all but the newest ``keep`` steps.  ``rng``: generator states
    saved beside it.  Returns the step's directory.  ``mesh``: every rank
    calls it; data rank 0's model group gathers the shards whole, rank 0
    writes and the others return None."""
    if mesh is not None and mesh.data_rank != 0:
        return None
    gather = mesh is not None and mesh.model > 1
    step = int(state.step)
    model_sd = gather_state_dict(state.model) if gather else state.model.state_dict()
    moments = optimizer_state_by_name(state.optimizer, state.model, gather)
    if mesh is not None and mesh.rank != 0:
        return None
    data = {"step": step, "model": _cpu(model_sd), "optimizer": moments}
    if rng:
        data["rng"] = _cpu(rng)
    if state.disc is not None:
        data["disc"] = _cpu(state.disc.state_dict())
        data["d_optimizer"] = optimizer_state_by_name(state.d_optimizer, state.disc)
    root = Path(directory)
    root.mkdir(parents=True, exist_ok=True)
    final = root / str(step)
    tmp = root / f".{step}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    torch.save(data, tmp / STATE_FILE)
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    for old in _steps(root)[:-keep] if keep > 0 else []:
        shutil.rmtree(root / str(old))
    return final


def load_checkpoint(directory, step: Optional[int] = None) -> dict:
    """The saved dict of one step (the newest by default), tensors on the
    CPU."""
    step = latest_step(directory) if step is None else step
    path = Path(directory) / str(step) / STATE_FILE
    if step is None or not path.is_file():
        raise FileNotFoundError(f"no checkpoint under {directory}")
    return torch.load(path, map_location="cpu", weights_only=True)


def _wn_norm(w: torch.Tensor) -> torch.Tensor:
    """||w|| over every axis but torch's dim 0, keepdim, fp32."""
    w = w.float()
    return w.square().sum(tuple(range(1, w.dim())), keepdim=True).sqrt()


def _wn_crosswalk(name: str, loaded: Mapping[str, torch.Tensor]) -> Optional[torch.Tensor]:
    """A model tensor across the weight-norm parametrizations: template
    ``weight_v``/``weight_g`` from a saved folded ``weight`` (v = w, g =
    ||w||), or template ``weight`` from a saved (g, v) pair (w = g v /
    max(||v||, 1e-12), as ``io/weights.py:fold_weight_norm``)."""
    if name.endswith((".weight_v", ".weight_g")):
        w = loaded.get(name[: -len("_v")])
        if w is None:
            return None
        return w.clone() if name.endswith("_v") else _wn_norm(w)
    if name.endswith(".weight"):
        g, v = loaded.get(name + "_g"), loaded.get(name + "_v")
        if g is None or v is None:
            return None
        folded = fold_weight_norm({"x.weight_g": g.float().numpy(),
                                   "x.weight_v": v.float().numpy()})["x.weight"]
        return torch.from_numpy(folded)
    return None


def graft_state(current: Mapping[str, torch.Tensor],
                loaded: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Tensors of ``loaded`` for the names of ``current`` where name and
    shape match (through the weight-norm crosswalk where a name is missing);
    every other name keeps its current tensor and is reported as
    ``missing:<name>`` or ``shape:<name> <saved>!=<current>``.  Returns
    (the grafted state dict, the reports)."""
    out, skipped = {}, []
    for name, cur in current.items():
        cand = loaded.get(name)
        if cand is None:
            cand = _wn_crosswalk(name, loaded)
        if cand is None:
            skipped.append(f"missing:{name}")
            out[name] = cur
        elif tuple(cand.shape) != tuple(cur.shape):
            skipped.append(f"shape:{name} {tuple(cand.shape)}!={tuple(cur.shape)}")
            out[name] = cur
        else:
            out[name] = cand.to(dtype=cur.dtype)
    return out, skipped


def _restore_module(module: nn.Module, saved: Mapping[str, torch.Tensor],
                    partial: bool) -> List[str]:
    current = module.state_dict()
    saved = localize(saved, module)
    grafted, skipped = graft_state(current, saved) if partial else (saved, [])
    module.load_state_dict(grafted)
    return skipped


def restore_checkpoint(directory, state, step: Optional[int] = None,
                       partial: bool = True, verbose: bool = True,
                       rng: Optional[Dict[str, torch.Tensor]] = None) -> List[str]:
    """Restore a saved step (the newest by default) into ``state`` in place.

    ``partial=True``: model and discriminator tensors by name and shape
    (with the weight-norm crosswalk), moments by parameter name; what does
    not match keeps its current value and is returned (and printed when
    ``verbose``): ``missing:<name>`` or ``shape:<name> ...`` for the model,
    the same behind ``optimizer.``, ``disc.`` or ``d_optimizer.`` for the
    rest.  ``partial=False``: every tensor must match.  ``rng``: a dict
    that takes the saved generator states (none if there are none).  The
    file holds full tensors; a sharded state (``parallel.mesh.shard_module_``)
    takes this rank's slices of them, with no collective."""
    data = load_checkpoint(directory, step)
    if rng is not None:
        rng.update(data.get("rng", {}))
    skipped = _restore_module(state.model, data["model"], partial)
    skipped += [f"optimizer.{s}" for s in load_optimizer_state_by_name(
        state.optimizer, state.model, data["optimizer"], partial)]
    if state.disc is not None:
        if "disc" in data:
            skipped += [f"disc.{s}" for s in _restore_module(state.disc, data["disc"],
                                                               partial)]
            skipped += [f"d_optimizer.{s}" for s in load_optimizer_state_by_name(
                state.d_optimizer, state.disc, data["d_optimizer"], partial)]
        elif partial:
            skipped.append("disc.missing:*")
        else:
            raise KeyError("the checkpoint holds no discriminator")
    state.step = int(data["step"])
    if verbose and skipped:
        print(f"checkpoint: kept current values for {len(skipped)} entries "
              f"(first: {skipped[:5]})")
    return skipped


# ---------------------------------------------------------------------------
# Serving weights
# ---------------------------------------------------------------------------


def fold_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A CPU copy of ``sd`` with every (weight_g, weight_v) pair folded into
    ``weight`` (``io/weights.py:fold_weight_norm``)."""
    folded = fold_weight_norm({k: v.detach().cpu().numpy() for k, v in sd.items()})
    return {k: torch.from_numpy(np.array(v)) for k, v in folded.items()}


def restore_variables(path, cfg) -> Dict[str, torch.Tensor]:
    """A folded serving ``state_dict`` from the newest step of a trainer's
    checkpoint directory: (g, v) pairs are folded, and every key and shape
    of ``SynthesizerTrn(cfg)`` must be there."""
    from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn

    folded = fold_state_dict(load_checkpoint(path)["model"])
    with torch.device("meta"):
        template = SynthesizerTrn(cfg).state_dict()
    bad = [k for k, ref in template.items()
           if k not in folded or tuple(folded[k].shape) != tuple(ref.shape)]
    if bad:
        raise ValueError(f"{path}: the checkpoint does not fit the config "
                         f"(missing or other shape: {bad[:5]})")
    return {k: folded[k].to(ref.dtype) for k, ref in template.items()}


def save_variables(path, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Serving weights as ``{"model": folded state_dict}``, the layout
    ``io/weights.py:load_reference_checkpoint`` reads."""
    torch.save({"model": fold_state_dict(state_dict)}, path)
