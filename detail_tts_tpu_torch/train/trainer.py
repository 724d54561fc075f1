"""Trainer, a subset of ``detail_tts_tpu/train/trainer.py`` (train.py:80-465).

``Trainer(cfg, data_iter, device, seed).train(max_steps, log_every)`` runs
the config's target through ``make_train_step`` (the single-loss step of
``vqvae``, ``gpt`` and ``diff`` over batches in the layout (accum,
micro_batch, ...); the GAN step of ``flowvae`` and ``all`` over (batch,
...), a leading accumulation axis of 1 dropped, as JAX's trainer does) and
logs every scalar metric to ``metrics.jsonl``.  Checkpoints, eval dumps,
TensorBoard and the command line come with later slices.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterator, Optional

import torch

from detail_tts_tpu_torch.config import Config
from detail_tts_tpu_torch.serving.pipeline import resolve_device
from detail_tts_tpu_torch.train.step import (GAN_TARGETS, make_train_state,
                                             make_train_step)


class MetricsLogger:
    """Scalars as one JSON object a line in ``<logdir>/metrics.jsonl``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class Trainer:
    def __init__(self, cfg: Config, data_iter: Iterator, device="cuda",
                 seed: int = 0, logs_folder: Optional[str] = None):
        """Seeded random weights (``seed``) and one ``torch.Generator`` on
        ``device`` for every draw of the steps (seeded from the config's
        seed and ``seed``).  ``logs_folder``: where ``metrics.jsonl`` goes;
        None logs nothing to disk.  An unknown target raises ``ValueError``."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = make_train_state(cfg, self.device, seed=seed)
        self.step_fn = make_train_step(cfg, self.device)
        self.data_iter = data_iter
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.train.seed * 1000003 + seed)
        self.metrics = MetricsLogger(logs_folder) if logs_folder else None
        self.last_metrics: Dict[str, object] = {}

    def next_batch(self) -> Dict[str, torch.Tensor]:
        """The next batch in the step's layout: a GAN target's leading
        accumulation axis (which must be 1) is dropped."""
        batch = next(self.data_iter)
        if self.cfg.train.target in GAN_TARGETS and batch["mel"].dim() == 4:
            if batch["mel"].shape[0] != 1:
                raise ValueError("GAN targets take accum 1, not "
                                 f"{batch['mel'].shape[0]}")
            batch = {k: v[0] for k, v in batch.items()}
        return batch

    def train(self, max_steps: Optional[int] = None,
              log_every: int = 10) -> Dict[str, float]:
        """Step until ``state.step`` reaches ``max_steps``; every
        ``log_every`` steps the scalar metrics (and steps per second) are
        read back and logged.  Returns the last logged scalars."""
        max_steps = max_steps or self.cfg.train.train_steps
        logged: Dict[str, float] = {}
        t_last = time.perf_counter()
        while self.state.step < max_steps:
            metrics = self.step_fn(self.state, self.next_batch(), self.generator)
            self.last_metrics = metrics
            if self.state.step % log_every == 0:
                logged = {k: float(v) for k, v in metrics.items()
                          if torch.is_tensor(v) and v.dim() == 0}
                now = time.perf_counter()
                logged["steps_per_sec"] = log_every / (now - t_last)
                t_last = now
                if self.metrics is not None:
                    self.metrics.log(self.state.step, logged)
        return logged
