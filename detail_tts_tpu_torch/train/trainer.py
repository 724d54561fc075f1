"""Staged trainer: the reference ``Trainer`` (train.py:80-465).

Counterpart of ``detail_tts_tpu/train/trainer.py``.  ``Trainer`` runs the
config's target through ``make_train_step``: the single-loss step of
``vqvae``, ``gpt`` and ``diff`` over batches in the layout (accum,
micro_batch, ...), the GAN step of ``flowvae`` and ``all`` over (batch,
...), a leading accumulation axis of 1 dropped, as JAX's trainer does.

* data: a jsonl corpus through ``default_data`` (data/dataset.py: numpy
  batches from decode threads, moved to the trainer's device here), or any
  iterator of batches;
* checkpoints every ``save_freq`` steps under ``<logs>/ckpt`` with keep-N
  (train/checkpoint.py); ``load`` restores one, partially where the target
  or the parametrization differs;
* metrics to ``metrics.jsonl`` (and TensorBoard where it is installed);
* eval dumps every ``val_freq`` steps: ``sample-<milestone>.wav`` and
  ``gt-<milestone>.wav`` (train.py:229-258), and mel images and audio in
  TensorBoard;
* spans (``tracing``): each iteration of ``train`` is a ``train_step``
  root over its batch, step, metric read-back, eval and save, with the
  step's stages and its host waits on the device as children.

Parallelism (``group``, every rank, one process a card, ``torchrun``; see
``parallel/mesh.py`` and the step): the ranks form the (``data_parallel``
x ``model_parallel``) mesh of ``cfg.mesh``.  ``batch_size`` is the global
micro-batch; each data rank loads ``batch_size // D`` clips a micro-batch
from its own rows of the corpus, and its model peers take the same batch
(an iterator passed in must yield this data rank's rows).  The initial
state is rank 0's, broadcast, then the GPT is sharded over the model group
and AdamW made on the shards.  Each data rank draws its dropout masks from
its own generator.  Metrics and TensorBoard are rank 0's (JAX's
``_is_host0``), and so are eval dumps, which data rank 0's model group
computes where they run the split GPT; rank 0 writes the checkpoints, with
full tensors and every data rank's generator state, and every rank
restores them.
"""
from __future__ import annotations

import json
import os
import time
import traceback
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from detail_tts_tpu_torch import tracing
from detail_tts_tpu_torch.audio.mel import MelFrontend
from detail_tts_tpu_torch.config import Config
from detail_tts_tpu_torch.data.dataset import (BucketSpec, DataIterator, JsonlTtsDataset,
                                               save_wav)
from detail_tts_tpu_torch.nn.common import eval_mode
from detail_tts_tpu_torch.parallel import mesh
from detail_tts_tpu_torch.serving.pipeline import resolve_device
from detail_tts_tpu_torch.text.tokenizer import make_tokenizer
from detail_tts_tpu_torch.train import checkpoint as ckpt_lib
from detail_tts_tpu_torch.train.step import (GAN_TARGETS, make_train_state,
                                             make_train_step)


def mel_to_image(mel: np.ndarray) -> np.ndarray:
    """(T, n_mels) log-mel -> (3, n_mels, T) uint8 spectrogram image.

    Matplotlib-free equivalent of the reference's
    ``plot_spectrogram_to_numpy`` (log_utils.py:41-55): per-image min/max
    normalisation through a compact viridis ramp, low bins at the bottom."""
    m = np.asarray(mel, np.float32).T
    lo, hi = float(m.min()), float(m.max())
    x = (m - lo) / max(hi - lo, 1e-6)
    ramp = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140],
                     [94, 201, 98], [253, 231, 37]], np.float32)  # viridis
    idx = x * (len(ramp) - 1)
    i0 = np.clip(idx.astype(np.int32), 0, len(ramp) - 2)
    frac = (idx - i0)[..., None]
    rgb = ramp[i0] * (1 - frac) + ramp[i0 + 1] * frac
    return np.flipud(rgb).transpose(2, 0, 1).astype(np.uint8)


class MetricsLogger:
    """Scalars as one JSON object a line in ``<logdir>/metrics.jsonl``, and
    scalars, mel images and audio in TensorBoard where it is installed
    (log_utils.py:31-39, train.py:416-439)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # the package is optional
            return
        self.tb = SummaryWriter(log_dir=logdir)

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.tb is not None:
            for k, v in rec.items():
                if k != "step":
                    self.tb.add_scalar(k, v, step)

    def log_media(self, step: int, mels: Optional[Dict[str, np.ndarray]] = None,
                  audios: Optional[Dict[str, np.ndarray]] = None,
                  sr: int = 24000) -> None:
        """mels: {tag: (T, n_mels) log-mel}; audios: {tag: (N,) float wav}."""
        if self.tb is None:
            return
        for tag, mel in (mels or {}).items():
            self.tb.add_image(tag, mel_to_image(mel), step)
        for tag, wav in (audios or {}).items():
            wav = np.clip(np.asarray(wav, np.float32).reshape(-1), -1, 1)
            self.tb.add_audio(tag, wav[None], step, sample_rate=sr)

    def close(self) -> None:
        self._f.close()
        if self.tb is not None:
            self.tb.close()


class Trainer:
    def __init__(self, cfg, data_iter: Optional[Iterator] = None, device="cuda",
                 seed: int = 0, logs_folder: Optional[str] = None,
                 buckets: BucketSpec = BucketSpec(), synth_eval: bool = False,
                 group=None):
        """``cfg``: a :class:`Config` or the path of a reference-format JSON.
        Seeded random weights (``seed``) and one ``torch.Generator`` on
        ``device`` for every draw of the steps (seeded from the config's seed
        and ``seed``).  ``logs_folder``: metrics, eval dumps and ``ckpt/``;
        by default ``cfg.train.logs_folder/<timestamp>``.  ``synth_eval``:
        for ``gpt`` and ``diff``, the eval dump synthesizes from the batch's
        text and prompt (train.py:229-240).  ``group``: the data-parallel
        process group of every rank (``parallel.mesh.init_distributed``),
        with ``device`` this rank's card; the mesh is ``cfg.mesh`` over it.
        An unknown target raises ``ValueError``."""
        if isinstance(cfg, str):
            cfg = Config.from_json(cfg)
        mesh.check_mesh(cfg, group)
        self.cfg = cfg
        self.target = cfg.train.target
        self.mesh = mesh.make_mesh(cfg.mesh.data_parallel, cfg.mesh.model_parallel, group)
        self.group = group
        self.rank, self.world = mesh.rank(group), mesh.world(group)
        # the data axis: this rank's rows and the collectives of the step
        self.data_group = self.mesh.data_group
        self.data_rank, self.data_world = self.mesh.data_rank, self.mesh.data
        self.device = resolve_device(device)
        self.state = make_train_state(cfg, self.device, seed=seed,
                                      mesh=None if group is None else self.mesh)
        if self.mesh.model > 1 and self.rank == 0:
            print(mesh.describe_shards(self.state.model, self.mesh), flush=True)
        self.step_fn = make_train_step(cfg, self.device, self.data_group)
        self.data_iter = data_iter
        self.buckets = buckets
        self.synth_eval = synth_eval
        run_seed = cfg.train.seed * 1000003 + seed
        self.generator = torch.Generator(device=self.device).manual_seed(run_seed)
        self.dropout_generator = (mesh.rank_generator(run_seed, self.device,
                                                      self.data_group)
                                  if self.data_world > 1 else None)
        self.logs_folder = logs_folder or os.path.join(
            cfg.train.logs_folder, time.strftime("%Y-%m-%d-%H-%M-%S"))
        self.metrics = MetricsLogger(self.logs_folder) if self.rank == 0 else None
        self.last_metrics: Dict[str, object] = {}

    def default_data(self, jsonl_path: str, num_threads: int = 8) -> "Trainer":
        """Batches from a jsonl corpus: this data rank's rows, micro-batch
        ``batch_size // D`` (a ``ValueError`` if the data axis does not
        divide it), accum ``gradient_accumulate_every`` (1 for the GAN
        targets); model peers take model rank 0's batches."""
        micro, rest = divmod(self.cfg.train.batch_size, self.data_world)
        if rest or not micro:
            raise ValueError(f"batch_size {self.cfg.train.batch_size} does not split over "
                             f"a data axis of {self.data_world}")
        tok = make_tokenizer(self.cfg.data.tokenizer_vocab)
        ds = JsonlTtsDataset(self.cfg, jsonl_path, tok, rank=self.data_rank,
                             world=self.data_world)
        accum = 1 if self.target in GAN_TARGETS else self.cfg.train.gradient_accumulate_every
        self.data_iter = DataIterator(ds, micro, accum=accum, buckets=self.buckets,
                                      num_threads=num_threads, group=self.group,
                                      model_group=self.mesh.model_group)
        return self

    def close(self) -> None:
        """Stop the corpus's decode threads and close the logs."""
        if isinstance(self.data_iter, DataIterator):
            self.data_iter.close()
        if self.metrics is not None:
            self.metrics.close()

    # ----------------------------------------------------------- checkpoint

    def save(self) -> None:
        """Rank 0 writes ``<logs>/ckpt/<step>`` (full tensors, gathered over
        the model group) with the step generator's state and every data
        rank's dropout generator state; the ranks wait for it."""
        rng = {"generator": self.generator.get_state()}
        if self.dropout_generator is not None:
            rng["dropout"] = mesh.all_gather_host(self.dropout_generator.get_state(),
                                                  self.data_group)
        ckpt_lib.save_checkpoint(os.path.join(self.logs_folder, "ckpt"), self.state,
                                 keep=self.cfg.train.keep_ckpts, rng=rng,
                                 mesh=None if self.group is None else self.mesh)
        mesh.barrier(self.group)

    def load(self, ckpt_dir: str, step: Optional[int] = None) -> "Trainer":
        """Restore ``ckpt_dir`` (its newest step by default), partially: what
        does not match keeps its current value and is reported.  The saved
        generator states are restored too (a rank's dropout generator only
        when the checkpoint's data axis is this one).  The GPT's shards are
        cut from the saved full tensors, whatever mesh saved them."""
        rng: Dict[str, torch.Tensor] = {}
        ckpt_lib.restore_checkpoint(ckpt_dir, self.state, step, rng=rng,
                                    verbose=self.rank == 0)
        if "generator" in rng:
            self.generator.set_state(rng["generator"])
        dropout = rng.get("dropout")
        if self.dropout_generator is not None and dropout is not None:
            if dropout.shape[0] == self.data_world:
                # a copy: set_state reads a row view from its storage's start
                self.dropout_generator.set_state(dropout[self.data_rank].clone())
            elif self.rank == 0:
                print(f"checkpoint: saved at a data axis of {dropout.shape[0]}, not "
                      f"{self.data_world}: the dropout generators start from the seed")
        return self

    # ---------------------------------------------------------------- data

    def next_batch(self) -> Dict[str, torch.Tensor]:
        """The next batch on the trainer's device in the step's layout: numpy
        leaves become tensors (integer leaves int64), and a GAN target's
        leading accumulation axis (which must be 1) is dropped."""
        leaves = next(self.data_iter)
        with tracing.wait("batch"):
            batch = {k: _to_device(v, self.device) for k, v in leaves.items()}
        if self.target in GAN_TARGETS and batch["mel"].dim() == 4:
            if batch["mel"].shape[0] != 1:
                raise ValueError("GAN targets take accum 1, not "
                                 f"{batch['mel'].shape[0]}")
            batch = {k: v[0] for k, v in batch.items()}
        return batch

    # ----------------------------------------------------------------- eval

    def _eval_dump(self, batch: Dict[str, torch.Tensor]) -> None:
        """``sample-<milestone>.wav`` and ``gt-<milestone>.wav`` from the
        step's first clip (train.py:229-258), in fp32 with dropout off and
        from a generator seeded with the step, so the training generator is
        untouched.  Rank 0 computes and writes it, alone unless the dump
        synthesizes through a GPT split over ``model_parallel`` M > 1: then
        data rank 0's M ranks compute it together (the other data ranks
        return at once).  A failure is printed, never raised, where no peer
        can be waiting on the failed rank (eval must not stop training);
        a failure while the split GPT runs raises instead, so that the run
        ends rather than leave a model peer waiting in a collective."""
        split = (self.mesh.model > 1 and self.synth_eval
                 and self.target in ("gpt", "diff"))
        if self.rank != 0 and not (split and self.data_rank == 0):
            return
        gen_wav = None
        try:
            step = self.state.step
            milestone = step // max(self.cfg.train.save_freq, 1)
            sr = self.cfg.data.sampling_rate

            def first(key):
                v = batch[key]
                return (v if self.target in GAN_TARGETS else v[0])[:1]

            model = self.state.model  # the vocoder's prior draws under JAX's PRNGKey(step)
            with torch.no_grad(), eval_mode(model):
                if self.target == "vqvae":
                    _, wav = model.infer_vqvae(first("raw_mel"), key=step)
                    gen_wav = wav[0, :, 0].float().cpu().numpy()
                elif self.target in ("gpt", "diff") and self.synth_eval:
                    gen_wav = self._synth_eval(first, step)
                else:
                    wav = model.infer_flowvae(first("raw_mel"), first("raw_spec_length"),
                                              key=step)
                    gen_wav = wav[0, :, 0].float().cpu().numpy()
            if self.rank != 0:
                return
            gt_wav = first("raw_wav").reshape(-1).float().cpu().numpy()
            save_wav(os.path.join(self.logs_folder, f"sample-{milestone}.wav"), gen_wav, sr)
            save_wav(os.path.join(self.logs_folder, f"gt-{milestone}.wav"), gt_wav, sr)
            if self.metrics is not None and self.metrics.tb is not None:
                d = self.cfg.data
                fe = MelFrontend(d.sampling_rate, d.filter_length, d.hop_length,
                                 d.win_length, d.n_mel_channels, d.mel_fmin, d.mel_fmax)
                gen_mel = fe.mel_spectrogram(torch.from_numpy(gen_wav)[None])[0].numpy()
                self.metrics.log_media(
                    step, mels={"mel/gt": first("raw_mel")[0].float().cpu().numpy(),
                                "mel/gen": gen_mel},
                    audios={"audio/gt": gt_wav, "audio/gen": gen_wav}, sr=sr)
        except Exception:  # noqa: BLE001 - eval must never kill training
            if split and gen_wav is None:
                raise  # a model peer may be waiting in one of the split GPT's collectives
            print("eval dump failed:", flush=True)
            traceback.print_exc()

    def _synth_eval(self, first, step: int) -> np.ndarray:
        """Synthesis from the clip's text and prompt mel on a fresh fp32
        engine over the folded current weights: ``vq_only`` for ``gpt``
        (train.py:234-236).  Under tensor parallelism the weights are
        gathered whole and the engine shards them over a (1 x M) mesh of
        this rank's model group, with no data group."""
        from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
        from detail_tts_tpu_torch.serving.pipeline import EngineConfig, TTSEngine

        sd = ckpt_lib.fold_state_dict(mesh.gather_state_dict(self.state.model))
        with torch.device(self.device):
            model = SynthesizerTrn(self.cfg)
        model.load_state_dict(sd)
        m = self.mesh
        engine = TTSEngine(model, EngineConfig(max_generate_length=200,
                                               compute_dtype=torch.float32,
                                               cache_dtype=torch.float32),
                           device=self.device,
                           mesh=None if m.model == 1 else mesh.Mesh(
                               1, m.model, m.model_rank, m.model_group, None, m.model_group))
        return engine.synthesize_from_ids(first("text"), first("mel"),
                                          first("spec_length"), seed=step,
                                          vq_only=self.target == "gpt")[0]

    # ---------------------------------------------------------------- train

    def train(self, max_steps: Optional[int] = None, log_every: int = 10) -> Dict[str, float]:
        """Step until ``state.step`` reaches ``max_steps``; every
        ``log_every`` steps and at ``max_steps`` the scalar metrics (and
        steps per second) are read back and logged, every ``val_freq`` steps an eval dump is
        written and every ``save_freq`` steps a checkpoint.  Each iteration
        is a ``train_step`` root span (``step``: the step it completes).
        Returns the last logged scalars."""
        if self.data_iter is None:
            raise ValueError("no data: call default_data() or pass data_iter")
        cfg = self.cfg.train
        max_steps = max_steps or cfg.train_steps
        logged: Dict[str, float] = {}
        t_last, step_last = time.perf_counter(), self.state.step
        while self.state.step < max_steps:
            with tracing.root("train_step", step=self.state.step + 1,
                              profiled=tracing.profiling()):
                batch = self.next_batch()
                metrics = self.step_fn(self.state, batch, self.generator,
                                       dropout_generator=self.dropout_generator)
                self.last_metrics = metrics
                step = self.state.step
                if step % log_every == 0 or step == max_steps:
                    with tracing.wait("log"):
                        logged = {k: float(v) for k, v in metrics.items()
                                  if torch.is_tensor(v) and v.dim() == 0}
                    now = time.perf_counter()
                    logged["steps_per_sec"] = (step - step_last) / (now - t_last)
                    t_last, step_last = now, step
                    if self.metrics is not None:
                        self.metrics.log(step, logged)
                if step % cfg.val_freq == 0:
                    self._eval_dump(batch)
                if step % cfg.save_freq == 0:
                    self.save()
        return logged


def _to_device(v, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
    if not t.is_floating_point():
        t = t.long()
    return t.to(device)
