"""Training data pipeline: jsonl corpus -> bucketed, padded host batches.

Counterpart of ``detail_tts_tpu/data/dataset.py`` (the reference dataset
and collate, vqvae/dataset_24k.py:43-272):

* jsonl rows ``{"path": wav, "text": zh}``; pinyin (TONE3, neutral 5), then
  the config's tokenizer;
* 24 kHz decode and resample (native/, scipy where it is unavailable);
  duration filter 0.69 s < len < 30.1 s (dataset_24k.py:124);
* linear spectrogram and log-mel from :class:`MelFrontend` on the CPU; the
  frame count trimmed to a multiple of 4 (:155);
* a random 496-frame crop above 500 frames, keeping full ``raw_*`` copies
  (:162);
* the 12-key padded batch (:258-272), rows sorted by descending raw length,
  lengths padded up to fixed buckets.

Background decode threads fill a bounded queue; each thread builds whole
batches of micro x accum clips, with JAX's seeding, so one thread gives
the JAX package's batches exactly.  Batches are numpy arrays in JAX's
layout ``(accum, micro, ...)``, channels last, int32 lengths and ids; the
trainer moves them to its device.  The card never sees a decode thread.

Under data parallelism each rank loads its own rows of the corpus
(``JsonlTtsDataset(rank, world)``) into micro-batches of ``batch_size //
world``, and the ranks agree on each batch's padded lengths (the max of
their buckets, one small all-reduce in ``next``), so the world-W batch is a
world-1 batch cut by rows, as JAX's one global array is.  Under tensor
parallelism the rows are the data rank's (``JsonlTtsDataset(data rank,
D)``), and every model peer of a data rank must hold the same batch: model
rank 0 decodes it and sends it to its peers (``DataIterator(model_group=)``),
since the decode threads' interleaving is not reproducible across
processes.
"""
from __future__ import annotations

import dataclasses
import json
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from detail_tts_tpu_torch.audio.mel import MelFrontend
from detail_tts_tpu_torch.config import Config
from detail_tts_tpu_torch.native import load_wav_native
from detail_tts_tpu_torch.parallel import mesh
from detail_tts_tpu_torch.text.pinyin import to_pinyin


def read_wav(path: str, target_sr: int) -> Optional[np.ndarray]:
    """Mono float32 at ``target_sr``: the native decoder for ``.wav`` files,
    else (or where it is unavailable) scipy's reader and ``resample_poly``."""
    if path.lower().endswith(".wav"):
        wav = load_wav_native(path, target_sr)
        if wav is not None:
            return wav
    import scipy.signal as sps
    from scipy.io import wavfile

    sr, wav = wavfile.read(path)
    wav = np.asarray(wav)
    if wav.ndim > 1:
        wav = wav[:, 0]
    if wav.dtype == np.int16:
        wav = wav.astype(np.float32) / 32768.0
    elif wav.dtype == np.int32:
        wav = wav.astype(np.float32) / 2147483648.0
    else:
        wav = wav.astype(np.float32)
    if sr != target_sr:
        g = np.gcd(sr, target_sr)
        wav = sps.resample_poly(wav, target_sr // g, sr // g).astype(np.float32)
    return wav


def save_wav(path: str, wav: np.ndarray, sr: int) -> None:
    """PCM16 WAV: float samples clipped to [-1, 1], or int16 as they are
    (the engine's ``pcm16_output`` mode)."""
    from scipy.io import wavfile

    if wav.dtype == np.int16:
        wavfile.write(path, sr, wav)
        return
    pcm = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sr, (pcm * 32767.0).astype(np.int16))


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Padding buckets (frame counts; all multiples of 4)."""

    crop_frames: int = 496          # dataset_24k.py:162-167
    crop_threshold: int = 500
    raw_buckets: Sequence[int] = (512, 1024, 1536, 2048, 2560, 2824)
    text_buckets: Sequence[int] = (32, 64, 128, 256, 512, 800)

    def bucket(self, n: int, buckets: Sequence[int]) -> int:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]


class JsonlTtsDataset:
    """Random access to decoded samples (host side, numpy out).

    Rows are shuffled with ``seed`` and then sharded: this process keeps
    rows ``rank::world``."""

    def __init__(self, cfg: Config, jsonl_path: str, tokenizer,
                 min_secs: float = 0.69, max_secs: float = 30.1,
                 seed: int = 1234, rank: int = 0, world: int = 1):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.min_secs, self.max_secs = min_secs, max_secs
        d = cfg.data
        self.frontend = MelFrontend(d.sampling_rate, d.filter_length, d.hop_length,
                                    d.win_length, d.n_mel_channels, d.mel_fmin,
                                    d.mel_fmax)
        rows: List[Dict[str, str]] = []
        with open(jsonl_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        np.random.default_rng(seed).shuffle(rows)
        self.rows = rows[rank::world]

    def __len__(self) -> int:
        return len(self.rows)

    def features(self, wav: np.ndarray) -> Dict[str, np.ndarray]:
        """spec, mel and wav of one clip, trimmed to a multiple of 4 frames.

        The wav is zero-padded to a multiple of ``hop * 128`` samples before
        the STFT, as JAX does, so the last kept frame reads zeros past the
        end of the clip (not the frontend's reflection)."""
        hop = self.cfg.data.hop_length
        n_true = len(wav) // hop // 4 * 4
        pad = (-len(wav)) % (hop * 128)
        with torch.no_grad():
            y = torch.from_numpy(np.pad(wav, (0, pad)))[None]
            spec = self.frontend.linear_spectrogram(y)[0, :n_true]
            mel = self.frontend.spec_to_mel(spec)
        return {"spec": spec.numpy(), "mel": mel.numpy(), "wav": wav[: n_true * hop]}

    def load(self, index: int) -> Optional[Dict[str, np.ndarray]]:
        """Decode one sample; None when it fails or is filtered out (the
        reference drops such rows too)."""
        try:
            row = self.rows[index]
            sr = self.cfg.data.sampling_rate
            wav = read_wav(row["path"], sr)
            if wav is None or not (self.min_secs < len(wav) / sr < self.max_secs):
                return None
            text = self.tokenizer.encode(to_pinyin(row["text"]))
            if not text:
                return None
            return {**self.features(wav), "text": np.asarray(text, np.int32)}
        except Exception:  # noqa: BLE001 - a corpus run survives bad rows
            return None


def _crop(sample: Dict[str, np.ndarray], buckets: BucketSpec,
          rng: np.random.Generator, hop: int) -> Dict[str, np.ndarray]:
    """Random 496-frame crop with raw copies kept (dataset_24k.py:152-171)."""
    spec, mel, wav = sample["spec"], sample["mel"], sample["wav"]
    out = {"raw_spec": spec, "raw_mel": mel, "raw_wav": wav, "text": sample["text"]}
    if spec.shape[0] > buckets.crop_threshold:
        start = int(rng.integers(0, spec.shape[0] - buckets.crop_threshold + 1))
        end = start + buckets.crop_frames
        spec, mel, wav = spec[start:end], mel[start:end], wav[start * hop:end * hop]
    out.update({"spec": spec, "mel": mel, "wav": wav})
    return out


def collate(samples: List[Dict[str, np.ndarray]], buckets: BucketSpec,
            hop: int, spec_channels: int, mel_channels: int) -> Dict[str, np.ndarray]:
    """Pad to bucketed shapes; the 12-key contract (dataset_24k.py:258-272),
    rows sorted by descending raw length."""
    samples = sorted(samples, key=lambda s: -s["raw_spec"].shape[0])
    b = len(samples)
    # an uncropped sample may be up to crop_threshold frames long (the
    # reference crops only above 500 frames, but TO 496)
    thr4 = -(-buckets.crop_threshold // 4) * 4
    t_crop = buckets.bucket(max(s["spec"].shape[0] for s in samples),
                            (buckets.crop_frames, thr4))
    t_raw = buckets.bucket(max(s["raw_spec"].shape[0] for s in samples),
                           buckets.raw_buckets)
    t_text = buckets.bucket(max(len(s["text"]) for s in samples) + 1,
                            buckets.text_buckets)
    out = {
        "spec": np.zeros((b, t_crop, spec_channels), np.float32),
        "mel": np.zeros((b, t_crop, mel_channels), np.float32),
        "wav": np.zeros((b, t_crop * hop, 1), np.float32),
        "raw_spec": np.zeros((b, t_raw, spec_channels), np.float32),
        "raw_mel": np.zeros((b, t_raw, mel_channels), np.float32),
        "raw_wav": np.zeros((b, t_raw * hop, 1), np.float32),
        "text": np.zeros((b, t_text), np.int32),
        "spec_length": np.zeros((b,), np.int32),
        "raw_spec_length": np.zeros((b,), np.int32),
        "wav_length": np.zeros((b,), np.int32),
        "raw_wav_length": np.zeros((b,), np.int32),
        "text_length": np.zeros((b,), np.int32),
    }
    for i, s in enumerate(samples):
        ts, tr, tt = s["spec"].shape[0], s["raw_spec"].shape[0], len(s["text"])
        out["spec"][i, :ts] = s["spec"]
        out["mel"][i, :ts] = s["mel"]
        out["wav"][i, :ts * hop, 0] = s["wav"][:ts * hop]
        out["raw_spec"][i, :tr] = s["raw_spec"]
        out["raw_mel"][i, :tr] = s["raw_mel"]
        out["raw_wav"][i, :tr * hop, 0] = s["raw_wav"][:tr * hop]
        out["text"][i, :tt] = s["text"]
        out["spec_length"][i] = ts
        out["raw_spec_length"][i] = tr
        out["wav_length"][i] = ts * hop
        out["raw_wav_length"][i] = tr * hop
        out["text_length"][i] = tt
    return out


# Keys padded together (axis 2 of (accum, micro, T, ...)): the crop, the
# raw copies and the text; the wavs in samples.
_PADDED = (("spec", "mel", "wav"), ("raw_spec", "raw_mel", "raw_wav"), ("text",))


def pad_to_agreed(batch: Dict[str, np.ndarray], hop: int, group) -> Dict[str, np.ndarray]:
    """``batch`` zero-padded to the ranks' largest crop, raw and text
    lengths (one all-reduce of three integers)."""
    own = [batch[keys[0]].shape[2] for keys in _PADDED]
    agreed = mesh.all_reduce_max_host(own, group)
    out = dict(batch)
    for n, want, keys in zip(own, agreed, _PADDED):
        for key in keys:
            width = [(0, 0)] * out[key].ndim
            width[2] = (0, (want - n) * (hop if key.endswith("wav") else 1))
            out[key] = np.pad(out[key], width)
    return out


class DataIterator:
    """Endless shuffled batches from background decode threads.

    Each batch holds micro_batch x accum clips in the layout (accum, micro,
    ...).  Thread ``wid`` crops with ``default_rng(hash((wid, 1234)) %
    2**31)``; the visiting order is a permutation from ``default_rng(seed)``,
    drawn anew at each pass.  ``group``: the process group of every rank
    (the world); ``next`` then pads each batch to the ranks' agreed lengths
    (every rank must call it once a step).  ``model_group``: this rank's
    model group under tensor parallelism; its rank 0 decodes and broadcasts
    each batch, and the other peers run no decode thread.  ``close()``
    stops and joins the threads."""

    def __init__(self, dataset: JsonlTtsDataset, micro_batch: int,
                 accum: int = 1, buckets: BucketSpec = BucketSpec(),
                 num_threads: int = 8, prefetch: int = 4, seed: int = 0, group=None,
                 model_group=None):
        self.ds = dataset
        self.group = group
        self.model_group = model_group
        if model_group is not None and mesh.rank(model_group) > 0:
            num_threads = 0  # the batches come from model rank 0
        self.micro = micro_batch
        self.accum = accum
        self.buckets = buckets
        self.rng = np.random.default_rng(seed)
        self.hop = dataset.cfg.data.hop_length
        self.spec_ch = dataset.cfg.data.spec_channels
        self.mel_ch = dataset.cfg.data.n_mel_channels
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._index_lock = threading.Lock()
        self._perm = self.rng.permutation(len(dataset))
        self._cursor = 0
        self._threads = [threading.Thread(target=self._worker, args=(i,), daemon=True)
                         for i in range(num_threads)]
        for t in self._threads:
            t.start()

    def _next_index(self) -> int:
        with self._index_lock:
            if self._cursor >= len(self._perm):
                self._perm = self.rng.permutation(len(self.ds))
                self._cursor = 0
            i = int(self._perm[self._cursor])
            self._cursor += 1
            return i

    def _worker(self, wid: int) -> None:
        rng = np.random.default_rng(hash((wid, 1234)) % (2 ** 31))
        need = self.micro * self.accum
        while not self._stop.is_set():
            items: List[Dict[str, np.ndarray]] = []
            while len(items) < need and not self._stop.is_set():
                s = self.ds.load(self._next_index())
                if s is not None:
                    items.append(_crop(s, self.buckets, rng, self.hop))
            if len(items) < need:
                return
            batch = collate(items, self.buckets, self.hop, self.spec_ch, self.mel_ch)
            batch = {k: v.reshape((self.accum, self.micro) + v.shape[1:])
                     for k, v in batch.items()}
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self._q.get() if self._threads else None
        if self.model_group is not None:
            box = [batch]
            dist.broadcast_object_list(box, src=dist.get_global_rank(self.model_group, 0),
                                       group=self.model_group)
            batch = box[0]
        if mesh.world(self.group) > 1:
            batch = pad_to_agreed(batch, self.hop, self.group)
        return batch

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:  # a thread stops after the clip it decodes
            t.join(60.0)
