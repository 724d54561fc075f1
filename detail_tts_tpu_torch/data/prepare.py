"""Offline data preparation: VAD -> clips -> transcripts -> jsonl -> VQ codes.

Counterpart of ``detail_tts_tpu/data/prepare.py`` (the reference's
prepare/ scripts: 0_vad_asr_save_to_jsonl.py, vad_process.py,
asr_process.py, 5_save_vq_to_disk.py / extract_vq.py):

* phase 1 (VAD): split on silence (-40 dBFS, 500 ms), keep 0.7-30 s clips
  at 24 kHz as PCM16 wavs; a numpy re-implementation of pydub's
  ``split_on_silence`` (windowed dBFS threshold, ``keep_silence`` padding);
* phase 2 (ASR): a pluggable recognizer ``(wav, sr) -> str`` (the
  reference hard-codes a Paraformer-zh model), or a table of existing
  transcripts; rows with Latin letters or under 2 characters are dropped
  (asr_process.py:14-46);
* phase 3 (VQ codes): the frozen encoder's codes of each clip, saved as
  ``<wav>.vq.npy`` (extract_vq.py:18-46 wrote .pth files), on the card
  unless ``device="cpu"``.
"""
from __future__ import annotations

import json
import os
import re
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from detail_tts_tpu_torch.data.dataset import read_wav, save_wav

Recognizer = Callable[[np.ndarray, int], str]

_LATIN_RE = re.compile(r"[A-Za-z]")


# ---------------------------------------------------------------------------
# Phase 1: VAD
# ---------------------------------------------------------------------------


def _dbfs(wav: np.ndarray, frame: int) -> np.ndarray:
    """Per-frame dBFS of a float waveform (pydub semantics, RMS-based)."""
    n = len(wav) // frame
    frames = wav[: n * frame].reshape(n, frame)
    rms = np.sqrt(np.mean(frames ** 2, axis=1))
    return 20.0 * np.log10(np.maximum(rms, 1e-10))


def split_on_silence(wav: np.ndarray, sr: int, min_silence_ms: int = 500,
                     silence_thresh_db: float = -40.0,
                     keep_silence_ms: int = 100) -> List[np.ndarray]:
    """pydub ``split_on_silence`` on a float waveform: cut at every run of
    10 ms frames under ``silence_thresh_db`` at least ``min_silence_ms``
    long, each chunk padded by ``keep_silence_ms`` of its surroundings."""
    frame = max(sr // 100, 1)
    silent = _dbfs(wav, frame) < silence_thresh_db
    min_frames = max(min_silence_ms // 10, 1)
    keep = int(keep_silence_ms / 1000 * sr)

    chunks: List[Tuple[int, int]] = []
    start, run_start = 0, None
    for i, s in enumerate(np.append(silent, False)):
        if s and run_start is None:
            run_start = i
        elif not s and run_start is not None:
            if i - run_start >= min_frames:
                if run_start * frame > start:
                    chunks.append((start, run_start * frame))
                start = i * frame
            run_start = None
    if len(wav) > start and not np.all(silent[start // frame:]):
        chunks.append((start, len(wav)))
    return [wav[max(0, a - keep):min(len(wav), b + keep)] for a, b in chunks]


def vad_file(path: str, out_dir: str, sr: int = 24000, min_secs: float = 0.7,
             max_secs: float = 30.0, silence_thresh_db: float = -40.0,
             min_silence_ms: int = 500) -> List[str]:
    """Split one file into ``<name>_<i>.wav`` clips in ``out_dir``; returns
    the paths written (vad_process.py:6-30)."""
    wav = read_wav(path, sr)
    base = os.path.splitext(os.path.basename(path))[0]
    written = []
    for i, clip in enumerate(split_on_silence(wav, sr, min_silence_ms,
                                              silence_thresh_db)):
        if not (min_secs <= len(clip) / sr <= max_secs):
            continue
        out = os.path.join(out_dir, f"{base}_{i:04d}.wav")
        save_wav(out, clip, sr)
        written.append(out)
    return written


def _vad_one(args) -> List[str]:
    path, out_dir, sr, kwargs = args
    try:
        return vad_file(path, out_dir, sr, **kwargs)
    except Exception as e:  # noqa: BLE001 - bad files are skipped, like the reference
        print(f"vad failed for {path}: {e!r}")
        return []


def vad_directory(in_paths: Sequence[str], out_dir: str, sr: int = 24000,
                  workers: int = 12, **kwargs) -> List[str]:
    """Phase 1 over many files, in ``workers`` spawned processes
    (0_vad_asr:26-30); returns every clip written."""
    import multiprocessing

    os.makedirs(out_dir, exist_ok=True)
    jobs = [(p, out_dir, sr, kwargs) for p in in_paths]
    if workers <= 1:
        return [c for job in jobs for c in vad_file(*job[:3], **kwargs)]
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        return [c for res in pool.map(_vad_one, jobs) for c in res]


# ---------------------------------------------------------------------------
# Phase 2: ASR or existing transcripts -> jsonl
# ---------------------------------------------------------------------------


def _keep_text(text: str, min_chars: int, drop_latin: bool) -> bool:
    return len(text) >= min_chars and not (drop_latin and _LATIN_RE.search(text))


def asr_to_jsonl(clip_paths: Sequence[str], jsonl_path: str,
                 recognizer: Recognizer, sr: int = 24000, min_chars: int = 2,
                 drop_latin: bool = True, workers: int = 4) -> int:
    """Transcribe clips and append ``{"text", "path"}`` rows
    (asr_process.py:14-46); a clip whose recognition fails is skipped, as
    the reference does.  Returns the rows written."""

    def work(path):
        try:
            text = recognizer(read_wav(path, sr), sr).strip()
        except Exception as e:  # noqa: BLE001 - per-clip fault tolerance
            print(f"asr failed for {path}: {e!r}")
            return None
        return {"text": text, "path": path} if _keep_text(text, min_chars, drop_latin) else None

    n = 0
    with ThreadPoolExecutor(max_workers=workers) as pool, open(jsonl_path, "a") as f:
        for row in pool.map(work, clip_paths):
            if row is not None:
                f.write(json.dumps(row, ensure_ascii=False) + "\n")
                n += 1
    return n


def load_transcript_table(path: str) -> List[Tuple[str, str]]:
    """(clip path, text) pairs from jsonl rows ``{"path", "text"}``,
    tab-separated ``path\\ttext`` or LJSpeech-style ``path|text`` lines."""
    pairs: List[Tuple[str, str]] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            if line.lstrip().startswith("{"):
                row = json.loads(line)
                pairs.append((row["path"], row["text"]))
            else:
                p, t = line.split("\t" if "\t" in line else "|", 1)
                pairs.append((p, t))
    return pairs


def transcripts_to_jsonl(pairs, jsonl_path: str, clips_dir: Optional[str] = None,
                         min_chars: int = 2, drop_latin: bool = True) -> int:
    """Existing transcripts -> jsonl rows, in place of ASR: the same text
    filters, and a row whose wav is missing is dropped.  ``pairs``: (path,
    text) pairs or a dict; relative paths resolve against ``clips_dir``.
    Returns the rows written."""
    if isinstance(pairs, dict):
        pairs = pairs.items()
    n = 0
    with open(jsonl_path, "a") as f:
        for path, text in pairs:
            if clips_dir is not None and not os.path.isabs(path):
                path = os.path.join(clips_dir, path)
            text = text.strip()
            if not _keep_text(text, min_chars, drop_latin):
                continue
            if not os.path.exists(path):
                print(f"transcripts: missing wav, dropping row: {path}")
                continue
            f.write(json.dumps({"text": text, "path": path}, ensure_ascii=False) + "\n")
            n += 1
    return n


# ---------------------------------------------------------------------------
# Phase 3: offline VQ-code extraction
# ---------------------------------------------------------------------------

BUCKET_FRAMES = 256  # pad mels to multiples of this (~2.7 s): few shapes


def extract_vq(jsonl_path: str, cfg, state_dict, device="cuda",
               suffix: str = ".vq.npy") -> int:
    """Save the VQ codes of every jsonl row's clip beside its wav, as int32
    ``n_frames // 4`` codes.  ``state_dict``: serving weights (e.g. from
    ``train/checkpoint.py:restore_variables``).

    Each mel is padded up to a multiple of 256 frames with the log-mel
    floor ``MEL_MIN`` (a silent frame, not 0.0, which is a loud one) and
    encoded by ``encode_masked``, so the codes do not depend on the pad.
    A row that fails is reported and skipped.  Returns files written."""
    import torch

    from detail_tts_tpu_torch.audio.mel import MEL_MIN, MelFrontend
    from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
    from detail_tts_tpu_torch.serving.pipeline import resolve_device

    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 codes, as the engine
    torch.backends.cudnn.allow_tf32 = False
    with torch.device(dev):
        model = SynthesizerTrn(cfg)
    model.load_state_dict(state_dict)
    model.eval().requires_grad_(False)
    d = cfg.data
    frontend = MelFrontend(d.sampling_rate, d.filter_length, d.hop_length, d.win_length,
                           d.n_mel_channels, d.mel_fmin, d.mel_fmax, device=dev)
    n = skipped = 0
    with open(jsonl_path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    for row in rows:
        try:
            wav = read_wav(row["path"], d.sampling_rate)
            if wav is None:
                raise OSError(f"unreadable wav: {row.get('path')}")
            n_frames = len(wav) // d.hop_length // 4 * 4
            if n_frames < 4:
                continue
            bucket = -(-n_frames // BUCKET_FRAMES) * BUCKET_FRAMES
            with torch.no_grad():
                mel = frontend.mel_spectrogram(torch.from_numpy(wav).to(dev)[None])
                mel = torch.nn.functional.pad(mel[:, :n_frames],
                                              (0, 0, 0, bucket - n_frames), value=MEL_MIN)
                codes, _ = model.encode_masked(
                    mel, torch.tensor([n_frames], dtype=torch.long, device=dev))
            np.save(row["path"] + suffix,
                    codes[0, :n_frames // 4].cpu().numpy().astype(np.int32))
            n += 1
        except Exception as e:  # noqa: BLE001 - corpus runs survive bad rows
            skipped += 1
            print(f"extract_vq: skipping row ({e!r})")
    if skipped:
        print(f"extract_vq: {skipped} rows skipped, {n} written")
    return n
