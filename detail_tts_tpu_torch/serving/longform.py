"""Long-form synthesis: sentence chunking with prompt reuse.

Counterpart of ``detail_tts_tpu/serving/longform.py``.  The model bounds its
context (GPT generation cap 600 codes, about 25.6 s), so long text is split
at sentence punctuation, the chunks go through the engine in batches with
the same voice prompt (zero-shot prompt reuse keeps the speaker), and the
pieces are joined with short crossfades.  Chunk batch k takes the k-th key
of JAX's chain from ``seed`` (an int, ``PRNGKey(seed)``, or a key):
``rng, key = split(rng)`` a batch.
"""
from __future__ import annotations

import re
from typing import Iterator, List, Optional, Sequence

import numpy as np

from detail_tts_tpu_torch.ops import prng

_SENT_SPLIT = re.compile(r"(?<=[。！？!?；;.])\s*")


def split_sentences(text: str, max_chars: int = 120) -> List[str]:
    """Split on sentence punctuation; re-chunk over-long pieces on commas."""
    parts = [p.strip() for p in _SENT_SPLIT.split(text) if p.strip()]
    out: List[str] = []
    for p in parts:
        while len(p) > max_chars:
            cut = max((p.rfind(c, 0, max_chars) for c in "，,、 "), default=-1)
            if cut <= 0:
                cut = max_chars
            out.append(p[:cut].strip())
            p = p[cut:].lstrip("，,、 ").strip()
        if p:
            out.append(p)
    return out


def crossfade_concat(wavs: Sequence[np.ndarray], sr: int,
                     fade_ms: float = 20.0) -> np.ndarray:
    """Concatenate with equal-power crossfades."""
    fade = max(int(sr * fade_ms / 1000.0), 1)
    out = np.asarray(wavs[0], np.float32)
    for w in wavs[1:]:
        w = np.asarray(w, np.float32)
        n = min(fade, len(out), len(w))
        if n > 0:
            t = np.linspace(0.0, np.pi / 2, n, dtype=np.float32)
            out_tail = out[-n:] * np.cos(t) ** 2 + w[:n] * np.sin(t) ** 2
            out = np.concatenate([out[:-n], out_tail, w[n:]])
        else:
            out = np.concatenate([out, w])
    return out


def _chunk_batches(engine, chunks: List[str], prompt_wav: np.ndarray, seed: prng.Seed,
                   batch_size: int, vq_only: bool) -> Iterator[List[np.ndarray]]:
    """The audio of each batch of chunks, in order."""
    fn = engine.synthesize_vq_batch if vq_only else engine.synthesize_batch
    rng = prng.as_key(seed)
    for i in range(0, len(chunks), batch_size):
        group = chunks[i:i + batch_size]
        rng, key = prng.split(rng)
        yield fn(group, [prompt_wav] * len(group), seed=key)


def synthesize_long(engine, text: str, prompt_wav: np.ndarray, seed: prng.Seed = 0,
                    batch_size: int = 8, max_chars: int = 120,
                    fade_ms: float = 20.0, vq_only: bool = False) -> np.ndarray:
    """Synthesize arbitrarily long text through the bounded-context engine."""
    wavs: List[np.ndarray] = []
    for batch in _chunk_batches(engine, split_sentences(text, max_chars=max_chars),
                                prompt_wav, seed, batch_size, vq_only):
        wavs.extend(batch)
    if not wavs:
        return np.zeros((0,), np.float32)
    return crossfade_concat(wavs, engine.cfg.data.sampling_rate, fade_ms=fade_ms)


def synthesize_long_stream(engine, text: str, prompt_wav: np.ndarray,
                           seed: prng.Seed = 0, batch_size: int = 8,
                           max_chars: int = 120, fade_ms: float = 20.0,
                           vq_only: bool = False) -> Iterator[np.ndarray]:
    """Streaming long-form synthesis: yields playable segments as each chunk
    batch completes (time to first audio: one batch, not the whole text).

    Each join's crossfade is applied before the segment is yielded: the last
    fade window of audio is held back to blend with the next batch, so the
    concatenated yields equal :func:`synthesize_long` with the same
    arguments, sample for sample.
    """
    sr = engine.cfg.data.sampling_rate
    fade = max(int(sr * fade_ms / 1000.0), 1)
    pending: Optional[np.ndarray] = None  # audio whose tail may still fade
    chunks = split_sentences(text, max_chars=max_chars)
    n_batches = -(-len(chunks) // batch_size)
    for k, wavs in enumerate(_chunk_batches(engine, chunks, prompt_wav, seed,
                                            batch_size, vq_only)):
        merged = crossfade_concat(
            wavs if pending is None else [pending] + list(wavs), sr, fade_ms=fade_ms)
        if k + 1 < n_batches:
            hold = min(fade, len(merged))
            if len(merged) > hold:
                yield merged[:-hold]
            pending = merged[-hold:]
        else:
            yield merged
