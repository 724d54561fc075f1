"""Microbatching request server around :class:`TTSEngine`.

Counterpart of ``detail_tts_tpu/serving/server.py``.  Concurrent requests
should ride one batched engine call, whose throughput at batch 8 is well
above batch 1's:

* requests enqueue (text, prompt_wav, seed) and get a Future;
* one dispatch thread drains the queue, groups up to ``max_batch``
  requests (waiting at most ``max_wait_ms`` for stragglers once the first
  request of a batch arrives) and runs them as one batch;
* voice conditioning stays per item (the engine pads prompts per item and
  masks); the batch's sampling noise comes from one key folded from the
  group's size and seeds (JAX's ``_batch_rng``), so exact sample-level
  reproducibility of a (text, prompt, seed) needs a direct batch-1 engine
  call.

One dispatch thread means one batch in flight per engine.  Within it the
loop double-buffers: batch N+1's decode is dispatched before batch N's audio
is fetched, then batch N is finalized, then batch N+1's tail is dispatched
(``TTSEngine.dispatch_decode`` / ``finalize_batch`` / ``dispatch_tail``),
so the device does not idle on host prep between batches.  The engine's
entry points run under ``torch.inference_mode`` themselves, since that mode
is per thread.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from detail_tts_tpu_torch.ops import prng


@dataclass
class _Request:
    text: str
    prompt_wav: np.ndarray
    seed: int
    vq_only: bool
    future: Future = field(default_factory=Future)


class TTSServer:
    """Threaded microbatching front-end for a TTSEngine.

    Usage::

        server = TTSServer(engine, max_batch=8, max_wait_ms=20)
        server.start()
        fut = server.submit("ni3 hao3", prompt_wav, seed=0)
        wav = fut.result()
        server.stop()
    """

    def __init__(self, engine, max_batch: int = 8, max_wait_ms: float = 20.0):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self.batches_dispatched = 0
        self.requests_served = 0

    # ------------------------------------------------------------------ api

    def submit(self, text: str, prompt_wav: np.ndarray, seed: int = 0,
               vq_only: bool = False) -> Future:
        """Enqueue a request; returns a Future that resolves to the wav.

        Each request is validated here (ValueError), so that a malformed one
        cannot fail the futures of the whole batch it would be grouped with.
        """
        if not self._running:
            raise RuntimeError("server not started")
        if not isinstance(text, str) or not text.strip():
            raise ValueError("text must be a non-empty string")
        wav = np.asarray(prompt_wav, np.float32)
        if wav.ndim != 1:
            raise ValueError(f"prompt_wav must be 1-D mono, got shape {wav.shape}")
        hop = int(self.engine.cfg.data.hop_length)
        if wav.shape[0] < hop:
            raise ValueError(f"prompt_wav too short: {wav.shape[0]} samples "
                             f"< one hop of {hop}")
        if not np.isfinite(wav).all():
            raise ValueError("prompt_wav contains non-finite samples")
        req = _Request(text, wav, seed, vq_only)
        self._queue.put(req)
        return req.future

    def synthesize(self, text: str, prompt_wav: np.ndarray, seed: int = 0,
                   timeout: Optional[float] = None) -> np.ndarray:
        """Blocking convenience wrapper."""
        return self.submit(text, prompt_wav, seed).result(timeout=timeout)

    def start(self) -> "TTSServer":
        if self._running:
            return self
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tts-dispatch")
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        if not self._running:
            return
        self._running = False
        self._queue.put(None)  # wake the dispatcher
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------- internals

    def _collect(self, block: bool = True) -> List[_Request]:
        """Wait for the first request, then drain stragglers until the batch
        deadline (``max_wait_ms`` after the first arrival) or ``max_batch``.

        ``block=False`` (a batch waits to be finalized): wait one batching
        window at most for the first request, so that the pending batch's
        futures resolve promptly when traffic pauses."""
        try:
            first = self._queue.get(
                timeout=None if block else self.max_wait_ms / 1000.0)
        except queue.Empty:
            return []
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_ms / 1000.0
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # re-post the stop sentinel
                break
            batch.append(nxt)
        return batch

    def _loop(self) -> None:
        # Double-buffer: batch N+1's decode is dispatched before batch N is
        # finalized, and N+1's tail after.  The tail's decode-length wait
        # would block until N+1's decode ends, which runs after all of N's
        # work, so finalizing N first keeps N's latency free of it.
        inflight = None  # (group, InflightBatch)
        while self._running:
            batch = self._collect(block=inflight is None)
            if not batch:
                if inflight is not None:
                    self._finalize(*inflight)
                    inflight = None
                continue
            for vq_only in (False, True):
                group = [r for r in batch if r.vq_only == vq_only]
                if not group:
                    continue
                if vq_only:
                    # another pipeline, with no split handle: drain first
                    if inflight is not None:
                        self._finalize(*inflight)
                        inflight = None
                    self._dispatch_vq(group)
                else:
                    pending = self._guard(group, self.engine.dispatch_decode,
                                          [r.text for r in group],
                                          [r.prompt_wav for r in group],
                                          seed=self._batch_key(group))
                    if inflight is not None:
                        self._finalize(*inflight)
                        inflight = None
                    if pending is not None:
                        handle = self._guard(group, self.engine.dispatch_tail, pending)
                        if handle is not None:
                            inflight = (group, handle)
        if inflight is not None:
            self._finalize(*inflight)

    @staticmethod
    def _batch_key(group: List[_Request]) -> prng.Key:
        """The batch's key: each request's seed folded into
        ``PRNGKey(len(group))`` in order (JAX's ``_batch_rng``)."""
        key = prng.PRNGKey(len(group))
        for r in group:
            key = prng.fold_in(key, r.seed & 0x7FFFFFFF)
        return key

    @staticmethod
    def _guard(group: List[_Request], fn, *args, **kwargs):
        """``fn(*args, **kwargs)``; on an exception, fail the group's futures
        (and only them) and return None."""
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # a failing batch must not stop the server
            for r in group:
                if not r.future.done():
                    r.future.set_exception(e)
            return None

    def _resolve(self, group: List[_Request], outs) -> None:
        # counters before the futures: a client unblocked by set_result may
        # read them at once
        self.batches_dispatched += 1
        self.requests_served += len(group)
        for r, wav in zip(group, outs):
            r.future.set_result(wav)

    def _finalize(self, group: List[_Request], handle) -> None:
        outs = self._guard(group, self.engine.finalize_batch, handle)
        if outs is not None:
            self._resolve(group, outs)

    def _dispatch_vq(self, group: List[_Request]) -> None:
        """One batched diffusion-free engine call for the group."""
        outs = self._guard(group, self.engine.synthesize_vq_batch,
                           [r.text for r in group], [r.prompt_wav for r in group],
                           seed=self._batch_key(group))
        if outs is not None:
            self._resolve(group, outs)
