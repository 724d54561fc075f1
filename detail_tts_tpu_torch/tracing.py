"""Spans and counters of the engine and the trainer, kept in memory.

``snapshot()`` returns what is kept as plain Python data: the spans of the
last ``RING_ROOTS`` roots with their children, and the process's counters.

* A **root** is one batch of ``TTSEngine`` (``batch``: from
  ``dispatch_decode`` to ``finalize_batch``, attributes ``batch``, the
  engine's count of batches before it, ``profiled`` and ``synced``) or
  one iteration of ``Trainer.train`` (``train_step``: its batch, step,
  metric read-back, eval and save; attributes ``step`` and ``profiled``).
  Every span records its parent and its root.
* A **stage** span (``prepare``, ``generate``, ``diffuse``, ...,
  ``forward``, ``backward``, ...) is a stage of a batch or a step.  On
  CUDA a batch's stages also time their work on the device with a pair of
  CUDA events, read once the device has passed them (``device_ms``), so
  that no read waits.
* A **decode_step** span (children ``sample`` and ``gpt``) is one step of
  the autoregressive decode, host time; counter ``decode.steps``.  Where
  the GPT's step is a CUDA graph (``models/gpt.py`` ``DecodeSteps``),
  ``gpt`` is the host's enqueue of one graph launch, counted under
  ``decode.graph_replays``; each capture of a graph counts under
  ``decode.graph_captures``.
* A **wait** span (attribute ``site``) is a place where the host blocks
  until the device has finished the work queued before it; a kept one
  adds its count and seconds to the counter ``wait.<site>``.

A counter holds a count and seconds since the process started, beyond
the ring.  Host times are ``time.perf_counter_ns()`` moved by one offset
onto the Unix clock that ``torch.profiler`` stamps its events with, so
spans and a device trace lie on one timeline.  While a profiler runs, every span is
also a ``record_function`` range of its name, whether or not recording is
on.  Recording is on unless ``set_enabled(False)``; a span opened with no
root open (outside a batch or a training step) is not kept, and a wait
there is not counted.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

# roots kept, each with its children: a serving batch of 400 codes holds
# ~1,200 spans
RING_ROOTS = 64


def _unix_offset_ns() -> int:
    """``time.time_ns() - time.perf_counter_ns()``, from the tightest of a
    few paired reads."""
    best = None
    for _ in range(8):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, unix - (a + b) // 2)
    return best[1]


_OFFSET_NS = _unix_offset_ns()


def now_ns() -> int:
    """The host clock of spans: nanoseconds on the profiler's clock."""
    return time.perf_counter_ns() + _OFFSET_NS


_profiler_enabled = torch._C._autograd._profiler_enabled


def profiling() -> bool:
    """A ``torch.profiler`` is recording."""
    return _profiler_enabled()


class Span:
    """One interval of host time.  A root has no parent and holds its
    children."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns", "attrs",
                 "events", "device_ms", "children")

    def __init__(self, name: str, span_id: int, parent: Optional["Span"],
                 attrs: Optional[Dict]):
        self.name, self.id, self.parent, self.attrs = name, span_id, parent, attrs
        self.root = self if parent is None else parent.root
        self.events = self.device_ms = self.end_ns = None
        self.children: Optional[List[Span]] = [] if parent is None else None
        self.start_ns = now_ns()

    def settle(self) -> None:
        """Read the device time of the CUDA event pair once the device has
        passed its end (never waits)."""
        if self.events is not None and self.events[1].query():
            self.device_ms = self.events[0].elapsed_time(self.events[1])
            self.events = None

    def as_dict(self) -> Dict:
        return {"name": self.name, "id": self.id,
                "parent": None if self.parent is None else self.parent.id,
                "root": self.root.id, "start_ns": self.start_ns, "end_ns": self.end_ns,
                "attrs": dict(self.attrs or {}), "device_ms": self.device_ms}


class _Scope:
    """``with``: a span from enter to exit, innermost on this thread while
    it is open, and a profiler range of its name while a profiler runs."""

    __slots__ = ("_tracer", "_name", "_parent", "_attrs", "_root", "span", "_range",
                 "_stack")

    def __init__(self, tracer: "Tracer", name: str, parent: Optional[Span],
                 attrs: Optional[Dict], root: bool = False):
        self._tracer, self._name, self._parent, self._attrs = tracer, name, parent, attrs
        self._root = root
        self.span = self._range = None

    def __enter__(self) -> Optional[Span]:
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()
        t = self._tracer
        if not t.enabled:
            return None
        stack = self._stack = t._stack()
        if self._root:
            s = t.open_root(self._name, **(self._attrs or {}))
        else:
            parent = self._parent or (stack[-1] if stack else None)
            if parent is None:
                return None
            s = Span(self._name, next(t._ids), parent, self._attrs)
            parent.root.children.append(s)
        stack.append(s)
        self.span = s
        return s

    def __exit__(self, *exc) -> bool:
        s = self.span
        if s is not None:
            self._stack.pop()
            self._tracer.close(s)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class _Wait(_Scope):
    """A ``wait`` span that, once kept, adds its count and seconds to the
    counter ``wait.<site>``."""

    __slots__ = ()

    def __init__(self, tracer: "Tracer", site: str):
        super().__init__(tracer, "wait", None, {"site": site})

    def __exit__(self, *exc) -> bool:
        super().__exit__(*exc)
        s = self.span
        if s is not None:
            self._tracer.count("wait." + s.attrs["site"], 1, (s.end_ns - s.start_ns) / 1e9)
        return False


class Tracer:
    """The ring of roots, the counters and each thread's open spans."""

    def __init__(self):
        self.enabled = True
        self._lock = threading.Lock()
        self._roots: "collections.deque[Span]" = collections.deque(maxlen=RING_ROOTS)
        self._counters: Dict[str, List] = {}
        self._local = threading.local()
        self._ids = itertools.count(1)

    def _stack(self) -> List[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def open_root(self, name: str, **attrs) -> Optional[Span]:
        """A root, open until :meth:`close`; the oldest root leaves the
        ring.  None while recording is off."""
        if not self.enabled:
            return None
        s = Span(name, next(self._ids), None, attrs)
        with self._lock:
            self._roots.append(s)
        return s

    def close(self, span: Optional[Span]) -> None:
        """End ``span``; a root also reads its stages' device times that the
        device has passed."""
        if span is None or span.end_ns is not None:
            return
        span.end_ns = now_ns()
        if span.children is not None:
            for c in span.children:
                c.settle()

    def span(self, name: str, parent: Optional[Span] = None, **attrs) -> _Scope:
        """``with``: a span under ``parent`` or the innermost open span."""
        return _Scope(self, name, parent, attrs or None)

    def root(self, name: str, **attrs) -> _Scope:
        """``with``: a root, innermost on this thread while it is open."""
        return _Scope(self, name, None, attrs, root=True)

    def wait(self, site: str) -> _Wait:
        """``with``: the host waits for the device at ``site``."""
        return _Wait(self, site)

    def count(self, name: str, n: int = 1, seconds: float = 0.0) -> None:
        """Add to counter ``name``."""
        if not self.enabled:
            return
        with self._lock:
            c = self._counters.setdefault(name, [0, 0.0])
            c[0] += n
            c[1] += seconds

    def snapshot(self) -> Dict:
        """``{"spans": [...], "counters": {name: {"count", "seconds"}}}``:
        each root of the ring, oldest first, followed by its children in
        the order they opened; a span is a dict of ``name``, ``id``,
        ``parent`` and ``root`` (ids), ``start_ns``, ``end_ns`` (None while
        open), ``attrs`` and ``device_ms`` (None where not timed on the
        device or not passed yet)."""
        with self._lock:
            roots = list(self._roots)
            counters = {k: {"count": c, "seconds": s} for k, (c, s) in self._counters.items()}
        spans = []
        for r in roots:
            children = list(r.children)
            for c in children:
                c.settle()
            spans.append(r.as_dict())
            spans.extend(c.as_dict() for c in children)
        return {"spans": spans, "counters": counters}


@contextlib.contextmanager
def stage(name: str, timings: Optional[Dict[str, float]] = None, device=None, wait=True,
          parent: Optional[Span] = None, events: bool = False):
    """A stage of a batch or a step: a span under ``parent`` or the
    innermost open span.  ``events``: on CUDA, time the stage's work on the
    device (a CUDA event before its first launch and after its last).
    With ``timings``, its wall time is added under ``name``, after waiting
    for the device: for all its work (``wait=True``), for the work before
    an event (``wait`` the event), or not at all (``wait=False``)."""
    cuda = device is not None and torch.device(device).type == "cuda"
    with TRACER.span(name, parent) as s:
        timed = s is not None and events and cuda
        if timed:
            stream = torch.cuda.current_stream(device)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record(stream)
        t0 = time.perf_counter()
        yield s
        if timed:
            end.record(stream)
            s.events = (start, end)
        if timings is not None:
            if cuda and wait is not False:
                if wait is True:
                    torch.cuda.synchronize(device)
                else:
                    wait.synchronize()
            timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


TRACER = Tracer()
span = TRACER.span
root = TRACER.root
wait = TRACER.wait
count = TRACER.count
open_root = TRACER.open_root
close = TRACER.close
snapshot = TRACER.snapshot


def set_enabled(flag: bool) -> None:
    """Turn recording of spans and counters on or off (profiler ranges and
    ``timings`` go on either way)."""
    TRACER.enabled = bool(flag)
