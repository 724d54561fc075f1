"""SPMD control of a sharded engine: rank 0 takes the calls, every other
rank follows it call for call.

This module stands where JAX's single controller needs nothing.  In JAX one
process drives every device of a ``TTSEngine(mesh=)``, so ``TTSServer``,
``http_api.serve`` and ``synthesize_long`` take a sharded engine as they
are.  The port's sharded engine is SPMD: every rank must call the same
method with the whole request (``serving/pipeline.py``).  So on a mesh:

* rank 0 wraps its engine in :class:`LeaderEngine` and hands that to the
  front ends, which take it as they take an engine;
* every other rank runs :func:`follow` on its engine, which returns when
  the leader closes.

Each engine call of the leader is first broadcast to every rank of the
mesh: a call id, the method and its host arguments (texts, prompt wavs as
numpy, the key folded on rank 0, knobs; tensors on the CPU).  A handle
that an earlier call returned (``PendingDecode``, ``InflightBatch``) goes
as that call's id, and every rank keeps its own handles by id.  Then every
rank runs the call, and one all-reduce of an error flag agrees its outcome:

* every rank raised: the leader re-raises its own exception, so the server
  fails only that batch's futures, as it does on one card (a request the
  one-card engine refuses raises on every rank, before any collective);
* some ranks raised: the leader raises a ``RuntimeError`` that names them
  and their exceptions; every rank drops the call's handle and stays ready
  for the next call.

The channel is a gloo group of its own over the mesh's ranks, carrying
``broadcast_object_list``: it never touches NCCL or the card.  While the
leader is idle it sends a keep-alive every quarter of the group's
``timeout``, so an idle server does not end its followers.  The timeout
bounds every other wait on the channel: a follower that has failed waits in
the outcome's all-reduce while the others finish the call, so it must
exceed the longest call.

A fault inside a collective cannot be caught this way.  A rank that raises
after another has entered a collective that it will not enter leaves that
one waiting there until the engine's process group times out (under NCCL its
watchdog then ends the process; under gloo the collective raises and the
outcome is agreed).  No fault is swallowed, and no rank carries on alone.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Union

import torch
import torch.distributed as dist

from detail_tts_tpu_torch.serving.pipeline import InflightBatch, PendingDecode, TTSEngine

# The engine methods the front ends call, and so those the leader sends.
CALLS = ("dispatch_decode", "dispatch_tail", "dispatch_batch", "finalize_batch",
         "synthesize_batch", "synthesize", "synthesize_vq_batch", "synthesize_from_ids",
         "warmup")
TIMEOUT = datetime.timedelta(hours=1)
_CLOSE = "close"


@dataclasses.dataclass
class Handle:
    """A handle that a leader's call returned: ``local`` is rank 0's own
    (``PendingDecode`` or ``InflightBatch``), ``call_id`` names every
    other rank's."""

    call_id: int
    local: Union[PendingDecode, InflightBatch]


@dataclasses.dataclass(frozen=True)
class _Ref:
    call_id: int


def _channel(engine: TTSEngine, timeout: datetime.timedelta):
    """(the control group over ``engine``'s mesh, the global rank of its
    rank 0).  Every rank of the default group must call it, in the same
    order (``dist.new_group``)."""
    m = engine.mesh
    if m is None or m.world_group is None:
        raise ValueError("the control channel needs an engine on a mesh of ranks")
    ranks = [dist.get_global_rank(m.world_group, i) for i in range(m.data * m.model)]
    return dist.new_group(ranks, timeout=timeout, backend="gloo"), ranks[0]


def _outcome(group, error: Optional[BaseException]) -> Optional[List[Optional[str]]]:
    """Every rank's exception as text (None where the call returned), or
    None where no rank raised: one all-reduce, and a gather after a fault."""
    failed = torch.tensor([error is not None], dtype=torch.int64)
    dist.all_reduce(failed, group=group)
    if not failed.item():
        return None
    errors: List[Optional[str]] = [None] * dist.get_world_size(group)
    dist.all_gather_object(errors, None if error is None else
                           f"{type(error).__name__}: {error}", group=group)
    return errors


def _map(fn, args: tuple, kwargs: dict):
    """``fn`` over a call's arguments (not into them: a caller's ``timings``
    dict stays the one the engine fills)."""
    return tuple(fn(a) for a in args), {k: fn(v) for k, v in kwargs.items()}


class LeaderEngine:
    """Rank 0's engine for the front ends: each call runs on every rank of
    ``engine``'s mesh (see the module's docstring).  Every other rank runs
    :func:`follow`; :meth:`close` (or leaving a ``with`` block) ends it."""

    def __init__(self, engine: TTSEngine, timeout: datetime.timedelta = TIMEOUT):
        self._group, self._leader = _channel(engine, timeout)
        if engine.mesh.rank != 0:
            raise ValueError(f"the leader is rank 0 of the mesh, not rank {engine.mesh.rank}")
        self.engine = engine
        self._keepalive = timeout.total_seconds() / 4
        self._ids = itertools.count()
        self._lock = threading.Lock()  # one message and its call at a time
        self._closed = threading.Event()
        self._last = time.monotonic()
        self._pinger = threading.Thread(target=self._ping, daemon=True, name="spmd-keepalive")
        self._pinger.start()

    cfg = property(lambda self: self.engine.cfg)
    ecfg = property(lambda self: self.engine.ecfg)
    device = property(lambda self: self.engine.device)

    def _send(self, msg) -> None:
        dist.broadcast_object_list([msg], src=self._leader, group=self._group)
        self._last = time.monotonic()

    def _ping(self) -> None:
        while not self._closed.wait(self._keepalive / 2):
            with self._lock:
                if (not self._closed.is_set()
                        and time.monotonic() - self._last >= self._keepalive):
                    self._send(None)

    def call(self, name: str, *args, **kwargs):
        """``engine.<name>(*args, **kwargs)`` on every rank; rank 0's result
        (a :class:`Handle` in place of a handle)."""
        if name not in CALLS:
            raise ValueError(f"{name!r} is not one of {CALLS}")

        def wire(x):  # what the followers receive
            if isinstance(x, Handle):
                return _Ref(x.call_id)
            return x.detach().cpu() if torch.is_tensor(x) else x

        def local(x):
            return x.local if isinstance(x, Handle) else x

        with self._lock:
            if self._closed.is_set():
                raise RuntimeError("the leader is closed")
            call_id = next(self._ids)
            self._send((call_id, name) + _map(wire, args, kwargs))
            # the current card is per host thread: the caller may be a server's
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            result = error = None
            try:
                a, kw = _map(local, args, kwargs)
                result = getattr(self.engine, name)(*a, **kw)
            except Exception as e:  # agreed with the other ranks below
                error = e
            errors = _outcome(self._group, error)
        if errors is None:
            return Handle(call_id, result) if isinstance(
                result, (PendingDecode, InflightBatch)) else result
        if all(e is not None for e in errors):
            raise error
        failed = "; ".join(f"rank {r}: {e}" for r, e in enumerate(errors) if e is not None)
        raise RuntimeError(f"{name} failed on some ranks of the mesh only ({failed})") \
            from error

    def close(self) -> None:
        """End every follower (each :func:`follow` returns); idempotent."""
        with self._lock:
            if self._closed.is_set():
                return
            self._closed.set()
            self._send((next(self._ids), _CLOSE, (), {}))
            _outcome(self._group, None)
        self._pinger.join()

    def __enter__(self) -> "LeaderEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _method(name: str):
    def method(self, *args, **kwargs):
        return self.call(name, *args, **kwargs)
    method.__name__ = name
    method.__doc__ = f"``TTSEngine.{name}`` on every rank of the mesh; rank 0's result."
    return method


for _name in CALLS:
    setattr(LeaderEngine, _name, _method(_name))


def follow(engine: TTSEngine, timeout: datetime.timedelta = TIMEOUT) -> int:
    """Run the leader's calls on this rank's ``engine`` until it closes;
    returns the number of calls run.  Audio is dropped; handles are kept by
    call id until a later call takes them."""
    group, leader = _channel(engine, timeout)
    if engine.mesh.rank == 0:
        raise ValueError("rank 0 of the mesh leads; the others follow")
    if engine.device.type == "cuda":
        torch.cuda.set_device(engine.device)
    handles: Dict[int, Any] = {}

    def local(x):
        if isinstance(x, _Ref):
            return handles.pop(x.call_id)
        return x.to(engine.device) if torch.is_tensor(x) else x

    for calls in itertools.count():
        msg = [None]
        while msg[0] is None:  # None: the leader's keep-alive
            dist.broadcast_object_list(msg, src=leader, group=group)
        call_id, name, args, kwargs = msg[0]
        if name == _CLOSE:
            _outcome(group, None)
            return calls
        result = error = None
        try:
            a, kw = _map(local, args, kwargs)
            result = getattr(engine, name)(*a, **kw)
        except Exception as e:  # agreed with the other ranks below
            error = e
        if _outcome(group, error) is None and isinstance(result, (PendingDecode,
                                                                  InflightBatch)):
            handles[call_id] = result
