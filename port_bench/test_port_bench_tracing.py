"""The readers of the program's spans, on a hand-built snapshot: which roots
they take (serving: closed batches run without the profiler or
``timings``, the engine's first left out; training: closed steps run
without the profiler), None where no root qualifies or the program has no
tracer, and their units."""
from pathlib import Path

import pytest

from detail_tts_tpu_torch import tracing
from port_bench import bench

METRICS = Path(__file__).resolve().parent / "metrics"
MS = 1_000_000  # ns


def _reader(name):
    return bench.load_reader(METRICS / f"{name}.py")


class _Snap:
    """Spans laid out by hand: ids in order, times in ms."""

    def __init__(self):
        self.spans, self._id = [], 0

    def add(self, name, parent, start, end, **attrs):
        self._id += 1
        root = self._id if parent is None else next(
            s["root"] for s in self.spans if s["id"] == parent)
        span = {"name": name, "id": self._id, "parent": parent, "root": root,
                "start_ns": int(start * MS), "end_ns": None if end is None else int(end * MS),
                "attrs": attrs, "device_ms": None}
        self.spans.append(span)
        return span

    def batch(self, n, *, steps=4, host_ms=2.0, device_ms=12.0, profiled=False, synced=False,
              closed=True):
        """A batch root with prepare (two waits), generate (its steps) and
        vocode (a wait)."""
        r = self.add("batch", None, 0, 1000 if closed else None, batch=n, profiled=profiled,
                     synced=synced)
        p = self.add("prepare", r["id"], 0, 400)
        self.add("wait", p["id"], 10, 20, site="text")
        self.add("wait", p["id"], 200, 300, site="prompt")
        g = self.add("generate", r["id"], 400, 500)
        g["device_ms"] = device_ms * steps
        for k in range(steps):
            st = self.add("decode_step", g["id"], 400 + 10 * k, 400 + 10 * k + host_ms)
            self.add("sample", st["id"], 400 + 10 * k, 400 + 10 * k + host_ms / 2)
        self.add("generate", r["id"], 600, 601).update(device_ms=0.5)  # the tail's wait stage
        v = self.add("vocode", r["id"], 700, 900)
        self.add("wait", v["id"], 700, 890, site="mel_lengths")
        return r

    def step(self, start, *, wall_ms, wait_ms, profiled=False, closed=True):
        r = self.add("train_step", None, start, start + wall_ms if closed else None,
                     step=int(start), profiled=profiled)
        f = self.add("forward", r["id"], start, start + wall_ms / 2)
        self.add("wait", f["id"], start + 1, start + 1 + wait_ms / 2, site="layer_drop")
        self.add("wait", r["id"], start + wall_ms / 2, start + wall_ms / 2 + wait_ms / 2,
                 site="log")
        return r


@pytest.fixture
def snap(monkeypatch):
    s = _Snap()
    monkeypatch.setattr(tracing, "snapshot", lambda: {"spans": s.spans, "counters": {}})
    return s


SERVE = ("decode_host_ms_per_step.serve", "decode_span_ms_per_step.serve")
TRAIN = ("host_wait_ms.train", "host_busy_ms.train")


def test_serving_readers_take_the_window_batches(snap):
    snap.batch(0, host_ms=50, device_ms=90)   # the engine's first
    snap.batch(1, host_ms=40, device_ms=80, profiled=True, synced=True)
    snap.batch(2, host_ms=30, device_ms=70, synced=True)
    snap.batch(3, host_ms=2, device_ms=12)
    snap.batch(4, host_ms=3, device_ms=13)
    snap.batch(5, host_ms=4, device_ms=14)
    snap.batch(6, host_ms=99, device_ms=99, closed=False)
    values = {m: _reader(m)({}) for m in SERVE}
    assert values["decode_host_ms_per_step.serve"] == pytest.approx(3.0)   # ms
    assert values["decode_span_ms_per_step.serve"] == pytest.approx(13.0)  # ms


def test_training_readers_take_the_unprofiled_steps(snap):
    snap.step(0, wall_ms=400, wait_ms=100)
    snap.step(1000, wall_ms=600, wait_ms=300)
    snap.step(2000, wall_ms=5000, wait_ms=4000, profiled=True)
    snap.step(9000, wall_ms=5000, wait_ms=4000, closed=False)
    assert _reader("host_wait_ms.train")({}) == pytest.approx(200.0)   # ms
    assert _reader("host_busy_ms.train")({}) == pytest.approx(300.0)   # ms


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_none_where_no_root_qualifies(snap, name):
    snap.batch(0)
    snap.batch(1, profiled=True)
    snap.batch(2, synced=True)
    snap.batch(3, closed=False)
    snap.step(0, wall_ms=400, wait_ms=100, profiled=True)
    assert _reader(name)({}) is None


@pytest.mark.parametrize("steps", [1, 4])
def test_decode_readers_take_a_step_count_of_their_batch(snap, steps):
    snap.batch(1, steps=steps, host_ms=5.0, device_ms=9.0)
    assert _reader("decode_host_ms_per_step.serve")({}) == pytest.approx(5.0)
    assert _reader("decode_span_ms_per_step.serve")({}) == pytest.approx(9.0)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_none_without_the_tracer(monkeypatch, name):
    import builtins

    real = builtins.__import__

    def no_tracer(mod, globals=None, locals=None, fromlist=(), level=0):
        if mod == "detail_tts_tpu_torch" and "tracing" in (fromlist or ()):
            raise ImportError("cannot import name 'tracing'")
        return real(mod, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_tracer)
    assert _reader(name)({}) is None
