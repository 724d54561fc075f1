"""The traffic generator: the same inputs from the same seed, others from
another, the same sizes in every batch, and text the pinyin table covers."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench.generator import ServeTraffic, TrainTraffic, covered_chars
from port_bench.reference import pinyin

HERE = Path(__file__).resolve().parent
SERVE = json.loads((HERE / "traffic" / "offline-b16-400codes.json").read_text())
TRAIN = dict(json.loads((HERE / "traffic" / "diff-steps-b64x2.json").read_text()),
             micro_batch=3, frames=16)
SEEDS = (0, 7, 2 ** 31 + 5, 3 * 2 ** 32 + 11)


def _same(a, b):
    return a[0] == b[0] and all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))


@pytest.mark.parametrize("seed", SEEDS)
def test_serve_batches_repeat_from_the_seed(seed):
    a, b = ServeTraffic(SERVE, seed), ServeTraffic(SERVE, seed)
    for i in (-1, 0, 3):
        assert _same(a.batch(i), b.batch(i))
        assert a.key(i) == b.key(i)
    assert not _same(a.batch(0), ServeTraffic(SERVE, seed + 1).batch(0))
    assert not _same(a.batch(0), a.batch(1))
    assert a.key(0) != ServeTraffic(SERVE, seed + 1).key(0)


def test_every_batch_asks_for_the_same_sizes():
    t = ServeTraffic(SERVE, 12345)
    sizes = None
    for i in range(4):
        texts, wavs = t.batch(i)
        assert len(texts) == len(wavs) == SERVE["batch"]
        got = (sorted(len(x) for x in texts), sorted(len(w) for w in wavs))
        assert sizes in (None, got)
        sizes = got
    assert sizes[0][0] == SERVE["text_chars"][0] and sizes[0][-1] == SERVE["text_chars"][1]
    assert sizes[1][-1] == SERVE["prompt_seconds"][1] * 24000


def test_text_is_covered_and_prompts_are_bounded():
    table = set(covered_chars())
    texts, wavs = ServeTraffic(SERVE, 99).batch(2)
    for text in texts:
        assert set(text) <= table
        assert pinyin.coverage(text)[1] == []
    for w in wavs:
        assert w.dtype == np.float32 and np.abs(w).max() <= 1.0 and np.abs(w).max() > 0.05


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_train_batches_repeat_from_the_seed(seed):
    a = TrainTraffic(TRAIN, seed, 256, 128, "cpu").batches()
    b = TrainTraffic(TRAIN, seed, 256, 128, "cpu").batches()
    first, second = next(a), next(a)
    again = next(b)
    assert all(torch.equal(first[k], again[k]) for k in first)
    assert not torch.equal(first["mel"], second["mel"])
    other = next(TrainTraffic(TRAIN, seed + 1, 256, 128, "cpu").batches())
    assert not torch.equal(first["mel"], other["mel"])
    assert first["mel"].shape == (TRAIN["accum"], 3, 16, 128)
    assert int(first["text"].min()) >= 1 and int(first["text"].max()) < 256
    assert TrainTraffic(TRAIN, seed, 256, 128, "cpu").draw_seed() != \
        TrainTraffic(TRAIN, seed + 1, 256, 128, "cpu").draw_seed()
