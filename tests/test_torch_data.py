"""The port's data pipeline against the JAX package's: the native WAV decoder,
the char tokenizer, ``JsonlTtsDataset.load`` (duration filter, the frame
trim and the zero pad past the clip's end), ``_crop``, ``collate`` and the
first batches of a one-thread ``DataIterator``.

Tolerances: exact unless stated; spectrogram and log-mel ``atol = rtol =
1e-4`` (the port's ``MelFrontend`` against JAX's, both fp32); the
resampler against scipy at 5e-4 on interior samples, as
``tests/test_native.py`` holds JAX's.
"""
import json

import numpy as np
import pytest
import scipy.signal as sps
import torch
from scipy.io import wavfile

from detail_tts_tpu.config import small_test_config as jax_small_config
from detail_tts_tpu.data import dataset as jds
from detail_tts_tpu.text.tokenizer import CharTokenizer as JaxCharTokenizer
from detail_tts_tpu_torch.config import small_test_config
from detail_tts_tpu_torch.data import dataset as pds
from detail_tts_tpu_torch.native import load_library, load_wav_native
from detail_tts_tpu_torch.text.tokenizer import CharTokenizer, make_tokenizer

from torch_parity import close  # noqa: F401 - pins torch to one thread

SR = 24000
HOP = 256
# (sample rate, samples): a clip whose remainder past its last kept frame is
# under the frontend's 384-sample reflect pad, a 44.1 kHz and a 16 kHz clip,
# one under the duration filter's 0.69 s, one ragged 24 kHz clip
CLIPS = [(SR, HOP * 120 + 100), (44100, int(2.3 * 44100)), (16000, int(0.9 * 16000)),
         (SR, int(0.5 * SR)), (SR, int(3.0 * SR) + 77)]
TEXTS = ["你好世界", "今天天气很好。", "欢迎使用语音合成", "短句", "我们一起去公园散步吧！"]
SMALL = dict(crop_frames=96, crop_threshold=100, raw_buckets=(128, 256, 512),
             text_buckets=(32, 64))


@pytest.fixture
def native():
    if load_library() is None:
        pytest.skip("no g++ toolchain: the native decoder is not built")


def _write(path, sr, wav):
    wavfile.write(str(path), sr, (np.clip(wav, -1, 1) * 32767).astype(np.int16))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    rows = []
    for i, ((sr, n), text) in enumerate(zip(CLIPS, TEXTS)):
        path = root / f"{i}.wav"
        _write(path, sr, rng.uniform(-0.3, 0.3, n))
        rows.append({"path": str(path), "text": text})
    jsonl = root / "data.jsonl"
    jsonl.write_text("".join(json.dumps(r, ensure_ascii=False) + "\n" for r in rows))
    return str(jsonl)


@pytest.fixture(scope="module")
def datasets(corpus):
    return (jds.JsonlTtsDataset(jax_small_config(), corpus, JaxCharTokenizer(), shard=False),
            pds.JsonlTtsDataset(small_test_config(), corpus, CharTokenizer()))


def test_native_pcm16_without_resampling(tmp_path, native):
    wav = np.random.default_rng(0).uniform(-0.5, 0.5, SR * 2).astype(np.float32)
    _write(tmp_path / "a.wav", SR, wav)
    out = load_wav_native(str(tmp_path / "a.wav"), SR)
    assert out.dtype == np.float32 and out.shape == (SR * 2,)
    np.testing.assert_array_equal(out, (wav * 32767).astype(np.int16) / np.float32(32768))


def test_native_resamples_44k1_like_scipy(tmp_path, native):
    t = np.arange(44100) / 44100
    wav = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    _write(tmp_path / "b.wav", 44100, wav)
    out = load_wav_native(str(tmp_path / "b.wav"), SR)
    pcm = (wav * 32767).astype(np.int16) / 32768.0
    ref = sps.resample_poly(pcm, 80, 147)
    assert len(out) == len(ref) == SR
    np.testing.assert_allclose(out[100:-100], ref[100:-100], atol=5e-4)


def test_native_16k_length_and_bad_file(tmp_path, native):
    _write(tmp_path / "c.wav", 16000, np.full(16000, 0.1, np.float32))
    assert len(load_wav_native(str(tmp_path / "c.wav"), SR)) == SR
    (tmp_path / "bad.wav").write_bytes(b"RIFF\x00\x00\x00\x00JUNK")
    assert load_wav_native(str(tmp_path / "bad.wav"), SR) is None
    assert pds.read_wav(str(tmp_path / "c.wav"), SR).shape == (SR,)


def test_char_tokenizer_ids_match_jax():
    ours, ref = make_tokenizer("char"), JaxCharTokenizer()
    assert isinstance(ours, CharTokenizer) and ours.vocab_size == ref.vocab_size
    for text in ("ni3 hao3, shi4 jie4!", "Jin1 Tian1 [x] {y} `z` — a#b", "。，？ 1 2 3"):
        assert ours.encode(text) == ref.encode(text)
        assert ours.decode(ours.encode(text)) == ref.decode(ref.encode(text))


def test_rows_are_shuffled_and_sharded_as_jax(corpus, datasets):
    jax_ds, ours = datasets
    assert ours.rows == jax_ds.rows
    shards = [pds.JsonlTtsDataset(small_test_config(), corpus, CharTokenizer(),
                                  rank=r, world=2).rows for r in (0, 1)]
    assert shards[0] == ours.rows[0::2] and shards[1] == ours.rows[1::2]


@pytest.mark.parametrize("index", range(len(CLIPS)))
def test_load_matches_jax(datasets, index):
    jax_ds, ours = datasets
    ref, got = jax_ds.load(index), ours.load(index)
    assert (ref is None) == (got is None)
    if ref is None:  # the 0.5 s clip: under the duration filter
        assert ours.rows[index]["path"].endswith("3.wav")
        return
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["wav"], ref["wav"])
    np.testing.assert_array_equal(got["text"], ref["text"])
    assert got["text"].dtype == np.int32 and got["spec"].shape[0] % 4 == 0
    for key in ("spec", "mel"):
        assert got[key].shape == ref[key].shape
        np.testing.assert_allclose(got[key], ref[key], atol=1e-4, rtol=1e-4)


def test_last_frame_reads_zeros_past_the_clip(datasets):
    """The clip whose last kept frame reaches 284 samples past its end: the
    frontend's own reflect pad would give another last frame, which the
    parity test above must tell apart."""
    _, ours = datasets
    index = next(i for i, r in enumerate(ours.rows) if r["path"].endswith("0.wav"))
    wav = pds.read_wav(ours.rows[index]["path"], SR)
    got = ours.load(index)
    n = got["spec"].shape[0]
    assert n == 120 and len(wav) - n * HOP == 100
    reflected = ours.frontend.linear_spectrogram(torch.from_numpy(wav)[None])[0, :n].numpy()
    np.testing.assert_allclose(got["spec"][:-2], reflected[:-2], atol=1e-4, rtol=1e-4)
    assert np.abs(got["spec"][-1] - reflected[-1]).max() > 1e-2


def test_crop_and_collate_match_jax(datasets):
    jax_ds, ours = datasets
    samples = [s for s in (ours.load(i) for i in range(len(ours))) if s is not None]
    jb, pb = jds.BucketSpec(**SMALL), pds.BucketSpec(**SMALL)
    jrng, prng = np.random.default_rng(3), np.random.default_rng(3)
    ref = [jds._crop(dict(s), jb, jrng, HOP) for s in samples for _ in range(2)]
    got = [pds._crop(dict(s), pb, prng, HOP) for s in samples for _ in range(2)]
    for r, g in zip(ref, got):
        assert set(r) == set(g)
        for k in r:
            np.testing.assert_array_equal(g[k], r[k])
    assert any(len(g["spec"]) == 96 for g in got)  # some clip was cropped
    d = small_test_config().data
    rb = jds.collate(ref, jb, HOP, d.spec_channels, d.n_mel_channels)
    gb = pds.collate(got, pb, HOP, d.spec_channels, d.n_mel_channels)
    assert set(gb) == set(rb) and len(gb) == 12
    for k in rb:
        assert gb[k].dtype == rb[k].dtype
        np.testing.assert_array_equal(gb[k], rb[k])
    assert list(gb["raw_spec_length"]) == sorted(gb["raw_spec_length"], reverse=True)


def test_first_batches_of_one_thread_match_jax(datasets):
    jax_ds, ours = datasets
    ref_it = jds.DataIterator(jax_ds, 2, accum=2, buckets=jds.BucketSpec(**SMALL),
                              num_threads=1, seed=5)
    it = pds.DataIterator(ours, 2, accum=2, buckets=pds.BucketSpec(**SMALL),
                          num_threads=1, seed=5)
    try:
        for _ in range(2):
            ref, got = next(ref_it), next(it)
            assert set(got) == set(ref)
            for k in ref:
                assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype
                if k in ("spec", "mel", "raw_spec", "raw_mel"):
                    np.testing.assert_allclose(got[k], ref[k], atol=1e-4, rtol=1e-4)
                else:
                    np.testing.assert_array_equal(got[k], ref[k])
    finally:
        ref_it.close()
        it.close()
    assert not any(t.is_alive() for t in it._threads)
