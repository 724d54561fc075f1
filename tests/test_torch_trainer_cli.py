"""The port's trainer, training CLI and data-prep library and CLI against the
JAX package's: ``mel_to_image``, TensorBoard media, a two-step ``vqvae``
run from a jsonl corpus (metrics, checkpoint, eval dumps, step spans),
the eval dump's fault tolerance and synthesis, ``train/__main__`` with
``--resume``, the VAD / ASR / transcript phases and the four
``prepare_cli`` subcommands.  Everything on the CPU at the small config.
Exact unless stated.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from detail_tts_tpu.data import prepare as jprep
from detail_tts_tpu.train.trainer import mel_to_image as jax_mel_to_image
from detail_tts_tpu_torch import tracing
from detail_tts_tpu_torch.config import small_test_config
from detail_tts_tpu_torch.data import prepare as prep
from detail_tts_tpu_torch.data import prepare_cli
from detail_tts_tpu_torch.data.dataset import BucketSpec
from detail_tts_tpu_torch.train import __main__ as train_cli
from detail_tts_tpu_torch.train import checkpoint as ckpt
from detail_tts_tpu_torch.train.trainer import MetricsLogger, Trainer, mel_to_image

from torch_parity import close  # noqa: F401 - pins torch to one thread

SR = 24000
SMALL = BucketSpec(crop_frames=96, crop_threshold=100, raw_buckets=(128, 256),
                   text_buckets=(32, 64))
TEXTS = ["你好世界", "今天天气很好", "欢迎使用语音合成", "我们去公园"]


def _speech(secs, seed):
    """Harmonics under a 3 Hz envelope plus a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(secs * SR)) / SR
    env = 0.5 * (1 + np.sin(2 * np.pi * 3 * t + seed))
    tone = np.sin(2 * np.pi * (150 + 20 * seed) * t) + 0.5 * np.sin(2 * np.pi * 400 * t)
    return (0.3 * env * tone + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def _write(path, wav, sr=SR):
    wavfile.write(str(path), sr, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
    return str(path)


def _corpus(root, n=4):
    rows = [{"path": _write(root / f"c{i}.wav", _speech(1.0 + 0.3 * i, i)), "text": TEXTS[i % 4]}
            for i in range(n)]
    jsonl = root / "data.jsonl"
    jsonl.write_text("".join(json.dumps(r, ensure_ascii=False) + "\n" for r in rows))
    return str(jsonl)


def _cfg(target, **train):
    cfg = small_test_config()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, target=target, **train))


def _lines(path):
    return [json.loads(x) for x in open(path).read().splitlines()]


def _finite_wav(path):
    sr, wav = wavfile.read(path)
    return sr == SR and len(wav) > 0 and np.all(np.isfinite(wav.astype(np.float32)))


# ------------------------------------------------------------------ trainer


@pytest.mark.parametrize("kind", ["ramp", "random", "constant"])
def test_mel_to_image_matches_jax(kind):
    rng = np.random.default_rng(0)
    mel = {"ramp": np.linspace(-11.5, 2.7, 40 * 8).reshape(40, 8),
           "random": rng.normal(-5.0, 2.0, (57, 128)),
           "constant": np.full((10, 16), -11.5)}[kind].astype(np.float32)
    ours, ref = mel_to_image(mel), jax_mel_to_image(mel)
    assert ours.dtype == np.uint8 and ours.shape == (3, mel.shape[1], mel.shape[0])
    np.testing.assert_array_equal(ours, ref)


def test_metrics_logger_writes_scalars_and_media(tmp_path):
    logger = MetricsLogger(str(tmp_path))
    logger.log(1, {"loss": torch.tensor(1.5)})
    logger.log_media(1, mels={"mel/gt": np.linspace(-11.5, 2.7, 320).reshape(40, 8)},
                     audios={"audio/gt": np.zeros(2400, np.float32)}, sr=SR)
    logger.close()
    assert _lines(tmp_path / "metrics.jsonl") == [{"step": 1, "loss": 1.5}]
    if logger.tb is not None:  # TensorBoard is optional
        events = [f for f in os.listdir(tmp_path) if "tfevents" in f]
        assert events and sum(os.path.getsize(tmp_path / f) for f in events) > 2000


def test_vqvae_trainer_from_a_corpus_writes_everything(tmp_path):
    jsonl = _corpus(tmp_path)
    logs = tmp_path / "logs"
    tr = Trainer(_cfg("vqvae", save_freq=2, val_freq=2), device="cpu", seed=0,
                 logs_folder=str(logs), buckets=SMALL)
    tr.default_data(jsonl, num_threads=1)
    try:
        batch = tr.next_batch()
        assert batch["mel"].shape[:2] == (1, 2) and batch["text"].dtype == torch.long
        assert batch["raw_mel"].dtype == torch.float32 and batch["raw_mel"].shape[2] == 128
        first = max((s["id"] for s in tracing.snapshot()["spans"]), default=0)
        logged = tr.train(max_steps=2, log_every=1)
    finally:
        tr.close()
    assert not any(t.is_alive() for t in tr.data_iter._threads)
    lines = _lines(logs / "metrics.jsonl")
    assert [x["step"] for x in lines] == [1, 2] and lines[-1]["loss"] == logged["loss"]
    assert all(np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"]) for x in lines)
    assert ckpt.latest_step(logs / "ckpt") == 2
    assert _finite_wav(logs / "sample-1.wav") and _finite_wav(logs / "gt-1.wav")
    spans = [s for s in tracing.snapshot()["spans"] if s["root"] > first]
    steps = [s for s in spans if s["parent"] is None]
    assert [(s["name"], s["attrs"]["step"]) for s in steps] == [("train_step", 1),
                                                                ("train_step", 2)]
    for root in steps:
        assert any(s["name"] == "forward" and s["parent"] == root["id"] for s in spans)


def test_eval_dump_failure_does_not_stop_training(tmp_path, monkeypatch, capsys):
    from detail_tts_tpu_torch.train.step import synthetic_batches

    cfg = _cfg("vqvae", val_freq=1, save_freq=10 ** 9)
    data = synthetic_batches(cfg, 1, 2, 48, 8, generator=torch.Generator().manual_seed(1))
    tr = Trainer(cfg, data, device="cpu", logs_folder=str(tmp_path))

    def boom(*args, **kwargs):
        raise RuntimeError("vocoder exploded")

    monkeypatch.setattr(tr.state.model, "infer_vqvae", boom)
    tr.train(max_steps=2, log_every=1)
    tr.close()
    assert tr.state.step == 2 and "vocoder exploded" in capsys.readouterr().err
    assert not (tmp_path / "sample-1.wav").exists()


@pytest.mark.parametrize("target", ["gpt", "diff"])
def test_synth_eval_dump(tmp_path, target):
    """``synth_eval``: synthesis from the batch's text and prompt on the
    current folded weights (the VQ path for ``gpt``), without touching the
    training generator."""
    jsonl = _corpus(tmp_path)
    cfg = _cfg(target, val_freq=1, save_freq=10 ** 9)
    tr = Trainer(cfg, device="cpu", logs_folder=str(tmp_path / "logs"),
                 buckets=BucketSpec(crop_frames=96, crop_threshold=100, raw_buckets=(256,),
                                    text_buckets=(32,)), synth_eval=True)
    tr.default_data(jsonl, num_threads=1)
    try:
        batch = tr.next_batch()
        state = tr.generator.get_state()
        tr._eval_dump(batch)
        assert torch.equal(tr.generator.get_state(), state)
    finally:
        tr.close()
    assert _finite_wav(tmp_path / "logs" / "sample-0.wav")


def test_train_cli_on_the_cpu_and_resume(tmp_path):
    jsonl = _corpus(tmp_path)
    config = tmp_path / "small.json"
    config.write_text(json.dumps(_cfg("vqvae", save_freq=1, val_freq=10 ** 9).to_dict()))
    common = ["--config", str(config), "--data", jsonl, "--num-workers", "1",
              "--device", "cpu"]
    logged = train_cli.main(common + ["--steps", "1", "--logs-folder", str(tmp_path / "a")])
    assert np.isfinite(logged["loss"])
    assert _lines(tmp_path / "a" / "metrics.jsonl")[0]["step"] == 1
    assert ckpt.latest_step(tmp_path / "a" / "ckpt") == 1
    train_cli.main(common + ["--steps", "2", "--logs-folder", str(tmp_path / "b"),
                             "--resume", str(tmp_path / "a" / "ckpt")])
    assert [x["step"] for x in _lines(tmp_path / "b" / "metrics.jsonl")] == [2]
    assert ckpt.latest_step(tmp_path / "b" / "ckpt") == 2
    with pytest.raises(SystemExit):
        train_cli.main(common + ["--target", "vocoder"])


# ---------------------------------------------------------------- data prep


def _long_recording(seed):
    """Speech bursts of 1.2, 2.0 and 0.3 s between 0.8 s silences."""
    sil = np.zeros(int(0.8 * SR), np.float32)
    return np.concatenate([sil, _speech(1.2, seed), sil, _speech(2.0, seed + 1), sil,
                           _speech(0.3, seed + 2), sil])


def test_split_on_silence_matches_jax():
    wav = _long_recording(0)
    for kwargs in ({}, {"keep_silence_ms": 0}, {"min_silence_ms": 900}):
        ours, ref = prep.split_on_silence(wav, SR, **kwargs), jprep.split_on_silence(
            wav, SR, **kwargs)
        assert len(ours) == len(ref) and len(ours) >= 1
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(prep._dbfs(wav, 240), jprep._dbfs(wav, 240))


def test_vad_file_matches_jax(tmp_path):
    import scipy.signal as sps

    src = _write(tmp_path / "long.wav", sps.resample_poly(_long_recording(1), 147, 80),
                 sr=44100)
    (tmp_path / "ours").mkdir()
    (tmp_path / "ref").mkdir()
    ours = prep.vad_file(src, str(tmp_path / "ours"))
    ref = jprep.vad_file(src, str(tmp_path / "ref"))
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in ref]
    assert len(ours) == 2  # the 0.3 s burst is under 0.7 s
    for a, b in zip(ours, ref):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_asr_and_transcripts_match_jax(tmp_path):
    clips = [_write(tmp_path / f"k{i}.wav", _speech(1.0, i)) for i in range(4)]
    texts = {clips[0]: "你好世界", clips[1]: "with LATIN", clips[2]: "短", clips[3]: "再见了"}
    outs = []
    for mod in (prep, jprep):
        path = tmp_path / f"{mod.__name__.split('.')[0]}.jsonl"
        n = mod.asr_to_jsonl(clips, str(path), _ordered_recognizer(clips, texts), workers=1)
        outs.append((n, path.read_text()))
    assert outs[0] == outs[1] and outs[0][0] == 2

    table = tmp_path / "meta.tsv"
    table.write_text("k0.wav\t你好世界\nk1.wav\thas LATIN text\nk2.wav\t短\n"
                     "missing.wav\t这条没有音频\nk3.wav|再见了\n")
    pairs = prep.load_transcript_table(str(table))
    assert pairs == jprep.load_transcript_table(str(table)) and len(pairs) == 5
    rows = []
    for mod in (prep, jprep):
        path = tmp_path / f"t_{mod.__name__.split('.')[0]}.jsonl"
        n = mod.transcripts_to_jsonl(pairs, str(path), clips_dir=str(tmp_path))
        rows.append((n, path.read_text()))
    assert rows[0] == rows[1] and rows[0][0] == 2
    jl = tmp_path / "meta.jsonl"
    jl.write_text(json.dumps({"path": "k0.wav", "text": "你好世界"}, ensure_ascii=False) + "\n")
    assert prep.load_transcript_table(str(jl)) == [("k0.wav", "你好世界")]


def _ordered_recognizer(clips, texts):
    """Transcripts by clip order (``workers=1`` keeps the order), padded
    with spaces that the phase strips."""
    order = iter(clips)

    def transcribe(wav, sr):
        assert sr == SR and wav.dtype == np.float32
        return " " + texts[next(order)] + " "
    return transcribe


def test_prepare_cli_subcommands(tmp_path, monkeypatch):
    raw = tmp_path / "raw"
    raw.mkdir()
    for k in range(2):
        _write(raw / f"long{k}.wav", _long_recording(2 * k))
    clips = tmp_path / "clips"
    prepare_cli.main(["vad", "--in-dir", str(raw), "--out-dir", str(clips), "--workers", "1"])
    names = sorted(os.listdir(clips))
    assert len(names) == 4 and all(n.endswith(".wav") for n in names)

    table = tmp_path / "meta.tsv"
    table.write_text("".join(f"{n}\t{TEXTS[i]}\n" for i, n in enumerate(names[:2])))
    jsonl = tmp_path / "data.jsonl"
    prepare_cli.main(["transcripts", "--table", str(table), "--jsonl", str(jsonl),
                      "--clips-dir", str(clips)])
    # a module name of its own: the process caches the module, and
    # tests/test_prepare.py's stub recognizer is named fake_asr
    (tmp_path / "fake_asr_port.py").write_text("def transcribe(wav, sr):\n    return '谢谢大家'\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    asr_jsonl = tmp_path / "asr.jsonl"
    prepare_cli.main(["asr", "--clips-dir", str(clips), "--jsonl", str(asr_jsonl),
                      "--recognizer", "fake_asr_port", "--workers", "1"])
    assert len(_lines(jsonl)) == 2 and len(_lines(asr_jsonl)) == 4
    assert {r["text"] for r in _lines(asr_jsonl)} == {"谢谢大家"}

    cfg = _cfg("vqvae")
    from detail_tts_tpu_torch.train.step import make_train_state
    ckpt.save_checkpoint(tmp_path / "ckpt", make_train_state(cfg, device="cpu", seed=1))
    config = tmp_path / "small.json"
    config.write_text(json.dumps(cfg.to_dict()))
    prepare_cli.main(["extract-vq", "--jsonl", str(asr_jsonl), "--ckpt", str(tmp_path / "ckpt"),
                      "--config", str(config), "--device", "cpu"])
    for row in _lines(asr_jsonl):
        codes = np.load(row["path"] + ".vq.npy")
        n_frames = len(wavfile.read(row["path"])[1]) // 256 // 4 * 4
        assert codes.dtype == np.int32 and codes.shape == (n_frames // 4,)
