"""The worked examples on the PyTorch port (``examples/*_torch.py``), the
twins of ``examples/prepare_demo.py``, ``lifecycle_demo.py`` and
``demo.py``: each run end to end in a subprocess with ``--small --cpu``,
as ``tests/test_prepare.py`` runs the JAX ones, checking the same phase
lines and files; the port's prepare phase against the JAX package's
``vad_directory`` and ``transcripts_to_jsonl`` on the same recordings; the
refusal to run without a GPU unless ``--cpu`` is given; and that no script
imports the JAX package.  ``chip_smoke.py`` phase 11 runs the three on the
card at the full width of ``Config()``.
"""
import ast
import glob
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from scipy.io import wavfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
SCRIPTS = ("prepare_demo_torch.py", "lifecycle_demo_torch.py", "demo_torch.py")
SR = 24000


def _speechy(secs, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, int(secs * SR)).astype(np.float32)


def _recording(path, secs):
    """Bursts of seeded noise between 0.8 s silences, as PCM16."""
    sil = np.zeros(int(0.8 * SR), np.float32)
    parts = [sil]
    for i, s in enumerate(secs):
        parts += [_speechy(s, i), sil]
    wavfile.write(str(path), SR, (np.concatenate(parts) * 32767).astype(np.int16))


def _run(script, *args, timeout=600):
    return subprocess.run([sys.executable, os.path.join(EXAMPLES, script), *args],
                          capture_output=True, text=True, timeout=timeout, cwd=REPO)


def test_prepare_demo_torch_end_to_end(tmp_path):
    """Every prep phase (VAD -> transcripts passthrough -> VQ extraction ->
    one training batch) on a tiny corpus."""
    raw_dir = tmp_path / "raw"
    raw_dir.mkdir()
    _recording(raw_dir / "rec.wav", (1.5, 2.0))
    out = _run("prepare_demo_torch.py", "--in-dir", str(raw_dir), "--work-dir",
               str(tmp_path / "work"), "--cpu", "--small")
    assert out.returncode == 0, out.stderr[-2000:]
    for tag in ("[1/4] vad: 1 recordings -> 2 clips", "[2/4] jsonl: 2 rows",
                "[3/4] vq: encoded 2 clips", "[4/4] batch:"):
        assert tag in out.stdout, out.stdout
    assert (tmp_path / "work" / "data.jsonl").exists()
    codes = [np.load(f) for f in glob.glob(str(tmp_path / "work" / "clips" / "*.vq.npy"))]
    assert len(codes) == 2
    assert all(c.size and 0 <= c.min() and c.max() < 64 for c in codes)  # small vq_bins


@pytest.mark.parametrize("serve", ["vq-only", "diffusion"])
def test_lifecycle_demo_torch_end_to_end(tmp_path, serve):
    """The whole user path: prepare (VAD -> jsonl) -> vqvae stage -> gpt
    stage grown from its checkpoint -> TTSEngine serving from the trained
    checkpoint, by the VQ path (as the JAX test) and the diffusion path."""
    raw_dir = tmp_path / "raw"
    raw_dir.mkdir()
    _recording(raw_dir / "rec.wav", (1.5, 2.0, 1.2))
    args = ["--in-dir", str(raw_dir), "--work-dir", str(tmp_path / "work"), "--cpu",
            "--small", "--steps", "2"]
    out = _run("lifecycle_demo_torch.py", *args, *(["--vq-only"] if serve == "vq-only" else []))
    assert out.returncode == 0, (out.stdout[-1000:], out.stderr[-2000:])
    for tag in ("[1/4] prepare:", "[2/4] train vqvae:",
                "[3/4] train gpt (grown from vqvae ckpt):", "[4/4] serve: wrote"):
        assert tag in out.stdout, out.stdout
    assert (tmp_path / "work" / "train_vqvae" / "ckpt" / "2" / "state.pt").is_file()
    assert (tmp_path / "work" / "train_gpt" / "ckpt" / "4" / "state.pt").is_file()
    sr, pcm = wavfile.read(str(tmp_path / "work" / "lifecycle.wav"))
    assert sr == SR and pcm.size > 0


def test_demo_torch_small_end_to_end(tmp_path):
    """The demo.ipynb flow (zero-shot diffusion path, diffusion-free VQ path,
    long-form chunking) through a small random-weight engine."""
    prompt = str(tmp_path / "prompt.wav")
    wavfile.write(prompt, SR, (_speechy(2.0) * 32767).astype(np.int16))
    out = _run("demo_torch.py", "--prompt", prompt, "--small", "--cpu", "--out-dir",
               str(tmp_path))
    assert out.returncode == 0, (out.stdout[-1000:], out.stderr[-2000:])
    for name in ("demo_full.wav", "demo_vq.wav", "demo_long.wav"):
        assert f"{name}:" in out.stdout, out.stdout
        sr, pcm = wavfile.read(str(tmp_path / name))
        assert sr == SR and pcm.size > 0, name
    # long form chunks the text three times and crossfades: more audio
    n_full = wavfile.read(str(tmp_path / "demo_full.wav"))[1].size
    n_long = wavfile.read(str(tmp_path / "demo_long.wav"))[1].size
    assert n_long > n_full


def test_demo_torch_without_cpu_refuses_to_run_on_a_host_without_cuda(tmp_path):
    """Without --cpu the script runs on the GPU or not at all: on a host with
    no CUDA it exits non-zero with the port's CUDA error and writes no wav."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    prompt = str(tmp_path / "prompt.wav")
    wavfile.write(prompt, SR, (_speechy(1.0) * 32767).astype(np.int16))
    out = _run("demo_torch.py", "--prompt", prompt, "--small", "--out-dir", str(tmp_path))
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr, out.stderr[-2000:]
    assert sorted(os.listdir(tmp_path)) == ["prompt.wav"]


def test_prepare_phase_matches_the_jax_package(tmp_path):
    """The port's prepare phase (``prepare_demo_torch.prepare``: VAD and
    the transcripts passthrough) against JAX's ``vad_directory`` and
    ``transcripts_to_jsonl`` on the same seeded recordings: the same clips,
    byte for byte, and the same jsonl rows."""
    from detail_tts_tpu.data.prepare import transcripts_to_jsonl, vad_directory

    spec = importlib.util.spec_from_file_location(
        "prepare_demo_torch", os.path.join(EXAMPLES, "prepare_demo_torch.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)

    raw_dir = tmp_path / "raw"
    (raw_dir / "sub").mkdir(parents=True)
    _recording(raw_dir / "a.wav", (1.5, 2.0, 0.3))  # the 0.3 s burst is dropped
    _recording(raw_dir / "sub" / "b.wav", (1.2, 3.1))
    raw, clips, n, jsonl = demo.prepare(str(raw_dir), str(tmp_path / "port"), SR)

    jax_clips_dir = str(tmp_path / "jax" / "clips")
    jax_raw = sorted(glob.glob(os.path.join(str(raw_dir), "**/*.wav"), recursive=True))
    jax_clips = vad_directory(jax_raw, jax_clips_dir, sr=SR, workers=1)
    jax_jsonl = str(tmp_path / "jax" / "data.jsonl")
    jax_n = transcripts_to_jsonl([(c, demo.PLACEHOLDER_TEXT) for c in jax_clips], jax_jsonl,
                                 clips_dir=jax_clips_dir)

    assert raw == jax_raw
    assert [os.path.basename(c) for c in clips] == [os.path.basename(c) for c in jax_clips]
    assert len(clips) == 4
    for ours, theirs in zip(clips, jax_clips):
        with open(ours, "rb") as f, open(theirs, "rb") as g:
            assert f.read() == g.read(), ours

    def rows(path, clips_dir):
        with open(path) as f:
            return [dict(r, path=os.path.relpath(r["path"], clips_dir))
                    for r in map(json.loads, f)]

    assert n == jax_n == 4
    assert rows(jsonl, str(tmp_path / "port" / "clips")) == rows(jax_jsonl, jax_clips_dir)


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_imports_nothing_of_the_jax_package(script):
    """The port's scripts import neither JAX, flax nor optax, nor the JAX
    package (``detail_tts_tpu``; ``detail_tts_tpu_torch`` is the port)."""
    with open(os.path.join(EXAMPLES, script)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert names, script
    banned = ("jax", "flax", "optax", "detail_tts_tpu")
    assert not [n for n in names if n.split(".")[0] in banned], names
