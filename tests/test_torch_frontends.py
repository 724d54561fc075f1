"""The port's serving front-ends on its small CPU engine: the microbatching
server, long-form chunking and streaming, the HTTP endpoint and the CLI
(after ``tests/test_server.py``, ``test_longform.py``, ``test_http_api.py``
and ``test_serving.py``'s CLI test), and their pure helpers against the JAX
package's on the same input.  Every wait has its own timeout."""
import base64
import functools
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from detail_tts_tpu.serving import http_api as jax_http
from detail_tts_tpu.serving import longform as jax_longform
from detail_tts_tpu_torch.config import small_test_config
from detail_tts_tpu_torch.io.weights import random_weights_
from detail_tts_tpu_torch.models.synthesizer import SynthesizerTrn
from detail_tts_tpu_torch.serving import api
from detail_tts_tpu_torch.serving.http_api import (_decode_wav_bytes,
                                                   _encode_wav_bytes, serve)
from detail_tts_tpu_torch.serving.longform import (crossfade_concat,
                                                   split_sentences,
                                                   synthesize_long,
                                                   synthesize_long_stream)
from detail_tts_tpu_torch.serving.pipeline import EngineConfig, TTSEngine
from detail_tts_tpu_torch.serving.server import TTSServer

WAIT = 60.0  # seconds, for any one future or HTTP call
LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # no proxy
SMALL = dict(max_generate_length=8, text_buckets=(8, 16), prompt_buckets=(32,),
             code_buckets=(8,), compute_dtype=torch.float32, cache_dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _model():
    return random_weights_(SynthesizerTrn(small_test_config()), 0)


def _engine(**kw):
    return TTSEngine(_model(), EngineConfig(**{**SMALL, **kw}), device="cpu")


def _prompt(seed, n=24000):
    return np.random.default_rng(seed).uniform(-0.3, 0.3, n).astype(np.float32)


# ------------------------------------------------------------ pure helpers


@pytest.mark.parametrize("text,max_chars", [
    ("你好世界。这是第二句！短。This is a test? 好的", 120),
    ("a" * 50 + "，" + "b" * 50 + "，" + "c" * 50, 80),
    ("一二三四五六七八九十" * 20, 37),
    ("", 120)])
def test_split_sentences_equals_jax(text, max_chars):
    assert split_sentences(text, max_chars) == jax_longform.split_sentences(text, max_chars)


def test_crossfade_and_wav_codec_equal_jax():
    rng = np.random.default_rng(0)
    wavs = [rng.uniform(-1, 1, n).astype(np.float32) for n in (24000, 100, 3, 5000)]
    for fade_ms in (20.0, 1.0):
        np.testing.assert_array_equal(crossfade_concat(wavs, 24000, fade_ms),
                                      jax_longform.crossfade_concat(wavs, 24000, fade_ms))
    sr = 24000
    out = crossfade_concat([np.ones(sr, np.float32), -np.ones(sr, np.float32)], sr)
    assert len(out) == 2 * sr - int(sr * 0.02) and np.all(np.abs(out) <= 1.0)

    wav = rng.uniform(-1.2, 1.2, 2400).astype(np.float32)
    data = _encode_wav_bytes(wav, 24000)
    assert data == jax_http._encode_wav_bytes(wav, 24000)
    pcm = (wav * 1000).astype(np.int16)
    assert _encode_wav_bytes(pcm, 16000) == jax_http._encode_wav_bytes(pcm, 16000)
    for target in (24000, 12000, 44100):
        np.testing.assert_array_equal(_decode_wav_bytes(data, target),
                                      jax_http._decode_wav_bytes(data, target))
    np.testing.assert_allclose(_decode_wav_bytes(data, 24000), np.clip(wav, -1, 1),
                               atol=2.0 / 32768)


def test_decode_wav_dtype_scaling():
    from scipy.io import wavfile

    ref = np.sin(np.linspace(0, 40 * np.pi, 2400)).astype(np.float32) * 0.5

    def rt(arr):
        buf = io.BytesIO()
        wavfile.write(buf, 24000, arr)
        return _decode_wav_bytes(buf.getvalue(), 24000)

    np.testing.assert_allclose(rt((ref * 32767).astype(np.int16)), ref, atol=2.0 / 32768)
    np.testing.assert_allclose(rt((ref * 2147483647).astype(np.int32)), ref, atol=2.0 / 32768)
    u8 = (np.clip(ref, -1, 1) * 127 + 128).astype(np.uint8)
    np.testing.assert_allclose(rt(u8), ref, atol=2.0 / 127)
    np.testing.assert_allclose(rt(ref), ref, atol=1e-6)
    with pytest.raises(Exception):
        rt(ref.astype(np.float16))


# ------------------------------------------------------------------ server


def test_server_batches_concurrent_requests():
    eng = _engine()
    with TTSServer(eng, max_batch=4, max_wait_ms=1000.0) as server:
        first = server.synthesize("ni3 hao3", _prompt(0), timeout=WAIT)
        futs = [server.submit(t, _prompt(i), seed=i, vq_only=(i == 3))
                for i, t in enumerate(["yi1", "er4", "san1", "si4"])]
        outs = [f.result(timeout=WAIT) for f in futs]
    for w in [first] + outs:
        assert w.ndim == 1 and len(w) > 0 and np.isfinite(w).all()
    # 1 batch of one + 1 grouped batch + its vq_only group
    assert server.requests_served == 5
    assert server.batches_dispatched <= 3
    assert server._thread is None


def test_server_rejects_bad_requests_and_survives_a_failing_batch():
    eng = _engine()
    server = TTSServer(eng, max_batch=2, max_wait_ms=1.0)
    with pytest.raises(RuntimeError):
        server.submit("a", _prompt(0))
    server.start()
    try:
        for text, wav in [("yi1", np.zeros((0,), np.float32)),   # empty
                          ("yi1", _prompt(0)[:100]),              # sub-hop
                          ("yi1", _prompt(0).reshape(2, -1)),     # not mono
                          ("   ", _prompt(0))]:                   # blank text
            with pytest.raises(ValueError):
                server.submit(text, wav)
        bad = _prompt(0).copy()
        bad[7] = np.nan
        with pytest.raises(ValueError):
            server.submit("yi1", bad)
        # a batch whose engine call raises fails its own futures only
        real = eng.dispatch_decode
        eng.dispatch_decode = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom"))
        with pytest.raises(RuntimeError, match="boom"):
            server.synthesize("yi1", _prompt(1), timeout=WAIT)
        eng.dispatch_decode = real
        ok = server.synthesize("yi1 ju4", _prompt(1), timeout=WAIT)
        assert np.isfinite(ok).all() and len(ok) > 0
    finally:
        server.stop()
    assert server._thread is None


def test_server_bad_submit_does_not_poison_concurrent_batch():
    eng = _engine()
    with TTSServer(eng, max_batch=4, max_wait_ms=500.0) as server:
        futs = [server.submit("yi1", _prompt(1)), server.submit("er4", _prompt(2))]
        with pytest.raises(ValueError):
            server.submit("san1", _prompt(3)[:10])
        outs = [f.result(timeout=WAIT) for f in futs]
    assert all(np.isfinite(w).all() and len(w) > 0 for w in outs)


def test_server_back_to_back_batches_and_batch_seed():
    """Waves of requests go through the double-buffered loop; a batch's
    seed folds its size and seeds, so the same group repeats its audio."""
    eng = _engine()
    with TTSServer(eng, max_batch=2, max_wait_ms=100.0) as server:
        futs = []
        for wave in range(3):
            futs += [server.submit("yi1 er4", _prompt(wave), seed=wave) for _ in range(2)]
            time.sleep(0.05)
        outs = [f.result(timeout=WAIT) for f in futs]
    assert all(w.ndim == 1 and len(w) > 0 and np.isfinite(w).all() for w in outs)
    assert server.requests_served == 6
    group = [type("R", (), {"seed": s}) for s in (3, -1)]
    seed = TTSServer._batch_seed(group)
    assert seed == TTSServer._batch_seed(group) != TTSServer._batch_seed(group[:1])
    assert 0 <= seed < 2 ** 32


# --------------------------------------------------------------- long form


def test_longform_e2e_and_stream_matches_batch():
    eng = _engine()
    wav = synthesize_long(eng, "yi1 ju4. er4 ju4!", _prompt(0), seed=0, vq_only=True)
    assert wav.ndim == 1 and len(wav) > 0 and np.isfinite(wav).all()
    text = "yi1 ju4. er4 ju4! san1 ju4? si4 ju4."  # 4 chunks, 2 batches
    for vq_only in (True, False):
        full = synthesize_long(eng, text, _prompt(1), seed=7, batch_size=2, vq_only=vq_only)
        parts = list(synthesize_long_stream(eng, text, _prompt(1), seed=7, batch_size=2,
                                            vq_only=vq_only))
        assert len(parts) >= 2  # it yields before the end
        np.testing.assert_array_equal(np.concatenate(parts), full)
    assert synthesize_long(eng, "  ", _prompt(1)).shape == (0,)
    assert list(synthesize_long_stream(eng, "  ", _prompt(1))) == []


# -------------------------------------------------------------------- HTTP


@pytest.fixture(scope="module")
def http_server():
    box = {}
    thread = threading.Thread(target=serve, kwargs=dict(
        engine=_engine(), port=0, max_batch=2, max_wait_ms=5.0, httpd_box=box), daemon=True)
    thread.start()
    deadline = time.monotonic() + WAIT
    while "httpd" not in box and time.monotonic() < deadline:
        time.sleep(0.01)
    host, port = box["httpd"].server_address
    yield f"http://{host}:{port}"
    box["httpd"].shutdown()
    thread.join(timeout=WAIT)
    assert not thread.is_alive()


def _post(url, payload):
    req = urllib.request.Request(url + "/synthesize", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return LOCAL.open(req, timeout=WAIT)


def test_http_synthesize_and_health(http_server):
    wav_b64 = base64.b64encode(_encode_wav_bytes(_prompt(1), 24000)).decode()
    for vq_only in (True, False):
        resp = _post(http_server, {"text": "ni3 hao3", "prompt_wav_b64": wav_b64,
                                   "vq_only": vq_only})
        assert resp.status == 200 and resp.headers["Content-Type"] == "audio/wav"
        out = _decode_wav_bytes(resp.read(), 24000)
        assert len(out) > 0 and np.isfinite(out).all()
    with LOCAL.open(http_server + "/healthz", timeout=WAIT) as r:
        health = json.loads(r.read())
    assert health["ok"] and health["requests_served"] >= 2


def test_http_raw_pcm_prompt(http_server):
    pcm = (_prompt(2, 12000) * 32767).astype(np.int16)
    resp = _post(http_server, {"text": "shi4 jie4", "vq_only": True, "prompt_sr": 12000,
                               "prompt_pcm16_b64": base64.b64encode(pcm.tobytes()).decode()})
    assert resp.status == 200 and len(resp.read()) > 44


def test_http_bad_requests_are_400_and_other_paths_404(http_server):
    tiny = base64.b64encode(_encode_wav_bytes(np.zeros(16, np.float32), 24000)).decode()
    for payload in ({"text": "no prompt"}, {"text": "yi1", "prompt_wav_b64": tiny},
                    {"text": "   ", "prompt_wav_b64": tiny}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(http_server, payload)
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        LOCAL.open(http_server + "/nope", timeout=WAIT)
    assert e.value.code == 404


def test_http_concurrent_clients_mixed_lengths(http_server):
    results, errors = {}, {}

    def client(i, text, n):
        try:
            wav_b64 = base64.b64encode(_encode_wav_bytes(_prompt(10 + i, n), 24000)).decode()
            resp = _post(http_server, {"text": text, "vq_only": i % 2 == 0,
                                       "prompt_wav_b64": wav_b64, "seed": i})
            results[i] = _decode_wav_bytes(resp.read(), 24000)
        except Exception as e:  # noqa: BLE001
            errors[i] = e

    specs = [("yi1", 24000), ("er4 san1 si4 wu3", 8000), ("liu4 qi1", 16000),
             ("ba1 jiu3 shi2 yi1 er4 san1", 24000)]
    threads = [threading.Thread(target=client, args=(i, t, n)) for i, (t, n) in enumerate(specs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=WAIT)
    assert not errors, errors
    assert set(results) == {0, 1, 2, 3}
    assert all(len(w) > 0 and np.isfinite(w).all() for w in results.values())


# --------------------------------------------------------------------- CLI


def test_api_cli_wiring(tmp_path, monkeypatch):
    """--long/--vq-only/--sampler/--diffusion-steps/--top-p/--temperature and
    --device reach the engine; the wav is written."""
    from scipy.io import wavfile

    box = {}

    def fake_build(config, ckpt, seed=0, engine_cfg=None, device="cuda"):
        box["device"] = device
        box["eng"] = _engine(diffusion_sampler=engine_cfg.diffusion_sampler,
                             diffusion_steps=engine_cfg.diffusion_steps,
                             top_p=engine_cfg.top_p, temperature=engine_cfg.temperature)
        return box["eng"]

    monkeypatch.setattr(api, "build_engine", fake_build)
    prompt_path, out_path = str(tmp_path / "p.wav"), str(tmp_path / "o.wav")
    wavfile.write(prompt_path, 24000, (_prompt(0) * 32767).astype(np.int16))
    for extra in (["--long", "--vq-only"], []):
        api.main(["--text", "yi1 ju4. er4 ju4.", "--prompt", prompt_path, "--out", out_path,
                  "--sampler", "ddim", "--diffusion-steps", "3", "--top-p", "0.9",
                  "--temperature", "0.7", "--device", "cpu"] + extra)
        sr, out = wavfile.read(out_path)
        assert sr == 24000 and len(out) > 0 and out.dtype == np.int16
    ecfg = box["eng"].ecfg
    assert (ecfg.diffusion_sampler, ecfg.top_p, ecfg.temperature, box["device"]) == \
        ("ddim", 0.9, 0.7, "cpu")
    assert box["eng"].schedule.num_timesteps == 3
    with pytest.raises(SystemExit):
        api.main(["--text", "a", "--prompt", prompt_path, "--sampler", "nope"])


def test_build_engine_reads_a_reference_checkpoint(tmp_path, capsys):
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(small_test_config().to_dict()))
    sd = dict(_model().state_dict())
    sd["unknown_module.bias"] = torch.zeros(3)  # a key of no port module
    torch.save({"G": sd}, tmp_path / "model.pt")
    eng = api.build_engine(str(cfg_path), str(tmp_path / "model.pt"),
                           engine_cfg=EngineConfig(**SMALL), device="cpu")
    assert "unknown_module.bias" in capsys.readouterr().err
    for k, v in _model().state_dict().items():
        assert torch.equal(eng.model.state_dict()[k], v), k
    rand = api.build_engine(str(cfg_path), None, engine_cfg=EngineConfig(**SMALL),
                            device="cpu")
    assert "random weights" in capsys.readouterr().err
    assert rand.device.type == "cpu"
    api.save_wav(str(tmp_path / "i.wav"), np.array([1, -2, 3], np.int16), 24000)
    np.testing.assert_array_equal(api.load_wav(str(tmp_path / "i.wav"), 24000),
                                  np.array([1, -2, 3], np.float32) / 32768.0)
