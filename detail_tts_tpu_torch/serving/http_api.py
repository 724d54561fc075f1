"""Minimal HTTP synthesis endpoint over the microbatching server.

Counterpart of ``detail_tts_tpu/serving/http_api.py``, on the standard
library's ``http.server``: concurrent POSTs are batched by
:class:`TTSServer` into single engine calls.

Endpoints:
  GET  /healthz            -> {"ok": true, "requests_served": N, ...}
  POST /synthesize         -> audio/wav (16-bit PCM)
      JSON body: {"text": "...", "prompt_wav_b64": "<base64 wav bytes>",
                  "seed": 0, "vq_only": false}
      or raw PCM: {"text": ..., "prompt_pcm16_b64": ..., "prompt_sr": 24000}
      (little-endian int16 samples)
  Status codes: 200, 400 (a malformed request, refused before it reaches a
  batch), 404 (another path), 500 (the engine failed).

Run (on the card; ``--device cpu`` for a small model on the CPU):
  python -m detail_tts_tpu_torch.serving.http_api --port 8080 \\
      [--config cfg.json] [--ckpt logs/.../ckpt | model.pt] [--device cuda] \\
      [--max-batch 8] [--wait-ms 20] [--warmup]

Threads: ``ThreadingHTTPServer`` gives one thread per connection; all of
them enqueue into the single-dispatch TTSServer, so the engine still sees
batched, serialized calls.
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import struct
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
# imported with the module, not in the first request (seconds of imports)
import scipy.signal as sps
from scipy.io import wavfile


def _decode_wav_bytes(data: bytes, target_sr: int) -> np.ndarray:
    """RIFF wav bytes -> mono float32 at ``target_sr`` (scipy resampling)."""
    sr, wav = wavfile.read(io.BytesIO(data))
    wav = np.asarray(wav)
    # scale by sample format (scipy returns the container's dtype as it is)
    if wav.dtype == np.int16:
        wav = wav.astype(np.float32) / 32768.0
    elif wav.dtype == np.int32:
        wav = wav.astype(np.float32) / 2147483648.0
    elif wav.dtype == np.uint8:  # unsigned with a +128 offset
        wav = (wav.astype(np.float32) - 128.0) / 128.0
    elif wav.dtype in (np.float32, np.float64):
        wav = wav.astype(np.float32)
    else:
        raise ValueError(f"unsupported wav sample format {wav.dtype}")
    if wav.ndim > 1:
        wav = wav[:, 0]
    if sr != target_sr:
        wav = sps.resample_poly(wav, target_sr, sr).astype(np.float32)
    return wav


def _encode_wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    """Mono float32 or int16 -> 16-bit PCM RIFF bytes."""
    if wav.dtype != np.int16:
        wav = (np.clip(np.asarray(wav, np.float32), -1, 1) * 32767.0).astype(np.int16)
    pcm = wav.tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVEfmt " + \
        struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16) + \
        b"data" + struct.pack("<I", len(pcm))
    return hdr + pcm


def make_handler(server, sample_rate: int):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # no per-request lines on stderr
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, {
                    "ok": True,
                    "requests_served": server.requests_served,
                    "batches_dispatched": server.batches_dispatched,
                })
            else:
                self._send_json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/synthesize":
                self._send_json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n))
                text = req["text"]
                if "prompt_wav_b64" in req:
                    prompt = _decode_wav_bytes(
                        base64.b64decode(req["prompt_wav_b64"]), sample_rate)
                elif "prompt_pcm16_b64" in req:
                    raw = np.frombuffer(
                        base64.b64decode(req["prompt_pcm16_b64"]), np.int16)
                    prompt = raw.astype(np.float32) / 32768.0
                    src_sr = int(req.get("prompt_sr", sample_rate))
                    if src_sr != sample_rate:
                        prompt = sps.resample_poly(
                            prompt, sample_rate, src_sr).astype(np.float32)
                else:
                    raise KeyError("prompt_wav_b64 or prompt_pcm16_b64")
            except Exception as e:
                self._send_json(400, {"error": f"bad request: {e}"})
                return
            try:
                # submit() validates each request, so a malformed one is a
                # 400 here and never reaches a batch
                fut = server.submit(text, prompt, seed=int(req.get("seed", 0)),
                                    vq_only=bool(req.get("vq_only", False)))
            except ValueError as e:
                self._send_json(400, {"error": f"bad request: {e}"})
                return
            try:
                wav = fut.result(timeout=float(req.get("timeout", 600.0)))
                self._send(200, _encode_wav_bytes(wav, sample_rate), "audio/wav")
            except Exception as e:
                self._send_json(500, {"error": str(e)})

    return Handler


def serve(engine, host: str = "127.0.0.1", port: int = 8080,
          max_batch: int = 8, max_wait_ms: float = 20.0,
          httpd_box: Optional[dict] = None):
    """Blocking serve loop.  ``httpd_box`` receives {'httpd', 'server'}, so
    that another thread can shut the loop down (``httpd.shutdown()``)."""
    from detail_tts_tpu_torch.serving.server import TTSServer

    server = TTSServer(engine, max_batch=max_batch, max_wait_ms=max_wait_ms)
    server.start()
    httpd = ThreadingHTTPServer(
        (host, port), make_handler(server, engine.cfg.data.sampling_rate))
    if httpd_box is not None:
        httpd_box["httpd"] = httpd
        httpd_box["server"] = server
    print(f"serving on http://{host}:{httpd.server_address[1]}  "
          f"(max_batch={max_batch}, wait={max_wait_ms}ms)", file=sys.stderr)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        server.stop()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--config", default=None)
    p.add_argument("--ckpt", default=None,
                   help="a checkpoint dir the trainer wrote, or a torch "
                        "checkpoint file (model-*.pt)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--wait-ms", type=float, default=20.0)
    p.add_argument("--warmup", action="store_true",
                   help="run one request at the smallest buckets before binding")
    args = p.parse_args(argv)

    from detail_tts_tpu_torch.serving.api import build_engine

    eng = build_engine(args.config, args.ckpt, device=args.device)
    if args.warmup:
        eng.warmup()
    serve(eng, args.host, args.port, args.max_batch, args.wait_ms)


if __name__ == "__main__":
    main()
