"""Native (C++) host decoding for the data pipeline: RIFF/WAVE parsing and
Kaiser-windowed polyphase resampling (the port's own copy of
``detail_tts_tpu/native/``).

``wavio.cc`` is compiled with ``g++`` at first use into ``build/native/``
of the repository, keyed by a hash of the source, and loaded with ctypes.
ctypes releases the interpreter lock for the call, so the loader's decode
threads (data/dataset.py) run it in parallel.  Where no toolchain is found
or ``DTTS_NO_NATIVE`` is set, :func:`load_library` returns None and the
callers decode with scipy instead.  This is host work: nothing here touches
the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "wavio.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libdttswavio-{digest}.so"


def load_library() -> Optional[ctypes.CDLL]:
    """Compile (once) and load the native library; None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("DTTS_NO_NATIVE"):
            return None
        so = library_path()
        try:
            if not so.is_file():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                                str(SOURCE), "-o", str(tmp)],
                               check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.CalledProcessError):
            return None
        fptr = ctypes.POINTER(ctypes.c_float)
        lib.dtts_load_wav.restype = ctypes.c_long
        lib.dtts_load_wav.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                      ctypes.POINTER(fptr),
                                      ctypes.POINTER(ctypes.c_long)]
        lib.dtts_resample.restype = ctypes.c_long
        lib.dtts_resample.argtypes = [fptr, ctypes.c_long, ctypes.c_long,
                                      ctypes.c_long, ctypes.POINTER(fptr),
                                      ctypes.POINTER(ctypes.c_long)]
        lib.dtts_free.restype = None
        lib.dtts_free.argtypes = [fptr]
        _LIB = lib
        return _LIB


def load_wav_native(path: str, target_sr: int) -> Optional[np.ndarray]:
    """Mono float32 at ``target_sr`` (channel 0 of a PCM16/24/32 or float32
    WAV); None when the library is unavailable or the file does not parse."""
    lib = load_library()
    if lib is None:
        return None
    data = ctypes.POINTER(ctypes.c_float)()
    length = ctypes.c_long(0)
    rc = lib.dtts_load_wav(os.fsencode(path), target_sr, ctypes.byref(data),
                           ctypes.byref(length))
    if rc != 0:
        return None
    try:
        return np.ctypeslib.as_array(data, shape=(length.value,)).copy()
    finally:
        lib.dtts_free(data)
