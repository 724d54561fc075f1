"""Bias attention for the diffusion ``AttentionBlock``: one CUDA kernel and its
plain PyTorch version.

``bias_attention`` computes, per head h,
``softmax(q k^T * sm_scale + bias[h]) v`` on the (B, T, 3C) output of the qkv
projection (channel order [head][q|k|v][ch]) and returns (B, T, C).  The bias
(H, T, T) is shared over the batch.  The softmax runs in base 2: the scale and
a log2-domain bias (``bias_log2=True``, as the hoisted serving biases are) go
straight into ``exp2``.  A row whose every bias is <= -1e9 gives 0.

On a CUDA tensor the wrapper launches ``csrc/bias_attention.cu`` (built with
``nvcc`` for sm_90a at first use, keyed by a hash of the source, loaded with
ctypes) and counts the launch in :data:`LAUNCHES`; on a CPU tensor it calls
:func:`bias_attention_reference`.  The kernel replaces the Pallas serving
kernels ``attention_packed_pairs``, ``attention_packed`` and
``row_block_attention`` of the JAX package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Tuple

import torch

LOG2E = 1.4426950408889634
# log2-domain floor of the running max: rows whose every logit lies below it
# (a bias of -1e9 masks a key) sum to 0 and come out as 0.
FLOOR = -1.0e4

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "bias_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = 0  # kernel launches through bias_attention (never the plain path)

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_lib = None


def bias_attention_reference(qkv: torch.Tensor, bias: torch.Tensor, *,
                             heads: int, sm_scale: float,
                             bias_log2: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same inputs, same result.

    fp32 logits and softmax; P is rounded to the input dtype before P.V, as
    the kernel (and the Pallas kernel it replaces) does.
    """
    b, t, c3 = qkv.shape
    d = c3 // (3 * heads)
    q, k, v = qkv.reshape(b, t, heads, 3, d).unbind(3)
    bias2 = bias.float() if bias_log2 else bias.float() * LOG2E
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) \
        * (sm_scale * LOG2E) + bias2[None]
    m = s.amax(dim=-1, keepdim=True).clamp_min(FLOOR)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhts,bshd->bhtd", p.to(qkv.dtype).float(), v.float())
    o = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    return o.permute(0, 2, 1, 3).reshape(b, t, heads * d).to(qkv.dtype)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the bias-attention kernel is "
                           "built from source on the machine with the card")
    return found


def build() -> Tuple[Path, float, str]:
    """Compile the kernel library unless this source is already built.

    Returns (library path, seconds spent compiling, compiler output).
    """
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"bias_attention_{tag}.so"
    if lib_path.is_file():
        return lib_path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib_path)
    return lib_path, seconds, log


def _library():
    global _lib
    if _lib is None:
        lib_path, _, _ = build()
        lib = ctypes.CDLL(str(lib_path))
        lib.bias_attention_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p]
        lib.bias_attention_fwd.restype = ctypes.c_int
        lib.bias_attention_error_string.argtypes = [ctypes.c_int]
        lib.bias_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(qkv: torch.Tensor, bias: torch.Tensor, heads: int) -> int:
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"qkv must be (B, T, 3*H*D), got {tuple(qkv.shape)}")
    b, t, c3 = qkv.shape
    d = c3 // (3 * heads)
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"head dim {d} is not a multiple of 16 in [16, 128]")
    if tuple(bias.shape) != (heads, t, t):
        raise ValueError(f"bias must be {(heads, t, t)}, got {tuple(bias.shape)}")
    if qkv.dtype not in _DTYPE_CODE or bias.dtype != qkv.dtype:
        raise TypeError(f"qkv/bias dtypes {qkv.dtype}/{bias.dtype}: need both "
                        "bfloat16 or both float32")
    if bias.device != qkv.device:
        raise ValueError(f"qkv on {qkv.device}, bias on {bias.device}")
    for name, x in (("qkv", qkv), ("bias", bias)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if qkv.data_ptr() % 16 or bias.data_ptr() % 16:
        raise ValueError("qkv and bias must be 16-byte aligned")
    return d


def bias_attention(qkv: torch.Tensor, bias: torch.Tensor, *, heads: int,
                   sm_scale: float, bias_log2: bool = True) -> torch.Tensor:
    """(B, T, 3C) qkv + (H, T, T) bias -> (B, T, C).  See the module doc."""
    global LAUNCHES
    if qkv.device.type not in ("cuda", "cpu"):
        raise ValueError(f"bias_attention runs on cuda or cpu, not {qkv.device}")
    if not bias_log2:
        bias = bias * LOG2E
    d = _check(qkv, bias, heads)
    if qkv.device.type == "cpu":
        return bias_attention_reference(qkv, bias, heads=heads,
                                        sm_scale=sm_scale, bias_log2=True)
    b, t, _ = qkv.shape
    out = torch.empty((b, t, heads * d), dtype=qkv.dtype, device=qkv.device)
    lib = _library()
    rc = lib.bias_attention_fwd(
        qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), b, t, heads, d,
        sm_scale * LOG2E, _DTYPE_CODE[qkv.dtype],
        torch.cuda.current_stream(qkv.device).cuda_stream)
    if rc != 0:
        msg = lib.bias_attention_error_string(rc).decode()
        raise RuntimeError(f"bias_attention_fwd failed: {msg} ({rc})")
    LAUNCHES += 1
    return out
