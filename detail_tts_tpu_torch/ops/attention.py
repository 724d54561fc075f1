"""Bias attention for the diffusion ``AttentionBlock``: CUDA kernels and
their plain PyTorch versions.

Every function here computes, per head h,
``softmax(q k^T * sm_scale + bias[h]) v`` on the (B, T, 3C) output of the
qkv projection (channel order [head][q|k|v][ch]) and returns (B, T, C).  The
bias (H, T, T) is shared over the batch.  The softmax runs in base 2: the
scale and a log2-domain bias go straight into ``exp2``.  A row whose every
bias is <= -1e9 gives 0, and zero gradients.

* :func:`bias_attention` - serving forward (no gradient): kernel
  ``bias_attention_fwd`` (``csrc/bias_attention.cu``; in bf16 128 query rows
  a CTA with the bias tile in the ``cp.async`` ring), replacing the Pallas
  serving kernels ``attention_packed_pairs``, ``attention_packed`` and
  ``row_block_attention`` of the JAX package.  It raises when grad mode is
  on and an input requires grad.  The C entry
  ``bias_attention_fwd_blocks_per_sm`` reports its CTAs per SM.
* :func:`bias_attention_train` - the trainable version, a
  :class:`BiasAttentionFunction` over an fp32 natural-domain bias.  Its
  forward is kernel ``bias_attention_train_fwd`` (the same source, on the
  serving kernel's skeleton with the fp32 bias tile in the ``cp.async``
  ring, 128 query rows a CTA where that grid fills the card, also writing
  the row statistic lse = m + log2(l); the C entry
  ``bias_attention_train_fwd_blocks_per_sm`` reports its CTAs per SM); its
  backward the kernels ``bias_attention_bwd_dq_dbias`` (delta, dq
  and one dbias partial per batch row), ``bias_attention_bwd_dkv`` and
  ``bias_attention_bwd_dbias_sum`` (the partials added in batch order)
  (``csrc/bias_attention_bwd.cu``), which write one d(qkv) tensor and a
  dbias summed over the batch.  They replace the Pallas ``attention_train``
  custom VJP (``_attn_train_fwd`` and the two kernels of ``_attn_train_bwd``).

On a CUDA tensor a wrapper launches its kernel (each source is built with
``nvcc`` for sm_90a at first use into ``build/kernels/``, keyed by a hash of
the sources and flags, and loaded with ctypes) and counts the launch in
:data:`LAUNCHES` (serving) or :data:`TRAIN_LAUNCHES`; on a CPU tensor it
calls the plain version.  There is no other route: a failed build or launch
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

import torch

LOG2E = 1.4426950408889634
# log2-domain floor of the running max: rows whose every logit lies below it
# (a bias of -1e9 masks a key) sum to 0 and come out as 0.
FLOOR = -1.0e4
# Row statistic of a row whose softmax sum is 0: exp2(z - lse) is exactly 0.
MASKED_LSE = 1.0e30
TILE = 64  # rows of the kernels' tiles

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCE = CSRC / "bias_attention.cu"
BWD_SOURCE = CSRC / "bias_attention_bwd.cu"
HEADERS = (CSRC / "mma.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = 0  # kernel launches through bias_attention (never the plain path)
# kernel launches of the trainable function, by kernel (never the plain path)
TRAIN_LAUNCHES: Dict[str, int] = {"bias_attention_train_fwd": 0,
                                  "bias_attention_bwd_dq_dbias": 0,
                                  "bias_attention_bwd_dkv": 0,
                                  "bias_attention_bwd_dbias_sum": 0}

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_libs: Dict[Path, ctypes.CDLL] = {}


def bias_attention_reference(qkv: torch.Tensor, bias: torch.Tensor, *,
                             heads: int, sm_scale: float,
                             bias_log2: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the serving kernel: same inputs, same result.

    fp32 logits and softmax (autocast off); P is rounded to the input dtype
    before P.V, as the kernel (and the Pallas kernel it replaces) does.
    """
    with torch.autocast(qkv.device.type, enabled=False):
        return _bias_attention_reference(qkv, bias, heads, sm_scale, bias_log2)


def _bias_attention_reference(qkv, bias, heads, sm_scale, bias_log2):
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


def _split_heads(x: torch.Tensor, heads: int, parts: int) -> List[torch.Tensor]:
    """(B, T, parts*H*D) -> ``parts`` fp32 tensors (B, H, T, D)."""
    b, t, c = x.shape
    d = c // (parts * heads)
    return [y.float().permute(0, 2, 1, 3)
            for y in x.reshape(b, t, heads, parts, d).unbind(3)]


def _logits_log2(q, k, bias, sm_scale):
    """z = scale q k^T + log2(e) bias (fp32, log2 domain), (B, H, T, T)."""
    return (torch.einsum("bhtd,bhsd->bhts", q, k) * (sm_scale * LOG2E)
            + bias.float()[None] * LOG2E)


def bias_attention_train_reference(qkv: torch.Tensor, bias: torch.Tensor, *,
                                   heads: int, sm_scale: float
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the training forward: (B, T, 3C) qkv + fp32
    natural-domain (H, T, T) bias -> (out (B, T, C), lse (B, H, T) fp32).

    Differentiable by torch autograd (through ``out``).  As the kernel: fp32
    logits and softmax (autocast off), the running max floored at FLOOR, P
    rounded to the input dtype before P.V, lse = m + log2(l) or MASKED_LSE
    where l is 0.
    """
    with torch.autocast(qkv.device.type, enabled=False):
        return _bias_attention_train_reference(qkv, bias, heads, sm_scale)


def _bias_attention_train_reference(qkv, bias, heads, sm_scale):
    b, t, _ = qkv.shape
    q, k, v = _split_heads(qkv, heads, 3)
    z = _logits_log2(q, k, bias, sm_scale)
    m = z.amax(dim=-1, keepdim=True).clamp_min(FLOOR)
    p = torch.exp2(z - m)
    l = p.sum(dim=-1, keepdim=True)
    p_in = p + (p.to(qkv.dtype).float() - p).detach()  # rounded, straight-through
    o = torch.einsum("bhts,bhsd->bhtd", p_in, v)
    o = torch.where(l > 0, o / torch.where(l > 0, l, 1.0), 0.0)
    out = o.permute(0, 2, 1, 3).reshape(b, t, -1).to(qkv.dtype)
    lse = torch.where(l > 0, m + torch.log2(torch.where(l > 0, l, 1.0)),
                      MASKED_LSE)[..., 0]
    return out, lse.detach()


def bias_attention_bwd_reference(qkv: torch.Tensor, bias: torch.Tensor,
                                 out: torch.Tensor, lse: torch.Tensor,
                                 dout: torch.Tensor, *, heads: int,
                                 sm_scale: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: -> (dqkv (B, T, 3C) in qkv's
    dtype, dbias (H, T, T) fp32, summed over the batch).

    P = exp2(z - lse) is recomputed from the saved row statistic; with
    delta = rowsum(dout * out), dX = P (dout v^T - delta) is the gradient of
    the natural-domain logits.  P and dX are rounded to the input dtype
    before the products, as the kernels do.  fp32, autocast off.
    """
    with torch.autocast(qkv.device.type, enabled=False):
        return _bias_attention_bwd_reference(qkv, bias, out, lse, dout, heads, sm_scale)


def _probs_and_dx(qkv, bias, out, lse, dout, heads, sm_scale):
    """(q, k, dO, P, dX) of the backward, fp32 (B, H, T, *)."""
    q, k, v = _split_heads(qkv, heads, 3)
    (do,) = _split_heads(dout, heads, 1)
    (o,) = _split_heads(out, heads, 1)
    p = torch.exp2(_logits_log2(q, k, bias, sm_scale) - lse[..., None])
    delta = (do * o).sum(-1, keepdim=True)
    return q, k, do, p, p * (torch.einsum("bhtd,bhsd->bhts", do, v) - delta)


def _bias_attention_bwd_reference(qkv, bias, out, lse, dout, heads, sm_scale):
    b, t, c3 = qkv.shape
    q, k, do, p, dx = _probs_and_dx(qkv, bias, out, lse, dout, heads, sm_scale)
    rnd = lambda x: x.to(qkv.dtype).float()  # noqa: E731
    dq = torch.einsum("bhts,bhsd->bhtd", rnd(dx), k) * sm_scale
    dk = torch.einsum("bhts,bhtd->bhsd", rnd(dx), q) * sm_scale
    dv = torch.einsum("bhts,bhtd->bhsd", rnd(p), do)
    dqkv = torch.stack([dq, dk, dv], dim=3)  # (B, H, T, 3, D)
    dqkv = dqkv.permute(0, 2, 1, 3, 4).reshape(b, t, c3).to(qkv.dtype)
    return dqkv, dx.sum(0)


def bias_attention_dbias_partials_reference(qkv: torch.Tensor, bias: torch.Tensor,
                                            out: torch.Tensor, lse: torch.Tensor,
                                            dout: torch.Tensor, *, heads: int,
                                            sm_scale: float) -> torch.Tensor:
    """Plain version of the dbias partials that ``bias_attention_bwd_dq``
    writes: each batch row's dX, (B, H, T, T) fp32, autocast off."""
    with torch.autocast(qkv.device.type, enabled=False):
        return _probs_and_dx(qkv, bias, out, lse, dout, heads, sm_scale)[-1]


def bias_attention_dbias_sum_reference(part: torch.Tensor) -> torch.Tensor:
    """Plain version of the sum pass: (B, H, T, T) fp32 partials -> (H, T, T),
    added in batch order, part[0] + part[1] + ..., as the kernel adds them."""
    acc = part[0].clone()
    for x in part[1:]:
        acc += x
    return acc


def padded_len(t: int) -> int:
    """Row stride of the kernels' dbias partials: T rounded up to 64."""
    return -(-t // TILE) * TILE


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the bias-attention kernels are "
                           "built from source on the machine with the card")
    return found


def build(source: Path = SOURCE) -> Tuple[Path, float, str]:
    """Compile one kernel library unless this source is already built.

    Returns (library path, seconds spent compiling, compiler output).
    """
    digest = hashlib.sha256(source.read_bytes())
    for header in HEADERS:
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"{source.stem}_{digest.hexdigest()[:16]}.so"
    if lib_path.is_file():
        return lib_path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{log}")
    os.replace(tmp, lib_path)
    return lib_path, seconds, log


def build_all() -> List[Tuple[Path, float, str]]:
    """Build every kernel library of ``csrc/`` at once (the attention
    kernels and ``threefry.cu``), one nvcc process per source."""
    sources = sorted(CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return list(pool.map(build, sources))


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    SOURCE: {"bias_attention_fwd": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
             "bias_attention_train_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _F,
                                          _F, _I, _P],
             "bias_attention_fwd_blocks_per_sm": [_I],
             "bias_attention_train_fwd_blocks_per_sm": [_I],
             "bias_attention_error_string": [_I]},
    BWD_SOURCE: {"bias_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _P, _I,
                                           _I, _I, _I, _F, _F, _F, _I, _P],
                 "bias_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                            _I, _F, _F, _F, _I, _P],
                 "bias_attention_bwd_dbias_sum": [_P, _P, _I, _I, _I, _P],
                 "bias_attention_bwd_blocks_per_sm": [_I, _I],
                 "bias_attention_bwd_error_string": [_I]},
}


def _library(source: Path = SOURCE):
    if source not in _libs:
        lib_path, _, _ = build(source)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_char_p if name.endswith("error_string") else ctypes.c_int
        _libs[source] = lib
    return _libs[source]


def _launch(source: Path, name: str, *args) -> None:
    lib = _library(source)
    rc = getattr(lib, name)(*args)
    if rc != 0:
        err = (lib.bias_attention_error_string if source == SOURCE
               else lib.bias_attention_bwd_error_string)
        raise RuntimeError(f"{name} failed: {err(rc).decode()} ({rc})")


def _check(qkv: torch.Tensor, bias: torch.Tensor, heads: int,
           bias_dtype=None) -> int:
    """Shapes, dtypes, device and layout the kernels take; returns head dim.
    ``bias_dtype``: the bias's required dtype (default: qkv's)."""
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * heads):
        raise ValueError(f"qkv must be (B, T, 3*H*D), got {tuple(qkv.shape)}")
    b, t, c3 = qkv.shape
    d = c3 // (3 * heads)
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"head dim {d} is not a multiple of 16 in [16, 128]")
    if tuple(bias.shape) != (heads, t, t):
        raise ValueError(f"bias must be {(heads, t, t)}, got {tuple(bias.shape)}")
    want = qkv.dtype if bias_dtype is None else bias_dtype
    if qkv.dtype not in _DTYPE_CODE or bias.dtype != want:
        raise TypeError(f"qkv/bias dtypes {qkv.dtype}/{bias.dtype}: need qkv "
                        f"bfloat16 or float32 and bias {want}")
    if bias.device != qkv.device:
        raise ValueError(f"qkv on {qkv.device}, bias on {bias.device}")
    for name, x in (("qkv", qkv), ("bias", bias)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if qkv.data_ptr() % 16 or bias.data_ptr() % 16:
        raise ValueError("qkv and bias must be 16-byte aligned")
    return d


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _device_ok(x: torch.Tensor, what: str) -> None:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")


def bias_attention(qkv: torch.Tensor, bias: torch.Tensor, *, heads: int,
                   sm_scale: float, bias_log2: bool = True) -> torch.Tensor:
    """(B, T, 3C) qkv + (H, T, T) bias -> (B, T, C), without a gradient.

    See the module doc.  Raises under grad mode when ``qkv`` or ``bias``
    requires grad: the kernel has no backward, and the trainable route is
    :func:`bias_attention_train`.
    """
    global LAUNCHES
    if torch.is_grad_enabled() and (qkv.requires_grad or bias.requires_grad):
        raise RuntimeError("bias_attention has no backward; use "
                           "bias_attention_train for inputs that require grad")
    _device_ok(qkv, "bias_attention")
    if not bias_log2:
        bias = bias * LOG2E
    d = _check(qkv, bias, heads)
    if qkv.device.type == "cpu":
        return bias_attention_reference(qkv, bias, heads=heads,
                                        sm_scale=sm_scale, bias_log2=True)
    b, t, _ = qkv.shape
    out = torch.empty((b, t, heads * d), dtype=qkv.dtype, device=qkv.device)
    _launch(SOURCE, "bias_attention_fwd", qkv.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, t, heads, d, sm_scale * LOG2E,
            _DTYPE_CODE[qkv.dtype], _stream(qkv))
    LAUNCHES += 1
    return out


def bias_attention_train_fwd(qkv: torch.Tensor, bias: torch.Tensor, *,
                             heads: int, sm_scale: float
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training forward: (B, T, 3C) qkv + fp32 natural (H, T, T) bias ->
    (out (B, T, C), lse (B, H, T) fp32).  Kernel on CUDA, plain on the CPU."""
    _device_ok(qkv, "bias_attention_train_fwd")
    d = _check(qkv, bias, heads, bias_dtype=torch.float32)
    if qkv.device.type == "cpu":
        return bias_attention_train_reference(qkv, bias, heads=heads,
                                              sm_scale=sm_scale)
    b, t, _ = qkv.shape
    out = torch.empty((b, t, heads * d), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((b, heads, t), dtype=torch.float32, device=qkv.device)
    _launch(SOURCE, "bias_attention_train_fwd", qkv.data_ptr(), bias.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, t, heads, d, sm_scale * LOG2E,
            LOG2E, _DTYPE_CODE[qkv.dtype], _stream(qkv))
    TRAIN_LAUNCHES["bias_attention_train_fwd"] += 1
    return out, lse


def bias_attention_bwd(qkv: torch.Tensor, bias: torch.Tensor, out: torch.Tensor,
                       lse: torch.Tensor, dout: torch.Tensor, *, heads: int,
                       sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training backward: -> (dqkv (B, T, 3C), dbias (H, T, T) fp32 summed
    over the batch).  Three kernels on CUDA (delta, dq and the dbias
    partials; dk and dv; the partials' sum), plain on the CPU."""
    _device_ok(qkv, "bias_attention_bwd")
    d = _check(qkv, bias, heads, bias_dtype=torch.float32)
    b, t, c3 = qkv.shape
    dout = dout.to(qkv.dtype).contiguous()
    for name, x, shape, dtype in (("out", out, (b, t, c3 // 3), qkv.dtype),
                                  ("dout", dout, (b, t, c3 // 3), qkv.dtype),
                                  ("lse", lse, (b, heads, t), torch.float32)):
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != qkv.device:
            raise ValueError(f"{name} must be {shape} {dtype} on {qkv.device}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    if qkv.device.type == "cpu":
        return bias_attention_bwd_reference(qkv, bias, out, lse, dout,
                                            heads=heads, sm_scale=sm_scale)
    out, lse = out.contiguous(), lse.contiguous()
    t_pad = padded_len(t)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty((b, heads, t), dtype=torch.float32, device=qkv.device)
    # one dX per batch row, written once; 0.125 GiB at B=8, T=496, H=16
    part = torch.empty((b, heads, t_pad, t_pad), dtype=torch.float32, device=qkv.device)
    code, stream = _DTYPE_CODE[qkv.dtype], _stream(qkv)
    scales = (sm_scale * LOG2E, LOG2E, sm_scale, code, stream)
    _launch(BWD_SOURCE, "bias_attention_bwd_dq", qkv.data_ptr(), bias.data_ptr(),
            dout.data_ptr(), out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dqkv.data_ptr(), part.data_ptr(), b, t, heads, d, *scales)
    TRAIN_LAUNCHES["bias_attention_bwd_dq_dbias"] += 1
    _launch(BWD_SOURCE, "bias_attention_bwd_dkv", qkv.data_ptr(), bias.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), b, t,
            heads, d, *scales)
    TRAIN_LAUNCHES["bias_attention_bwd_dkv"] += 1
    return dqkv, bias_attention_dbias_sum(part, t)


def bias_attention_dbias_sum(part: torch.Tensor, t: int) -> torch.Tensor:
    """dbias (H, t, t) fp32 from the partials (B, H, Tp, Tp) fp32 with
    Tp = ``padded_len(t)``, added in batch order: kernel
    ``bias_attention_bwd_dbias_sum`` on CUDA, plain on the CPU."""
    _device_ok(part, "bias_attention_dbias_sum")
    t_pad = padded_len(t)
    if (part.dim() != 4 or tuple(part.shape[2:]) != (t_pad, t_pad)
            or part.dtype != torch.float32 or not part.is_contiguous()):
        raise ValueError(f"partials must be contiguous fp32 (B, H, {t_pad}, {t_pad}), "
                         f"got {tuple(part.shape)} {part.dtype}")
    b, h = part.shape[:2]
    if part.device.type == "cpu":
        return bias_attention_dbias_sum_reference(part[:, :, :t, :t])
    dbias = torch.empty((h, t, t), dtype=torch.float32, device=part.device)
    _launch(BWD_SOURCE, "bias_attention_bwd_dbias_sum", part.data_ptr(), dbias.data_ptr(),
            b, t, h, _stream(part))
    TRAIN_LAUNCHES["bias_attention_bwd_dbias_sum"] += 1
    return dbias


class BiasAttentionFunction(torch.autograd.Function):
    """Trainable bias attention: forward ``bias_attention_train_fwd``,
    backward ``bias_attention_bwd`` (kernels on CUDA, plain versions on the
    CPU).  Saves (qkv, bias, out, lse); the (B, H, T, T) probabilities are
    recomputed, never stored."""

    @staticmethod
    def forward(ctx, qkv, bias, heads: int, sm_scale: float):
        out, lse = bias_attention_train_fwd(qkv, bias, heads=heads,
                                            sm_scale=sm_scale)
        ctx.save_for_backward(qkv, bias, out, lse)
        ctx.heads, ctx.sm_scale = heads, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, bias, out, lse = ctx.saved_tensors
        dqkv, dbias = bias_attention_bwd(qkv, bias, out, lse, dout,
                                         heads=ctx.heads, sm_scale=ctx.sm_scale)
        return dqkv, dbias, None, None


def bias_attention_train(qkv: torch.Tensor, bias: torch.Tensor, *, heads: int,
                         sm_scale: float) -> torch.Tensor:
    """Trainable (B, T, 3C) qkv + fp32 natural-domain (H, T, T) bias ->
    (B, T, C); gradients reach both inputs."""
    return BiasAttentionFunction.apply(qkv, bias, heads, sm_scale)
