"""Token sampling with HF ``generate`` semantics (counterpart of ``ops/sampling.py``).

Repetition penalty -> temperature -> typical -> top-p, all on fp32 logits,
then ``argmax(logits + gumbel)``, which is a draw from the categorical:
``jax.random.categorical(key, l)`` is ``argmax(gumbel(key, l.shape) + l)``.
The Gumbel noise is drawn under a JAX key (``ops/prng.py``: a host key, or
a row of the decode's device key buffer) or is passed in.

:func:`sample_step` is one decode step of the JAX package's ``body_fn``
(``models/gpt.py:356-377``): :func:`sample_token` and the step's
bookkeeping (``codes``, ``seen``, ``lengths``, ``finished``, in place).  On
a CUDA device it is one launch of kernel ``sample_step``
(``csrc/sample.cu``, built with ``nvcc`` for sm_90a at first use into
``build/kernels/`` and loaded with ctypes, as the other kernels are), which
draws the Gumbels of the kept tokens in registers from the step's device
key, counted in :data:`LAUNCHES`; on the CPU it is the plain version
:func:`sample_step_reference`.  The kernel takes any vocabulary: up to
65,536 it spreads a row over a cluster of 8 CTAs, each holding its share
of the row in shared memory; past that (to the C entry's int, 2**31 - 1)
a sibling kernel spreads it over a group of G CTAs, up to every SM (G a
function of V and of the card, never of the batch), in one cooperative
launch whose groups take the batch's rows in turn, reads the row from
global memory once into shared memory and re-reads only what that does not
hold.  There is no other route: a failed build or launch, a cluster the
card cannot schedule, or a wide grid it cannot hold at once, raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch

from detail_tts_tpu_torch.ops import attention, prng

SOURCE = attention.CSRC / "sample.cu"
# the kernel's C entry takes the vocabulary as an int
_INT_MAX = 2 ** 31 - 1
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}

# kernel launches, by kernel (never the plain path)
LAUNCHES: Dict[str, int] = {"sample_step": 0}


def _divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` by IEEE division on every device, as the ``sample_step``
    kernel divides (PyTorch's CUDA divide by a Python number multiplies by
    its rounded reciprocal instead)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def apply_repetition_penalty(logits: torch.Tensor, seen_mask: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor: score > 0 -> /p, else *p."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, _divide(logits, penalty), logits * penalty)
    return torch.where(seen_mask, penalized, logits)


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return logits if temperature == 1.0 else _divide(logits, temperature)


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """HF TopPLogitsWarper (min_tokens_to_keep=1) with its tie semantics.

    Removal in ascending stable-sorted order is a prefix, so the kept set is:
    value > boundary value, or equal to it with an original index at or after
    the boundary's (the stable sort orders ties by index).
    """
    if top_p >= 1.0:
        return logits
    v = logits.shape[-1]
    sorted_logits, order = torch.sort(logits, dim=-1, stable=True)
    cum = torch.softmax(sorted_logits.float(), dim=-1).cumsum(dim=-1)
    k = (cum <= (1.0 - top_p)).sum(dim=-1, keepdim=True).clamp_max(v - 1)
    boundary_val = sorted_logits.gather(-1, k)
    boundary_idx = order.gather(-1, k)
    idx = torch.arange(v, device=logits.device)
    remove = (logits < boundary_val) | ((logits == boundary_val)
                                        & (idx < boundary_idx))
    return logits.masked_fill(remove, float("-inf"))


def apply_typical(logits: torch.Tensor, mass: float = 0.9) -> torch.Tensor:
    """Entropy-typical filtering (gpt/modules/typical_sampling.py:1-33)."""
    if mass >= 1.0:
        return logits
    logp = torch.log_softmax(logits.float(), dim=-1)
    p = logp.exp()
    entropy = -torch.where(p > 0, p * logp, 0.0).sum(dim=-1, keepdim=True)
    shifted = (-logp - entropy).abs()
    sorted_shifted, order = torch.sort(shifted, dim=-1, stable=True)
    cum = p.gather(-1, order).cumsum(dim=-1)
    last_ind = (cum < mass).sum(dim=-1, keepdim=True).clamp_max(p.shape[-1] - 1)
    remove = shifted > sorted_shifted.gather(-1, last_ind)
    return logits.masked_fill(remove, float("-inf"))


def sample_token(logits: torch.Tensor, *, seen_mask: torch.Tensor,
                 temperature: float = 0.8, top_p: float = 0.8,
                 repetition_penalty: float = 2.0, typical_mass: float = 1.0,
                 key=None, gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode-step sample, (B, V) -> (B,) int64.  The Gumbel noise is
    ``gumbel``, else drawn under ``key`` (``prng.draw``)."""
    logits = logits.float()
    logits = apply_repetition_penalty(logits, seen_mask, repetition_penalty)
    logits = apply_temperature(logits, temperature)
    logits = apply_typical(logits, typical_mass)
    logits = apply_top_p(logits, top_p)
    if gumbel is None:
        gumbel = prng.draw(key, logits.shape, "gumbel", device=logits.device)
    return torch.argmax(gumbel + logits, dim=-1)


# ---------------------------------------------------------------- the decode step


def sample_step_reference(logits: torch.Tensor, seen: torch.Tensor, codes: torch.Tensor,
                          lengths: torch.Tensor, finished: torch.Tensor, step: int,
                          key: torch.Tensor, *, temperature: float, top_p: float,
                          repetition_penalty: float, typical_mass: float, stop_token: int,
                          force_full: bool, offset: int = 0) -> torch.Tensor:
    """Plain version of :func:`sample_step`: :func:`sample_token` with the
    Gumbels of ``prng.draw_reference``, then ``body_fn``'s bookkeeping."""
    gumbel = prng.draw_reference(key, logits.shape, "gumbel", offset=offset,
                                 device=logits.device)
    tok = sample_token(logits, seen_mask=seen, temperature=temperature, top_p=top_p,
                       repetition_penalty=repetition_penalty, typical_mass=typical_mass,
                       gumbel=gumbel)
    tok = torch.where(finished, stop_token, tok)
    codes[:, step] = tok
    seen[torch.arange(tok.shape[0], device=tok.device), tok] = True
    lengths += (~finished).long()
    if not force_full:
        finished |= tok == stop_token
    return tok


def _check_step(logits, seen, codes, lengths, finished, step, key, stop_token) -> None:
    """What the kernel takes: (B, V) bf16/fp32 logits with V >= 1, bool
    ``seen`` (B, V), int64 ``codes`` (B, n) with 0 <= step < n, int64
    ``lengths`` and bool ``finished`` (B,), an int32 (2,) key, all
    contiguous on one device, and a stop token inside the vocabulary."""
    if logits.dim() != 2 or logits.dtype not in _DTYPE_CODE:
        raise TypeError(f"logits must be (B, V) bfloat16 or float32, got {logits.dtype} "
                        f"{tuple(logits.shape)}")
    b, v = logits.shape
    if v < 1:
        raise ValueError(f"vocabulary {v} is empty")
    want = {"seen": ((b, v), torch.bool), "lengths": ((b,), torch.int64),
            "finished": ((b,), torch.bool), "key": ((2,), torch.int32)}
    given = {"seen": seen, "lengths": lengths, "finished": finished, "key": key}
    for name, (shape, dtype) in want.items():
        x = given[name]
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    if codes.dim() != 2 or codes.shape[0] != b or codes.dtype != torch.int64:
        raise ValueError(f"codes must be int64 ({b}, n), got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    if not 0 <= step < codes.shape[1]:
        raise ValueError(f"step {step} is outside the {codes.shape[1]} code columns")
    if not 0 <= stop_token < v:
        raise ValueError(f"stop token {stop_token} is outside the vocabulary {v}")
    for name, x in (("logits", logits), ("codes", codes), *given.items()):
        if x.device != logits.device:
            raise ValueError(f"{name} is on {x.device}, logits on {logits.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if logits.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the sample step runs on cuda or cpu, not {logits.device}")


_P, _I, _F, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint64
_SIGNATURES = {"sample_step": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                               _F, _I, _F, _I, _F, _I, _I, _U64, _P],
               "sample_step_floor": [_I, _P],
               "sample_step_shape": [_P, _P],
               "sample_step_wide_shape": [_I, _I, _I, _P, _P, _P],
               "sample_error_string": [_I]}
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib_path, _, _ = attention.build(SOURCE)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_char_p if name.endswith("error_string") else ctypes.c_int
        _lib = lib
    return _lib


def _launch(name: str, *args) -> None:
    lib = _library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed: {lib.sample_error_string(rc).decode()} ({rc})")


def sample_step(logits: torch.Tensor, seen: torch.Tensor, codes: torch.Tensor,
                lengths: torch.Tensor, finished: torch.Tensor, step: int,
                key: torch.Tensor, *, temperature: float, top_p: float,
                repetition_penalty: float, typical_mass: float, stop_token: int,
                force_full: bool, offset: int = 0) -> torch.Tensor:
    """One decode step on (B, V) ``logits``: the (B,) int64 tokens, drawn
    under the step's device ``key`` (a row of ``prng.decode_keys``' buffer;
    row r of the batch draws at flat indices ``offset`` + r V + j, ``offset``
    a data rank's ``prng.row_offset``), with the stop token where
    ``finished``.  In place: ``codes[:, step]``, ``seen[r, tok]``,
    ``lengths`` (+1 where not finished) and, unless ``force_full``,
    ``finished`` (| tok == stop).  Kernel ``sample_step`` on CUDA, each row
    over a cluster of 8 CTAs, or past V = 65,536 over a group of up to
    every SM; the plain version on the CPU."""
    _check_step(logits, seen, codes, lengths, finished, step, key, stop_token)
    kw = dict(temperature=temperature, top_p=top_p, repetition_penalty=repetition_penalty,
              typical_mass=typical_mass, stop_token=stop_token, force_full=force_full,
              offset=offset)
    if logits.device.type == "cpu":
        return sample_step_reference(logits, seen, codes, lengths, finished, step, key, **kw)
    b, v = logits.shape
    if v > _INT_MAX:
        raise ValueError(f"vocabulary {v} is past the kernel's int ({_INT_MAX})")
    tok = torch.empty(b, dtype=torch.int64, device=logits.device)
    _launch("sample_step", logits.data_ptr(), _DTYPE_CODE[logits.dtype], seen.data_ptr(),
            codes.data_ptr(), lengths.data_ptr(), finished.data_ptr(), tok.data_ptr(),
            key.data_ptr(), b, v, codes.shape[1], int(step),
            int(repetition_penalty != 1.0), float(repetition_penalty),
            int(temperature != 1.0), float(temperature),
            int(typical_mass < 1.0), float(np.float32(typical_mass)),
            int(top_p < 1.0), float(np.float32(1.0 - top_p)),
            int(stop_token), int(bool(force_full)), int(offset),
            torch.cuda.current_stream(logits.device).cuda_stream)
    LAUNCHES["sample_step"] += 1
    return tok
