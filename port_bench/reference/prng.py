"""JAX's threefry2x32 keys and draws, as the JAX package's serving path uses
``jax.random`` (with ``jax_threefry_partitionable`` on, JAX's default).

The port's own copy of what serving needs of ``jax/_src/prng.py`` and
``jax/_src/random.py``, bit for bit, so that a seed gives the JAX engine's
codes and audio:

* keys, on the host: a key is two uint32 words, here a tuple of two ints.
  :func:`PRNGKey` (``threefry_seed``: ``(0, seed mod 2**32)`` for a seed
  that fits 32 bits), :func:`split` (the partitionable
  ``_threefry_split_foldlike``: key i is threefry2x32(key; 0, i)) and
  :func:`fold_in` (threefry2x32(key; 0, data)).  They depend on the seed
  only, so they cost no device synchronisation.
* draws, on the device: element i of a draw of shape S is
  threefry2x32(key; hi(j), lo(j)) with j its flat index in S, the two words
  XORed into 32 bits (``_threefry_random_bits_partitionable``), then one
  transform: ``"bits"``, ``"uniform"`` on [0, 1) (JAX's mantissa trick),
  ``"normal"`` (sqrt(2) * erfinv of a uniform on [nextafter(-1, 0), 1), with
  XLA's float32 ErfInv polynomial) or ``"gumbel"`` (JAX's mode ``"low"``,
  -log(-log(u)) of a uniform on [tiny, 1), as ``jax.random.categorical``
  draws it).  A draw depends on the key and the flat index only: row r of a
  batch is the same whatever rows follow it, and a data rank of a sharded
  engine draws its rows alone from ``offset`` = its first row times the row
  width (:func:`row_offset`).
* device keys for the loops: :func:`decode_keys` (the decode's chain
  ``rng, key = split(rng)`` a step) and :func:`split_keys` (``split(key,
  n)``, the ancestral sampler's step keys), each one launch that writes an
  (n, 2) int32 buffer; a step draws with a row of it as its key, so a
  decode step is one launch and no host work.

This copy keeps the plain versions only, on any device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

Key = Tuple[int, int]
# what the engine's entry points take as ``seed``: an int (PRNGKey(seed)) or a key
Seed = Union[int, Key, Sequence[int], np.ndarray]

KINDS = {"bits": 0, "uniform": 1, "normal": 2, "gumbel": 3}
M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# XLA's float32 ErfInv (xla math.cc ErfInv32): coefficients for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)



# ---------------------------------------------------------------- threefry


def _threefry(k0, k1, x0, x1, add, rotl):
    """threefry2x32 (20 rounds, jax/_src/prng.py ``_threefry2x32_lowering``)
    over any integer type given its 32-bit ``add`` and ``rotl``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = add(x0, ks[0]), add(x1, ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = add(x0, x1)
            x1 = rotl(x1, r) ^ x0
        x0 = add(x0, ks[(i + 1) % 3])
        x1 = add(add(x1, ks[(i + 2) % 3]), i + 1)
    return x0, x1


def _threefry_np(k0, k1, x0, x1):
    """On numpy uint32 arrays, which wrap."""
    u = np.uint32
    return _threefry(u(k0), u(k1), np.asarray(x0, u), np.asarray(x1, u),
                     lambda a, b: a + u(b), lambda x, r: (x << u(r)) | (x >> u(32 - r)))


def threefry2x32_reference(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """Plain version on int64 tensors (or ints) holding 32-bit values."""
    return _threefry(k0, k1, x0, x1, lambda a, b: (a + b) & M32,
                     lambda x, r: ((x << r) & M32) | (x >> (32 - r)))


# ---------------------------------------------------------------- host keys


def PRNGKey(seed: int) -> Key:  # noqa: N802 (JAX's name)
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: (0, seed mod 2**32)."""
    return 0, int(seed) & M32


def split(key: Seed, n: int = 2) -> List[Key]:
    """``jax.random.split(key, n)``: key i is threefry2x32(key; 0, i)."""
    k0, k1 = as_key(key)
    x0, x1 = _threefry_np(k0, k1, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    return [(int(a), int(b)) for a, b in zip(x0, x1)]


def fold_in(key: Seed, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: threefry2x32(key; 0, data)."""
    k0, k1 = as_key(key)
    x0, x1 = _threefry_np(k0, k1, np.zeros(1, np.uint32),
                          np.array([int(data) & M32], np.uint32))
    return int(x0[0]), int(x1[0])


def as_key(seed: Seed) -> Key:
    """A key from an entry point's ``seed``: an int means ``PRNGKey(seed)``;
    two uint32 words (a tuple, or ``jax.random.key_data`` as numpy) are the
    key itself."""
    if isinstance(seed, (int, np.integer)):
        return PRNGKey(int(seed))
    if (isinstance(seed, tuple) and len(seed) == 2
            and all(type(w) is int and 0 <= w <= M32 for w in seed)):
        return seed
    words = [int(w) for w in np.asarray(seed).reshape(-1)]
    if len(words) != 2 or not all(0 <= w <= M32 for w in words):
        raise ValueError(f"a key is two uint32 words, got {seed!r}")
    return words[0], words[1]


def row_offset(rows, shape: Sequence[int]) -> int:
    """Flat offset of a draw of ``shape`` whose batch is rows [rows.start,
    ...) of the request's (``rows``: a ``parallel.mesh.Rows``, or None)."""
    return 0 if rows is None else rows.start * math.prod(shape[1:])


# ---------------------------------------------------------------- plain draws


def _words(key, device) -> Tuple:
    """(k0, k1) of a host key or seed, or of a device key row as int64 0-d
    tensors."""
    if torch.is_tensor(key):
        k = key.to(device=device, dtype=torch.int64) & M32
        return k[0], k[1]
    return as_key(key)


def bits_reference(key, shape: Sequence[int], offset: int = 0, device="cpu") -> torch.Tensor:
    """The 32 random bits of each element, int64 in [0, 2**32)."""
    n = math.prod(shape)
    j = torch.arange(n, dtype=torch.int64, device=device) + int(offset)
    k0, k1 = _words(key, device)
    x0, x1 = threefry2x32_reference(k0, k1, j >> 32, j & M32)
    return (x0 ^ x1).reshape(tuple(shape))


def _uniform_reference(bits: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jax.random._uniform in float32: max(lo, f * (hi - lo) + lo), f the
    23 high bits as a mantissa of [1, 2), minus 1."""
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0)
    span = float(np.float32(hi) - np.float32(lo))
    return torch.clamp_min(f * span + lo, lo)


def erfinv_reference(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ErfInv (xla math.cc ErfInv32), one rounding an op."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i])

    p = coef(0)
    for i in range(1, 9):
        p = coef(i) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def draw_reference(key, shape: Sequence[int], kind: str = "normal", *, scale: float = 1.0,
                   offset: int = 0, device="cpu") -> torch.Tensor:
    """Plain version of :func:`draw`."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} is not one of {tuple(KINDS)}")
    bits = bits_reference(key, shape, offset, device)
    if kind == "bits":
        return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)
    if kind == "uniform":
        v = _uniform_reference(bits, 0.0, 1.0)
    elif kind == "normal":
        v = erfinv_reference(_uniform_reference(bits, _NORMAL_LO, 1.0)) * _SQRT2
    else:
        v = -torch.log(-torch.log(_uniform_reference(bits, _TINY, 1.0)))
    return v * scale


def gumbel_rows(keys: np.ndarray, width: int, offset: int = 0, device="cpu") -> torch.Tensor:
    """(n, width) fp32: row s is the Gumbel draw of shape (width,) at flat
    ``offset`` under key ``keys[s]`` ((n, 2) words), as
    :func:`draw_reference` draws it row by row."""
    k = torch.as_tensor(np.asarray(keys, np.int64), device=device) & M32
    j = torch.arange(width, dtype=torch.int64, device=device)[None] + int(offset)
    x0, x1 = threefry2x32_reference(k[:, :1], k[:, 1:], j >> 32, j & M32)
    return -torch.log(-torch.log(_uniform_reference(x0 ^ x1, _TINY, 1.0)))


def keys_reference(key: Key, n: int, chain: bool) -> np.ndarray:
    """Plain version of :func:`decode_keys` (``chain``) and :func:`split_keys`,
    as (n, 2) uint32."""
    if not chain:
        return np.asarray(split(key, n), np.uint32).reshape(n, 2)
    out = np.zeros((n, 2), np.uint32)
    rng = key
    for s in range(n):
        rng, out[s] = split(rng, 2)
    return out


# ---------------------------------------------------------------- device keys


def draw(key, shape: Sequence[int], kind: str = "normal", *, scale: float = 1.0,
         offset: int = 0, device="cpu") -> torch.Tensor:
    """:func:`draw_reference` on the key's device (a device key row) or on
    ``device``."""
    dev = key.device if torch.is_tensor(key) else torch.device(device)
    return draw_reference(key, shape, kind, scale=scale, offset=offset, device=dev)


def decode_keys(key: Seed, n: int, device="cpu") -> torch.Tensor:
    """(n, 2) int32 on ``device``: row s is the key of decode step s, from
    the chain ``rng, key = split(rng)``."""
    return torch.from_numpy(keys_reference(as_key(key), n, True).view(np.int32)).to(device)


def split_keys(key: Seed, n: int, device="cpu") -> torch.Tensor:
    """``split(key, n)`` as an (n, 2) int32 buffer on ``device``."""
    return torch.from_numpy(keys_reference(as_key(key), n, False).view(np.int32)).to(device)
