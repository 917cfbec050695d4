"""The reference's noise stream: Threefry-2x32 keys, bits and normals.

Port of the ``jax.random`` calls behind ``repro/core/aggregation.py``'s
``noise_key`` and ``_leaf_noise`` (the default ``threefry2x32``
implementation with ``jax_threefry_partitionable``), so a byzantine
``mode="noise"`` attack and the lossy channel's payload corruption draw the
reference's own noise from the same seed:

* a key is a pair of uint32 words; ``prng_key(s)`` is ``(s >> 32, s &
  0xFFFFFFFF)`` and ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``.
  Keys are host Python ints: every key this package draws with is a pure
  function of the seed, the round and the leaf index, all known on the
  host, so a device chunk never reads one back;
* ``bits(k, n, offset)`` is ``y0 ^ y1`` of ``threefry2x32(k, (c >> 32, c &
  0xFFFFFFFF))`` over the row-major flat counter ``c`` — bit for bit
  ``jax.random.bits``.  ``offset`` starts the counter anywhere, so one row
  of a ``[W, ...]`` noise stack is drawn without the others;
* ``normal(k, shape, offset)`` is ``sqrt(2) * erfinv(u)``, ``u`` the
  mantissa trick of ``jax.random.uniform`` on ``(nextafter(-1, 0), 1)``.
  ``erfinv`` is XLA's float32 lowering (M. Giles' single-precision
  polynomial on ``w = -log1p(-u^2)``, its Horner steps fused
  multiply-adds as XLA emits them); the remaining gap to JAX is the last
  bit of XLA's own ``log1p`` (``tests/test_torch_robust.py`` states the
  bound).

uint32 arithmetic is emulated in int64 tensors masked to 32 bits (torch's
``uint32`` lacks most operations on the card).  Counters are drawn in
chunks of ``CHUNK`` so a VGG16-sized leaf never holds more than a few
hundred MB of temporaries.  Plain torch ops on an explicit device: this is
not a TPU kernel in the reference, and its work is elementwise.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["CHUNK", "threefry2x32", "prng_key", "fold_in", "bits", "normal", "uniform"]

MASK = 0xFFFFFFFF
CHUNK = 1 << 22
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
Key = Tuple[int, int]
Word = Union[int, torch.Tensor]

# XLA's ErfInv32 coefficients (Giles), highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(key: Key, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x0, x1)``
    under ``key``: Python ints or int64 tensors holding uint32 values."""
    ks = (key[0], key[1], key[0] ^ key[1] ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return (seed >> 32, seed & MASK)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key, 0, int(data) & MASK)


def bits(key: Key, n: int, offset: int = 0, device="cpu") -> torch.Tensor:
    """``n`` uint32 draws (int64 tensor) at flat counters ``offset ..
    offset + n - 1``: ``jax.random.bits(key, shape)`` flattened is
    ``bits(key, prod(shape))``."""
    c = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, c >> 32, c & MASK)
    return y0 ^ y1


def uniform(key: Key, n: int, offset: int = 0, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, (n,), minval=nextafter(-1, 0), maxval=1)``
    at flat counters from ``offset``, float32."""
    f = ((bits(key, n, offset, device) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    # (maxval - minval) rounds to 2.0 in float32, so f * 2 is exact
    return torch.clamp_min((f - 1.0) * 2.0 + lo, lo)


def _erfinv(u: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv: Giles' polynomial in ``w = -log1p(-u*u)``.

    XLA contracts each Horner step ``c + p * w`` into one fused multiply-add;
    the step is taken in float64 (the product of two float32 values is exact
    there) and rounded once, which reproduces that.  The log1p is taken in
    float64 and rounded once too: torch's vectorized float32 log1p is off by
    far more than XLA's on some CPUs."""
    w = -torch.log1p((u * -u).double()).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = (torch.where(lt, a, b).double() + p.double() * w).float()
    return p * u


def normal(key: Key, shape: Sequence[int], offset: int = 0, device="cpu") -> torch.Tensor:
    """Standard normals of ``shape`` at flat counters from ``offset``:
    ``jax.random.normal(key, full_shape)`` flattened, from position
    ``offset`` on (``offset = 0`` and the full shape give the whole draw).
    Float32, drawn ``CHUNK`` counters at a time."""
    n = int(np.prod(shape)) if len(shape) else 1
    out = torch.empty(n, dtype=torch.float32, device=device)
    sqrt2 = float(np.float32(np.sqrt(2)))
    for s in range(0, n, CHUNK):
        m = min(CHUNK, n - s)
        out[s : s + m] = _erfinv(uniform(key, m, offset + s, device)) * sqrt2
    return out.reshape(tuple(shape))
