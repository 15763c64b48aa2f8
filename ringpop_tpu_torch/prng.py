"""Bit-exact threefry2x32 keys and draws, matching ``jax.random``.

The port's state is integer lattice math, so it is held to exact
equality with the JAX package tick by tick.  That needs the very bits
``jax.random`` draws, not a ``torch.Generator`` stream.  This module
reimplements the legacy raw keys (``uint32[2]``) of ``jax.random``:
``PRNGKey``, ``split``, ``fold_in``, ``uniform`` (float32), ``randint``
(int32) and ``categorical``, in both ``jax_threefry_partitionable``
modes:

* ``partitionable=True`` (jax 0.9's default): a draw of shape ``s``
  hashes the 64-bit linear index of each element, split into
  (hi, lo) words; 32-bit bits are ``bits1 ^ bits2`` and a split key is
  the pair ``(bits1, bits2)`` (``jax/_src/prng.py``
  ``_threefry_split_foldlike`` and ``_threefry_random_bits_partitionable``).
* ``partitionable=False`` (jax 0.4.37's default): the counter
  ``iota(m)`` is hashed as two halves, ``x0 = iota[:m/2]`` and
  ``x1 = iota[m/2:]`` (zero-padded when odd), and the two outputs are
  concatenated (``_threefry_split_original`` and
  ``_threefry_random_bits_original``).

Which mode a draw takes is a process-wide setting, the counterpart of
jax's ``jax_threefry_partitionable`` flag: ``set_partitionable(flag)``
or ``with partitionable_mode(flag):``; the default is ``True``, jax
0.9's.  Every function below takes ``partitionable=None`` to mean that
setting, so every draw of the port follows it; the incident goldens
were pinned under jax 0.4.37 and replay with ``partitionable_mode(False)``.

uint32 arithmetic runs in int64 masked with ``& 0xFFFFFFFF`` (torch's
uint32 support is partial).  ``categorical`` adds Gumbel noise
``-log(-log(u))`` and takes the argmax; its float32 ``log`` is
``xla_log``, XLA:CPU's own algorithm written as separate elementwise
ops, so that the CPU and the card give the reference's bits.  A key is a CPU int64 tensor of shape
``[2]`` holding two uint32 words: keys are host metadata, and only the
draws are made on the caller's device.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


_PARTITIONABLE = True


def get_partitionable() -> bool:
    """The process-wide threefry mode (jax's ``jax_threefry_partitionable``)."""
    return _PARTITIONABLE


def set_partitionable(flag: bool) -> bool:
    """Set the process-wide threefry mode; returns the mode it replaces."""
    global _PARTITIONABLE
    before, _PARTITIONABLE = _PARTITIONABLE, bool(flag)
    return before


@contextlib.contextmanager
def partitionable_mode(flag: bool) -> Iterator[None]:
    """Draw in mode ``flag`` inside the block; the mode before comes back
    after it, also when the block raises."""
    before = set_partitionable(flag)
    try:
        yield
    finally:
        set_partitionable(before)


def _mode(partitionable: bool | None) -> bool:
    return _PARTITIONABLE if partitionable is None else bool(partitionable)


def _i32(v: int) -> int:
    """A uint32 word as the int32 with the same bits."""
    return v - (1 << 32) if v >= (1 << 31) else v


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    """Rotate int32 words left by ``d``: the arithmetic right shift's sign
    bits are masked off, so the bits are those of a uint32 rotation."""
    low = x >> (32 - d)
    low &= (1 << d) - 1
    return low.bitwise_or_(x << d)


def threefry2x32(
    k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block (20 rounds) on uint32 words held in int64.
    The rounds run on int32 words, whose additions wrap as uint32's do,
    in place on the block's own temporaries: half the bytes of int64
    words, and no mask after each add."""
    words = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = x0.to(torch.int32) + _i32(words[0])
    x1 = x1.to(torch.int32) + _i32(words[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x1 = _rotl(x1, r).bitwise_xor_(x0)
        x0 += _i32(words[(i + 1) % 3])
        x1 += _i32((words[(i + 2) % 3] + i + 1) & _M32)
    return x0.to(torch.int64) & _M32, x1.to(torch.int64) & _M32


def _words(key: torch.Tensor) -> tuple[int, int]:
    if key.shape != (2,):
        raise ValueError(f"a key is an int64 tensor of shape [2], got {tuple(key.shape)}")
    k1, k2 = (int(v) for v in key.tolist())
    return k1 & _M32, k2 & _M32


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words ``(seed >> 32, seed & M32)``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32], dtype=torch.int64)


def _hash_counts(
    k1: int, k2: int, m: int, device: torch.device, partitionable: bool, offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """(bits1, bits2) of a draw of ``m`` elements in partitionable mode
    (elements ``offset .. offset + m - 1`` of a larger draw), or the
    flat ``2 * ceil(m/2)``-word stream (as two halves) otherwise."""
    if partitionable:
        idx = torch.arange(offset, offset + m, dtype=torch.int64, device=device)
        return threefry2x32(k1, k2, idx >> 32, idx & _M32)
    half = (m + 1) // 2
    idx = torch.arange(2 * half, dtype=torch.int64, device=device)
    if m % 2:
        idx = torch.where(idx == m, 0, idx)  # the zero pad word
    return threefry2x32(k1, k2, idx[:half], idx[half:])


def split(key: torch.Tensor, num: int = 2, *, partitionable: bool | None = None) -> torch.Tensor:
    """``jax.random.split(key, num)``: int64[num, 2] keys (on the CPU)."""
    partitionable = _mode(partitionable)
    k1, k2 = _words(key)
    if partitionable:
        b1, b2 = _hash_counts(k1, k2, num, torch.device("cpu"), True)
        return torch.stack([b1, b2], dim=1)
    y0, y1 = _hash_counts(k1, k2, 2 * num, torch.device("cpu"), False)
    return torch.cat([y0, y1]).reshape(num, 2)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the block applied to the count
    ``(0, data)`` (``threefry_seed`` of a uint32), the same in both modes."""
    k1, k2 = _words(key)
    x0 = torch.zeros(1, dtype=torch.int64)
    x1 = torch.full((1,), int(data) & _M32, dtype=torch.int64)
    y0, y1 = threefry2x32(k1, k2, x0, x1)
    return torch.cat([y0, y1])


def random_bits(
    key: torch.Tensor,
    shape: tuple[int, ...],
    *,
    device: torch.device | str | None = None,
    partitionable: bool | None = None,
    offset: int = 0,
) -> torch.Tensor:
    """32-bit random words (int64 holding uint32) of ``shape``; in
    partitionable mode ``offset`` skips that many elements of the flat
    draw (a row block of a larger one)."""
    partitionable = _mode(partitionable)
    k1, k2 = _words(key)
    device = torch.device("cpu") if device is None else torch.device(device)
    m = math.prod(shape)
    if partitionable:
        b1, b2 = _hash_counts(k1, k2, m, device, True, offset)
        bits = b1 ^ b2
    else:
        if offset:
            raise ValueError("offset needs the partitionable mode")
        y0, y1 = _hash_counts(k1, k2, m, device, False)
        bits = torch.cat([y0, y1])[:m]
    return bits.reshape(shape)


def _floats(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from 32-bit words: the top 23 bits become the
    mantissa of a float in [1, 2), minus 1."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0


def uniform(
    key: torch.Tensor,
    shape: tuple[int, ...],
    *,
    device: torch.device | str | None = None,
    partitionable: bool | None = None,
    minval: float = 0.0,
    maxval: float = 1.0,
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` (float32):
    ``max(minval, u * (maxval - minval) + minval)`` with u in [0, 1),
    the multiply-add rounded once, as XLA:CPU's FMA does."""
    partitionable = _mode(partitionable)
    u = _floats(random_bits(key, shape, device=device, partitionable=partitionable))
    return _scaled(u, minval, maxval)


def _scaled(u: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """``max(minval, u * (maxval - minval) + minval)`` in float32, the
    multiply-add one FMA as XLA:CPU contracts it."""
    if minval == 0.0 and maxval == 1.0:
        return u
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    return torch.clamp(_fma(u, float(span), float(lo)), min=float(lo))


def randint(
    key: torch.Tensor,
    shape: tuple[int, ...],
    minval: int,
    maxval: int,
    *,
    device: torch.device | str | None = None,
    partitionable: bool | None = None,
) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32, host
    int bounds inside the int32 range): two 32-bit draws from the split
    key, ``(hi % span) * (2**32 % span) + lo % span`` in uint32 (every
    product and sum wraps at 2**32), then ``% span``."""
    partitionable = _mode(partitionable)
    if not (-(1 << 31) <= minval < (1 << 31) and -(1 << 31) <= maxval < (1 << 31)):
        raise ValueError("randint bounds must lie in the int32 range")
    k1, k2 = split(key, partitionable=partitionable)
    hi = random_bits(k1, shape, device=device, partitionable=partitionable)
    lo = random_bits(k2, shape, device=device, partitionable=partitionable)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M32) % span
    off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    # the int32 add of the reference, wrapping
    out = ((minval + off % span + (1 << 31)) & _M32) - (1 << 31)
    return out.to(torch.int32)


# ---------------------------------------------------------------------------
# the Gumbel transform and categorical draws
# ---------------------------------------------------------------------------

_F32_TINY = float(np.finfo(np.float32).tiny)
# the float32 constants of the logarithm (Eigen's cephes log, which
# XLA:CPU lowers float32 ``log`` to), exact as doubles
_LOG_P = tuple(float(np.float32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = float(np.float32(0.693359375))
_SQRTHF = float(np.float32(0.707106781186547524))
# categorical draws hash at most this many elements at once (a row block)
CATEGORICAL_BLOCK = 1 << 24


def _fma(a: torch.Tensor | float, b: torch.Tensor | float, c: torch.Tensor | float) -> torch.Tensor:
    """float32 ``a * b + c`` with the product exact: float64 product and
    sum, then one cast to float32, each a separate op (none can fuse).
    ``b`` may come widened already (a float32 value held in float64)."""
    def dbl(v):
        return v.to(torch.float64) if torch.is_tensor(v) else v
    prod = dbl(a) * dbl(b)
    return prod.add_(dbl(c)).to(torch.float32)


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log of positive normal floats, bit for bit
    XLA:CPU's ``jnp.log`` (Eigen's ``plog_impl_float`` with the one
    multiply-add XLA contracts into an FMA).  Every step is its own
    elementwise op, so the card gives the CPU's bits; ``torch.log``
    misses the last bit on some inputs."""
    x = torch.clamp(x, min=_F32_TINY)
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 126).to(torch.float32)
    x = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    m = x < _SQRTHF
    tmp = torch.where(m, x, 0.0)
    x = x - 1.0
    e = e - m.to(torch.float32)
    x = x + tmp
    x2 = x * x
    x3 = x2 * x
    # each widened once for the nine multiply-adds
    xd, x3d = x.to(torch.float64), x3.to(torch.float64)
    p = _LOG_P
    y = _fma(p[0], xd, p[1])
    y1 = _fma(p[3], xd, p[4])
    y2 = _fma(p[6], xd, p[7])
    y = _fma(y, xd, p[2])
    y1 = _fma(y1, xd, p[5])
    y2 = _fma(y2, xd, p[8])
    del xd
    y = _fma(y, x3d, y1)
    y = _fma(y, x3d, y2)
    y = _fma(y, x3d, e * _LOG_Q1)
    del x3d
    x = x - x2 * 0.5
    x = x + y
    return x + e * _LOG_Q2


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """``-log(-log(u))`` (float32), with the reference's logarithm."""
    return -xla_log(-xla_log(u))


def categorical(
    key: torch.Tensor,
    logits: torch.Tensor,
    m: int,
    *,
    partitionable: bool | None = None,
) -> torch.Tensor:
    """``jax.random.categorical(key, logits, shape=(m,))`` for float32
    ``logits`` [K] (int64 indices on the logits' device): the argmax of
    ``logits + gumbel`` over a [m, K] draw, the Gumbel noise from
    ``uniform(minval=tiny)`` (the "low" mode).  In partitionable mode the
    draw is hashed in row blocks of at most ``CATEGORICAL_BLOCK``
    elements, so the int64 threefry temporaries stay bounded."""
    partitionable = _mode(partitionable)
    k = logits.shape[0]
    dev = logits.device
    if not partitionable:
        u = uniform(key, (m, k), device=dev, partitionable=False, minval=_F32_TINY)
        return torch.argmax(gumbel_from_uniform(u) + logits[None, :], dim=1)
    rows = max(1, CATEGORICAL_BLOCK // max(k, 1))
    out = []
    for a in range(0, m, rows):
        b = min(a + rows, m)
        u = _scaled(_floats(random_bits(key, (b - a, k), device=dev, partitionable=True,
                                            offset=a * k)),
                    _F32_TINY, 1.0)
        out.append(torch.argmax(gumbel_from_uniform(u) + logits[None, :], dim=1))
    return out[0] if len(out) == 1 else torch.cat(out)
