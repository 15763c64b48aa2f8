"""Bit-exact threefry2x32 keys and draws, matching ``jax.random``.

The port's state is integer lattice math, so it is held to exact
equality with the JAX package tick by tick.  That needs the very bits
``jax.random`` draws, not a ``torch.Generator`` stream.  This module
reimplements the legacy raw keys (``uint32[2]``) of ``jax.random``:
``PRNGKey``, ``split`` and ``uniform`` (float32), in both
``jax_threefry_partitionable`` modes:

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

uint32 arithmetic runs in int64 masked with ``& 0xFFFFFFFF`` (torch's
uint32 support is partial).  A key is a CPU int64 tensor of shape
``[2]`` holding two uint32 words: keys are host metadata, and only the
draws are made on the caller's device.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(
    k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block (20 rounds) on uint32 words held in int64."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


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
    k1: int, k2: int, m: int, device: torch.device, partitionable: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """(bits1, bits2) of a draw of ``m`` elements in partitionable mode,
    or the flat ``2 * ceil(m/2)``-word stream (as two halves) otherwise."""
    if partitionable:
        idx = torch.arange(m, dtype=torch.int64, device=device)
        return threefry2x32(k1, k2, idx >> 32, idx & _M32)
    half = (m + 1) // 2
    idx = torch.arange(2 * half, dtype=torch.int64, device=device)
    if m % 2:
        idx = torch.where(idx == m, 0, idx)  # the zero pad word
    return threefry2x32(k1, k2, idx[:half], idx[half:])


def split(key: torch.Tensor, num: int = 2, *, partitionable: bool = True) -> torch.Tensor:
    """``jax.random.split(key, num)``: int64[num, 2] keys (on the CPU)."""
    k1, k2 = _words(key)
    if partitionable:
        b1, b2 = _hash_counts(k1, k2, num, torch.device("cpu"), True)
        return torch.stack([b1, b2], dim=1)
    y0, y1 = _hash_counts(k1, k2, 2 * num, torch.device("cpu"), False)
    return torch.cat([y0, y1]).reshape(num, 2)


def random_bits(
    key: torch.Tensor,
    shape: tuple[int, ...],
    *,
    device: torch.device | str | None = None,
    partitionable: bool = True,
) -> torch.Tensor:
    """32-bit random words (int64 holding uint32) of ``shape``."""
    k1, k2 = _words(key)
    device = torch.device("cpu") if device is None else torch.device(device)
    m = math.prod(shape)
    if partitionable:
        b1, b2 = _hash_counts(k1, k2, m, device, True)
        bits = b1 ^ b2
    else:
        y0, y1 = _hash_counts(k1, k2, m, device, False)
        bits = torch.cat([y0, y1])[:m]
    return bits.reshape(shape)


def uniform(
    key: torch.Tensor,
    shape: tuple[int, ...],
    *,
    device: torch.device | str | None = None,
    partitionable: bool = True,
) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1)): the top 23
    bits become the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key, shape, device=device, partitionable=partitionable)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0
