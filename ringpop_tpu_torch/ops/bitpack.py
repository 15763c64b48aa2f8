"""Bit-packed boolean planes for the delta backend's at-rest masks.

The port of ``ringpop_tpu/ops/bitpack.py``.  A bool plane packs 32 bits
to a word along its last axis: bit ``j`` of word ``i`` holds element
``i * 32 + j`` and a ragged tail pads with zero bits, so packed planes
compare equal iff the masks do and ``popcount_bits`` needs no tail mask.

torch has no uint32 arithmetic to speak of, so a word is held in int64
with a value in ``[0, 2**32)``: the same bits as the reference's
``uint32`` (``convert.py`` maps one to the other), with room for the
shifts and the SWAR popcount below.
"""

from __future__ import annotations

import torch

WORD_BITS = 32
_M32 = 0xFFFFFFFF


def packed_width(length: int) -> int:
    """Number of 32-bit words covering ``length`` bits."""
    return -(-length // WORD_BITS)


def _shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(WORD_BITS, dtype=torch.int64, device=device)


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool[..., L] -> int64[..., ceil(L/32)] words along the last axis."""
    length = mask.shape[-1]
    words = packed_width(length)
    bits = mask.to(torch.int64)
    pad = words * WORD_BITS - length
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(*mask.shape[:-1], words, WORD_BITS)
    return (bits << _shifts(mask.device)).sum(dim=-1)


def unpack_bits(packed: torch.Tensor, length: int) -> torch.Tensor:
    """int64[..., W] words -> bool[..., length] (inverse of pack_bits)."""
    bits = (packed[..., None] >> _shifts(packed.device)) & 1
    bits = bits.reshape(*packed.shape[:-1], packed.shape[-1] * WORD_BITS)
    return bits[..., :length].to(torch.bool)


def bit_gather(
    packed: torch.Tensor, idx: torch.Tensor, row: torch.Tensor | None = None
) -> torch.Tensor:
    """Point lookups ``mask[idx]`` on a packed plane ([W] words), or
    ``mask[row, idx]`` on a plane of G rows ([G, W]: the sided bases) with
    ``row`` broadcast against ``idx``; in-range indices, one word gather
    and a shift each."""
    idx = idx.to(torch.int64)
    word = packed[idx >> 5] if row is None else packed[row.to(torch.int64), idx >> 5]
    return ((word >> (idx & 31)) & 1).to(torch.bool)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (SWAR, in int64 masked to 32 bits)."""
    x = x & _M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def popcount_bits(
    packed: torch.Tensor, dim: int | None = None, dtype: torch.dtype = torch.int32
) -> torch.Tensor:
    """Total set bits of a packed plane (pad bits are zero by layout)."""
    counts = _popcount32(packed)
    total = counts.sum() if dim is None else counts.sum(dim=dim)
    return total.to(dtype)
