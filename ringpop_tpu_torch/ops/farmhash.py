"""FarmHash32 (farmhashmk Fingerprint32) for membership checksums.

Three versions, bit-identical:

* ``farmhash32``: pure Python over ``bytes``, the host oracle (a copy of
  the portable path of ``ringpop_tpu/ops/farmhash.py``);
* ``farmhash32_plain``: plain PyTorch over a batch of padded rows,
  uint32 arithmetic in int64 masked to 32 bits, vectorised over rows
  and looping over the 20-byte blocks of the long arm;
* ``farmhash32_batch``: the wrapper that launches a CUDA kernel of
  ``csrc/farmhash32.cu`` (the port of the TPU kernel
  ``ringpop_tpu/ops/farmhash_pallas.py``: a warp a row for any length,
  or a thread a row when every row is at most 24 bytes) for CUDA
  tensors and runs the plain version for CPU tensors only.

Batched hashes return int64 tensors holding uint32 values.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ringpop_tpu_torch import _build

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M32 = 0xFFFFFFFF
_MAGIC = 0xE6546B64

# ---------------------------------------------------------------------------
# pure Python (host oracle)
# ---------------------------------------------------------------------------


def _rotr32(v: int, s: int) -> int:
    if s == 0:
        return v
    return ((v >> s) | (v << (32 - s))) & _M32


def _fmix(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


def _mur(a: int, h: int) -> int:
    a = (a * _C1) & _M32
    a = _rotr32(a, 17)
    a = (a * _C2) & _M32
    h ^= a
    h = _rotr32(h, 19)
    return (h * 5 + _MAGIC) & _M32


def _fetch32(s: bytes, i: int) -> int:
    return int.from_bytes(s[i : i + 4], "little")


def _hash32_len_0_to_4(s: bytes, seed: int = 0) -> int:
    b = seed
    c = 9
    for ch in s:
        v = ch - 256 if ch >= 128 else ch  # signed char semantics
        b = (b * _C1 + v) & _M32
        c ^= b
    return _fmix(_mur(b, _mur(len(s), c)))


def _hash32_len_5_to_12(s: bytes, seed: int = 0) -> int:
    n = len(s)
    a = (n + _fetch32(s, 0)) & _M32
    b = (n * 5 + _fetch32(s, n - 4)) & _M32
    c = (9 + _fetch32(s, (n >> 1) & 4)) & _M32
    d = (n * 5 + seed) & _M32
    return _fmix(seed ^ _mur(c, _mur(b, _mur(a, d))))


def _hash32_len_13_to_24(s: bytes, seed: int = 0) -> int:
    n = len(s)
    a = _fetch32(s, (n >> 1) - 4)
    b = _fetch32(s, 4)
    c = _fetch32(s, n - 8)
    d = _fetch32(s, n >> 1)
    e = _fetch32(s, 0)
    f = _fetch32(s, n - 4)
    h = (d * _C1 + n + seed) & _M32
    a = (_rotr32(a, 12) + f) & _M32
    h = (_mur(c, h) + a) & _M32
    a = (_rotr32(a, 3) + c) & _M32
    h = (_mur(e, h) + a) & _M32
    a = (_rotr32((a + f) & _M32, 12) + d) & _M32
    h = (_mur(b ^ seed, h) + a) & _M32
    return _fmix(h)


def farmhash32(data: bytes | str) -> int:
    """Fingerprint32 of ``data`` (a str is encoded as UTF-8)."""
    s = data.encode("utf-8") if isinstance(data, str) else bytes(data)
    n = len(s)
    if n <= 24:
        if n <= 12:
            return _hash32_len_0_to_4(s) if n <= 4 else _hash32_len_5_to_12(s)
        return _hash32_len_13_to_24(s)

    h = n
    g = (_C1 * n) & _M32
    f = g
    a0 = (_rotr32((_fetch32(s, n - 4) * _C1) & _M32, 17) * _C2) & _M32
    a1 = (_rotr32((_fetch32(s, n - 8) * _C1) & _M32, 17) * _C2) & _M32
    a2 = (_rotr32((_fetch32(s, n - 16) * _C1) & _M32, 17) * _C2) & _M32
    a3 = (_rotr32((_fetch32(s, n - 12) * _C1) & _M32, 17) * _C2) & _M32
    a4 = (_rotr32((_fetch32(s, n - 20) * _C1) & _M32, 17) * _C2) & _M32
    h ^= a0
    h = _rotr32(h, 19)
    h = (h * 5 + _MAGIC) & _M32
    h ^= a2
    h = _rotr32(h, 19)
    h = (h * 5 + _MAGIC) & _M32
    g ^= a1
    g = _rotr32(g, 19)
    g = (g * 5 + _MAGIC) & _M32
    g ^= a3
    g = _rotr32(g, 19)
    g = (g * 5 + _MAGIC) & _M32
    f = (f + a4) & _M32
    f = (_rotr32(f, 19) + 113) & _M32
    iters = (n - 1) // 20
    off = 0
    while iters > 0:
        a = _fetch32(s, off)
        b = _fetch32(s, off + 4)
        c = _fetch32(s, off + 8)
        d = _fetch32(s, off + 12)
        e = _fetch32(s, off + 16)
        h = (h + a) & _M32
        g = (g + b) & _M32
        f = (f + c) & _M32
        h = (_mur(d, h) + e) & _M32
        g = (_mur(c, g) + a) & _M32
        f = (_mur((b + e * _C1) & _M32, f) + d) & _M32
        f = (f + g) & _M32
        g = (g + f) & _M32
        off += 20
        iters -= 1
    g = (_rotr32(g, 11) * _C1) & _M32
    g = (_rotr32(g, 17) * _C1) & _M32
    f = (_rotr32(f, 11) * _C1) & _M32
    f = (_rotr32(f, 17) * _C1) & _M32
    h = _rotr32((h + g) & _M32, 19)
    h = (h * 5 + _MAGIC) & _M32
    h = (_rotr32(h, 17) * _C1) & _M32
    h = _rotr32((h + f) & _M32, 19)
    h = (h * 5 + _MAGIC) & _M32
    h = (_rotr32(h, 17) * _C1) & _M32
    return h


# ---------------------------------------------------------------------------
# plain PyTorch, batched (uint32 words held in int64)
# ---------------------------------------------------------------------------


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for uint32 ``a`` (in int64) and a constant
    ``c < 2**32``, split in 16-bit halves so no product leaves int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _t_rotr(v: torch.Tensor, s: int) -> torch.Tensor:
    return ((v >> s) | (v << (32 - s))) & _M32


def _t_fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _t_mur(a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    a = mul32(_t_rotr(mul32(a, _C1), 17), _C2)
    h = _t_rotr(h ^ a, 19)
    return (h * 5 + _MAGIC) & _M32


def _words_at(b: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Little-endian uint32 at byte ``pos[r]`` of row r (clamped reads;
    the caller masks rows whose arm does not read there)."""
    cols = (pos[:, None] + torch.arange(4, device=b.device)).clamp(0, b.shape[1] - 1)
    w = b.gather(1, cols)
    return w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16) | (w[:, 3] << 24)


# audit: allow=RPL001 the plain version's host loop over blocks
def farmhash32_plain(bufs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Fingerprint32 of each row's first ``lens[r]`` bytes: int64[B]
    holding uint32.  ``bufs`` uint8[B, L], ``lens`` int32[B]."""
    b = bufs.to(torch.int64)
    n = lens.to(torch.int64)
    rows = b.shape[0]
    dev = b.device
    fetch = functools.partial(_words_at, b)

    # len 0..4: signed-char fold over the row's bytes
    hb = torch.zeros(rows, dtype=torch.int64, device=dev)
    hc = torch.full((rows,), 9, dtype=torch.int64, device=dev)
    for i in range(min(4, b.shape[1])):
        v = b[:, i]
        v = torch.where(v >= 128, v - 256, v)
        nb = (mul32(hb, _C1) + v) & _M32
        take = i < n
        hb = torch.where(take, nb, hb)
        hc = torch.where(take, hc ^ nb, hc)
    h04 = _t_fmix(_t_mur(hb, _t_mur(n, hc)))

    # len 5..12
    a = (n + fetch(torch.zeros_like(n))) & _M32
    bb = (n * 5 + fetch(n - 4)) & _M32
    c = (9 + fetch((n >> 1) & 4)) & _M32
    d = (n * 5) & _M32
    h512 = _t_fmix(_t_mur(c, _t_mur(bb, _t_mur(a, d))))

    # len 13..24
    a = fetch((n >> 1) - 4)
    bb = fetch(torch.full_like(n, 4))
    c = fetch(n - 8)
    d = fetch(n >> 1)
    e = fetch(torch.zeros_like(n))
    f = fetch(n - 4)
    h = (mul32(d, _C1) + n) & _M32
    a = (_t_rotr(a, 12) + f) & _M32
    h = (_t_mur(c, h) + a) & _M32
    a = (_t_rotr(a, 3) + c) & _M32
    h = (_t_mur(e, h) + a) & _M32
    a = (_t_rotr((a + f) & _M32, 12) + d) & _M32
    h = (_t_mur(bb, h) + a) & _M32
    h1324 = _t_fmix(h)

    # len > 24
    def pre(p):
        return mul32(_t_rotr(mul32(fetch(p), _C1), 17), _C2)

    h = n & _M32
    g = mul32(n, _C1)
    f = g
    h = _t_rotr(h ^ pre(n - 4), 19)
    h = (h * 5 + _MAGIC) & _M32
    h = _t_rotr(h ^ pre(n - 16), 19)
    h = (h * 5 + _MAGIC) & _M32
    g = _t_rotr(g ^ pre(n - 8), 19)
    g = (g * 5 + _MAGIC) & _M32
    g = _t_rotr(g ^ pre(n - 12), 19)
    g = (g * 5 + _MAGIC) & _M32
    f = (f + pre(n - 20)) & _M32
    f = (_t_rotr(f, 19) + 113) & _M32
    iters = torch.where(n > 24, (n - 1) // 20, 0)
    max_iters = int(iters.max()) if rows else 0
    if max_iters:
        blk = b[:, : 20 * max_iters].reshape(rows, max_iters, 5, 4)
        words = blk[..., 0] | (blk[..., 1] << 8) | (blk[..., 2] << 16) | (blk[..., 3] << 24)
    for i in range(max_iters):
        wa, wb, wc, wd, we = words[:, i].unbind(1)
        nh = (h + wa) & _M32
        ng = (g + wb) & _M32
        nf = (f + wc) & _M32
        nh = (_t_mur(wd, nh) + we) & _M32
        ng = (_t_mur(wc, ng) + wa) & _M32
        nf = (_t_mur((wb + mul32(we, _C1)) & _M32, nf) + wd) & _M32
        nf = (nf + ng) & _M32
        ng = (ng + nf) & _M32
        take = i < iters
        h = torch.where(take, nh, h)
        g = torch.where(take, ng, g)
        f = torch.where(take, nf, f)
    g = mul32(_t_rotr(g, 11), _C1)
    g = mul32(_t_rotr(g, 17), _C1)
    f = mul32(_t_rotr(f, 11), _C1)
    f = mul32(_t_rotr(f, 17), _C1)
    h = _t_rotr((h + g) & _M32, 19)
    h = (h * 5 + _MAGIC) & _M32
    h = mul32(_t_rotr(h, 17), _C1)
    h = _t_rotr((h + f) & _M32, 19)
    h = (h * 5 + _MAGIC) & _M32
    hlong = mul32(_t_rotr(h, 17), _C1)

    return torch.where(
        n <= 4, h04, torch.where(n <= 12, h512, torch.where(n <= 24, h1324, hlong))
    )


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

# 20-byte blocks per shared-memory tile of the kernel (its kTileBlocks,
# checked when the kernel is loaded): lengths at a tile's edges are where
# the tiled walk is likely to break, and the edge cases are built from this.
TILE_BLOCKS = 128

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("farmhash32")
        for entry in (lib.rp_farmhash32, lib.rp_farmhash32_short):
            entry.restype = ctypes.c_int
            entry.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
            ]
        lib.rp_farmhash32_tile_blocks.restype = ctypes.c_int
        tile = lib.rp_farmhash32_tile_blocks()
        if tile != TILE_BLOCKS:
            raise RuntimeError(
                f"csrc/farmhash32.cu tiles {tile} blocks, ops/farmhash.py says {TILE_BLOCKS}"
            )
        _lib = lib
    return _lib


# The longest row the short-row kernel hashes: its arms end at 24 bytes.
SHORT_MAX_LEN = 24


def _launch(bufs: torch.Tensor, lens: torch.Tensor, stream: int) -> torch.Tensor:
    """The kernel launch for ``farmhash32_batch``: checks the lengths,
    then hashes with the short-row kernel when every row is at most
    ``SHORT_MAX_LEN`` bytes (counted in ``farmhash32_batch.short_launches``)
    and with the warp kernel otherwise (``farmhash32_batch.launches``)."""
    rows, width = bufs.shape
    if rows == 0:
        return torch.zeros(0, dtype=torch.int64, device=bufs.device)
    lo, hi = (int(v) for v in torch.aminmax(lens))
    if lo < 0 or hi > width:
        raise ValueError(f"lens must lie in [0, {width}]")
    if bufs.stride(1) != 1 or bufs.stride(0) < width:
        bufs = bufs.contiguous()
    lens = lens.contiguous()
    if hi <= SHORT_MAX_LEN:
        out = torch.empty(rows, dtype=torch.int64, device=bufs.device)
        rc = _kernel().rp_farmhash32_short(
            bufs.data_ptr(), lens.data_ptr(), out.data_ptr(), rows, bufs.stride(0), stream
        )
        _build.check(rc, "farmhash32_short")
        farmhash32_batch.short_launches += 1
        return out
    out = torch.empty(rows, dtype=torch.int32, device=bufs.device)
    rc = _kernel().rp_farmhash32(
        bufs.data_ptr(), lens.data_ptr(), out.data_ptr(), rows, bufs.stride(0), stream
    )
    _build.check(rc, "farmhash32")
    farmhash32_batch.launches += 1
    return out.to(torch.int64) & _M32


def farmhash32_batch(bufs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Fingerprint32 per row: ``bufs`` uint8[B, L], ``lens`` int32[B]
    (each <= L) -> int64[B] holding uint32.  CPU tensors take the plain
    version; CUDA tensors launch a kernel or raise: the short-row kernel
    when no row is longer than ``SHORT_MAX_LEN`` bytes, the warp kernel
    otherwise (mixed batches included).  The kernels read rows at any
    row stride, so a view cut from wider rows (as ``row_strings``
    returns) is hashed in place, without a copy."""
    if bufs.dtype != torch.uint8 or bufs.dim() != 2:
        raise TypeError(f"bufs must be uint8[B, L], got {bufs.dtype}{list(bufs.shape)}")
    rows = bufs.shape[0]
    if lens.dtype != torch.int32 or lens.shape != (rows,):
        raise TypeError(f"lens must be int32[{rows}], got {lens.dtype}{list(lens.shape)}")
    if bufs.device != lens.device:
        raise ValueError("bufs and lens must share a device")
    dev = bufs.device
    if dev.type == "cpu":
        return farmhash32_plain(bufs, lens)
    if dev.type != "cuda":
        raise ValueError(f"farmhash32_batch runs on cpu or cuda tensors, not {dev}")
    with torch.cuda.device(dev):
        return _launch(bufs, lens, torch.cuda.current_stream(dev).cuda_stream)


farmhash32_batch.launches = 0
farmhash32_batch.short_launches = 0


# audit: allow=RPL001 numpy rows and lengths, no tensor
def pack_rows(raw: list[bytes], width: int) -> tuple[np.ndarray, np.ndarray]:
    """Byte strings as the rows ``farmhash32_batch`` takes: uint8[R, width],
    each string zero-padded (none may be longer than ``width``), and
    their lengths int32[R]."""
    lens = np.fromiter(map(len, raw), dtype=np.int32, count=len(raw))
    if lens.size and int(lens.max()) > width:
        raise ValueError(f"a string of {int(lens.max())} bytes does not fit rows of {width}")
    flat = b"".join(b.ljust(width, b"\0") for b in raw)
    return np.frombuffer(flat, dtype=np.uint8).reshape(len(raw), width).copy(), lens
