"""Reference-format membership checksums computed on the device.

The port of ``ringpop_tpu/ops/checksum_device.py``: the checksum string
of each view row (members sorted by address, ``addr + status + inc``,
joined by ``;``) is assembled by tensor ops and hashed by the FarmHash32
kernel (``ops/farmhash.py``), so a whole-cluster checksum sweep of a
large simulation never leaves the card.

* static per-book tables (padded address bytes, lengths, sorted order,
  status names) are built once per ``DeviceBook``;
* the decimal form of ``base_inc + inc`` splits the base around 1e9
  into (hi, lo), so only int32 arithmetic is needed;
* each member entry scatters its bytes at an offset from an exclusive
  cumsum of entry lengths, with a ``;`` before every entry; the first
  entry's ``;`` and every unused slot land in a spare column that is cut
  off.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ringpop_tpu_torch import resolve_device
from ringpop_tpu_torch.models.swim_sim import INC_MAX, STATUS_NAMES
from ringpop_tpu_torch.ops.farmhash import farmhash32_batch

_POW10 = tuple(10**i for i in range(10))


class DeviceBook:
    """Static device tables for one address book."""

    def __init__(
        self,
        addresses: Sequence[str],
        base_inc: int,
        device: torch.device | str | None = None,
    ):
        dev = resolve_device(device)
        self.device = dev
        raw = [a.encode() for a in addresses]
        self.n = len(raw)
        self.base_inc = int(base_inc)
        self.max_addr = max(len(b) for b in raw)
        addr = np.zeros((self.n, self.max_addr), dtype=np.uint8)
        alen = np.zeros((self.n,), dtype=np.int32)
        for i, b in enumerate(raw):
            addr[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
            alen[i] = len(b)
        order = np.argsort(np.array(addresses, dtype=object), kind="stable")
        # tables pre-permuted into checksum (address-sorted) order
        self.addr = torch.as_tensor(addr[order], device=dev)
        self.alen = torch.as_tensor(alen[order], device=dev)
        self.order = torch.as_tensor(order.astype(np.int64), device=dev)

        codes = sorted(STATUS_NAMES)
        self.max_status = max(len(v) for v in STATUS_NAMES.values())
        sbytes = np.zeros((max(codes) + 1, self.max_status), dtype=np.uint8)
        slen = np.zeros((max(codes) + 1,), dtype=np.int32)
        for code, name in STATUS_NAMES.items():
            b = name.encode()
            sbytes[code, : len(b)] = np.frombuffer(b, dtype=np.uint8)
            slen[code] = len(b)
        self.status_bytes = torch.as_tensor(sbytes, device=dev)
        self.status_len = torch.as_tensor(slen, device=dev)

        self.base_hi = self.base_inc // 10**9
        self.base_lo = self.base_inc % 10**9
        self.max_inc_digits = len(str(self.base_inc + INC_MAX))
        # worst-case row string: every member present
        self.entry_width = 1 + self.max_addr + self.max_status + self.max_inc_digits
        self.row_width = max(self.n * self.entry_width, 25)


def _digit_count(x: torch.Tensor) -> torch.Tensor:
    """Decimal digits of a non-negative int32 (0 -> 1)."""
    d = torch.ones_like(x)
    for p in _POW10[1:]:
        d = d + (x >= p).to(x.dtype)
    return d


def row_strings(
    book: DeviceBook, view_key_rows: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Checksum strings of view rows: (bufs uint8[R, W], lens int32[R]).

    ``view_key_rows``: int32[R, N] packed lattice keys."""
    r = view_key_rows.shape[0]
    dev = view_key_rows.device
    keys = view_key_rows.index_select(1, book.order)  # address-sorted order
    status = (keys & 7).to(torch.int64)
    inc = keys >> 3
    present = keys > 0

    # absolute incarnation decimal = (hi, lo) around 1e9
    lo = book.base_lo + inc
    carry = lo >= 10**9
    lo = torch.where(carry, lo - 10**9, lo)
    hi = book.base_hi + carry.to(torch.int32)
    inc_len = torch.where(hi > 0, _digit_count(hi) + 9, _digit_count(lo))

    slen = book.status_len[status]  # [R, N]
    alen = book.alen[None, :]  # [1, N]
    entry_len = torch.where(present, 1 + alen + slen + inc_len, 0)  # [R, N]
    csum = torch.cumsum(entry_len, dim=1, dtype=torch.int32)
    offsets = csum - entry_len  # exclusive
    lens = torch.clamp(csum[:, -1] - 1, min=0)  # minus the leading ';'

    e = book.entry_width
    b = torch.arange(e, dtype=torch.int32, device=dev)[None, None, :]  # [1, 1, E]
    q = b - 1  # content position after the leading ';'
    in_addr = (q >= 0) & (q < alen[:, :, None])
    q_s = q - alen[:, :, None]  # [1, N, E]
    in_status = (q_s >= 0) & (q_s < slen[:, :, None])
    q_i = q_s - slen[:, :, None]  # [R, N, E]

    # address byte at q: the same for every row
    addr_byte = book.addr[:, torch.clamp(q[0, 0], 0, book.max_addr - 1)][None]
    # status byte at q_s of this row's status name
    s_idx = status[:, :, None] * book.max_status + torch.clamp(q_s, 0, book.max_status - 1)
    status_byte = book.status_bytes.reshape(-1)[s_idx]
    # decimal digit at exponent e10 (from the least significant): >= 9
    # reads hi, below reads lo
    e10 = inc_len[:, :, None] - 1 - q_i
    pow10 = torch.tensor(_POW10, dtype=torch.int32, device=dev)
    pow_hi = pow10[torch.clamp(e10 - 9, 0, 9)]
    pow_lo = pow10[torch.clamp(e10, 0, 8)]
    digit = torch.where(
        e10 >= 9,
        torch.div(hi[:, :, None], pow_hi, rounding_mode="floor") % 10,
        torch.div(lo[:, :, None], pow_lo, rounding_mode="floor") % 10,
    )
    inc_byte = (digit + ord("0")).to(torch.uint8)

    val = torch.where(
        b == 0,
        ord(";"),
        torch.where(in_addr, addr_byte, torch.where(in_status, status_byte, inc_byte)),
    ).to(torch.uint8)
    valid = present[:, :, None] & (b < entry_len[:, :, None])
    # unused slots and the first entry's ';' (position -1) go to the spare
    # column W, which is cut off
    w = book.row_width
    pos = offsets[:, :, None] + b - 1
    pos = torch.where(valid & (pos >= 0), pos, w).to(torch.int64)
    out = torch.zeros((r, w + 1), dtype=torch.uint8, device=dev)
    out = out.scatter(1, pos.reshape(r, -1), val.reshape(r, -1))
    return out[:, :w], lens


def view_checksums_device(
    book: DeviceBook,
    view_key_rows: torch.Tensor,
    max_elements: int = 64 * 1024 * 1024,
) -> torch.Tensor:
    """Reference-format checksum per view row: int64[R] holding uint32.

    Rows go in chunks: string assembly materializes [rows, N,
    entry_width] intermediates, so a chunk holds at most
    ``max_elements`` of them."""
    r = view_key_rows.shape[0]
    per_row = max(1, book.n * book.entry_width)
    chunk = max(1, min(r, max_elements // per_row))
    outs = []
    for start in range(0, r, chunk):
        bufs, lens = row_strings(book, view_key_rows[start : start + chunk])
        outs.append(farmhash32_batch(bufs, lens))
    return torch.cat(outs) if outs else torch.zeros(0, dtype=torch.int64, device=book.device)
