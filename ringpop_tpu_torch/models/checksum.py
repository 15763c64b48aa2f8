"""Reference-format membership checksums of view rows, on the host.

The checksum (ringpop's lib/membership.js) is FarmHash32 of the member
list sorted by address, each present member written as
``addr + status + incarnation`` and the entries joined by ``;``.  Node
i's checksum is a function of row i of ``view_key``.  This module
builds the string in Python and hashes it with the pure-Python
FarmHash: it is the host oracle for small clusters.  Whole-cluster
checksums of a large simulation go through ``ops/checksum_device.py``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ringpop_tpu_torch.models.swim_sim import NONE, STATUS_NAMES
from ringpop_tpu_torch.ops.farmhash import farmhash32


def default_addresses(n: int, host: str = "127.0.0.1", base_port: int = 10000) -> list[str]:
    """The address book of the host harness: ``host:port`` per node."""
    return [f"{host}:{base_port + i}" for i in range(n)]


class AddressBook:
    """Static per-simulation address table and its sort order (addresses
    never change during a simulation; membership changes are statuses)."""

    def __init__(self, addresses: Sequence[str]):
        self.addresses = list(addresses)
        self.sorted_order = np.argsort(np.array(self.addresses, dtype=object), kind="stable")
        self._addr_bytes = [a.encode() for a in self.addresses]
        self.index = {a: i for i, a in enumerate(self.addresses)}

    def __len__(self) -> int:
        return len(self.addresses)


_STATUS_BYTES = {code: name.encode() for code, name in STATUS_NAMES.items()}


def row_checksum(
    book: AddressBook, row_status: np.ndarray, row_inc: np.ndarray, base_inc: int
) -> int:
    """Reference checksum of one node's view row (uint32)."""
    parts = []
    for j in book.sorted_order:
        s = int(row_status[j])
        if s == NONE:
            continue
        inc = base_inc + int(row_inc[j])
        parts.append(b"%s%s%d" % (book._addr_bytes[j], _STATUS_BYTES[s], inc))
    return farmhash32(b";".join(parts))


def view_checksums(
    book: AddressBook,
    view_status: np.ndarray,
    view_inc: np.ndarray,
    base_inc: int,
    indices: Sequence[int] | None = None,
) -> dict[int, int]:
    """Checksums of the given (default: all) rows, keyed by row index."""
    if indices is None:
        indices = range(view_status.shape[0])
    return {
        int(i): row_checksum(book, view_status[i], view_inc[i], base_inc) for i in indices
    }


def view_checksums_packed(
    book: AddressBook, keys_rows: np.ndarray, base_inc: int
) -> np.ndarray:
    """Checksums of packed ``view_key`` rows, in row order (uint32)."""
    keys_rows = np.asarray(keys_rows)
    out = view_checksums(book, (keys_rows & 7).astype(np.int8), keys_rows >> 3, base_inc)
    return np.array([out[i] for i in range(keys_rows.shape[0])], dtype=np.uint32)


def row_members(
    book: AddressBook, row_status: np.ndarray, row_inc: np.ndarray, base_inc: int
) -> list[dict]:
    """A view row as the reference's member list (sorted by address)."""
    out = []
    for j in book.sorted_order:
        s = int(row_status[j])
        if s == NONE:
            continue
        out.append(
            {
                "address": book.addresses[j],
                "status": STATUS_NAMES[s],
                "incarnationNumber": base_inc + int(row_inc[j]),
            }
        )
    return out
