"""Device-side consistent-hash ring: build and batched lookups.

The port of ``ringpop_tpu/ops/ring_ops.py``.  The ring is a sorted
replica-hash table (int64 holding uint32, the port's convention for
hashes) with an int32 owner table; ``lookup`` of M keys is one
``torch.searchsorted`` (``right=False``: an exact hash hit owns itself,
as ringpop's equality-inclusive upper bound does), and the wrap to the
minimum replica is ``idx % R``.

Replica placement is bit-identical to the host ring (``hashring.py``):
``farmhash32(f"{server}{i}")``, hashed by ``farmhash32_batch`` (the
FarmHash32 kernel on the card, its short-row path for names of at most
24 bytes), with hash ties broken by server name, as the host ring's
``(hash, server)`` order does.  The reference computes the search and
the sort with ``jnp.searchsorted`` and ``jnp.lexsort`` outside any
Pallas kernel, so here ``torch.searchsorted`` and ``torch.sort`` serve.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ringpop_tpu_torch import resolve_device
from ringpop_tpu_torch.hashring import DEFAULT_REPLICA_POINTS, hash_replicas
from ringpop_tpu_torch.ops.farmhash import farmhash32_batch, pack_rows


class DeviceRing(NamedTuple):
    """Sorted replica table: the device form of ringpop's ring."""

    hashes: torch.Tensor  # int64[R] holding uint32, sorted ascending
    owners: torch.Tensor  # int32[R], owner index per replica

    @property
    def size(self) -> int:
        return self.hashes.shape[0]


def _sorted_ring(hashes: torch.Tensor, owners: torch.Tensor, tie: torch.Tensor) -> DeviceRing:
    """Sort by (hash, tie): one int64 key, the hash's uint32 range
    shifted to signed in the high half and the tie (< 2**31) below it;
    stable, so equal keys keep their order as the reference's lexsort
    does."""
    key = (hashes - (1 << 31)) * (1 << 32) + tie.to(torch.int64)
    order = torch.sort(key, stable=True).indices
    return DeviceRing(hashes=hashes[order], owners=owners[order])


def _name_rank(servers: Sequence[str]) -> np.ndarray:
    """Each server's rank in name order (ties by position)."""
    rank = np.empty(len(servers), dtype=np.int64)
    rank[sorted(range(len(servers)), key=servers.__getitem__)] = np.arange(len(servers))
    return rank


def build_ring(
    servers: Sequence[str],
    replica_points: int = DEFAULT_REPLICA_POINTS,
    device: torch.device | str | None = None,
) -> DeviceRing:
    """Ring of ``servers`` on ``device``: the replica names built on the
    host, hashed in one ``farmhash32_batch`` call on the device, and
    sorted there.  Owner ids index into ``servers``; hash ties break by
    server name."""
    dev = resolve_device(device)
    servers = list(servers)
    hashes = hash_replicas(servers, replica_points, dev)
    owners = torch.arange(len(servers), dtype=torch.int32, device=dev).repeat_interleave(
        replica_points
    )
    rank = torch.from_numpy(_name_rank(servers)).to(dev)
    return _sorted_ring(hashes, owners, rank[owners.long()])


def encode_strings(
    strings: Sequence[str], pad_to: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Pack strings into the (padded uint8 buffer, length) form the
    device hash kernels consume: uint8[M, W] with W = ``pad_to`` or the
    longest string's length, at least 25, and int32[M]."""
    raw = [s.encode() for s in strings]
    # the reference's device FarmHash requires buffers of at least 25 bytes
    if pad_to is not None and pad_to < 25:
        raise ValueError("pad_to must be >= 25 (farmhash kernel minimum)")
    width = pad_to or max(max((len(b) for b in raw), default=1), 25)
    return pack_rows(raw, width)


def _digit_table(replica_points: int, device: torch.device):
    """uint8[P, D] decimal digits of 0..P-1 (zero-padded right), int32[P]
    their counts."""
    digits = [str(i).encode() for i in range(replica_points)]
    return (torch.from_numpy(pack_rows(digits, max(map(len, digits), default=1))[0]).to(device),
            torch.tensor([len(d) for d in digits], dtype=torch.int32, device=device))


def build_ring_on_device(
    server_bufs: torch.Tensor,  # uint8[S, L] padded server-name bytes
    server_lens: torch.Tensor,  # int32[S]
    replica_points: int = DEFAULT_REPLICA_POINTS,
    name_rank: torch.Tensor | None = None,  # int[S] rank in name order
) -> DeviceRing:
    """Fully on-device build: every ``server + str(i)`` replica name is
    assembled as [S, P, L + 3] tensor ops, hashed in one
    ``farmhash32_batch`` call, and sorted.  Replica-hash ties break by
    ``name_rank`` (what the host ring's (hash, server) order does); without
    it, by position in ``server_bufs``."""
    if replica_points > 1000:
        raise ValueError(
            "device ring build supports at most 1000 replica points"
            " (3-decimal-digit replica suffixes)"
        )
    dev = server_bufs.device
    s, max_len = server_bufs.shape
    digit_bytes, digit_lens = _digit_table(replica_points, dev)
    out_len = max(max_len + 3, 25)  # the reference kernel's minimum buffer
    col = torch.arange(out_len, device=dev)
    lens64 = server_lens.to(torch.int64)
    srv_pad = torch.nn.functional.pad(server_bufs, (0, out_len - max_len))
    rel = col[None, None, :] - lens64[:, None, None]  # [S, 1, out_len]
    rel = rel.expand(s, replica_points, out_len)
    in_server = (col[None, :] < lens64[:, None])[:, None, :]
    in_digit = (rel >= 0) & (rel < digit_lens[None, :, None])
    digit_vals = torch.gather(
        digit_bytes[None].expand(s, -1, -1), 2, rel.clamp(0, digit_bytes.shape[1] - 1)
    )
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    names = torch.where(in_server, srv_pad[:, None, :],
                        torch.where(in_digit, digit_vals, zero))
    lens = (server_lens[:, None] + digit_lens[None, :]).to(torch.int32)
    hashes = farmhash32_batch(
        names.reshape(s * replica_points, out_len), lens.reshape(s * replica_points)
    )
    owners = torch.arange(s, dtype=torch.int32, device=dev).repeat_interleave(replica_points)
    tie = owners if name_rank is None else name_rank.to(dev)[owners.long()]
    return _sorted_ring(hashes, owners, tie)


def lookup_idx(ring: DeviceRing, key_hashes: torch.Tensor) -> torch.Tensor:
    """Owner index per key hash: ``searchsorted`` with wraparound.  The
    ring must be non-empty (the host ``HashRing.lookup`` returns None on
    an empty ring; a fixed-shape device lookup has no None)."""
    if ring.size == 0:
        raise ValueError("lookup on an empty DeviceRing (no servers)")
    idx = torch.searchsorted(ring.hashes, key_hashes.to(torch.int64), right=False)
    return ring.owners[idx % ring.size]  # wrap to min (ring.js:142-145)


def lookup_keys(
    ring: DeviceRing, key_bufs: torch.Tensor, key_lens: torch.Tensor
) -> torch.Tensor:
    """Hash keys on the device (``farmhash32_batch``), then resolve owners."""
    return lookup_idx(ring, farmhash32_batch(key_bufs, key_lens))


def lookup_n_idx(
    ring: DeviceRing,
    key_hashes: torch.Tensor,
    n: int,
    window: int | None = None,
    in_ring: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Preference list per key: the first ``n`` distinct owners walking
    the ring clockwise with wraparound (ring.js:150-182 lookupN), over a
    static window of successive replicas.  Returns ``(owners int32[M,
    n] -1-padded, complete bool[M])``; ``complete[m]`` is False when the
    window ended before ``min(n, server_count)`` distinct owners.
    ``in_ring`` (bool[M, S]) restricts key m's walk to its masked server
    subset, whose in-mask count is then the floor."""
    if ring.size == 0:
        raise ValueError("lookupN on an empty DeviceRing (no servers)")
    if window is None:
        window = min(ring.size, 32 + 8 * n)
    window = min(window, ring.size)
    dev = ring.hashes.device
    start = torch.searchsorted(ring.hashes, key_hashes.to(torch.int64), right=False)
    offs = (start[:, None] + torch.arange(window, device=dev)[None, :]) % ring.size
    owners = ring.owners[offs]  # int32[M, W]
    # first (in-mask) occurrence of each owner within the walk
    eq = owners[:, :, None] == owners[:, None, :]
    earlier = torch.tril(torch.ones((window, window), dtype=torch.bool, device=dev), -1)
    first = ~(eq & earlier[None]).any(dim=2)
    if in_ring is not None:
        first = first & torch.gather(in_ring, 1, owners.long())
    rank = torch.cumsum(first.to(torch.int32), dim=1) - 1
    m = key_hashes.shape[0]
    # invalid slots scatter to column n, which is dropped
    cols = torch.where(first & (rank < n), rank, n).long()
    out = torch.full((m, n + 1), -1, dtype=torch.int32, device=dev)
    out.scatter_(1, cols, owners)
    if in_ring is None:
        server_count = ring.owners.max().to(torch.int64) + 1
    else:
        server_count = in_ring.to(torch.int64).sum(dim=1)
    found = first.to(torch.int64).sum(dim=1)
    complete = (found >= torch.clamp(server_count, max=n)) | (window >= ring.size)
    return out[:, :n].contiguous(), complete
