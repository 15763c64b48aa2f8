"""Consistent hash ring: 100 replica points per server, FarmHash32 placement.

The port of ``ringpop_tpu/hashring.py`` (after ringpop's ``lib/ring.js``).
``lookup(key)`` returns the owner of the first replica whose hash is at
or above ``farmhash32(key)``, wrapping to the minimum; ``lookup_n``
walks successive unique owners with wraparound.  The ring is a sorted
list of ``(replica_hash, server)`` pairs, so hash ties break by server
name, and every entry and return value equals the reference's.

The one change of design: ``add_remove_servers`` (and ``add_server``)
hash all of a batch's uncached replica names ``f"{server}{i}"`` in one
``farmhash32_batch`` call on the ring's device (the FarmHash32 kernel on
the card), when ``hash_func`` is the default.  Per-key ``lookup`` and
``lookup_n``, the checksum, and a caller's own ``hash_func`` hash on the
host with ``farmhash32``, as the reference does.
"""

from __future__ import annotations

import bisect
from typing import Callable, Sequence

import torch

from ringpop_tpu_torch import resolve_device
from ringpop_tpu_torch.ops.farmhash import farmhash32, farmhash32_batch, pack_rows
from ringpop_tpu_torch.utils.events import EventEmitter

DEFAULT_REPLICA_POINTS = 100


def replica_rows(servers: Sequence[str], replica_points: int):
    """The replica names ``f"{server}{i}"`` of every server, server-major,
    as (uint8[S * P, W], int32[S * P]) rows for ``farmhash32_batch``, W
    the longest name's length."""
    raw = [f"{server}{i}".encode() for server in servers for i in range(replica_points)]
    return pack_rows(raw, max(map(len, raw), default=0))


def hash_replicas(
    servers: Sequence[str], replica_points: int, device: torch.device
) -> torch.Tensor:
    """FarmHash32 of every server's replica names in one batch on
    ``device``: int64[S * P] holding uint32, server-major."""
    bufs, lens = replica_rows(servers, replica_points)
    return farmhash32_batch(
        torch.from_numpy(bufs).to(device), torch.from_numpy(lens).to(device)
    )


class HashRing(EventEmitter):
    def __init__(
        self,
        replica_points: int = DEFAULT_REPLICA_POINTS,
        hash_func: Callable[[str], int] | None = None,
        device: torch.device | str | None = None,
    ):
        """``device`` is where a batch's replica names are hashed when
        ``hash_func`` is the default (``cuda`` unless the caller names
        another; raises when no card is visible and none was named)."""
        super().__init__()
        self.replica_points = replica_points
        self.batch_hash = hash_func is None
        self.hash_func = hash_func or farmhash32
        self.device = resolve_device(device) if self.batch_hash else None
        # Sorted list of (replica_hash, server) pairs.
        self._entries: list[tuple[int, str]] = []
        self.servers: dict[str, bool] = {}
        self.checksum: int | None = None
        # server -> tuple of replica hashes; remove re-uses what add
        # computed, and churn re-adds recently removed servers.
        self._replica_cache: dict[str, tuple[int, ...]] = {}
        # batches hashed by hash_replicas (one kernel launch each on the card)
        self.batches = 0

    def _cache(self, server: str, hashes: tuple[int, ...]) -> None:
        if len(self._replica_cache) > 4 * max(len(self.servers), 1000):
            self._replica_cache.clear()
        self._replica_cache[server] = hashes

    def _replicas_of(self, servers: list[str]) -> dict[str, tuple[int, ...]]:
        """Replica hashes per server: cached ones as they are, the rest
        hashed (in one device batch with the default hash) and cached."""
        out = {s: self._replica_cache[s] for s in servers if s in self._replica_cache}
        missing = [s for s in dict.fromkeys(servers) if s not in out]
        if not missing:
            return out
        p = self.replica_points
        if self.batch_hash:
            flat = hash_replicas(missing, p, self.device).tolist()
            self.batches += 1
            fresh = [tuple(flat[k * p : (k + 1) * p]) for k in range(len(missing))]
        else:
            fresh = [tuple(self.hash_func(f"{s}{i}") for i in range(p)) for s in missing]
        for server, hashes in zip(missing, fresh):
            self._cache(server, hashes)
            out[server] = hashes
        return out

    def _replicas(self, server: str) -> tuple[int, ...]:
        return self._replicas_of([server])[server]

    # -- mutation (ring.js:39-94) -------------------------------------------

    def add_server(self, name: str) -> None:
        if self.has_server(name):
            return
        self._add_server_replicas(name)
        self.compute_checksum()
        self.emit("added", name)

    def remove_server(self, name: str) -> None:
        if not self.has_server(name):
            return
        self._remove_server_replicas(name)
        self.compute_checksum()
        self.emit("removed", name)

    def add_remove_servers(
        self,
        servers_to_add: list[str] | None = None,
        servers_to_remove: list[str] | None = None,
    ) -> bool:
        """Batch add/remove with a single checksum recompute (ring.js:60-94):
        one filter and one sort for the whole batch.  Duplicates within the
        batch count once; a server in both lists resolves to its final
        state as sequential add-then-remove would, and an absent server in
        both still counts as a change (checksum recomputed, True)."""
        removing = set(servers_to_remove or [])
        to_add = [
            s for s in dict.fromkeys(servers_to_add or [])
            if not self.has_server(s) and s not in removing
        ]
        to_remove = [s for s in dict.fromkeys(removing) if self.has_server(s)]
        transient = any(
            s in removing and not self.has_server(s) for s in (servers_to_add or [])
        )
        if not to_add and not to_remove:
            if transient:
                self.compute_checksum()
                return True
            return False
        entries = self._entries
        if to_remove:
            for server in to_remove:
                del self.servers[server]
            gone = self._replicas_of(to_remove)
            dead = {(h, server) for server in to_remove for h in gone[server]}
            entries = [e for e in entries if e not in dead]
        if to_add:
            for server in to_add:
                self.servers[server] = True
            added = self._replicas_of(to_add)
            entries = entries + [(h, server) for server in to_add for h in added[server]]
            entries.sort()
        self._entries = entries
        self.compute_checksum()
        return True

    def _add_server_replicas(self, server: str) -> None:
        self.servers[server] = True
        for h in self._replicas(server):
            bisect.insort(self._entries, (h, server))

    def _remove_server_replicas(self, server: str) -> None:
        del self.servers[server]
        for h in self._replicas(server):
            idx = bisect.bisect_left(self._entries, (h, server))
            if idx < len(self._entries) and self._entries[idx] == (h, server):
                del self._entries[idx]

    # -- checksum (ring.js:96-105) ------------------------------------------

    def compute_checksum(self) -> None:
        server_name_str = ";".join(sorted(self.servers.keys()))
        self.checksum = self.hash_func(server_name_str)
        self.emit("checksumComputed")

    # -- queries (ring.js:107-182) ------------------------------------------

    def get_server_count(self) -> int:
        return len(self.servers)

    def has_server(self, name: str) -> bool:
        return name in self.servers

    def lookup(self, key: str) -> str | None:
        if not self._entries:
            return None
        h = self.hash_func(key)
        idx = bisect.bisect_left(self._entries, (h, ""))
        if idx == len(self._entries):
            idx = 0  # wrap to min (ring.js:142-145)
        return self._entries[idx][1]

    def lookup_n(self, key: str, n: int) -> list[str]:
        """Preference list: up to n unique successor owners (ring.js:150-182)."""
        n = min(n, self.get_server_count())
        if n <= 0 or not self._entries:
            return []
        h = self.hash_func(key)
        start = bisect.bisect_left(self._entries, (h, ""))
        result: list[str] = []
        seen: set[str] = set()
        for k in range(len(self._entries)):
            server = self._entries[(start + k) % len(self._entries)][1]
            if server not in seen:
                seen.add(server)
                result.append(server)
                if len(result) == n:
                    break
        return result
