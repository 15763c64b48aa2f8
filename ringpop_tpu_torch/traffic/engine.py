"""Masked ring lookups: the lookup part of ``ringpop_tpu/traffic/engine.py``.

Per-viewer rings never materialize.  The GLOBAL ring (every address's
replica points, sorted by (hash, name rank) like the host ``HashRing``'s
(hash, server) entries) is one pair of [R] tables, and a viewer's ring
is a boolean mask over servers (its view's alive and suspect members).
A filtered ring is a subsequence of the global sorted table, so a
lookup on the viewer's ring is a ``searchsorted`` into the global table
and a walk clockwise to the first replica whose owner is in the mask.
The walk scans a fixed ``window`` of successive replicas; ``found=False``
reports the keys it could not settle.  The serving chain
(``serve_tick``) and its counters are not ported yet.
"""

from __future__ import annotations

import torch

from ringpop_tpu_torch.models.swim_sim import ALIVE, SUSPECT
from ringpop_tpu_torch.ops.ring_ops import DeviceRing, lookup_n_idx


def in_ring_from_rows(rows_key: torch.Tensor) -> torch.Tensor:
    """bool in-ring mask from packed view-key rows: alive and suspect
    members are ring members (the host ``ring_for`` filter)."""
    s = rows_key & 7
    return (s == ALIVE) | (s == SUSPECT)


def lookup_masked_idx(
    ring_hashes: torch.Tensor,
    ring_owners: torch.Tensor,
    key_hashes: torch.Tensor,
    in_ring: torch.Tensor,
    *,
    window: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Owner per key on a per-key-masked ring.

    ``in_ring`` is bool[M, S]: key m resolves as if the ring held only
    the servers with ``in_ring[m, s]``, bit-identical to a host
    ``HashRing`` of exactly that subset.  A bool[S] mask stands for the
    same row for every key, and is indexed by the walk's owners without
    an [M, S] broadcast.  Returns ``(owner int32[M], -1 where not found;
    found bool[M])``; ``found[m]`` is False when no in-mask replica fell
    inside the ``window``-wide walk."""
    r = ring_hashes.shape[0]
    w = min(window, r)
    m = key_hashes.shape[0]
    dev = ring_hashes.device
    start = torch.searchsorted(ring_hashes, key_hashes.to(torch.int64), right=False)
    offs = (start[:, None] + torch.arange(w, device=dev)[None, :]) % r
    owners = ring_owners[offs]  # int32[M, W]
    if in_ring.dim() == 1:
        ok = in_ring[owners.long()]
    else:
        ok = torch.gather(in_ring, 1, owners.long())  # bool[M, W]
    # torch.argmax takes no bool; on ties it returns the first maximum
    j = torch.argmax(ok.to(torch.uint8), dim=1)
    found = ok.any(dim=1)
    owner = owners[torch.arange(m, device=dev), j]
    return torch.where(found, owner, -1).to(torch.int32), found


def lookup_n_masked_idx(
    ring_hashes: torch.Tensor,
    ring_owners: torch.Tensor,
    key_hashes: torch.Tensor,
    in_ring: torch.Tensor,
    n: int,
    *,
    window: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Preference list per key on a per-key-masked ring: the first ``n``
    distinct in-mask owners walking clockwise (lookupN over the viewer's
    ring), ``ring_ops.lookup_n_idx`` with its ``in_ring`` mask.  Returns
    ``(owners int32[M, n] -1-padded, complete bool[M])``."""
    return lookup_n_idx(
        DeviceRing(hashes=ring_hashes, owners=ring_owners),
        key_hashes,
        n,
        window=window,
        in_ring=in_ring,
    )
