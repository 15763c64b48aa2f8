"""Point-to-point gossip plane: the ring primitives of the sharded step.

The port of ``ringpop_tpu/ops/gossip_remote_copy.py``.  Under a ring
context the member axis is cut into D contiguous row blocks, one per
shard, and the step's cross-row traffic moves between shards only as
rightward ring hops: each shard's block goes to its right neighbour.
Five primitives, all exact (each is a selection or a scatter with a
commutative combiner, never a re-association):

* ``ring_recv_merge(t_safe, fwd_ok, claim_rows)`` -- the receiver merge
  (``models/swim_sim._receiver_merge``): sender blocks circulate, and at
  each hop every shard scatter-maxes the rows addressed to its own
  receivers;
* ``ring_fetch_rows(plane, idx)`` -- ``plane[idx]`` with ``idx`` aligned
  to the member axis: the plane's blocks circulate, and each shard picks
  its rows out of the passing block;
* ``ring_fetch_global(plane, idx)`` -- the same with a replicated ``idx``
  and a replicated output;
* ``ring_take_per_row`` / ``ring_update_per_row`` -- each viewer row reads
  or writes one of its own columns: row-local, no hop.

Two placements, one body each:

* one process a shard (a process group's mesh, ``mesh.on_ranks``): a
  primitive runs the per-shard body of the reference primitive on this
  rank's own block, and each hop is a peer write into the right
  neighbour's memory (``ops/peer_hop.py``: the kernel ``rp_peer_hop`` of
  ``csrc/ring_hop.cu`` on the card, gloo on the CPU).  The same hop
  carries the ring's collectives, ``ring_allgather`` and ``ring_sum``,
  which the step uses where it reads across rows outside these seams,
  ``ring_take_at``, an element gather of a row-split plane, and
  ``ring_fetch_many``, the fetch of several planes in one circulation;
* all D shards in one process (``make_mesh(devices=[dev] * D)``): a
  primitive holds its D blocks as one stacked ``[D, n/D, ...]`` tensor
  and runs the per-shard body batched over the shard axis, so one hop is
  one launch of ``rp_ring_hop`` (the port of the TPU kernel
  ``_hop_kernel``), which copies block i into block (i + 1) mod D of a
  fresh stack.  CPU tensors take ``hop_plain``.

Both forms give the same values.

The ring the primitives run over comes from an ambient context, not an
argument: ``parallel/mesh.py`` opens ``ring_mesh(mesh)`` around its calls
and the models ask ``active_ring()``, so ``models/`` imports nothing of
``parallel/``.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Any, Iterator

import torch

from ringpop_tpu_torch import _build
from ringpop_tpu_torch.obs import annotate
from ringpop_tpu_torch.ops import peer_hop

# ---------------------------------------------------------------------------
# Ambient ring context
# ---------------------------------------------------------------------------

_RING_STACK: list[tuple[Any, str]] = []


@contextlib.contextmanager
def ring_mesh(mesh: Any, axis: str | None = None) -> Iterator[None]:
    """Make ``mesh`` (a ``parallel.mesh.Mesh``) the ambient gossip ring
    for calls in this block.  ``axis`` defaults to the mesh's single
    axis name.  Re-entrant: the innermost context wins."""
    if axis is None:
        (axis,) = mesh.axis_names
    _RING_STACK.append((mesh, axis))
    try:
        yield
    finally:
        _RING_STACK.pop()


def active_ring() -> tuple[Any, str] | None:
    """The innermost ``ring_mesh`` context, or None outside any."""
    return _RING_STACK[-1] if _RING_STACK else None


def ring_devices() -> int:
    """Ring size of the active context (0 when no ring is active)."""
    ring = active_ring()
    if ring is None:
        return 0
    mesh, axis = ring
    return mesh.shape[axis]


def active_rank() -> tuple[int, int] | None:
    """(rank, D) when the active ring runs one process a shard, else None."""
    mesh = _rank_mesh()
    return None if mesh is None else (mesh.rank, mesh.size)


def _rank_mesh() -> Any:
    """The active ring's mesh when it is a process group's, else None."""
    ring = active_ring()
    if ring is None or not getattr(ring[0], "on_ranks", False):
        return None
    return ring[0]


def _peer(mesh: Any, blocks: tuple[torch.Tensor, ...]) -> tuple[torch.Tensor, ...]:
    """One rightward hop of this rank's ``blocks`` to the next rank."""
    return peer_hop.peer_hop(blocks, mesh.peers)


def _circulate() -> None:
    """Count one circulation (D - 1 hops) of this rank's blocks."""
    _circulate.count += 1


_circulate.count = 0


# ---------------------------------------------------------------------------
# Hop transport: one rightward ring shift of each shard's block
# ---------------------------------------------------------------------------


def ring_perm(d: int) -> list[tuple[int, int]]:
    """The rightward ring permutation: shard i's block goes to i+1."""
    return [(i, (i + 1) % d) for i in range(d)]


def block_origin(me: int, hop: int, d: int) -> int:
    """Which shard's block ``me`` holds after ``hop`` rightward shifts
    (the host-side mirror of ``src`` in the fetch primitives)."""
    return (me - hop) % d


def hop_schedule(d: int) -> list[list[tuple[int, int]]]:
    """Per-hop (sender, receiver) pairs of a full D-1-hop circulation:
    every hop is the same rightward permutation, so each shard sends
    once and receives once per hop."""
    return [ring_perm(d) for _ in range(d - 1)]


def hop_plain(blocks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of one hop of the stack ``[D, ...]``:
    ``torch.roll(blocks, 1, dims=0)`` written out as one copy per block
    into a fresh stack."""
    d = blocks.shape[0]
    out = torch.empty_like(blocks)
    for i in range(d):
        out[(i + 1) % d].copy_(blocks[i])
    return out


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("ring_hop")
        lib.rp_ring_hop.restype = ctypes.c_int
        lib.rp_ring_hop.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        ]
        _lib = lib
    return _lib


def hop(blocks: torch.Tensor) -> torch.Tensor:
    """One rightward ring shift of the stack ``[D, ...]`` (any dtype):
    ``out[(i + 1) % D] = blocks[i]``, in a fresh tensor.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (and count
    the launch in ``hop.launches``) or raise.

    Each hop writes a new ``torch.empty`` stack, never its own input, and
    runs on the current stream: on one card that is all the ordering
    the TPU kernel's barrier semaphore gave.  Across cards the peer write
    will need an event each way (the sender's data ready, the
    receiver's buffer free)."""
    if blocks.dim() < 1:
        raise TypeError("hop takes a stack of shard blocks [D, ...]")
    dev = blocks.device
    if dev.type == "cpu":
        return hop_plain(blocks)
    if dev.type != "cuda":
        raise ValueError(f"hop runs on cpu or cuda tensors, not {dev}")
    src = blocks.contiguous()
    out = torch.empty_like(src, memory_format=torch.contiguous_format)
    d = src.shape[0]
    block_bytes = (src.numel() // d) * src.element_size() if d else 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel().rp_ring_hop(src.data_ptr(), out.data_ptr(), block_bytes, d, stream)
    _build.check(rc, "ring_hop")
    hop.launches += 1
    return out


hop.launches = 0


def _hop(blocks: tuple[torch.Tensor, ...]) -> tuple[torch.Tensor, ...]:
    """One rightward ring shift of every stack in ``blocks``."""
    return tuple(hop(b) for b in blocks)


# ---------------------------------------------------------------------------
# Ring primitives
# ---------------------------------------------------------------------------


def _require_ring(n: int) -> tuple[int, int]:
    """(D, n/D) of the active ring; raises outside a ring context or
    when the member axis does not divide."""
    ring = active_ring()
    if ring is None:
        raise RuntimeError("ring primitive called outside a ring_mesh() context")
    mesh, axis = ring
    d = mesh.shape[axis]
    if n % d != 0:
        raise ValueError(f"member axis {n} not divisible by ring size {d}")
    return d, n // d


def _cut(x: torch.Tensor, d: int) -> torch.Tensor:
    """The D row blocks of ``x`` as one stack ``[D, n/D, ...]``."""
    return x.reshape(d, x.shape[0] // d, *x.shape[1:])


def _shard_ids(d: int, ndim: int, device: torch.device) -> torch.Tensor:
    """int64[D, 1, ...] shard index, broadcastable against an
    ``ndim``-dimensional stack."""
    return torch.arange(d, dtype=torch.int64, device=device).view(d, *([1] * (ndim - 1)))


def _bcast(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    """Right-pad ``mask`` with singleton dims up to ``ndim``."""
    return mask.reshape(*mask.shape, *([1] * (ndim - mask.dim())))


def ring_recv_merge(
    t_safe: torch.Tensor, fwd_ok: torch.Tensor, claim_rows: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(in_key int32[N, N], inbound int32[N]): the receiver merge as a
    D-1-hop ring exchange, equal to the unsharded merge bit for bit.

    ``t_safe[s]`` is sender s's receiver, ``fwd_ok[s]`` delivery,
    ``claim_rows[s]`` its claim row (>= 0).  At each hop a shard folds
    the passing rows addressed to its own receivers with a scatter-max
    and counts them; other shards' receivers and undelivered senders go
    to a spare slot ``n_loc`` that is cut off.  Max and add commute
    over the hop order, so the fold is exact.  (The caller,
    ``swim_sim._receiver_merge``, carries the ``swim.recv_merge`` label.)"""
    mesh = _rank_mesh()
    if mesh is not None:
        return _rank_recv_merge(mesh, t_safe, fwd_ok, claim_rows)
    n = t_safe.shape[0]
    d, n_loc = _require_ring(n)
    dev = claim_rows.device
    off = _shard_ids(d, 2, dev) * n_loc  # [D, 1] first receiver of each shard
    acc = torch.zeros((d, n_loc + 1, n), dtype=torch.int32, device=dev)
    inb = torch.zeros((d, n_loc + 1), dtype=torch.int32, device=dev)
    blk = (
        _cut(t_safe.to(torch.int32), d),
        _cut(fwd_ok.to(torch.bool), d),
        _cut(claim_rows.to(torch.int32), d),
    )
    for h in range(d):
        bdest, bok, brows = blk
        tgt = bdest.to(torch.int64) - off
        tgt = torch.where(bok & (tgt >= 0) & (tgt < n_loc), tgt, n_loc)
        acc.scatter_reduce_(
            1, tgt[:, :, None].expand(d, n_loc, n),
            torch.where(bok[:, :, None], brows, 0), reduce="amax", include_self=True,
        )
        inb.scatter_add_(1, tgt, torch.ones_like(bdest))
        if h < d - 1:
            blk = _hop(blk)
    inbound = inb[:, :n_loc]
    in_key = torch.where((inbound > 0)[:, :, None], acc[:, :n_loc], 0)
    return in_key.reshape(n, n), inbound.reshape(n)


def _rank_recv_merge(
    mesh: Any, t_safe: torch.Tensor, fwd_ok: torch.Tensor, claim_rows: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The shard body of ``ring_recv_merge`` on this rank's senders
    (``claim_rows`` [N/D, N]): (in_key [N/D, N], inbound [N/D]) of its
    own receivers."""
    d, me = mesh.size, mesh.rank
    n_loc, n = claim_rows.shape
    dev = claim_rows.device
    off = me * n_loc
    _circulate()
    acc = torch.zeros((n_loc + 1, n), dtype=torch.int32, device=dev)
    inb = torch.zeros((n_loc + 1,), dtype=torch.int32, device=dev)
    blk = (t_safe.to(torch.int32), fwd_ok.to(torch.bool), claim_rows.to(torch.int32))
    for h in range(d):
        bdest, bok, brows = blk
        tgt = bdest.to(torch.int64) - off
        tgt = torch.where(bok & (tgt >= 0) & (tgt < n_loc), tgt, n_loc)
        acc.scatter_reduce_(
            0, tgt[:, None].expand(n_loc, n), torch.where(bok[:, None], brows, 0),
            reduce="amax", include_self=True,
        )
        inb.scatter_add_(0, tgt, torch.ones_like(bdest))
        if h < d - 1:
            blk = _peer(mesh, blk)
    inbound = inb[:n_loc]
    return torch.where((inbound > 0)[:, None], acc[:n_loc], 0), inbound


def _rank_fetch(
    mesh: Any, cur: torch.Tensor, il: torch.Tensor, cols: torch.Tensor | None = None
) -> torch.Tensor:
    """The shard body of the fetch primitives on this rank: ``cur`` its
    block [N/D, ...] of the plane, ``il`` global row ids (any shape).  At
    hop h the rank holds the block of rank ``(me - h) mod D`` and
    resolves the ids in its range; with ``cols`` (the shape of ``il``)
    it picks the element ``plane[il, cols]`` instead of the row."""
    return _rank_fetch_many(mesh, (cur,), il, cols)[0]


def _rank_fetch_many(
    mesh: Any, planes: tuple[torch.Tensor, ...], il: torch.Tensor,
    cols: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """``_rank_fetch`` of several planes with the same rows (any dtypes
    and trailing shapes), all of them in each hop of one circulation."""
    d, me = mesh.size, mesh.rank
    n_loc = planes[0].shape[0]
    _circulate()
    out: list = [None] * len(planes)
    cur = tuple(planes)
    for h in range(d):
        src = (me - h) % d
        sel = torch.div(il, n_loc, rounding_mode="floor") == src
        loc = torch.clamp(il - src * n_loc, 0, n_loc - 1)
        for i, c in enumerate(cur):
            got = c[loc] if cols is None else c[loc, cols]
            prev = torch.zeros_like(got) if out[i] is None else out[i]
            out[i] = torch.where(_bcast(sel, got.dim()), got, prev)
        if h < d - 1:
            cur = _peer(mesh, cur)
    return tuple(out)


def _fetch_blocks(cur: torch.Tensor, il: torch.Tensor, n_loc: int) -> torch.Tensor:
    """The shard bodies of the fetch primitives, batched over the shard
    axis: ``cur`` is the stacked plane ``[D, n_loc, ...]``, ``il`` each
    shard's global row ids ``[D, ...]``.  At hop h shard ``me`` holds the
    block of ``(me - h) mod D`` and resolves the ids in its range; the
    clip keeps the other lanes in bounds, and the ``where`` drops them."""
    d = cur.shape[0]
    dev = cur.device
    me = _shard_ids(d, il.dim(), dev)
    out = torch.zeros((*il.shape, *cur.shape[2:]), dtype=cur.dtype, device=dev)
    for h in range(d):
        src = (me - h) % d
        sel = torch.div(il, n_loc, rounding_mode="floor") == src
        loc = torch.clamp(il - src * n_loc, 0, n_loc - 1)
        got = cur[me, loc]
        out = torch.where(_bcast(sel, got.dim()), got, out)
        if h < d - 1:
            (cur,) = _hop((cur,))
    return out


def ring_fetch_rows(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``plane[idx]`` with ``idx`` aligned to the member axis
    (``idx.shape[0] == plane.shape[0]``, global row ids, any trailing
    index shape); output shape ``idx.shape + plane.shape[1:]``.  The
    plane's blocks circulate the ring; a pure gather, so exact."""
    with annotate.scope("gossip.ring_fetch"):
        mesh = _rank_mesh()
        if mesh is not None:
            if idx.shape[0] != plane.shape[0]:
                raise ValueError(f"idx must be aligned to the rank's rows ({plane.shape[0]}), "
                                 f"got {list(idx.shape)}")
            return _rank_fetch(mesh, plane, idx.to(torch.int64))
        n = plane.shape[0]
        d, n_loc = _require_ring(n)
        if idx.shape[0] != n:
            raise ValueError(f"idx must be aligned to the member axis ({n}), got {list(idx.shape)}")
        out = _fetch_blocks(_cut(plane, d), _cut(idx.to(torch.int64), d), n_loc)
        return out.reshape(*idx.shape, *plane.shape[1:])


def ring_take_per_row(plane: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """``plane[arange(N), col]``: each viewer row reads one of its own
    columns (the diagonal when ``col = arange(N)``).  Row-local: no hop."""
    with annotate.scope("gossip.per_row"):
        mesh = _rank_mesh()
        if mesh is not None:
            r = torch.arange(plane.shape[0], dtype=torch.int64, device=plane.device)
            n = plane.shape[0] * mesh.size
            return plane[r, torch.clamp(col.to(torch.int64), 0, n - 1)]
        n = plane.shape[0]
        d, n_loc = _require_ring(n)
        dev = plane.device
        r = torch.arange(n_loc, dtype=torch.int64, device=dev)[None, :]
        cl = _cut(torch.clamp(col.to(torch.int64), 0, n - 1), d)
        return _cut(plane, d)[_shard_ids(d, 2, dev), r, cl].reshape(n)


def ring_update_per_row(
    plane: torch.Tensor, col: torch.Tensor, values: torch.Tensor, op: str = "set"
) -> torch.Tensor:
    """A copy of ``plane`` with ``plane[i, col[i]]`` set to ``values[i]``
    (``op="set"``) or raised to it (``op="max"``).  Row-local like
    ``ring_take_per_row``."""
    if op not in ("set", "max"):
        raise ValueError(f"op={op!r}: set|max")
    with annotate.scope("gossip.per_row"):
        mesh = _rank_mesh()
        if mesh is not None:
            r = torch.arange(plane.shape[0], dtype=torch.int64, device=plane.device)
            cl = torch.clamp(col.to(torch.int64), 0, plane.shape[0] * mesh.size - 1)
            vl = values.to(plane.dtype)
            if op == "max":
                vl = torch.maximum(plane[r, cl], vl)
            return plane.index_put((r, cl), vl)
        n = plane.shape[0]
        d, n_loc = _require_ring(n)
        dev = plane.device
        shard = _shard_ids(d, 2, dev).expand(d, n_loc)
        r = torch.arange(n_loc, dtype=torch.int64, device=dev)[None, :].expand(d, n_loc)
        cl = _cut(torch.clamp(col.to(torch.int64), 0, n - 1), d)
        blk = _cut(plane, d)
        vl = _cut(values.to(plane.dtype), d)
        if op == "max":
            vl = torch.maximum(blk[shard, r, cl], vl)
        return blk.index_put((shard, r, cl), vl).reshape(plane.shape)


def ring_fetch_global(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``plane[idx]`` with ``idx`` (any shape of global row ids)
    replicated, and so the output: every shard watches all D blocks pass
    and resolves the full index set alike; shard 0's copy is returned."""
    with annotate.scope("gossip.ring_fetch"):
        mesh = _rank_mesh()
        if mesh is not None:
            return _rank_fetch(mesh, plane, idx.to(torch.int64))
        n = plane.shape[0]
        d, n_loc = _require_ring(n)
        il = idx.to(torch.int64)[None].expand(d, *idx.shape)
        return _fetch_blocks(_cut(plane, d), il, n_loc)[0]


# ---------------------------------------------------------------------------
# The ring's collectives on a process group's mesh (the identity elsewhere)
# ---------------------------------------------------------------------------


def ring_allgather(*xs: torch.Tensor) -> Any:
    """Each of ``xs``, this rank's rows [N/D, ...], as the whole [N, ...]
    on every rank: D - 1 hops, all of ``xs`` in each.  Outside a process
    group's ring, ``xs`` as they are.  One tensor in, one out."""
    mesh = _rank_mesh()
    if mesh is None:
        return xs[0] if len(xs) == 1 else xs
    ring_allgather.calls += 1
    with annotate.scope("gossip.allgather"):
        _circulate()
        d, me = mesh.size, mesh.rank
        parts = [[None] * d for _ in xs]
        cur = tuple(xs)
        for h in range(d):
            for p, x in zip(parts, cur):
                p[(me - h) % d] = x
            if h < d - 1:
                cur = _peer(mesh, cur)
        out = tuple(torch.cat(p) for p in parts)
    return out[0] if len(xs) == 1 else out


ring_allgather.calls = 0  # on a process group's ring, ``ring_sum``'s included


def ring_sum(x: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of ``x`` over the ranks (integer or bool
    counts: exact in any order), in ``x``'s dtype; ``x`` outside a
    process group's ring."""
    if _rank_mesh() is None:
        return x
    ring_sum.calls += 1
    every = ring_allgather(x.reshape(1, *x.shape))
    if x.dtype == torch.bool:
        return every.any(dim=0)
    return every.sum(dim=0, dtype=x.dtype)


ring_sum.calls = 0  # on a process group's ring


def ring_fetch_many(
    planes: tuple[torch.Tensor, ...], idx: torch.Tensor, cols: torch.Tensor | None = None
) -> tuple[torch.Tensor, ...]:
    """``plane[idx]`` (or ``plane[idx, cols]``, ``cols`` the shape of
    ``idx``) of each of ``planes``, row-split planes with the same rows,
    on a process group's ring: one circulation carries all of them and
    each rank resolves ``idx`` (global row ids, any shape: aligned to its
    rows or replicated) out of the passing blocks.  Outside it, the plain
    gathers."""
    mesh = _rank_mesh()
    il = idx.to(torch.int64)
    cl = None if cols is None else cols.to(torch.int64)
    if mesh is None:
        return tuple(p[il] if cl is None else p[il, cl] for p in planes)
    with annotate.scope("gossip.ring_fetch"):
        return _rank_fetch_many(mesh, tuple(planes), il, cl)


def ring_take_at(plane: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``plane[rows, cols]`` of a row-split plane on a process group's
    ring (``rows`` global ids, any shape, ``cols`` broadcast to it): the
    plane's blocks circulate and each rank picks its elements out of the
    passing block.  Outside it, the plain gather."""
    mesh = _rank_mesh()
    rows, cols = torch.broadcast_tensors(rows.to(torch.int64), cols.to(torch.int64))
    if mesh is None:
        return plane[rows, cols]
    with annotate.scope("gossip.ring_fetch"):
        return _rank_fetch(mesh, plane, rows, cols)
