"""Delta-from-base SWIM simulation in PyTorch: O(N * C) per tick, no N x N state.

The port of ``ringpop_tpu/models/swim_delta.py``.  The cluster's shared
view is stored once (``base_key: int32[N]``), and each viewer keeps a
bounded table of C slots, sorted by subject and SENTINEL-padded, of the
entries where it disagrees with the base or holds an active
dissemination or suspicion record:

    view(i, j) = d_key[i, c]   if d_subj[i, c] == j for some slot c
               = base_key[j]   otherwise

A 65,536-node cluster at C = 256 is ~167 MB of state, where the dense
layout needs 26 GB.  Names, state layout, PRNG key schedule and every
phase follow the reference, so the two agree exactly, field by field
and tick by tick; the reference module documents the semantics and the
bounded-resource deviations (``wire_cap``, ``claim_grid``, ``capacity``).

Two hand-written CUDA kernels carry the step on the card: the row-wise
searchsorted (``ops/searchsorted.py``, at more than ``_WIDE_QUERY``
queries per row) and the sorted-insert merge of ``_merge_claims``
(``ops/delta_merge.py``).  The reference's ``lax.cond`` branches become
host branches on one ``.item()`` sync per predicate; a skipped branch is
a proven no-op, so both give the same values.

uint32 quantities (the packed ``bp_mask`` words and the rolling
``digest``) are held in int64 with values in ``[0, 2**32)``; every sum
and product is masked back to 32 bits.

Sided mode, the structured-netsplit form (``side is not None``), keeps
one base row per group of viewers: ``base_key`` and the ``bp_*`` planes
are [G, N], ``side[i]`` names viewer i's row, and a cross-side full sync
flips the adopter to ``merge_to[own side, provider side]``, a row whose
base is the lattice merge of both.  ``make_sides`` enters it,
``fold_to_single`` leaves it, and ``rebase`` folds each group into its
own row.

The fault-model arms are ported: link rules, per-node periods and
``phase_mod > 1`` (shared with the dense step), and the in-flight claim
lanes (``pend_*``, ``install_pending``) that carry delayed claims across
ticks.  The carried slot-base planes (``d_bpmask``/``d_bprank``, built
under ``RINGPOP_CARRY_SLOTBASE=1`` as in the reference) and the
truncated profiling steps (``upto`` < 7) are ported too, and so are
the knobs (``swim_sim.SwimKnobs``: the countdown start, the piggyback
factor, a knob ``phase_mod`` and the capacity-padded ``ping_req_size``).
``prov=True`` adds the delivery-evidence bundle of the provenance plane
(``obs.provenance.EVIDENCE_KEYS``) to a full step's metrics.
The maintenance and admin operations
(``rebase``, ``make_sides``, ``fold_to_single``, joins, revives) are
host numpy, as in the reference.
"""

from __future__ import annotations

import math
import os
from typing import Any, NamedTuple

import numpy as np
import torch

from ringpop_tpu_torch import prng, resolve_device
from ringpop_tpu_torch.models.swim_sim import (
    ALIVE,
    FAULTY,
    LEAVE,
    SUSPECT,
    ClusterState,
    NetState,
    SwimParams,
    _adj,
    _apply_mask,
    _check_inc,
    _distinct_ranks,
    _drop_net,
    _gather_rows,
    _message_delay,
    _on_ring,
    _scoped,
    _stagger_send_gate,
    _sweep_divisor,
    _validate_params,
    _wrap_i32,
)
from ringpop_tpu_torch.obs import annotate
from ringpop_tpu_torch.ops import bitpack
from ringpop_tpu_torch.ops.delta_merge import merge_insert
from ringpop_tpu_torch.ops.farmhash import mul32
from ringpop_tpu_torch.ops.searchsorted import row_searchsorted

SENTINEL = (1 << 31) - 1  # empty delta slot (sorts to the end)
_M32 = 0xFFFFFFFF
# Row-wise lookups with more queries per row than this go through the
# row-searchsorted kernel; narrower ones are a fused compare-count (the
# reference's ``compare_all`` below its ``_WIDE_QUERY``).
_WIDE_QUERY = 4


class DeltaParams(NamedTuple):
    """Static configuration: protocol constants + the resource caps."""

    swim: SwimParams = SwimParams()
    wire_cap: int = 16  # max changes per ping/ack (W)
    claim_grid: int = 64  # max distinct inbound claims consumed per tick (K)


class DeltaState(NamedTuple):
    """Shared base view + per-viewer bounded divergence tables (the
    reference's fields and dtypes; uint32 planes held in int64)."""

    base_key: torch.Tensor  # int32[N] | int32[G, N] (sided)
    bp_mask: torch.Tensor  # int64[(G,) ceil(N/32)] packed base-pingable bits (uint32 words)
    bp_rank: torch.Tensor  # int32[(G,) N] exclusive prefix count of bp_mask
    bp_list: torch.Tensor  # int32[(G,) N] base-pingable subjects ascending (n-padded)
    d_subj: torch.Tensor  # int32[N, C]
    d_key: torch.Tensor  # int32[N, C]
    d_pb: torch.Tensor  # int8[N, C]
    d_sl: torch.Tensor  # int8[N, C]
    tick: torch.Tensor  # int32[]
    overflow_drops: torch.Tensor  # int32[] cumulative table-capacity drops
    side: torch.Tensor | None = None  # int32[N] viewer's base row (sided mode)
    merge_to: torch.Tensor | None = None  # int32[G, G] full-sync flip table (sided mode)
    digest: torch.Tensor | None = None  # int64[N] rolling view digest (uint32 values)
    # carried slot-base planes (``refresh_carried``): base pingability
    # (packed bits) and base rank at each slot's subject
    d_bpmask: torch.Tensor | None = None  # int64[N, ceil(C/32)] (uint32 words)
    d_bprank: torch.Tensor | None = None  # int32[N, C]
    # The in-flight claim lanes for per-link delay: a message delayed by d
    # at tick t parks its [W] claim list in slot ``(t + d) % D``, lane
    # ``2 * (d - 1) + kind`` (kind 0: the phase-3 ping payload, 1: the
    # phase-4 ack payload), at its sender's row, with its receiver in
    # ``pend_recv`` (n = none).  Slot ``tick % D`` matures at the start
    # of the tick.  Presence widens the key split to six.
    pend_subj: torch.Tensor | None = None  # int32[D, 2(D-1), N, W]
    pend_key: torch.Tensor | None = None  # int32[D, 2(D-1), N, W]
    pend_recv: torch.Tensor | None = None  # int32[D, 2(D-1), N]

    @property
    def n(self) -> int:
        return self.base_key.shape[-1]

    @property
    def delay_depth(self) -> int:
        return 0 if self.pend_subj is None else self.pend_subj.shape[0]

    @property
    def capacity(self) -> int:
        return self.d_subj.shape[1]

    @property
    def device(self) -> torch.device:
        return self.base_key.device

    @property
    def groups(self) -> int:
        return 1 if self.side is None else self.base_key.shape[0]

    def _row_side(self, q: torch.Tensor) -> torch.Tensor | None:
        """Each viewer's base row, broadcast against ``q`` ([N] or [N, K])."""
        if self.side is None:
            return None
        return self.side if q.dim() == 1 else self.side[:, None]

    def base_at(self, q: torch.Tensor) -> torch.Tensor:
        """Base view of subject ``q`` ([N] or [N, K], row-aligned)."""
        return _at_rows(self.base_key, self._row_side(q), q.clamp(0, self.n - 1))

    def bp_mask_at(self, q: torch.Tensor) -> torch.Tensor:
        return bitpack.bit_gather(self.bp_mask, q.clamp(0, self.n - 1), self._row_side(q))

    def bp_rank_at(self, q: torch.Tensor) -> torch.Tensor:
        return _at_rows(self.bp_rank, self._row_side(q), q.clamp(0, self.n - 1))

    def bp_list_at(self, r: torch.Tensor) -> torch.Tensor:
        """r-th base-pingable subject per viewer row (r [N] or [N, K])."""
        return _at_rows(self.bp_list, self._row_side(r), r)


def _at_rows(plane: torch.Tensor, row: torch.Tensor | None, q: torch.Tensor) -> torch.Tensor:
    """``plane[q]`` of a single [N] plane (``row`` None), or
    ``plane[row, q]`` of a [G, N] plane with ``row`` broadcast against
    the in-range indices ``q``."""
    if row is None:
        return plane[q.long()]
    return torch.take(plane, row.long() * plane.shape[-1] + q.long())


def _ids(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx, axis=1)`` with in-range ``idx``."""
    return torch.gather(x, 1, idx.long())


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the first axis: a plain gather, also under a
    gossip ring, where the reference gathers plainly too (``h_post[t_safe]``
    in phase 4, ``materialize_rows``).  Where the reference calls
    ``_gather_rows``, the port calls ``swim_sim._gather_rows``, which runs
    as ring hops under a ring.  Those sites, port function then
    ``ringpop_tpu/models/swim_delta.py`` lines: the ack replies in
    ``delta_step_impl`` (:1743-1744), ``_ack_full_sync`` (:1821-1822),
    stage 5b ``segs_b`` (:2102-2103), 5c ``segs_c`` (:2145-2146, and the
    witness anti-echo :2153, :2156, :2167), 5d ``segs_d`` (:2212-2213)
    and the ring form of ``_route_claims_multi`` (:1360-1361)."""
    return x.index_select(0, idx.long())


def _i8(v: int, device: torch.device) -> torch.Tensor:
    """An int8 scalar on ``device``, made by a fill (``torch.tensor``
    would copy it from the host and wait for the card)."""
    return torch.full((), v, dtype=torch.int8, device=device)


def _base_rank_structs(
    base_key: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pingability rank structures along the last axis: of a single [N]
    base, or of the [G, N] rows of sided mode."""
    n = base_key.shape[-1]
    status = base_key & 7
    bp_mask = (status == ALIVE) | (status == SUSPECT)
    m32 = bp_mask.to(torch.int32)
    bp_rank = torch.cumsum(m32, dim=-1, dtype=torch.int32) - m32
    ids = _ids(n, base_key.device)
    bp_list = torch.sort(torch.where(bp_mask, ids, n)).values.to(torch.int32)
    return bitpack.pack_bits(bp_mask), bp_rank, bp_list


def init_delta(
    n: int,
    inc: Any = None,
    *,
    capacity: int = 256,
    mode: str = "converged",
    device: torch.device | str | None = None,
) -> DeltaState:
    """Fresh delta state (the dense ``init_state`` twin): ``'converged'``
    (every view equals the all-alive base, tables empty) or ``'self'``
    (base all-nonexistent, each viewer holds its own alive entry)."""
    dev = resolve_device(device)
    if inc is None:
        inc = torch.zeros(n, dtype=torch.int32, device=dev)
    inc = torch.as_tensor(np.asarray(inc) if not torch.is_tensor(inc) else inc, device=dev)
    inc = inc.to(dtype=torch.int32)
    _check_inc(inc)
    alive_key = inc * 8 + ALIVE
    c = capacity
    d_subj = torch.full((n, c), SENTINEL, dtype=torch.int32, device=dev)
    d_key = torch.zeros((n, c), dtype=torch.int32, device=dev)
    if mode == "converged":
        base_key = alive_key
    elif mode == "self":
        base_key = torch.zeros(n, dtype=torch.int32, device=dev)
        d_subj[:, 0] = _ids(n, dev)
        d_key[:, 0] = alive_key
    else:
        raise ValueError(f"unknown init mode: {mode}")
    bp_mask, bp_rank, bp_list = _base_rank_structs(base_key)
    st = DeltaState(
        base_key=base_key,
        bp_mask=bp_mask,
        bp_rank=bp_rank,
        bp_list=bp_list,
        d_subj=d_subj,
        d_key=d_key,
        d_pb=torch.full((n, c), -1, dtype=torch.int8, device=dev),
        d_sl=torch.full((n, c), -1, dtype=torch.int8, device=dev),
        tick=torch.zeros((), dtype=torch.int32, device=dev),
        overflow_drops=torch.zeros((), dtype=torch.int32, device=dev),
    )
    return refresh_carried(st)


def install_pending(state: DeltaState, depth: int, wire_cap: int) -> DeltaState:
    """Install the in-flight claim lanes of ring depth ``depth``
    (``faults.delay_depth``), each ``min(wire_cap, capacity)`` claims
    wide.  It must happen before the first delayed tick: the lanes'
    presence widens the per-tick key split."""
    if depth < 2:
        raise ValueError(f"delay depth must be >= 2 (got {depth})")
    if state.pend_subj is not None:
        if state.pend_subj.shape[0] != depth:
            raise ValueError(
                f"in-flight lanes of depth {state.pend_subj.shape[0]} are "
                f"already installed (wanted {depth})"
            )
        return state
    n, dev = state.n, state.device
    w_eff = min(int(wire_cap), state.capacity)
    lanes = 2 * (depth - 1)
    return state._replace(
        pend_subj=torch.full((depth, lanes, n, w_eff), SENTINEL, dtype=torch.int32, device=dev),
        pend_key=torch.zeros((depth, lanes, n, w_eff), dtype=torch.int32, device=dev),
        pend_recv=torch.full((depth, lanes, n), n, dtype=torch.int32, device=dev),
    )


def _pend_write(
    st: DeltaState,
    kind: int,
    d: torch.Tensor,  # int32[N] per-sender delay (0 = in-tick, not parked)
    dly: torch.Tensor,  # bool[N] the sender's message is delayed
    subj_rows: torch.Tensor,  # int32[N, W] claim subjects (SENTINEL pad)
    key_rows: torch.Tensor,  # int32[N, W]
    valid_rows: torch.Tensor,  # bool[N, W]
    recv: torch.Tensor,  # int32[N] receiver per sender row
) -> DeltaState:
    """Park one phase's delayed claim rows in their (slot, lane, sender)
    cells, in place in the lanes the step owns (``_mature_lanes``
    copied them).  Within one maturity window each writing tick has its
    own d for a slot, so the cells never collide.

    The reference aims the rows that are not delayed at slot D and drops
    them; here every row writes the cell it names (slot D clamped to
    D - 1), and a row that is not delayed writes back the cell's own
    values, read first: the rows name distinct cells (one a sender), so
    nothing else changes."""
    n = st.n
    dd, lanes = st.pend_subj.shape[0], st.pend_subj.shape[1]
    ids = _ids(n, st.device).long()
    slot = torch.where(dly, (st.tick + d) % dd, dd - 1).long()
    lane = torch.clamp(2 * (d - 1) + kind, 0, lanes - 1).long()
    keep = valid_rows & dly[:, None]
    cell = (slot, lane, ids)
    put = dly[:, None]
    st.pend_subj.index_put_(
        cell, torch.where(put, torch.where(keep, subj_rows, SENTINEL), st.pend_subj[cell])
    )
    st.pend_key.index_put_(
        cell, torch.where(put, torch.where(keep, key_rows, 0), st.pend_key[cell])
    )
    recv_v = torch.where(keep.any(dim=1), recv, n)
    st.pend_recv.index_put_(cell, torch.where(dly, recv_v, st.pend_recv[cell]))
    return st


# ---------------------------------------------------------------------------
# lookups (binary search over the sorted tables)
# ---------------------------------------------------------------------------


def _row_searchsorted(a: torch.Tensor, v: torch.Tensor, side: str = "left") -> torch.Tensor:
    """int32[N, K] insertion positions of ``v`` in the sorted rows of
    ``a``: the row-searchsorted kernel past ``_WIDE_QUERY`` queries per
    row, a fused compare-count below."""
    if v.shape[-1] > _WIDE_QUERY:
        return row_searchsorted(a, v, side=side)
    t = a[:, None, :]
    q = v[:, :, None]
    cmp = (t <= q) if side == "right" else (t < q)
    return cmp.sum(dim=-1, dtype=torch.int32)


def _lookup_pos(d_subj: torch.Tensor, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row positions of subjects ``q`` ([N] or [N, K]): (pos clipped
    in range, found mask)."""
    squeeze = q.dim() == 1
    if squeeze:
        q = q[:, None]
    pos = _row_searchsorted(d_subj, q)
    pos_c = pos.clamp(max=d_subj.shape[1] - 1)
    found = _take(d_subj, pos_c) == q
    if squeeze:
        return pos_c[:, 0], found[:, 0]
    return pos_c, found


def view_lookup(state: DeltaState, q: torch.Tensor) -> torch.Tensor:
    """view(i, q[i]) (or view(i, q[i, k])): delta if present else base."""
    pos, found = _lookup_pos(state.d_subj, q)
    dk = _take(state.d_key, pos if q.dim() > 1 else pos[:, None])
    dk = dk if q.dim() > 1 else dk[:, 0]
    return torch.where(found, dk, state.base_at(q))


def _scatter_rows(
    base_rows: torch.Tensor, subj: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """Copy of ``base_rows`` [R, N] with ``values`` written at the live
    slot subjects of each row; empty slots aim at a spare column N that
    is cut off (they repeat it, so the scatter is not unique there)."""
    r, n = base_rows.shape
    live = subj < SENTINEL
    out = torch.empty((r, n + 1), dtype=base_rows.dtype, device=base_rows.device)
    out[:, :n] = base_rows
    cols = torch.where(live, subj, n).long()
    out.scatter_(1, cols, torch.where(live, values, torch.zeros_like(values)))
    return out[:, :n]


def _base_rows(state: DeltaState, idx: torch.Tensor) -> torch.Tensor:
    """[len(idx), N] base rows of the viewers ``idx``: the one base
    broadcast, or each viewer's own row in sided mode."""
    if state.side is None:
        return state.base_key[None, :].expand(idx.shape[0], state.n)
    return state.base_key.index_select(0, _rows(state.side, idx).long())


def densify(state: DeltaState) -> ClusterState:
    """The equivalent dense ``ClusterState`` (tests; O(N^2) memory)."""
    n = state.n
    dev = state.device
    vk = _scatter_rows(_base_rows(state, _ids(n, dev)), state.d_subj, state.d_key)
    neg = torch.full((n, n), -1, dtype=torch.int8, device=dev)
    pb = _scatter_rows(neg, state.d_subj, state.d_pb)
    sl = _scatter_rows(neg, state.d_subj, state.d_sl)
    return ClusterState(view_key=vk, pb=pb, suspect_left=sl, tick=state.tick)


# audit: allow=RPL001 a dense state converted on the host, once
def sparsify(dense: ClusterState, base_key: Any, capacity: int) -> DeltaState:
    """Delta representation of a dense state against ``base_key``
    (tests; host-side).  Raises if any row diverges beyond capacity."""
    dev = dense.view_key.device
    vk = dense.view_key.cpu().numpy()
    pb = dense.pb.cpu().numpy()
    sl = dense.suspect_left.cpu().numpy()
    base = np.asarray(base_key.cpu() if torch.is_tensor(base_key) else base_key)
    n = vk.shape[0]
    need = (vk != base[None, :]) | (pb >= 0) | (sl >= 0)
    counts = need.sum(axis=1)
    if counts.max(initial=0) > capacity:
        raise ValueError(f"divergence {counts.max()} exceeds capacity {capacity}")
    d_subj = np.full((n, capacity), SENTINEL, dtype=np.int32)
    d_key = np.zeros((n, capacity), dtype=np.int32)
    d_pb = np.full((n, capacity), -1, dtype=np.int8)
    d_sl = np.full((n, capacity), -1, dtype=np.int8)
    for i in range(n):
        js = np.nonzero(need[i])[0]
        d_subj[i, : len(js)] = js
        d_key[i, : len(js)] = vk[i, js]
        d_pb[i, : len(js)] = pb[i, js]
        d_sl[i, : len(js)] = sl[i, js]
    base_t = torch.as_tensor(base.astype(np.int32), device=dev)
    bp_mask, bp_rank, bp_list = _base_rank_structs(base_t)
    st = DeltaState(
        base_key=base_t,
        bp_mask=bp_mask,
        bp_rank=bp_rank,
        bp_list=bp_list,
        d_subj=torch.as_tensor(d_subj, device=dev),
        d_key=torch.as_tensor(d_key, device=dev),
        d_pb=torch.as_tensor(d_pb, device=dev),
        d_sl=torch.as_tensor(d_sl, device=dev),
        tick=dense.tick,
        overflow_drops=torch.zeros((), dtype=torch.int32, device=dev),
    )
    return refresh_carried(st)


# ---------------------------------------------------------------------------
# phase 0: per-viewer stats from base aggregates + delta corrections
# ---------------------------------------------------------------------------


def _hash1(key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-entry term of the commutative view digest (int64 holding
    uint32), bit for bit the dense ``_view_hash`` term."""
    k = key.to(torch.int64) & _M32
    h = mul32(k, 0x85EBCA6B) ^ (k >> 7)
    h = mul32(h ^ (h >> 13), 0xC2B2AE35)
    h = h ^ (h >> 16)
    salt = mul32(idx.to(torch.int64) & _M32, 0x27D4EB2F)
    return torch.where(key > 0, h ^ salt, 0)


def _hash_delta_sum(
    mask: torch.Tensor, new_key: torch.Tensor, old_key: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Per-row uint32 sum of ``_hash1(new) - _hash1(old)`` where ``mask``
    (the rolling digest's increments; wraps mod 2**32)."""
    d = (_hash1(new_key, idx) - _hash1(old_key, idx)) & _M32
    return torch.where(mask, d, 0).sum(dim=-1) & _M32


class _Stats(NamedTuple):
    live: torch.Tensor  # bool[N, C] slot occupied
    ping_now: torch.Tensor  # bool[N, C] slot subject pingable in viewer's view
    ping_base: torch.Tensor  # bool[N, C] slot subject pingable in the base
    ping_count: torch.Tensor  # int32[N] pingable members per viewer
    server_count: torch.Tensor  # int32[N] alive|suspect members (incl. self)
    digest: torch.Tensor  # int64[N] (uint32) dense _view_hash of the view
    own_key: torch.Tensor  # int32[N] view(i, i)


def compute_digest(state: DeltaState) -> torch.Tensor:
    """int64[N] (uint32 values) view digest from scratch: the base hash
    total (per base row in sided mode) corrected by the delta slots."""
    n = state.n
    ids = _ids(n, state.device)
    live = state.d_subj < SENTINEL
    subj_safe = torch.where(live, state.d_subj, 0)
    h_base_total = _hash1(state.base_key, ids).sum(dim=-1) & _M32
    if state.side is not None:
        h_base_total = h_base_total[state.side.long()]
    h_corr = _hash_delta_sum(live, state.d_key, state.base_at(subj_safe), subj_safe)
    return (h_base_total + h_corr) & _M32


def compute_slot_base(state: DeltaState) -> tuple[torch.Tensor, torch.Tensor]:
    """(bool[N, C], int32[N, C]): base pingability and base rank at each
    slot's subject, from scratch (empty slots hold (False, 0)); what the
    carried ``d_bpmask``/``d_bprank`` planes hold."""
    live = state.d_subj < SENTINEL
    subj_safe = torch.where(live, state.d_subj, 0)
    return (
        state.bp_mask_at(subj_safe) & live,
        torch.where(live, state.bp_rank_at(subj_safe), 0),
    )


def refresh_carried(state: DeltaState, digest: bool = True) -> DeltaState:
    """Recompute every carried derivative from scratch: the one call that
    makes a hand-mutated or rebuilt state step-ready.  The rolling digest
    is always carried (``digest=False`` keeps the state's own, as a
    checkpoint load that finds it does).  The slot-base planes
    (``d_bpmask``/``d_bprank``, the base gathers of phases 0-1 kept per
    slot) are carried where the state already carries them, or, for a
    state built while ``RINGPOP_CARRY_SLOTBASE=1`` (the reference's
    switch, read here at build time only, with its meaning), from now
    on; otherwise they are dropped."""
    if digest:
        state = state._replace(digest=compute_digest(state))
    if os.environ.get("RINGPOP_CARRY_SLOTBASE", "0") == "1" or state.d_bpmask is not None:
        return _with_slot_base(state)
    return state._replace(d_bpmask=None, d_bprank=None)


def _with_slot_base(state: DeltaState) -> DeltaState:
    bpm, bpr = compute_slot_base(state)
    return state._replace(d_bpmask=bitpack.pack_bits(bpm), d_bprank=bpr)


@_scoped("delta.refresh")
def _refresh_in_step(state: DeltaState) -> DeltaState:
    """Wholesale recompute inside the step (the full-sync path): the
    digest, and the slot-base planes where the state carries them."""
    state = state._replace(digest=compute_digest(state))
    return _with_slot_base(state) if state.d_bpmask is not None else state


def _check_carry(state: DeltaState) -> None:
    if (state.d_bpmask is None) != (state.d_bprank is None):
        raise ValueError(
            "DeltaState.d_bpmask/d_bprank must be carried together "
            "(refresh_carried populates or clears both)"
        )


def _phase0_stats(state: DeltaState) -> _Stats:
    n = state.n
    ids = _ids(n, state.device)
    live = state.d_subj < SENTINEL
    subj_safe = torch.where(live, state.d_subj, 0)
    d_status = state.d_key & 7
    ping_now = live & ((d_status == ALIVE) | (d_status == SUSPECT))
    if state.d_bpmask is not None:
        ping_base = bitpack.unpack_bits(state.d_bpmask, state.capacity)
    else:
        ping_base = live & state.bp_mask_at(subj_safe)
    # the base total, per base row in sided mode ([G] totals gathered by
    # each viewer's side)
    if state.side is None:
        p_total = bitpack.popcount_bits(state.bp_mask)
    else:
        p_total = bitpack.popcount_bits(state.bp_mask, dim=1)[state.side.long()]
    corr = (ping_now.to(torch.int32) - ping_base.to(torch.int32)).sum(dim=1, dtype=torch.int32)
    own_pos, own_found = _lookup_pos(state.d_subj, ids)
    own_key = torch.where(
        own_found, _take(state.d_key, own_pos[:, None])[:, 0], state.base_at(ids)
    )
    own_status = own_key & 7
    self_pingable = (own_status == ALIVE) | (own_status == SUSPECT)
    server_count = p_total + corr
    ping_count = server_count - self_pingable.to(torch.int32)
    digest = state.digest if state.digest is not None else compute_digest(state)
    return _Stats(live, ping_now, ping_base, ping_count, server_count, digest, own_key)


def _max_piggyback_1d(server_count: torch.Tensor, factor: int) -> torch.Tensor:
    """``factor * ceil(log10(count + 1))`` per node, clamped to 126."""
    x = server_count + 1
    digits = torch.zeros_like(x)
    p = 1
    for _ in range(10):
        digits = digits + (x > p).to(x.dtype)
        p *= 10
    return torch.clamp(factor * digits, max=126)


# ---------------------------------------------------------------------------
# phase 1: probe/witness selection by rank (binary search, no cumsum)
# ---------------------------------------------------------------------------


def _compact_true(mask: torch.Tensor, width: int) -> torch.Tensor:
    """Column indices of the first ``width`` True per row, SENTINEL-padded,
    order preserved (one row sort)."""
    n, c = mask.shape
    cols = torch.arange(c, dtype=torch.int32, device=mask.device).expand(n, c)
    return torch.sort(torch.where(mask, cols, SENTINEL), dim=1).values[:, :width]


def _row_searchsorted_right(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return _row_searchsorted(a, v, side="right")


def _windowed_changes(
    state: DeltaState, within: torch.Tensor, w: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(subject, key) lists of each row's windowed changes, [N, W]; a
    tick with no windowed change anywhere skips the row sort."""
    n = within.shape[0]
    w = min(w, within.shape[1])
    dev = within.device
    # audit: allow=RPL001 the reference's lax.cond predicate: the branch is skipped when empty
    if bool(within.any()):
        cols = _compact_true(within, w)
        safe = cols.clamp(max=state.capacity - 1)
        subj = torch.where(cols < SENTINEL, _take(state.d_subj, safe), SENTINEL)
        return subj, _take(state.d_key, safe)
    return (
        torch.full((n, w), SENTINEL, dtype=torch.int32, device=dev),
        torch.zeros((n, w), dtype=torch.int32, device=dev),
    )


class _Select(NamedTuple):
    gossiping: torch.Tensor  # bool[N]
    sends: torch.Tensor  # bool[N]
    t_safe: torch.Tensor  # int32[N]
    wit: torch.Tensor  # int32[N, k]
    wit_valid: torch.Tensor  # bool[N, k]


@_scoped("delta.select")
def _selection(
    state: DeltaState, stats: _Stats, net: NetState, k_sel: torch.Tensor, params: DeltaParams,
    knobs: Any = None,
) -> _Select:
    """Probe target + witnesses, RNG-identical to the dense phase 1: the
    rank -> subject map is evaluated at the per-row sorted correction
    list against the base-pingable list (see the reference)."""
    sw = params.swim
    n = state.n
    dev = state.device
    ids = _ids(n, dev)
    k = sw.ping_req_size
    per = torch.clamp(net.period, min=1) if net.period is not None else None

    own_status = stats.own_key & 7
    gossiping = net.up & net.responsive & ((own_status == ALIVE) | (own_status == SUSPECT))

    live, ping_now, ping_base = stats.live, stats.ping_now, stats.ping_base
    is_self = state.d_subj == ids[:, None]
    added = ping_now & ~ping_base & ~is_self
    removed = (ping_base & ~ping_now & ~is_self) | (is_self & live & ping_base)
    d_slot = added.to(torch.int32) - removed.to(torch.int32)
    self_in_delta = (is_self & live).any(dim=1)
    self_extra = state.bp_mask_at(ids) & ~self_in_delta

    corr_live = d_slot != 0
    cpd = torch.cumsum(d_slot, dim=1, dtype=torch.int32)  # inclusive prefix
    if state.d_bprank is not None:
        slot_rank = state.d_bprank
    else:
        slot_rank = state.bp_rank_at(torch.where(live, state.d_subj, 0))
    F = torch.where(corr_live, slot_rank + (cpd - d_slot), 1 << 30)
    cc = F.shape[1]
    F = torch.flip(torch.cummin(torch.flip(F, [1]), dim=1).values, [1])  # suffix-min

    ranks, valid = _distinct_ranks(stats.ping_count, k + 1, k_sel)
    hi = torch.clamp(stats.ping_count - 1, min=0)[:, None]
    r_clip = torch.minimum(torch.clamp(ranks, min=0), hi)

    own_pos, _ = _lookup_pos(state.d_subj, ids)
    corr_below_self = torch.where(
        own_pos > 0, _take(cpd, torch.clamp(own_pos - 1, min=0)[:, None])[:, 0], 0
    )
    corr_below_self = torch.where(state.d_subj[:, -1] < ids, cpd[:, -1], corr_below_self)
    g_self = state.bp_rank_at(ids) + corr_below_self
    r_eff = r_clip + (self_extra[:, None] & (r_clip >= g_self[:, None])).to(torch.int32)

    kstar = _row_searchsorted_right(F, r_eff) - 1
    ks_safe = torch.clamp(kstar, 0, cc - 1)
    in_corr = kstar >= 0
    F_at = _take(F, ks_safe)
    d_at = _take(d_slot, ks_safe)
    su_at = _take(state.d_subj, ks_safe)
    cpd_at = torch.where(in_corr, _take(cpd, ks_safe), 0)
    added_answer = in_corr & (d_at == 1) & (F_at == r_eff)
    rprime = torch.clamp(r_eff - cpd_at, 0, n - 1)
    picks = torch.where(added_answer, su_at, state.bp_list_at(rprime))  # [N, k+1]

    target = torch.where(valid[:, 0], picks[:, 0], -1)
    has_target = valid[:, 0]
    wit = picks[:, 1:]
    wit_valid = valid[:, 1:]
    phase_mod = sw.phase_mod if knobs is None else knobs.phase_mod
    if knobs is not None:
        # capacity-padded effective k (the dense selection's mask)
        wit_valid = wit_valid & (torch.arange(k, device=dev)[None, :] < knobs.ping_req_size)

    if sw.probe == "sweep":
        mult = 0x9E37
        while math.gcd(mult, n) != 1:
            mult += 1
        # int32 arithmetic as in the reference: ids * mult wraps, then a
        # floored modulo
        start = _wrap_i32(ids.to(torch.int64) * mult) % n
        # with staggered periods the sweep advances once per period
        div = _sweep_divisor(phase_mod, per)
        tick = state.tick.to(torch.int64)
        swept = ((start + (tick if div is None else tick // div)) % n).to(torch.int32)
        sst = view_lookup(state, swept) & 7
        ok = ((sst == ALIVE) | (sst == SUSPECT)) & (swept != ids)
        target = torch.where(ok, swept, target)
        has_target = has_target | ok
        wit_valid = wit_valid & (wit != target[:, None])
    elif sw.probe != "uniform":
        raise ValueError(f"unknown probe policy: {sw.probe!r}")

    sends = _stagger_send_gate(gossiping & has_target, state.tick, n, phase_mod, per)
    t_safe = torch.where(sends, target, 0)
    return _Select(gossiping, sends, t_safe, wit, wit_valid)


# ---------------------------------------------------------------------------
# claim merge: matched updates elementwise, insertions by sorted merge
# ---------------------------------------------------------------------------


class _MergeOut(NamedTuple):
    state: DeltaState
    applied_points: torch.Tensor  # int32[] lattice applications (incl. refutations)
    refuted: torch.Tensor  # bool[N]
    dropped: torch.Tensor  # int32[] claims lost to table capacity


@_scoped("delta.merge_claims")
def _merge_claims(
    state: DeltaState,
    c_subj: torch.Tensor,  # int32[N, K] subject per claim, ascending, SENTINEL pad
    c_key: torch.Tensor,  # int32[N, K] claim lattice keys (deduped per subject)
    valid: torch.Tensor,  # bool[N, K]
    sl_start: int,
) -> _MergeOut:
    """Apply per-row claim lists (the sparse ``_merge_incoming``): matched
    subjects update in place, a suspect/faulty rumor about the receiver
    is refuted at ``max(incs) + 1``, and claims about subjects without a
    slot are inserted through the merge-insert kernel (dropped past the
    row's free slots, counted in ``overflow_drops``)."""
    n, cap = state.n, state.capacity
    dev = state.device
    kk = c_subj.shape[1]
    ids = _ids(n, dev)

    is_self = valid & (c_subj == ids[:, None])
    c_status = c_key & 7
    rumor = is_self & ((c_status == SUSPECT) | (c_status == FAULTY))
    refuted = rumor.any(dim=1)
    rumor_inc = torch.where(rumor, c_key >> 3, -1).amax(dim=1)

    # current belief at each claimed subject
    subj_q = torch.where(valid, c_subj, 0)
    pos, found = _lookup_pos(state.d_subj, subj_q)
    found = found & valid
    cur = torch.where(found, _take(state.d_key, pos), state.base_at(subj_q))
    applies = valid & ~is_self & _apply_mask(cur, c_key)

    # matched updates: invert (claim -> slot) into (slot -> claim)
    slots_live = state.d_subj < SENTINEL
    s_pos = _row_searchsorted(c_subj, torch.where(slots_live, state.d_subj, SENTINEL))
    s_pos_c = s_pos.clamp(max=kk - 1)
    s_hit = slots_live & (_take(c_subj, s_pos_c) == state.d_subj)
    s_applies = s_hit & _take(applies, s_pos_c)
    s_new_key = _take(c_key, s_pos_c)

    d_key = torch.where(s_applies, s_new_key, state.d_key)
    d_pb = torch.where(s_applies, _i8(0, dev), state.d_pb)
    new_status = d_key & 7
    d_sl = torch.where(s_applies & (new_status == SUSPECT), _i8(sl_start, dev), state.d_sl)
    d_sl = torch.where(s_applies & (new_status != SUSPECT), _i8(-1, dev), d_sl)

    # refutation at an existing self slot
    self_slot = (state.d_subj == ids[:, None]) & slots_live
    has_self_slot = self_slot.any(dim=1)
    old_self_key = torch.where(self_slot, state.d_key, 0).amax(dim=1)
    self_cur_inc = torch.where(has_self_slot, old_self_key, state.base_at(ids)) >> 3
    new_self_key = (torch.maximum(self_cur_inc, rumor_inc) + 1) * 8 + ALIVE
    upd_self = self_slot & refuted[:, None]
    d_key = torch.where(upd_self, new_self_key[:, None], d_key)
    d_pb = torch.where(upd_self, _i8(0, dev), d_pb)
    d_sl = torch.where(upd_self, _i8(-1, dev), d_sl)

    # rolling digest: matched updates and the in-place refutation
    d_matched = _hash_delta_sum(applies & found, c_key, cur, subj_q)
    d_self = torch.where(
        refuted & has_self_slot,
        (_hash1(new_self_key, ids) - _hash1(old_self_key, ids)) & _M32,
        0,
    )
    digest = (state.digest + d_matched + d_self) & _M32
    state = state._replace(d_key=d_key, d_pb=d_pb, d_sl=d_sl, digest=digest)

    # insertions: applying claims whose subject has no slot, and a
    # refutation needing a fresh self slot
    ins = applies & ~found
    self_ins = refuted & ~has_self_slot
    applied_points = applies.sum(dtype=torch.int32) + refuted.sum(dtype=torch.int32)
    free = cap - slots_live.sum(dim=1, dtype=torch.int32)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)

    # audit: allow=RPL001 the reference's lax.cond predicate: the branch is skipped when empty
    if bool((ins.any(dim=1) | self_ins).any()):
        # drop insertions beyond each row's free slots: self first, then
        # subject order
        ins_i = ins.to(torch.int32)
        order_rank = torch.cumsum(ins_i, dim=1, dtype=torch.int32) - ins_i
        order_rank = order_rank + self_ins.to(torch.int32)[:, None]
        keep = ins & (order_rank < free[:, None])
        keep_self = self_ins & (free > 0)
        dropped = (ins & ~keep).sum(dtype=torch.int32) + (self_ins & ~keep_self).sum(
            dtype=torch.int32
        )
        ins_subj = torch.cat(
            [torch.where(keep, c_subj, SENTINEL), torch.where(keep_self, ids, SENTINEL)[:, None]],
            dim=1,
        )
        ins_key = torch.cat(
            [torch.where(keep, c_key, 0), torch.where(keep_self, new_self_key, 0)[:, None]],
            dim=1,
        )
        s_ins_subj, order = torch.sort(ins_subj, dim=1, stable=True)
        s_ins_key = torch.gather(ins_key, 1, order)
        m_subj, m_key, m_pb, m_sl = merge_insert(
            state.d_subj, state.d_key, state.d_pb, state.d_sl, s_ins_subj, s_ins_key,
            sl_start=int(sl_start), suspect=SUSPECT,
        )
        planes = {}
        if state.d_bpmask is not None:
            planes = _merged_slot_base(state, s_ins_subj, m_subj)
        # kept insertions only; the old view at a not-found subject is its
        # base, which is ``cur`` there
        d_ins = _hash_delta_sum(keep, c_key, cur, subj_q) + torch.where(
            keep_self,
            (_hash1(new_self_key, ids) - _hash1(state.base_at(ids), ids)) & _M32,
            0,
        )
        state = state._replace(
            d_subj=m_subj, d_key=m_key, d_pb=m_pb, d_sl=m_sl,
            digest=(state.digest + d_ins) & _M32, **planes,
        )
    return _MergeOut(
        state._replace(overflow_drops=state.overflow_drops + dropped),
        applied_points,
        refuted,
        dropped,
    )


def _merged_slot_base(
    state: DeltaState, s_ins_subj: torch.Tensor, m_subj: torch.Tensor
) -> dict[str, torch.Tensor]:
    """The carried slot-base planes of a merged table: recomputed at the
    inserted subjects (the base is the same for the whole step) and
    gathered for the rest through the merge's inversion, the
    reference's sorted route: insert k lands at its existing-slot rank
    plus k, and output slot j takes the existing slot ``j - (inserts
    before j)`` when it is not an insert."""
    n, cap = state.n, state.capacity
    ki = s_ins_subj.shape[1]
    dev = state.device
    pos_ins = _row_searchsorted(state.d_subj, s_ins_subj) + torch.arange(
        ki, dtype=torch.int32, device=dev
    )
    out_j = torch.arange(cap, dtype=torch.int32, device=dev).expand(n, cap).contiguous()
    e = _row_searchsorted(pos_ins, out_j)  # inserts before slot j
    e_c = torch.clamp(e, max=ki - 1)
    is_ins = _take(pos_ins, e_c) == out_j
    x = torch.clamp(out_j - e, max=cap - 1)  # the existing slot feeding j
    ins_at_j = is_ins & (m_subj < SENTINEL)
    subj_safe = torch.where(ins_at_j, m_subj, 0)
    m_bpm = torch.where(
        is_ins,
        ins_at_j & state.bp_mask_at(subj_safe),
        _take(bitpack.unpack_bits(state.d_bpmask, cap), x),
    )
    m_bpr = torch.where(
        is_ins, torch.where(ins_at_j, state.bp_rank_at(subj_safe), 0), _take(state.d_bprank, x)
    )
    return {"d_bpmask": bitpack.pack_bits(m_bpm), "d_bprank": m_bpr}


# ---------------------------------------------------------------------------
# claim routing: sender lists -> per-receiver grids (sort + searchsorted)
# ---------------------------------------------------------------------------


def _run_bounds(sorted_vals: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(starts, ends) of the value runs 0..n-1 in a sorted int array."""
    bounds = torch.searchsorted(
        sorted_vals, torch.arange(n + 1, dtype=sorted_vals.dtype, device=sorted_vals.device)
    )
    return bounds[:-1], bounds[1:]


def _sort_claim_rows(
    subj: torch.Tensor, key: torch.Tensor, valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort claim rows by subject and dedup at the key max, repacked so
    the live claims lead each row.  The (subject asc, key desc) sort runs
    on one int64 key: subject in the high word, ``2**31 - key`` (keys are
    non-negative) in the low word."""
    subj = torch.where(valid, subj, SENTINEL)
    key = torch.where(valid, key, 0)
    comb = (subj.to(torch.int64) << 32) | ((1 << 31) - key.to(torch.int64))
    comb = torch.sort(comb, dim=1).values
    subj = (comb >> 32).to(torch.int32)
    key = ((1 << 31) - (comb & _M32)).to(torch.int32)
    prev = torch.cat([torch.full_like(subj[:, :1], -1), subj[:, :-1]], dim=1)
    valid = (prev != subj) & (subj < SENTINEL)
    subj = torch.where(valid, subj, SENTINEL)
    key = torch.where(valid, key, 0)
    subj, order = torch.sort(subj, dim=1, stable=True)
    key = torch.gather(key, 1, order)
    return subj, key, subj < SENTINEL


@_scoped("delta.route_claims")
def _route_claims(
    n: int,
    send_subj: torch.Tensor,
    send_key: torch.Tensor,
    send_valid: torch.Tensor,
    recv_of_sender: torch.Tensor,
    grid: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route sender claim lists into an [N, grid] per-receiver grid
    (subjects ascending, deduped at the key max): (subj, key, valid,
    dropped)."""
    return _route_claims_multi(n, [(send_subj, send_key, send_valid, recv_of_sender)], grid)


def _route_claims_multi(
    n: int,
    segments: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]],
    grid: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_route_claims`` over several [N, W] sender segments in one pass.
    Routing is by rows: a receiver consumes at most
    ``R = 2 * ceil(grid / W)`` sender rows, then at most ``grid`` claims
    of their merge; the rest drop as late packets (``dropped``)."""
    w = segments[0][0].shape[1]
    if any(s[0].shape[1] != w for s in segments):
        raise ValueError(
            "_route_claims_multi segments must share one claim width; got "
            f"{[s[0].shape[1] for s in segments]}"
        )
    dev = segments[0][0].device
    nrows = n * len(segments)
    row_recv = torch.cat([torch.where(v.any(dim=1), r, n) for _, _, v, r in segments])
    rows_subj = torch.cat([torch.where(v, s, SENTINEL) for s, _, v, _ in segments])
    rows_key = torch.cat([torch.where(v, k, 0) for _, k, v, _ in segments])
    rows_nvalid = (rows_subj < SENTINEL).sum(dim=1, dtype=torch.int32)

    order = torch.argsort(row_recv, stable=True)
    starts, ends = _run_bounds(row_recv[order], n)
    counts = ends - starts  # sending rows per receiver
    r = min(2 * -(-grid // w), nrows)
    ar = torch.arange(r, dtype=torch.int64, device=dev)
    idx = torch.clamp(starts[:, None] + ar[None, :], max=nrows - 1)
    row_ok = ar[None, :] < counts[:, None]
    src = torch.where(row_ok, order[idx], 0)
    if _on_ring():
        # the ring form: each segment's [N, W] payload block circulates
        # the ring on its own and a receiver keeps the <= R rows addressed
        # to it; the row-id arithmetic above stays replicated
        seg_i = torch.div(src, n, rounding_mode="floor")
        snd = src - seg_i * n  # [N, R] sender row within its segment
        g_subj = torch.full((n, r, w), SENTINEL, dtype=torch.int32, device=dev)
        g_key = torch.zeros((n, r, w), dtype=torch.int32, device=dev)
        for s_i, (subj, key, valid, _) in enumerate(segments):
            pick = row_ok & (seg_i == s_i)
            snd_s = torch.where(pick, snd, 0)
            f_subj = _gather_rows(torch.where(valid, subj, SENTINEL), snd_s)
            f_key = _gather_rows(torch.where(valid, key, 0), snd_s)
            g_subj = torch.where(pick[:, :, None], f_subj, g_subj)
            g_key = torch.where(pick[:, :, None], f_key, g_key)
        g_subj = g_subj.reshape(n, r * w)
        g_key = g_key.reshape(n, r * w)
    else:
        g_subj = torch.where(row_ok[:, :, None], rows_subj[src], SENTINEL).reshape(n, r * w)
        g_key = torch.where(row_ok[:, :, None], rows_key[src], 0).reshape(n, r * w)
    kept = torch.where(row_ok, rows_nvalid[src], 0).sum(dtype=torch.int32)
    dropped = rows_nvalid.sum(dtype=torch.int32) - kept

    g_subj, g_key, g_valid = _sort_claim_rows(g_subj, g_key, g_subj < SENTINEL)
    if r * w > grid:
        dropped = dropped + g_valid[:, grid:].sum(dtype=torch.int32)
        g_subj, g_key, g_valid = g_subj[:, :grid], g_key[:, :grid], g_valid[:, :grid]
    return g_subj, g_key, g_valid, dropped


# ---------------------------------------------------------------------------
# the protocol period
# ---------------------------------------------------------------------------


def _rotating_window(issuable: torch.Tensor, w: int, tick: torch.Tensor) -> torch.Tensor:
    """The wire window: ``w`` of a row's issuable entries, starting
    ``tick * w`` (uint32 arithmetic) positions into the row's backlog."""
    rank = torch.cumsum(issuable.to(torch.int32), dim=1, dtype=torch.int32)
    total = torch.clamp(rank[:, -1:], min=1)
    start = ((((tick.to(torch.int64) & _M32) * w) & _M32) % total).to(torch.int32)
    return issuable & (((rank - 1 - start) % total) < w)


def _stage_issue_delta(
    st: DeltaState, nserve: torch.Tensor, maxpb: torch.Tensor, w: int
) -> tuple[DeltaState, torch.Tensor]:
    """One phase-5 exchange stage's issue bookkeeping (int8 throughout):
    (state, within bool[N, C])."""
    has = st.d_pb >= 0
    ns8 = torch.clamp(nserve, max=127).to(torch.int8)[:, None]
    issuable = has & (ns8 > 0) & (st.d_pb + 1 <= maxpb[:, None])
    within = _rotating_window(issuable, w, st.tick)
    served = has & (ns8 > 0) & ~(issuable & ~within)
    evict = served & (st.d_pb > maxpb[:, None] - ns8)
    d_pb = torch.where(evict, _i8(-1, st.device), torch.where(served, st.d_pb + ns8, st.d_pb))
    return st._replace(d_pb=d_pb), within


def _check_supported(
    state: DeltaState, net: NetState, params: DeltaParams, upto: int, knobs: Any, prov: bool
) -> None:
    """The reference step's own refusals."""
    sw = params.swim
    if prov and upto != 7:
        raise ValueError(
            "provenance evidence spans every phase; prov requires the "
            "full step (upto=7)"
        )
    if net.adj is not None and net.adj.dim() != 1:
        raise NotImplementedError(
            "delta backend partitions take the int32[N] group-id form of "
            "NetState.adj; dense bool[N, N] masks need the dense backend"
        )
    if state.digest is None:
        raise ValueError(
            "delta_step requires the rolling digest (DeltaState.digest); "
            "init_delta/sparsify populate it -- for a hand-built state use "
            "swim_delta.refresh_carried(state)"
        )
    _check_carry(state)
    if sw.sparse_cap:
        raise ValueError("sparse_cap is a dense-backend knob; use wire_cap here")
    if sw.relay_full_sync:
        raise ValueError(
            "relay_full_sync is the dense-step fidelity experiment; the delta "
            "relay carries changes only"
        )
    if net.link_d is not None and state.pend_subj is None:
        raise ValueError(
            "per-link delay needs the in-flight claim lanes "
            "(DeltaState.pend_*): install them from tick 0 via "
            "SimCluster.enable_delay / swim_delta.install_pending"
        )
    if net.period is not None and sw.phase_mod != 1:
        raise ValueError(
            "per-node periods (NetState.period) do not compose with the "
            "static phase_mod stagger: a row of P subsumes phase_mod=P"
        )


def _cut(state: DeltaState, t: torch.Tensor) -> tuple[DeltaState, dict[str, torch.Tensor]]:
    """A truncated step's result: the state, ``pings_sent`` 0 and ``_t``
    (int32, wrapping as the reference's int32 sums do)."""
    return state, {
        "pings_sent": torch.zeros((), dtype=torch.int32, device=state.device),
        "_t": _wrap_i32(t.to(torch.int64)).to(torch.int32),
    }


def delta_step_impl(
    state: DeltaState,
    net: NetState,
    key: torch.Tensor,
    params: DeltaParams,
    upto: int = 7,
    knobs: Any = None,
    prov: bool = False,
) -> tuple[DeltaState, dict[str, torch.Tensor]]:
    """One synchronized protocol period over the delta representation,
    the dense ``swim_step_impl`` phase for phase: 0-1 stats and
    selection, 2 sender issue, 3 ping delivery and claim merge, 4 reply
    (+ full sync) and ack merge, 5 ping-req relay with its four exchange
    stages, then suspect declarations, 6 suspicion expiry.  Returns the
    new state and the reference's metrics as int32[] tensors.

    ``upto`` < 7 truncates the step after that phase, a profiling aid:
    it returns the state there and the reference's partial metrics,
    ``pings_sent`` 0 and ``_t``, an int32 digest of the phase's outputs
    (an [N] vector after phases 0 and 1)."""
    _check_supported(state, net, params, upto, knobs, prov)
    sw = params.swim
    n = state.n
    dev = state.device
    w = params.wire_cap
    ids = _ids(n, dev)
    sl_start = _validate_params(n, sw)
    if knobs is not None:
        # the knob's countdown start; the delta backend has no damping
        # plane and no relay full sync, so those knobs are pinned to
        # their defaults upstream (runner.validate_param_knobs)
        sl_start = int(knobs.suspicion_ticks) + 1
    loss = float(sw.loss)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    has_delay = state.pend_subj is not None
    if has_delay:
        # the lanes' presence (not rule activity) widens the split: two
        # more streams draw the per-message jitter
        k_sel, k_loss1, k_loss2, k_loss3, k_j1, k_j2 = prng.split(key, 6)
    else:
        k_sel, k_loss1, k_loss2, k_loss3 = prng.split(key, 4)

    # -- in-flight claims mature at the start of the tick ---------------------
    mat_applied, mat_late = zero, zero
    if has_delay:
        state, mat_applied, mat_late = _mature_lanes(state, net, params, sl_start)

    # -- phases 0-1 -----------------------------------------------------------
    stats = _phase0_stats(state)
    pb_factor = sw.piggyback_factor if knobs is None else knobs.piggyback_factor
    maxpb = _max_piggyback_1d(stats.server_count, int(pb_factor)).to(torch.int8)
    h_pre = stats.digest
    if upto <= 0:
        return _cut(state, stats.digest + maxpb.to(torch.int64))
    sel = _selection(state, stats, net, k_sel, params, knobs)
    gossiping, sends, t_safe = sel.gossiping, sel.sends, sel.t_safe
    wit, wit_valid = sel.wit, sel.wit_valid
    if upto <= 1:
        return _cut(state, t_safe.to(torch.int64) + wit[:, 0].to(torch.int64) + stats.digest)

    # -- phase 2: sender issues up to W changes -------------------------------
    bump = (state.d_pb >= 0) & sends[:, None]
    # audit: allow=RPL001 the reference's lax.cond predicate: the branch is skipped when empty
    if bool(bump.any()):
        d_pb = state.d_pb
        pb1_ok = bump & (d_pb + 1 <= maxpb[:, None])
        within = _rotating_window(pb1_ok, w, state.tick)
        bump_eff = bump & ~(pb1_ok & ~within)  # past-window entries keep budget
        pb_next = torch.where(bump_eff, d_pb + 1, d_pb)
        pb_next = torch.where(bump_eff & (pb_next > maxpb[:, None]), _i8(-1, dev), pb_next)
        state = state._replace(d_pb=pb_next)
    else:
        within = torch.zeros_like(bump)
    send_subj, send_key = _windowed_changes(state, within, w)
    if upto <= 2:
        return _cut(state, sum(x.sum(dtype=torch.int64) for x in (send_key, send_subj, t_safe, wit)))

    # -- phase 3: delivery + receiver merge -----------------------------------
    resp = net.up & net.responsive
    fwd_ok = (
        sends
        & _adj(net, ids, t_safe)
        & ~_drop_net(k_loss1, (n,), loss, net, ids, t_safe)
        & resp[t_safe.long()]
    )
    # the delivered set (anti-echo reference): a delayed claim counts too
    sent_valid = (send_subj < SENTINEL) & fwd_ok[:, None]
    delayed_claims = zero
    if has_delay:
        # the ping lands in-tick; the claims of a delayed link park in the
        # lanes.  The reference parks under lax.cond(any delayed claim);
        # with none, every row the write touches is either not delayed
        # (written back unchanged) or delayed with no claims, which writes
        # an empty list into a cell that is already empty (it was last
        # written D ticks ago and cleared when it matured), so it runs
        # every tick, without a host sync.
        d3 = _message_delay(net, k_j1, ids, t_safe, (n,))
        dly3 = fwd_ok & (d3 > 0)
        sent_merge = (send_subj < SENTINEL) & (fwd_ok & ~dly3)[:, None]
        delayed_claims = (sent_valid & dly3[:, None]).sum(dtype=torch.int32)
        state = _pend_write(state, 0, d3, dly3, send_subj, send_key, sent_valid, t_safe)
    else:
        sent_merge = sent_valid
    ping_applied, claims_dropped = zero, mat_late
    # audit: allow=RPL001 the reference's lax.cond predicate: the branch is skipped when empty
    if bool(sent_merge.any()):
        g_subj, g_key, g_valid, late = _route_claims(
            n, send_subj, send_key, sent_merge, t_safe, params.claim_grid
        )
        out = _merge_claims(state, g_subj, g_key, g_valid, sl_start)
        state, ping_applied = out.state, out.applied_points
        claims_dropped = late + mat_late
    if upto <= 3:
        return _cut(state, ping_applied)

    # -- phase 4: receiver replies; sender merges the ack ---------------------
    has_change2 = state.d_pb >= 0
    # audit: allow=RPL001 the reference's lax.cond predicate: the branch is skipped when empty
    if bool(has_change2.any() & fwd_ok.any()):
        d_pb = state.d_pb
        tgt_sorted = torch.sort(torch.where(fwd_ok, t_safe, n)).values
        starts, ends = _run_bounds(tgt_sorted, n)
        inbound = (ends - starts).to(torch.int32)
        rep_possible2 = has_change2 & (inbound > 0)[:, None]
        rep_issuable = rep_possible2 & (d_pb + 1 <= maxpb[:, None])
        within_rep = _rotating_window(rep_issuable, w, state.tick)
        inb8 = torch.clamp(inbound, max=127).to(torch.int8)[:, None]
        served = rep_possible2 & ~(rep_issuable & ~within_rep)
        evict = served & (d_pb > maxpb[:, None] - inb8)
        pb_after = torch.where(evict, _i8(-1, dev), torch.where(served, d_pb + inb8, d_pb))
        state = state._replace(d_pb=pb_after)
    else:
        within_rep = torch.zeros_like(has_change2)

    # the rolling digest is the post-merge value
    h_post = state.digest
    rep_subj, rep_key = _windowed_changes(state, within_rep, w)
    ack = fwd_ok & _adj(net, t_safe, ids) & ~_drop_net(k_loss2, (n,), loss, net, t_safe, ids)
    a_subj = _gather_rows(rep_subj, t_safe)  # [N, W]
    a_key = _gather_rows(rep_key, t_safe)
    a_subj_q = torch.where(a_subj < SENTINEL, a_subj, 0)

    # anti-echo: drop reply claims about a subject this sender delivered
    # this tick whose value equals the sender's current belief
    # audit: allow=RPL001 the reference's lax.cond predicate: the branch is skipped when empty
    if bool((a_subj < SENTINEL).any()):
        sent_sorted = torch.where(sent_valid, send_subj, SENTINEL)
        _, sent_hit = _lookup_pos(sent_sorted, a_subj_q)
        echo = sent_hit & (a_key == view_lookup(state, a_subj_q))
    else:
        echo = torch.zeros_like(a_subj, dtype=torch.bool)

    # full sync: nothing issuable for this sender but the digests differ
    a_raw = (a_subj < SENTINEL) & ~echo
    rep_any = a_raw.any(dim=1)
    full_sync = fwd_ok & ~rep_any & (_rows(h_post, t_safe) != h_pre)
    fs_apply = full_sync & ack
    if has_delay:
        # the reply claims ride the receiver->sender link and park at the
        # sender's row; the ack, and a full sync's flip, land in-tick
        d4 = _message_delay(net, k_j2, t_safe, ids, (n,))
        dly4 = ack & (d4 > 0)
        a_valid = a_raw & (ack & ~dly4)[:, None]
        delayed_claims = delayed_claims + (a_raw & dly4[:, None]).sum(dtype=torch.int32)
        state = _pend_write(state, 1, d4, dly4, a_subj, a_key, a_raw, ids)
    else:
        a_valid = a_raw & ack[:, None]
    # audit: allow=RPL001 the reference's lax.cond predicate: the branch is skipped when empty
    any_fs = bool(fs_apply.any())
    ack_applied = zero
    if any_fs:
        state, ack_applied = _ack_full_sync(
            state, a_subj, a_key, a_valid, fs_apply, t_safe, sl_start
        )
    # audit: allow=RPL001 the reference's lax.cond predicate: the branch is skipped when empty
    elif bool(a_valid.any()):
        with annotate.scope("delta.ack_merge"):
            out = _merge_claims(state, *_sort_claim_rows(a_subj, a_key, a_valid), sl_start)
        state, ack_applied = out.state, out.applied_points
    if upto <= 4:
        return _cut(state, ack_applied)

    # -- phase 5: ping-req relay with the piggyback exchange ------------------
    failed = sends & ~ack
    k_a, k_b, k_c, k_d = prng.split(k_loss3, 4)
    kk = sw.ping_req_size
    kshape = (n, kk)
    wit_safe = torch.clamp(wit, 0, n - 1)
    t_col = t_safe[:, None]
    req_del = (
        failed[:, None]
        & wit_valid
        & _adj(net, ids[:, None], wit_safe)
        & ~_drop_net(k_a, kshape, loss, net, ids[:, None], wit_safe)
        & resp[wit_safe.long()]
    )
    ping_del = (
        req_del
        & _adj(net, wit_safe, t_col)
        & ~_drop_net(k_b, kshape, loss, net, wit_safe, t_col)
        & resp[t_safe.long()][:, None]
    )
    ack_del = (
        ping_del
        & _adj(net, t_col, wit_safe)
        & ~_drop_net(k_c, kshape, loss, net, t_col, wit_safe)
    )
    resp_del = (
        req_del
        & _adj(net, wit_safe, ids[:, None])
        & ~_drop_net(k_d, kshape, loss, net, wit_safe, ids[:, None])
    )
    any_success = (ack_del & resp_del).any(dim=1)
    definite_fail = (req_del & ~ack_del & resp_del).any(dim=1)
    declare_suspect = failed & ~any_success & definite_fail

    pingreq_applied = zero
    # audit: allow=RPL001 the reference's lax.cond predicate: the branch is skipped when empty
    if bool(req_del.any() & (state.d_pb >= 0).any()):
        with annotate.scope("delta.exchange"):
            state, pingreq_applied, late = _exchange(
                state, params, maxpb, failed, t_safe, wit_safe, wit_valid,
                req_del, ping_del, ack_del, resp_del, sl_start,
            )
        claims_dropped = claims_dropped + late

    # the declaration sees the post-exchange view
    dec_valid = declare_suspect & (t_safe != ids)
    # audit: allow=RPL001 the reference's lax.cond predicate: the branch is skipped when empty
    if bool(dec_valid.any()):
        cur_t = view_lookup(state, t_safe)
        dec_key = torch.where(cur_t > 0, (cur_t >> 3) * 8 + SUSPECT, 0)
        state = _merge_claims(
            state, t_safe[:, None], dec_key[:, None], dec_valid[:, None], sl_start
        ).state
    if upto <= 5:
        return _cut(state, dec_valid.sum(dtype=torch.int32))

    # -- phase 6: suspicion countdowns fire -> faulty --------------------------
    n_expired = zero
    # audit: allow=RPL001 the reference's lax.cond predicate: the branch is skipped when empty
    if bool((state.d_sl >= 0).any()):
        key0, sl0 = state.d_key, state.d_sl
        sl1 = torch.where(sl0 > 0, sl0 - 1, sl0)
        expired = (
            (sl1 == 0)
            & ((key0 & 7) == SUSPECT)
            & gossiping[:, None]
            & (state.d_subj < SENTINEL)
        )
        d_key = torch.where(expired, (key0 >> 3) * 8 + FAULTY, key0)
        subj_e = torch.where(expired, state.d_subj, 0)
        state = state._replace(
            d_key=d_key,
            d_pb=torch.where(expired, _i8(0, dev), state.d_pb),
            d_sl=torch.where(expired, _i8(-1, dev), sl1),
            digest=(state.digest + _hash_delta_sum(expired, d_key, key0, subj_e)) & _M32,
        )
        n_expired = expired.sum(dtype=torch.int32)
    state = state._replace(tick=state.tick + 1)

    metrics = {
        "pings_sent": sends.sum(dtype=torch.int32),
        "acks": ack.sum(dtype=torch.int32),
        "ping_changes_applied": ping_applied,
        "ack_changes_applied": ack_applied,
        "full_syncs": full_sync.sum(dtype=torch.int32),
        "ping_reqs": failed.sum(dtype=torch.int32),
        "pingreq_changes_applied": pingreq_applied,
        "suspects_declared": declare_suspect.sum(dtype=torch.int32),
        "faulty_declared": n_expired,
        "claims_dropped": claims_dropped,
        "overflow_drops": state.overflow_drops,
        "max_occupancy": (state.d_subj < SENTINEL).sum(dim=1, dtype=torch.int32).max(),
    }
    if has_delay:
        metrics["delayed_claims"] = delayed_claims
        metrics["matured_applied"] = mat_applied
    if prov:
        metrics.update(
            pv_tgt=t_safe,
            pv_send=sends,
            # in-tick payload deliveries only (delayed claims park in the
            # lanes; their arrival has no in-tick edge)
            pv_ping=fwd_ok & ~dly3 if has_delay else fwd_ok,
            # a full sync's flip lands in-tick even over a delayed link,
            # so fs_apply joins the ack edges (the reference's one
            # deviation from the dense bundle)
            pv_ack=(ack & ~dly4) | fs_apply if has_delay else ack,
            pv_wit=wit_safe,
            pv_witv=wit_valid,
            pv_req=req_del,
            pv_rping=ping_del,
            pv_rack=ack_del,
            pv_resp=resp_del,
            # the attempted declarations (the dense bundle has the applied
            # ones); the fold's post-view status gate filters the ones the
            # lattice refused alike on both backends
            pv_decl=dec_valid,
        )
    return state, metrics


@_scoped("delta.mature")
def _mature_lanes(
    state: DeltaState, net: NetState, params: DeltaParams, sl_start: int
) -> tuple[DeltaState, torch.Tensor, torch.Tensor]:
    """Slot ``tick % D`` of the lanes lands: its 2(D - 1) lanes route to
    their receivers together (``_route_claims_multi``) and merge through
    ``_merge_claims``, at up and responsive receivers only; then the slot
    is cleared in a copy of the lanes that this step owns and writes in
    place from here on.  The merge runs under one host sync (the
    reference's ``lax.cond``): routing ten empty lanes at n = 65 536
    costs more than the sync.  Returns (state, applied, late claims)."""
    n = state.n
    zero = torch.zeros((), dtype=torch.int32, device=state.device)
    slot0 = (state.tick % state.pend_subj.shape[0]).long().view(1)
    m_subj = state.pend_subj.index_select(0, slot0)[0]  # [L, N, W]
    applied, late = zero, zero
    # audit: allow=RPL001 the reference's lax.cond predicate: the branch is skipped when empty
    if bool((m_subj < SENTINEL).any()):
        m_key = state.pend_key.index_select(0, slot0)[0]
        m_recv = state.pend_recv.index_select(0, slot0)[0]  # [L, N]
        can_recv = net.up & net.responsive
        segs = []
        for lane in range(m_subj.shape[0]):
            recv_l = m_recv[lane]
            recv_c = torch.clamp(recv_l, 0, n - 1)
            ok = (recv_l < n) & can_recv[recv_c.long()]
            valid = (m_subj[lane] < SENTINEL) & ok[:, None]
            segs.append((m_subj[lane], m_key[lane], valid, recv_c))
        g_subj, g_key, g_valid, late = _route_claims_multi(n, segs, params.claim_grid)
        out = _merge_claims(state, g_subj, g_key, g_valid, sl_start)
        state, applied = out.state, out.applied_points
    pend = [state.pend_subj.clone(), state.pend_key.clone(), state.pend_recv.clone()]
    for plane, empty in zip(pend, (SENTINEL, 0, n)):
        plane.index_fill_(0, slot0, empty)
    return state._replace(pend_subj=pend[0], pend_key=pend[1], pend_recv=pend[2]), applied, late


@_scoped("delta.fs_absorb")
def _ack_full_sync(
    st: DeltaState,
    a_subj: torch.Tensor,
    a_key: torch.Tensor,
    a_valid: torch.Tensor,
    fs_apply: torch.Tensor,
    t_safe: torch.Tensor,
    sl_start: int,
) -> tuple[DeltaState, torch.Tensor]:
    """The ack merge when some full sync fired: the adopter takes the
    provider's ack claims plus its whole delta table (a pre-merge
    snapshot), then the provider's base at the adopter's slots the
    provider does not override; the digest is recomputed wholesale.
    In sided mode a cross-side adopter first flips onto the merge row
    (and absorbs it), and a flip that leaves it suspect or faulty about
    itself is refuted at once."""
    n = st.n
    dev = st.device
    ids = _ids(n, dev)
    # the provider's snapshot (table, and below its side and base) is
    # taken before the flip: a provider that flips as an adopter this
    # tick answered the ping with its pre-flip view
    fs_subj0 = _gather_rows(st.d_subj, t_safe)  # [N, C]
    fs_key0 = _gather_rows(st.d_key, t_safe)
    prov_side = None
    if st.side is not None:
        prov_side = st.side[t_safe.long()]
        flip = fs_apply & (prov_side != st.side)
        st = _absorb_merge_row(
            st._replace(side=torch.where(
                flip, st.merge_to[st.side.long(), prov_side.long()], st.side)),
            flip, ids,
        )
    fs_valid0 = (fs_subj0 < SENTINEL) & fs_apply[:, None]
    m_subj = torch.cat(
        [torch.where(a_valid, a_subj, SENTINEL), torch.where(fs_valid0, fs_subj0, SENTINEL)],
        dim=1,
    )
    m_key = torch.cat([torch.where(a_valid, a_key, 0), torch.where(fs_valid0, fs_key0, 0)], dim=1)
    m_valid = torch.cat([a_valid, fs_valid0], dim=1)
    out = _merge_claims(st, *_sort_claim_rows(m_subj, m_key, m_valid), sl_start)
    st3 = out.state
    live3 = st3.d_subj < SENTINEL
    subj_safe3 = torch.where(live3, st3.d_subj, 0)
    _, rfound = _lookup_pos(fs_subj0, subj_safe3)
    # the provider's view at its unslotted subjects is its base row
    row = None if prov_side is None else prov_side[:, None]
    base_claim = _at_rows(st3.base_key, row, subj_safe3)
    applies_b = (
        live3
        & fs_apply[:, None]
        & ~rfound
        & (st3.d_subj != ids[:, None])
        & _apply_mask(st3.d_key, base_claim)
    )
    d_key = torch.where(applies_b, base_claim, st3.d_key)
    nst = d_key & 7
    d_sl = torch.where(applies_b & (nst == SUSPECT), _i8(sl_start, dev), st3.d_sl)
    d_sl = torch.where(applies_b & (nst != SUSPECT), _i8(-1, dev), d_sl)
    st4 = st3._replace(
        d_key=d_key, d_pb=torch.where(applies_b, _i8(0, dev), st3.d_pb), d_sl=d_sl
    )
    applied = out.applied_points + applies_b.sum(dtype=torch.int32)
    if st4.side is not None:
        # a flip can adopt a suspect/faulty claim about the adopter itself
        # through the merged base: refute it now (a no-op where none)
        own_now = view_lookup(st4, ids)
        own_st = own_now & 7
        need_ref = fs_apply & ((own_st == SUSPECT) | (own_st == FAULTY))
        # audit: allow=RPL001 the reference's lax.cond predicate: the branch is skipped when empty
        if bool(need_ref.any()):
            out2 = _merge_claims(
                st4, ids[:, None], own_now[:, None], need_ref[:, None], sl_start
            )
            st4, applied = out2.state, applied + out2.applied_points
    return _refresh_in_step(st4), applied


def _absorb_merge_row(st: DeltaState, flip: torch.Tensor, ids: torch.Tensor) -> DeltaState:
    """The flipped viewers absorb their new base: slots the merged base
    already covers (the slot does not beat it) drop, their pb duty and
    suspicion timers void; the permanent self slot stays, rising to the
    base's value where that is higher.  Rows stay sorted (a stable sort,
    dropped slots to the end)."""
    dev = st.device
    live = st.d_subj < SENTINEL
    m_at = st.base_at(torch.where(live, st.d_subj, 0))
    is_self_slot = st.d_subj == ids[:, None]
    beats = _apply_mask(m_at, st.d_key)
    keep = live & (~flip[:, None] | beats | is_self_slot)
    lift_self = live & is_self_slot & flip[:, None] & ~beats & (m_at > st.d_key)
    neg = _i8(-1, dev)
    return _keep_slots(
        st, keep, torch.where(lift_self, m_at, st.d_key),
        torch.where(lift_self, neg, st.d_pb), torch.where(lift_self, neg, st.d_sl),
    )


def _role_counts(recv2d: torch.Tensor, mask2d: torch.Tensor, n: int) -> torch.Tensor:
    """int32[N] delivered-request count per receiver over all slots."""
    flat = torch.sort(torch.where(mask2d, recv2d, n).reshape(-1)).values
    s_, e_ = _run_bounds(flat, n)
    return (e_ - s_).to(torch.int32)


def _stage(
    st: DeltaState, pred: torch.Tensor, build_segs, params: DeltaParams, sl_start: int
) -> tuple[DeltaState, torch.Tensor, torch.Tensor]:
    """Route + merge one exchange stage when some node holds a windowed
    change (``pred``); otherwise the stage is a proven no-op."""
    zero = torch.zeros((), dtype=torch.int32, device=st.device)
    if not bool(pred):
        return st, zero, zero
    g = _route_claims_multi(st.n, build_segs(st), params.claim_grid)
    out = _merge_claims(st, g[0], g[1], g[2], sl_start)
    return out.state, out.applied_points, g[3]


def _exchange(
    st: DeltaState,
    params: DeltaParams,
    maxpb: torch.Tensor,
    failed: torch.Tensor,
    t_safe: torch.Tensor,
    wit_safe: torch.Tensor,
    wit_valid: torch.Tensor,
    req_del: torch.Tensor,
    ping_del: torch.Tensor,
    ack_del: torch.Tensor,
    resp_del: torch.Tensor,
    sl_start: int,
) -> tuple[DeltaState, torch.Tensor, torch.Tensor]:
    """The ping-req piggyback exchange, stages 5a-5d, each run only when
    a node that issues in it holds an active change.  Returns (state,
    applied, late)."""
    n = st.n
    dev = st.device
    ids = _ids(n, dev)
    w = params.wire_cap
    kk = wit_safe.shape[1]
    applied = torch.zeros((), dtype=torch.int32, device=dev)
    late = torch.zeros((), dtype=torch.int32, device=dev)
    w_empty = torch.full((n, min(w, st.capacity)), SENTINEL, dtype=torch.int32, device=dev)

    # -- 5a: the ping-req body carries the source's changes
    sa_subj = w_empty
    # audit: allow=RPL001 the reference's lax.cond predicate: the branch is skipped when empty
    if bool(((st.d_pb >= 0) & failed[:, None]).any()):
        nreq = (failed[:, None] & wit_valid).sum(dim=1, dtype=torch.int32)
        st, win_a = _stage_issue_delta(st, nreq, maxpb, w)
        sa_subj, sa_key = _windowed_changes(st, win_a, w)
        st, ap, lt = _stage(
            st,
            win_a.any(),
            lambda st3: [
                (sa_subj, sa_key, (sa_subj < SENTINEL) & req_del[:, m][:, None], wit_safe[:, m])
                for m in range(kk)
            ],
            params,
            sl_start,
        )
        applied, late = applied + ap, late + lt

    # -- 5b: the witness relay-pings the target with its changes
    wit_sent_subj = w_empty
    hc_b = (st.d_pb >= 0).any(dim=1)
    # audit: allow=RPL001 the reference's lax.cond predicate: the branch is skipped when empty
    if bool((req_del & hc_b[wit_safe.long()]).any()):
        nsrv = _role_counts(wit_safe, req_del, n)
        st, win_b = _stage_issue_delta(st, nsrv, maxpb, w)
        sb_subj, sb_key = _windowed_changes(st, win_b, w)
        nping_del = _role_counts(wit_safe, ping_del, n)

        def segs_b(st3):
            segs = []
            for m in range(kk):
                b_subj = _gather_rows(sb_subj, wit_safe[:, m])
                b_key = _gather_rows(sb_key, wit_safe[:, m])
                segs.append((b_subj, b_key, (b_subj < SENTINEL) & ping_del[:, m][:, None], t_safe))
            return segs

        st, ap, lt = _stage(st, win_b.any(), segs_b, params, sl_start)
        applied, late = applied + ap, late + lt
        # the witness's delivered set (5c anti-echo)
        wit_sent_subj = torch.where((nping_del > 0)[:, None], sb_subj, SENTINEL)

    # -- 5c: the target's ack carries its changes back
    hc_c = (st.d_pb >= 0).any(dim=1)
    # audit: allow=RPL001 the reference's lax.cond predicate: the branch is skipped when empty
    if bool((ping_del & hc_c[t_safe.long()][:, None]).any()):
        ntgt = _role_counts(t_safe[:, None].expand(n, kk), ping_del, n)
        st, win_c = _stage_issue_delta(st, ntgt, maxpb, w)
        sc_subj, sc_key = _windowed_changes(st, win_c, w)

        def segs_c(st3):
            segs = []
            subj = _gather_rows(sc_subj, t_safe)
            key_c = _gather_rows(sc_key, t_safe)
            subj_q = torch.where(subj < SENTINEL, subj, 0)
            for m in range(kk):
                w_m = wit_safe[:, m]
                # anti-echo: the witness delivered this subject in 5b and
                # its current belief equals the claim
                _, in_sent = _lookup_pos(_gather_rows(wit_sent_subj, w_m), subj_q)
                pos_w, found_w = _lookup_pos(_gather_rows(st3.d_subj, w_m), subj_q)
                # the witness's base row (its view is probed), not the source's
                row_w = None if st3.side is None else st3.side[w_m.long()][:, None]
                cur_w = torch.where(
                    found_w, _take(_gather_rows(st3.d_key, w_m), pos_w),
                    _at_rows(st3.base_key, row_w, subj_q),
                )
                echo = in_sent & (key_c == cur_w)
                segs.append(
                    (subj, key_c, (subj < SENTINEL) & ack_del[:, m][:, None] & ~echo, w_m)
                )
            return segs

        st, ap, lt = _stage(st, win_c.any(), segs_c, params, sl_start)
        applied, late = applied + ap, late + lt

    # -- 5d: the witness response carries its (fresh) changes
    hc_d = (st.d_pb >= 0).any(dim=1)
    # audit: allow=RPL001 the reference's lax.cond predicate: the branch is skipped when empty
    if bool((req_del & hc_d[wit_safe.long()]).any()):
        nsrv = _role_counts(wit_safe, req_del, n)
        st, win_d = _stage_issue_delta(st, nsrv, maxpb, w)
        sd_subj, sd_key = _windowed_changes(st, win_d, w)
        src_sent_subj = torch.where(req_del.any(dim=1)[:, None], sa_subj, SENTINEL)

        def segs_d(st3):
            segs = []
            for m in range(kk):
                w_m = wit_safe[:, m]
                subj = _gather_rows(sd_subj, w_m)
                key_d = _gather_rows(sd_key, w_m)
                subj_q = torch.where(subj < SENTINEL, subj, 0)
                _, in_sent = _lookup_pos(src_sent_subj, subj_q)
                echo = in_sent & (key_d == view_lookup(st3, subj_q))
                segs.append(
                    (subj, key_d, (subj < SENTINEL) & resp_del[:, m][:, None] & ~echo, ids)
                )
            return segs

        st, ap, lt = _stage(st, win_d.any(), segs_d, params, sl_start)
        applied, late = applied + ap, late + lt
    return st, applied, late


def delta_run_impl(
    state: DeltaState,
    net: NetState,
    key: torch.Tensor,
    params: DeltaParams,
    ticks: int,
    knobs: Any = None,
) -> tuple[DeltaState, dict[str, torch.Tensor]]:
    """``ticks`` protocol periods on ``split(key, ticks)``; returns the
    last tick's metrics, as the reference's scan does."""
    if ticks < 1:
        raise ValueError(f"ticks must be >= 1, got {ticks}")
    metrics: dict[str, torch.Tensor] = {}
    for sub in prng.split(key, ticks):
        state, metrics = delta_step_impl(state, net, sub, params, knobs=knobs)
    return state, metrics


# ---------------------------------------------------------------------------
# row materialization + exact convergence (device-side, no densify)
# ---------------------------------------------------------------------------


def materialize_rows(state: DeltaState, idx: Any) -> torch.Tensor:
    """int32[len(idx), N] view rows of the requested viewers: the base
    with each viewer's live slots written in."""
    idx = torch.as_tensor(np.asarray(idx) if not torch.is_tensor(idx) else idx,
                          device=state.device)
    idx = idx.to(dtype=torch.int64)
    return _scatter_rows(_base_rows(state, idx), _rows(state.d_subj, idx), _rows(state.d_key, idx))


def _converged_impl(
    state: DeltaState, up: torch.Tensor, responsive: torch.Tensor
) -> torch.Tensor:
    """Exact view agreement among live (gossiping) viewers, O(N * C):
    viewer i's row equals the reference row iff every live slot of i
    carries the reference's value there and i holds a slot at every
    subject where the reference row diverges from its own base (in
    sided mode: i's slots at the subjects where the reference row
    diverges from i's base row, counted)."""
    n, c = state.n, state.capacity
    ids = _ids(n, state.device)
    own = view_lookup(state, ids) & 7
    live = up & responsive & ((own == ALIVE) | (own == SUSPECT))
    # 0 for an all-False row; one-row gathers (indexing with a tensor
    # scalar would read it back to the host)
    ref = torch.argmax(live.to(torch.uint8)).reshape(1)

    ref_subj = state.d_subj.index_select(0, ref)[0]  # [C]
    ref_key = state.d_key.index_select(0, ref)[0]
    ref_live = ref_subj < SENTINEL
    ref_base = _base_rows(state, ref)
    ref_row = _scatter_rows(ref_base, ref_subj[None, :], ref_key[None, :])[0]

    slots_live = state.d_subj < SENTINEL
    subj_safe = torch.where(slots_live, state.d_subj, 0)
    ok_slots = torch.where(slots_live, state.d_key == ref_row[subj_safe.long()], True).all(dim=1)
    if state.side is None:
        div_ref = ref_live & (ref_key != ref_base[0][ref_subj.clamp(0, n - 1).long()])
        q = torch.where(div_ref, ref_subj, 0)[None, :].expand(n, c).contiguous()
        _, found = _lookup_pos(state.d_subj, q)
        ok_cover = torch.where(div_ref[None, :], found, True).all(dim=1)
    else:
        need_cover = state.base_key != ref_row[None, :]  # bool[G, N]
        need_count = need_cover.sum(dim=1, dtype=torch.int32)[state.side.long()]
        have = (slots_live & _at_rows(need_cover, state.side[:, None], subj_safe)).sum(
            dim=1, dtype=torch.int32)
        ok_cover = have == need_count
    row_same = ok_slots & ok_cover
    return torch.where(live, row_same, True).all() | (live.sum() <= 1)


# ---------------------------------------------------------------------------
# maintenance: compact (on the device) and rebase (host)
# ---------------------------------------------------------------------------


@_scoped("delta.compact")
def compact(state: DeltaState) -> DeltaState:
    """Drop slots that match the base again with no active pb/suspicion
    record (sided mode keeps the permanent self slots); keeps rows
    sorted.  The digest is invariant."""
    _check_carry(state)
    live = state.d_subj < SENTINEL
    subj_safe = torch.where(live, state.d_subj, 0)
    needed = live & (
        (state.d_key != state.base_at(subj_safe)) | (state.d_pb >= 0) | (state.d_sl >= 0)
    )
    if state.side is not None:
        needed = needed | (live & (state.d_subj == _ids(state.n, state.device)[:, None]))
    return _keep_slots(state, needed, state.d_key, state.d_pb, state.d_sl)


def _keep_slots(
    state: DeltaState, keep: torch.Tensor, d_key: torch.Tensor, d_pb: torch.Tensor,
    d_sl: torch.Tensor,
) -> DeltaState:
    """The slots where ``keep`` (with these key, pb and sl channels), the
    rest emptied to (SENTINEL, 0, -1, -1), rows sorted again by a stable
    sort (emptied slots to the end)."""
    neg = _i8(-1, state.device)
    d_subj = torch.where(keep, state.d_subj, SENTINEL)
    order = torch.argsort(d_subj, dim=1, stable=True)
    planes = {}
    if state.d_bpmask is not None:
        # the carried slot-base planes ride the reorder
        bpm = torch.where(keep, bitpack.unpack_bits(state.d_bpmask, state.capacity), False)
        planes = {
            "d_bpmask": bitpack.pack_bits(torch.gather(bpm, 1, order)),
            "d_bprank": torch.gather(torch.where(keep, state.d_bprank, 0), 1, order),
        }
    return state._replace(
        d_subj=torch.gather(d_subj, 1, order),
        d_key=torch.gather(torch.where(keep, d_key, 0), 1, order),
        d_pb=torch.gather(torch.where(keep, d_pb, neg), 1, order),
        d_sl=torch.gather(torch.where(keep, d_sl, neg), 1, order),
        **planes,
    )


# audit: allow=RPL001 host-side by design: tables read back for the host
def _tables_np(state: DeltaState) -> tuple[np.ndarray, ...]:
    """Host copies of (d_subj, d_key, d_pb, d_sl), C-contiguous."""
    return tuple(
        t.detach().to("cpu", copy=True).numpy()
        for t in (state.d_subj, state.d_key, state.d_pb, state.d_sl)
    )


def _with_tables(state: DeltaState, d_subj, d_key, d_pb, d_sl, **extra) -> DeltaState:
    dev = state.device
    return state._replace(
        d_subj=torch.as_tensor(d_subj, device=dev),
        d_key=torch.as_tensor(d_key, device=dev),
        d_pb=torch.as_tensor(d_pb, device=dev),
        d_sl=torch.as_tensor(d_sl, device=dev),
        **extra,
    )


def _sort_rows(state: DeltaState) -> DeltaState:
    """Rows sorted by subject again after a host edit, empty slots reset
    to (SENTINEL, 0, -1, -1).  Live subjects are unique in a row, so any
    sort gives the reference's ``np.argsort`` result."""
    return _keep_slots(state, state.d_subj < SENTINEL, state.d_key, state.d_pb, state.d_sl)


def _with_base(state: DeltaState, base_key: torch.Tensor, **extra) -> DeltaState:
    """``state`` on a new base (one row or G), its rank structures
    rebuilt and the digest refreshed."""
    bp_mask, bp_rank, bp_list = _base_rank_structs(base_key)
    return refresh_carried(state._replace(
        base_key=base_key, bp_mask=bp_mask, bp_rank=bp_rank, bp_list=bp_list, **extra))


# audit: allow=RPL001 host-side by design: tables read back for the host
def rebase(state: DeltaState, anti_entropy: bool = False) -> DeltaState:
    """Fold majority divergence into the base (host-side, rare): per
    subject, a value most viewers converged on becomes the base, the
    convergent slots drop and the minority get compensating slots (see
    ``_fold_group``); ``anti_entropy=True`` folds to the lattice max.
    In sided mode each group of viewers folds into its own row, then
    every merge row is lifted to the lattice merge of its source rows,
    so a flip never lowers a view.  Spans: ``delta.rebase_transfer``
    (the tables to the host and back) and ``delta.rebase_fold`` (the
    host fold)."""
    state = compact(state)
    n, cap = state.n, state.capacity
    with annotate.scope("delta.rebase_transfer"):
        d_subj, d_key, d_pb, d_sl = _tables_np(state)
        base = state.base_key.cpu().numpy().copy()
    with annotate.scope("delta.rebase_fold"):
        if state.side is None:
            _fold_group(d_subj, d_key, d_pb, d_sl, base, np.arange(n), cap,
                        anti_entropy=anti_entropy)
        else:
            side = state.side.cpu().numpy()
            for g in range(base.shape[0]):
                members = np.flatnonzero(side == g)
                if members.size:
                    _fold_group(d_subj, d_key, d_pb, d_sl, base[g], members, cap,
                                anti_entropy=anti_entropy)
            _lift_merge_rows(base, state.merge_to.cpu().numpy())
    with annotate.scope("delta.rebase_transfer"):
        state = _with_tables(state, d_subj, d_key, d_pb, d_sl)
        base_t = torch.as_tensor(base, device=state.device)
    return _with_base(_sort_rows(state), base_t)


def _lift_merge_rows(base: np.ndarray, merge_to: np.ndarray) -> None:
    """Every merge row, in place, to the lattice merge of itself and its
    two source rows (``merge_to[g1, g2] = m`` with m not both g1 and g2)."""
    for g1 in range(merge_to.shape[0]):
        for g2 in range(merge_to.shape[1]):
            m = int(merge_to[g1, g2])
            if m != g1 or m != g2:
                base[m] = _lmerge_np(base[m], _lmerge_np(base[g1], base[g2]))


def _lmerge_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pointwise lattice merge of two base rows (the host twin of
    ``_apply_mask``): the numeric max, except that leave yields only to
    alive, and a zero is no value."""
    beats = (b > a) & ~(((a & 7) == LEAVE) & ((b & 7) != ALIVE)) & (b > 0)
    return np.where(beats, b, a)


# audit: allow=RPL001 host-side by design: tables read back for the host
def make_sides(state: DeltaState, gid: Any) -> DeltaState:
    """Enter sided mode for a block netsplit: ``gid[i]`` in 0..G-1 puts
    viewer i on a side.  Makes G + 1 base rows (each side's a copy of
    the base, and one merge row) and the ``merge_to`` flip table (a
    side stays on its own row, any cross pair flips to the merge row),
    and gives every viewer a permanent self slot, so that a refutation
    is always an in-place update that no full table can starve.  Runs
    on the state's device; raises if a viewer that needs a self slot
    has none free.  Use with the matching group-id ``NetState.adj``."""
    if state.side is not None:
        raise ValueError("already sided; fold_to_single first")
    gid = np.asarray(gid.cpu() if torch.is_tensor(gid) else gid, dtype=np.int32)
    g = int(gid.max()) + 1 if gid.size else 1
    n, dev = state.n, state.device
    merge_to = np.full((g + 1, g + 1), g, dtype=np.int32)
    np.fill_diagonal(merge_to, np.arange(g + 1))
    rows = state.base_key[None, :].expand(g + 1, n).contiguous()
    ids = _ids(n, dev)
    need = ~(state.d_subj == ids[:, None]).any(dim=1)
    if bool(need.any()):
        empty = state.d_subj == SENTINEL
        free_col = torch.argmax(empty.to(torch.uint8), dim=1)
        if not bool(torch.where(need, _take(empty, free_col[:, None])[:, 0], True).all()):
            raise ValueError("make_sides: no free slot for a self entry")
        r = need.nonzero()[:, 0]
        c = free_col[r]
        d_subj, d_key, d_pb, d_sl = (t.clone() for t in (
            state.d_subj, state.d_key, state.d_pb, state.d_sl))
        d_subj[r, c] = r.to(torch.int32)
        d_key[r, c] = state.base_key[r]
        d_pb[r, c] = -1
        d_sl[r, c] = -1
        state = _sort_rows(state._replace(d_subj=d_subj, d_key=d_key, d_pb=d_pb, d_sl=d_sl))
    return _with_base(state, rows, side=torch.tensor(gid, device=dev),
                      merge_to=torch.as_tensor(merge_to, device=dev))


# audit: allow=RPL001 host-side by design: tables read back for the host
def fold_to_single(state: DeltaState) -> DeltaState:
    """Leave sided mode (host-side, after the remerge converges): the
    single base becomes the lattice merge of all rows, and a viewer
    whose own row still differs from it gets compensating slots there,
    so no view moves.  Raises ``ValueError`` when a viewer has fewer
    free slots than it needs; ``rebase`` first to drain the residue."""
    if state.side is None:
        return state
    base_rows = state.base_key.cpu().numpy()
    side = state.side.cpu().numpy()
    merged = base_rows[0].copy()
    for gr in range(1, base_rows.shape[0]):
        merged = _lmerge_np(merged, base_rows[gr])
    diffs = [np.flatnonzero(row != merged) for row in base_rows]
    movers = [i for i in range(state.n) if diffs[side[i]].size]
    if movers:
        d_subj, d_key, d_pb, d_sl = _tables_np(state)
        for i in movers:
            own, diff = base_rows[side[i]], diffs[side[i]]
            row = d_subj[i]
            need = diff[~np.isin(diff, row)]
            free = np.flatnonzero(row == SENTINEL)
            if need.size > free.size:
                raise ValueError(
                    f"viewer {i}: {need.size} compensating slots exceed free capacity "
                    f"{free.size}; rebase before fold_to_single"
                )
            c = free[: need.size]
            d_subj[i, c] = need
            d_key[i, c] = own[need]
            d_pb[i, c] = -1
            d_sl[i, c] = -1
        state = _sort_rows(_with_tables(state, d_subj, d_key, d_pb, d_sl))
    return _with_base(state, torch.as_tensor(merged, device=state.device),
                      side=None, merge_to=None)


def _fold_group(
    d_subj: np.ndarray,
    d_key: np.ndarray,
    d_pb: np.ndarray,
    d_sl: np.ndarray,
    base_row: np.ndarray,
    members: np.ndarray,
    cap: int,
    anti_entropy: bool = False,
) -> None:
    """The rebase fold over one viewer group, in place (a copy of the
    reference's host numpy).  View-preserving by default: a subject
    folds only when it nets slots back and no compensating insert would
    overflow."""
    if anti_entropy:
        _fold_group_anti_entropy(d_subj, d_key, d_pb, d_sl, base_row, members)
        return
    nm = members.size
    n = base_row.shape[0]
    ds = d_subj[members]
    dk = d_key[members]
    dpb = d_pb[members]
    dsl = d_sl[members]

    live = ds < int(SENTINEL)
    rows, cols = np.nonzero(live)
    if rows.size == 0:
        return
    subs = ds[rows, cols]
    busy = (dpb[rows, cols] >= 0) | (dsl[rows, cols] >= 0)
    cnt = np.bincount(subs, minlength=n)  # member slot-holders per subject

    dr = ~busy
    if not dr.any():
        return
    s_d, k_d = subs[dr], dk[rows, cols][dr]
    order = np.lexsort((k_d, s_d))
    s_s, k_s = s_d[order], k_d[order]
    new_run = np.ones(len(s_s), dtype=bool)
    new_run[1:] = (s_s[1:] != s_s[:-1]) | (k_s[1:] != k_s[:-1])
    run_ids = np.cumsum(new_run) - 1
    run_counts = np.bincount(run_ids)
    run_subj = s_s[new_run]
    run_key = k_s[new_run]
    gains = run_counts - (nm - cnt[run_subj])
    best = np.lexsort((gains, run_subj))
    last_of_subj = np.ones(len(best), dtype=bool)
    last_of_subj[:-1] = run_subj[best][1:] != run_subj[best][:-1]
    pick = best[last_of_subj]
    pick = pick[gains[pick] > 0]
    if pick.size == 0:
        return

    occ = live.sum(axis=1)
    for p in pick[np.argsort(-gains[pick])]:
        j = int(run_subj[p])
        v = int(run_key[p])
        has_slot = np.zeros((nm,), dtype=bool)
        has_slot[rows[subs == j]] = True
        need_insert_idx = np.flatnonzero(~has_slot)
        if np.any(occ[need_insert_idx] >= cap):
            continue  # a compensating insert would overflow; skip
        drop_mask = live & (ds == j) & (dk == v) & (dpb < 0) & (dsl < 0)
        ds[drop_mask] = int(SENTINEL)
        for i in need_insert_idx:
            free = np.flatnonzero(ds[i] == int(SENTINEL))
            c = free[0]
            ds[i, c] = j
            dk[i, c] = base_row[j]
            dpb[i, c] = -1
            dsl[i, c] = -1
        base_row[j] = v
        live = ds < int(SENTINEL)
        occ = live.sum(axis=1)
        rows, cols = np.nonzero(live)
        subs = ds[rows, cols]

    d_subj[members] = ds
    d_key[members] = dk
    d_pb[members] = dpb
    d_sl[members] = dsl


def _fold_group_anti_entropy(
    d_subj: np.ndarray,
    d_key: np.ndarray,
    d_pb: np.ndarray,
    d_sl: np.ndarray,
    base_row: np.ndarray,
    members: np.ndarray,
) -> None:
    """Lattice-max fold, in place (the reference's host numpy, over the
    members' live slots only): each subject folds to the group's max
    value (never leave-involved or suspect values), superseded slots
    drop, and a folded suspect/faulty rumor about a member is refuted in
    its own slot.  The tables must be C-contiguous."""
    n, cap = base_row.shape[0], d_subj.shape[1]
    flat = [t.reshape(-1) for t in (d_subj, d_key, d_pb, d_sl)]
    if any(not np.shares_memory(f, t) for f, t in zip(flat, (d_subj, d_key, d_pb, d_sl))):
        raise ValueError("the fold edits the tables in place: pass C-contiguous arrays")
    fs, fk, fpb, fsl = flat
    if members.size and members[-1] - members[0] + 1 == members.size:
        # a block of rows (a side of a block netsplit): a view, no copy
        lo = int(members[0])
        pos = np.flatnonzero(d_subj[lo : lo + members.size] < SENTINEL) + lo * cap
    else:
        p = np.flatnonzero(d_subj[members] < SENTINEL)
        pos = members[p // cap] * cap + p % cap
    if pos.size == 0:
        return
    subs = fs[pos]
    keys = fk[pos]
    # per subject: present, the max key, any leave value
    present = np.bincount(subs, minlength=n) > 0
    run_max_of = np.full(n, -1, dtype=keys.dtype)
    np.maximum.at(run_max_of, subs, keys)
    has_leave_of = np.bincount(subs[(keys & 7) == LEAVE], minlength=n) > 0
    run_subj = np.flatnonzero(present)
    run_max = run_max_of[run_subj]
    fold = (
        (run_max > base_row[run_subj])
        & ~has_leave_of[run_subj]
        & ((base_row[run_subj] & 7) != LEAVE)
        & ((run_max & 7) != SUSPECT)
    )
    if not fold.any():
        return
    v_of = base_row.copy()
    v_of[run_subj[fold]] = run_max[fold]
    folded = np.zeros(n, dtype=bool)
    folded[run_subj[fold]] = True
    superseded = folded[subs] & (keys <= v_of[subs])
    is_self_slot = subs == pos // cap
    drop = pos[superseded & ~is_self_slot]
    lift = superseded & is_self_slot
    fs[drop] = SENTINEL
    fk[drop] = 0
    fpb[drop] = -1
    fsl[drop] = -1
    fk[pos[lift]] = v_of[subs[lift]]
    fpb[pos[lift]] = -1
    fsl[pos[lift]] = -1
    base_row[folded] = v_of[folded]

    folded_self = folded[members] & np.isin(v_of[members] & 7, (SUSPECT, FAULTY))
    for i in members[folded_self]:
        i = int(i)
        row = d_subj[i]
        hit = np.flatnonzero(row == i)
        new_key = ((int(v_of[i]) >> 3) + 1) * 8 + ALIVE
        if hit.size:
            if int(d_key[i, hit[0]]) > int(v_of[i]):
                continue  # already refuted past the rumor
            c = int(hit[0])
        else:
            free = np.flatnonzero(row == SENTINEL)
            if not free.size:
                continue  # full row: the gossip path will refute later
            c = int(free[0])
            d_subj[i, c] = i
        d_key[i, c] = new_key
        d_pb[i, c] = 0
        d_sl[i, c] = -1


# ---------------------------------------------------------------------------
# admin surface (host-side point ops: small states or rare events)
# ---------------------------------------------------------------------------


def _apply_mask_np(cur: int, in_key: int) -> bool:
    """The override lattice on two host ints (``_apply_mask``)."""
    leave_guard = (cur & 7) == LEAVE and (in_key & 7) != ALIVE
    return in_key > cur and not leave_guard and in_key > 0


def _set_entry(
    state: DeltaState, viewer: int, subject: int, key: int, pb: int, sl: int
) -> DeltaState:
    """Host-side single-slot upsert (admin ops; not a hot path)."""
    d_subj, d_key, d_pb, d_sl = _tables_np(state)
    row = d_subj[viewer]
    hit = np.nonzero(row == subject)[0]
    if hit.size:
        c = int(hit[0])
    else:
        free = np.nonzero(row == int(SENTINEL))[0]
        if not free.size:
            raise ValueError(f"viewer {viewer} delta table full")
        c = int(free[0])
        d_subj[viewer, c] = subject
    d_key[viewer, c] = key
    d_pb[viewer, c] = pb
    d_sl[viewer, c] = sl
    order = np.argsort(d_subj[viewer])
    for t in (d_subj, d_key, d_pb, d_sl):
        t[viewer] = t[viewer][order]
    return _with_tables(state, d_subj, d_key, d_pb, d_sl)


# audit: allow=RPL001 host-side by design: tables read back for the host
def _base_row_np(state: DeltaState, viewer: int) -> np.ndarray:
    """The viewer's base row as numpy (its side's row in sided mode)."""
    if state.side is None:
        return state.base_key.cpu().numpy()
    return state.base_key[int(state.side[viewer])].cpu().numpy()


# audit: allow=RPL001 host-side by design: tables read back for the host
def view_of(state: DeltaState, viewer: int, subject: int) -> int:
    row = state.d_subj[viewer].cpu().numpy()
    hit = np.nonzero(row == subject)[0]
    if hit.size:
        return int(state.d_key[viewer].cpu().numpy()[hit[0]])
    return int(_base_row_np(state, viewer)[subject])


# audit: allow=RPL001 host-side by design: tables read back for the host
def _materialize_row(state: DeltaState, i: int):
    """Dense (vk, pb, sl) of viewer ``i`` (host-side numpy)."""
    n = state.n
    vk = _base_row_np(state, i).copy()
    pb = np.full(n, -1, np.int8)
    sl = np.full(n, -1, np.int8)
    subj = state.d_subj[i].cpu().numpy()
    live = subj < int(SENTINEL)
    vk[subj[live]] = state.d_key[i].cpu().numpy()[live]
    pb[subj[live]] = state.d_pb[i].cpu().numpy()[live]
    sl[subj[live]] = state.d_sl[i].cpu().numpy()[live]
    return vk, pb, sl


# audit: allow=RPL001 host-side by design: tables read back for the host
def _write_row(
    state: DeltaState,
    i: int,
    vk: np.ndarray,
    pb: np.ndarray,
    sl: np.ndarray,
    *,
    elide_redundant: bool = False,
) -> DeltaState:
    """Re-sparsify a dense row against the base and store it as viewer
    ``i``'s table.  Past capacity, base-valued entries (slots needed only
    for their pb/sl records) drop first; ``elide_redundant=True`` (the
    join path) counts only drops that lose real state."""
    n, cap = state.n, state.capacity
    dev = state.device
    base = _base_row_np(state, i)
    need = (vk != base) | (pb >= 0) | (sl >= 0)
    subs = np.flatnonzero(need)
    dropped = 0
    if len(subs) > cap:
        divergent = vk[subs] != base[subs]
        if divergent.sum() > cap:
            raise ValueError(
                f"viewer {i}: view divergence {int(divergent.sum())} exceeds "
                f"table capacity {cap}"
            )
        order = np.argsort(~divergent, kind="stable")  # divergent first
        kept = subs[order][:cap]
        cut = subs[order][cap:]
        if elide_redundant:
            dropped = int(((vk[cut] != base[cut]) | (sl[cut] >= 0)).sum())
        else:
            dropped = len(cut)
        subs = np.sort(kept)
    row_subj = np.full(cap, int(SENTINEL), np.int32)
    row_key = np.zeros(cap, np.int32)
    row_pb = np.full(cap, -1, np.int8)
    row_sl = np.full(cap, -1, np.int8)
    row_subj[: len(subs)] = subs
    row_key[: len(subs)] = vk[subs]
    row_pb[: len(subs)] = pb[subs]
    row_sl[: len(subs)] = sl[subs]
    out = {}
    for name, row in (("d_subj", row_subj), ("d_key", row_key), ("d_pb", row_pb),
                      ("d_sl", row_sl)):
        t = getattr(state, name).clone()
        t[i] = torch.as_tensor(row, device=dev)
        out[name] = t
    return state._replace(**out, overflow_drops=state.overflow_drops + dropped)


def admin_join(state: DeltaState, joiner: int, seed: int) -> DeltaState:
    """Bootstrap join against a seed over deltas: the seed marks the
    joiner alive (recording the change), and the joiner adopts the
    seed's entire view with every adopted member recorded (pb = 0);
    redundant re-announcements past capacity are elided."""
    n = state.n
    svk, spb, ssl = _materialize_row(state, seed)
    jvk, jpb, jsl = _materialize_row(state, joiner)

    j_key = int(jvk[joiner])
    in_key = (j_key >> 3) * 8 + ALIVE
    if _apply_mask_np(int(svk[joiner]), in_key):
        svk[joiner] = in_key
        spb[joiner] = 0
        state = _write_row(state, seed, svk, spb, ssl)

    learned = (svk > 0) & (np.arange(n) != joiner)
    jvk = np.where(learned, svk, jvk)
    jpb = np.where(learned, np.int8(0), jpb)
    jvk[joiner] = ALIVE if j_key == 0 else j_key
    if state.side is not None:
        # a cross-side join is a full-sync adoption: the joiner flips to
        # the merge row first, so it re-sparsifies against a base that
        # carries both sides' consensus
        j_g, s_g = int(state.side[joiner]), int(state.side[seed])
        if j_g != s_g:
            side = state.side.clone()
            side[joiner] = state.merge_to[j_g, s_g]
            state = state._replace(side=side)
    state = _write_row(state, joiner, jvk, jpb, jsl, elide_redundant=True)
    return refresh_carried(state)


def admin_leave(state: DeltaState, node: int) -> DeltaState:
    """makeLeave(self): the node marks itself leave and records it."""
    inc = view_of(state, node, node) >> 3
    state = _set_entry(state, node, node, inc * 8 + LEAVE, 0, -1)
    return refresh_carried(state)


def _wipe_row(state: DeltaState, node: int) -> DeltaState:
    out = {}
    for name, fill in (("d_subj", SENTINEL), ("d_key", 0), ("d_pb", -1), ("d_sl", -1)):
        t = getattr(state, name).clone()
        t[node] = fill
        out[name] = t
    return state._replace(**out)


def revive(state: DeltaState, node: int, inc: int) -> DeltaState:
    """A killed process restarts fresh: its row is wiped to self-only
    with a new incarnation (pb -1); re-entry is an ``admin_join``."""
    # audit: allow=RPL005 a host int's range check
    _check_inc(torch.tensor([int(inc)]))
    state = _wipe_row(state, node)
    state = _set_entry(state, node, node, int(inc) * 8 + ALIVE, -1, -1)
    return refresh_carried(state)


def revive_and_join(state: DeltaState, node: int, inc: int, seed: int) -> DeltaState:
    """Restart a killed process with a fresh higher incarnation and
    bootstrap it against ``seed`` in one operation."""
    return admin_join(revive(state, node, inc), node, seed)
