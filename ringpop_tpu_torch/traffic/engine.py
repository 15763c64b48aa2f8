"""Serving: masked ring lookups and the handle-or-forward chain.

The port of ``ringpop_tpu/traffic/engine.py``.  Per-viewer rings never
materialize.  The GLOBAL ring (every address's replica points, sorted
by (hash, name rank) like the host ``HashRing``'s (hash, server)
entries) is one pair of [R] tables, and a viewer's ring is a boolean
mask over servers (its view's alive and suspect members).  A filtered
ring is a subsequence of the global sorted table, so a lookup on the
viewer's ring is a ``searchsorted`` into the global table and a walk
clockwise to the first replica whose owner is in the mask, over a fixed
``window`` of successive replicas (``found=False`` reports the keys it
could not settle).

``serve_tick`` simulates the forwarding fabric on top: each key arrives
at a viewer, resolves through the viewer's ring, and when the owner is
remote follows the handle-or-forward chain: the holder re-resolves
through its own view and a disagreement forwards again, up to the retry
cap.  Against the ground-truth ring (the nodes actually gossiping) this
counts misroutes, forward hops and ring divergence per tick; with the
latency plane on (``latency_buckets``) it also sums each request's
latency (``traffic/latency.py``) and makes gray holders time out off
their duty phase.

The views come as a dense int32[N, N] table or, for the delta backend,
as ``DeltaRows(state)``: the rows a lookup needs are then built from the
delta tables ([M, N] for M requests), and the two whole-table counters
(the self-in-ring diagonal, ring divergence) are counted from the
tables in O(N * C) without the [N, N] table.  The reference's
``fori_loop``s are Python loops of the same fixed trip count with masked
updates; nothing here reads a value back from the device.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ringpop_tpu_torch import prng
from ringpop_tpu_torch.models import swim_delta as sdelta
from ringpop_tpu_torch.models.swim_sim import ALIVE, SUSPECT, _link_delay_bounds
from ringpop_tpu_torch.ops import gossip_remote_copy as _grc
from ringpop_tpu_torch.ops.ring_ops import DeviceRing, lookup_n_idx
from ringpop_tpu_torch.traffic import latency as tlat


class TrafficStatic(NamedTuple):
    """The fixed facts of a compiled workload (hashable)."""

    m: int  # keys per traffic tick
    max_retries: int  # forward-chain retry cap (request_proxy budget)
    window: int  # masked-walk width over the global ring
    every: int  # serve on ticks where tick % every == 0
    lookup_n: int  # >0: also resolve n-wide preference lists
    # SLO latency plane (traffic/latency.py): 0 = off, every counter as
    # without the plane; B > 0 sums each request's latency into a [B]
    # log2 histogram per tick, charges RETRY_SCHEDULE backoff per retry
    # and makes gray holders time out off their duty phase
    latency_buckets: int = 0
    period_ms: int = 200  # tick -> ms for link delays and backoff
    # 1 adds an int32[N] ``node_sends`` output: the send attempts landing
    # on each node this tick, which the overload loop and the policy
    # fold consume (never stacked into the trace)
    track_load: int = 0
    # 1 adds the ``policy_shed`` counter and threads the policy planes
    # (shed mask, quarantine mask, retry cap) through both chains
    track_policy: int = 0


class TrafficTensors(NamedTuple):
    """The device half (the key stays a host tensor, as the protocol's)."""

    pool: torch.Tensor  # int64[K] pre-hashed key pool (uint32 values)
    logits: torch.Tensor  # float32[K] sampler log-weights
    viewers: torch.Tensor  # int32[V] arrival nodes
    ring_hashes: torch.Tensor  # int64[R] global ring, sorted (uint32 values)
    ring_owners: torch.Tensor  # int32[R] owner per replica
    key: torch.Tensor  # int64[2] workload PRNG key (uint32 words), on the CPU


def sample_tick(
    tensors: TrafficTensors, t: int, m: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(pool index int32[M], viewer int32[M]) for traffic tick ``t``: a
    pure function of (workload key, t), so replaying a tick draws the
    same batch."""
    kk, kv = prng.split(prng.fold_in(tensors.key, t))
    idx = prng.categorical(kk, tensors.logits, m).to(torch.int32)
    pick = prng.randint(kv, (m,), 0, tensors.viewers.shape[0], device=tensors.viewers.device)
    return idx, tensors.viewers.index_select(0, pick.long())


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


def total_sends(metrics: dict) -> int:
    """The retry-amplification numerator: every send the serve plane
    issued (local handling, first proxy sends, consumed retries, and a
    shed request's one rejected arrival) over host trace series."""
    sends = (
        int(np.sum(metrics["handled_local"]))
        + int(np.sum(metrics["proxy_sends"]))
        + int(np.sum(metrics["proxy_retries"]))
    )
    if "policy_shed" in metrics:
        sends += int(np.sum(metrics["policy_shed"]))
    return sends


def counter_names(static: TrafficStatic) -> tuple[str, ...]:
    """The per-tick traffic counter series, in emission order."""
    names = [
        "lookups",
        "dropped",
        "handled_local",
        "proxy_sends",
        "proxy_retries",
        "proxy_failed",
        "delivered",
        "misroutes",
        "delivered_misroutes",
        "unresolved",
        "ring_divergence",
    ]
    names += [f"hops{h}" for h in range(static.max_retries + 2)]
    if static.track_policy:
        names += ["policy_shed"]
    if static.lookup_n:
        names += ["lookupns", "lookupn_incomplete"]
    if static.latency_buckets:
        names += ["send_errors", "retry_succeeded", "gray_timeouts",
                  "lat_count", "lat_sum_ms", "lat_max_ms"]
    return tuple(names)


def plane_names(static: TrafficStatic) -> tuple[tuple[str, int], ...]:
    """The per-tick vector series ``(name, width)`` a workload adds."""
    if static.latency_buckets:
        return (("lat_hist_ms", static.latency_buckets),)
    return ()


# ---------------------------------------------------------------------------
# the views a serve reads
# ---------------------------------------------------------------------------


class DeltaRows(NamedTuple):
    """A delta backend's views for ``serve_tick``: rows are built from
    the state's tables where the serve needs them."""

    state: Any  # swim_delta.DeltaState


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)


class _DenseViews:
    """The [N, N] in-ring mask of a dense view table, as the reference
    builds it: the self-in-ring diagonal from the raw mask, then the
    damped and quarantined members taken out of every viewer's ring.
    Under an active gossip ring the table is row-sharded: viewer rows
    arrive by ring hops (``ring_fetch_global``), the diagonal row-locally."""

    def __init__(self, view_rows: torch.Tensor, damped, quar):
        n = view_rows.shape[0]
        mask = in_ring_from_rows(view_rows)
        ids = torch.arange(n, dtype=torch.int64, device=view_rows.device)
        if _grc.active_ring() is not None:
            self.self_in = _grc.ring_take_per_row(mask, ids)
        else:
            self.self_in = mask[ids, ids]
        if damped is not None:
            mask = mask & ~damped
        if quar is not None:
            mask = mask & ~quar[None, :]
        self.mask = mask

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        if _grc.active_ring() is not None:
            return _grc.ring_fetch_global(self.mask, idx)
        return self.mask.index_select(0, idx.long())

    def divergence(self, gossip: torch.Tensor) -> torch.Tensor:
        return _count(gossip & (self.mask != gossip[None, :]).any(dim=1))


class _DeltaViews:
    """A delta state's in-ring views without its [N, N] table.  A row is
    the base row (the one base, or the viewer's side's) with the
    viewer's live slots written in; slot subjects are distinct within a
    row.  So viewer i's row differs from a reference row g somewhere
    iff a live slot differs, or the base row differs from g at a subject
    that i holds no slot for: ``|D| - |D & slots(i)| > 0`` with D the
    subjects where the base row's mask differs from g."""

    def __init__(self, state, quar):
        self.state = state
        self.quar = quar
        n = state.n
        ids = torch.arange(n, dtype=torch.int32, device=state.device)
        self.self_in = in_ring_from_rows(sdelta.view_lookup(state, ids))

    def _mask(self, keys: torch.Tensor, subj: torch.Tensor) -> torch.Tensor:
        m = in_ring_from_rows(keys)
        if self.quar is not None:
            m = m & ~self.quar[subj.long()]
        return m

    def rows(self, idx: torch.Tensor) -> torch.Tensor:
        m = in_ring_from_rows(sdelta.materialize_rows(self.state, idx))
        if self.quar is not None:
            m = m & ~self.quar[None, :]
        return m

    def divergence(self, gossip: torch.Tensor) -> torch.Tensor:
        st = self.state
        n = st.n
        cols = torch.arange(n, dtype=torch.int32, device=st.device)
        base = st.base_key if st.side is not None else st.base_key[None, :]
        base_diff = self._mask(base, cols[None, :].expand(base.shape)) != gossip[None, :]
        row = (torch.zeros(n, dtype=torch.int64, device=st.device) if st.side is None
               else st.side.to(torch.int64))
        live = st.d_subj < sdelta.SENTINEL
        subj = torch.where(live, st.d_subj, 0).to(torch.int64)
        slot_diff = live & (self._mask(st.d_key, subj) != gossip[subj])
        covered = live & base_diff[row[:, None], subj]
        left = base_diff.sum(dim=1, dtype=torch.int32)[row] - covered.sum(dim=1, dtype=torch.int32)
        return _count(gossip & (slot_diff.any(dim=1) | (left > 0)))


def _lut(values: np.ndarray, idx: torch.Tensor) -> torch.Tensor:
    """``values[idx]`` for a short host table, as device selects (a
    host-to-device copy of the table would wait for the card)."""
    out = torch.full(idx.shape, int(values[-1]), dtype=torch.int32, device=idx.device)
    for i in range(len(values) - 2, -1, -1):
        out = torch.where(idx == i, int(values[i]), out)
    return out


def _serve_impl(views, up, responsive, tensors, t, static, damped=None,
                net=None, period=None, policy=None):
    if isinstance(views, DeltaRows):
        n = views.state.n
    else:
        n = views.shape[0]
    dev = up.device
    rh, ro = tensors.ring_hashes, tensors.ring_owners
    w = static.window
    m = static.m
    quar = None
    if policy is not None:
        # the policy plane from the last tick's fold: shed flags, ring
        # quarantine (out of every viewer's ring like damped; liveness
        # truth untouched) and the retry cap
        po_shed, quar, po_cap = policy
    if isinstance(views, DeltaRows):
        v = _DeltaViews(views.state, quar)
    else:
        v = _DenseViews(views, damped, quar)
    # the ground-truth ring: pure liveness, before damping or quarantine
    gossip = up & responsive & v.self_in
    kidx, viewer = sample_tick(tensors, t, m)
    khash = tensors.pool.index_select(0, kidx.long())
    viewer_l = viewer.long()

    def clip(x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(x, 0, n - 1)

    # a request landing on a dead/suspended node is dropped, not served
    served = gossip[viewer_l]
    truth_owner, truth_found = lookup_masked_idx(rh, ro, khash, gossip, window=w)
    owner0, found0 = lookup_masked_idx(rh, ro, khash, v.rows(viewer), window=w)
    resolved = served & found0
    handled_local = resolved & (owner0 == viewer)
    unresolved = served & ~found0
    shed_req = None
    if policy is not None:
        # admission control: a request whose first holder is shedding is
        # rejected at arrival (one landed send on that holder)
        shed_req = resolved & po_shed[clip(owner0).long()]
        handled_local = handled_local & ~shed_req

    active = resolved & ~handled_local
    if shed_req is not None:
        active = active & ~shed_req
    # the retry cap: the fixed budget, or its minimum with the policy's
    cap: Any = static.max_retries
    if policy is not None:
        cap = torch.clamp(po_cap, max=static.max_retries)
    lat_extras: dict[str, torch.Tensor] = {}
    track = bool(static.track_load)
    i32 = torch.int32
    loads = None
    if track:
        loads = torch.zeros(n, dtype=i32, device=dev)
        loads.index_add_(0, viewer_l, handled_local.to(i32))
        if shed_req is not None:
            loads.index_add_(0, clip(owner0).long(), shed_req.to(i32))

    h = torch.where(active, owner0, viewer)  # current holder
    settled = handled_local
    act = active
    final = torch.where(handled_local, viewer, -1)  # final handler
    retries = torch.zeros(m, dtype=i32, device=dev)
    forwards = active.to(i32)  # the first send counted
    if not static.latency_buckets:
        for _ in range(static.max_retries + 1):
            hc = clip(h)
            if track:
                loads.index_add_(0, hc.long(), act.to(i32))
            has_retry = retries < cap
            alive_h = gossip[hc.long()]
            retry_dead = act & ~alive_h & has_retry  # failed send, re-sent
            nxt, f = lookup_masked_idx(rh, ro, khash, v.rows(hc), window=w)
            done = act & alive_h & f & (nxt == h)
            settled = settled | done
            final = torch.where(done, h, final)
            unresolved = unresolved | (act & alive_h & ~f)
            go = act & alive_h & f & (nxt != h) & has_retry  # reroute
            stepped = (go | retry_dead).to(i32)
            retries = retries + stepped
            forwards = forwards + stepped
            h = torch.where(go, nxt, h)
            act = go | retry_dead
    else:
        # the SLO latency chain: the plain chain's topology plus each
        # attempt's one-way link latency, the RETRY_SCHEDULE backoff per
        # consumed retry, and gray timeouts (a send landing on a gray
        # holder off its duty phase, at the request's backoff-advanced
        # effective tick, fails like a dead send)
        b = static.latency_buckets
        a_max = static.max_retries + 1  # send attempts per request
        kf, kr = prng.split(tlat.latency_key(tensors.key, t))
        u_fwd = prng.uniform(kf, (a_max, m), device=dev)
        u_ret = prng.uniform(kr, (m,), device=dev)
        bo_ms = tlat.backoff_ms_schedule(static.max_retries)
        bo_ticks = tlat.backoff_tick_offsets(static.max_retries, static.period_ms)

        def oneway(src, dst, u):
            if net is None or net.link_d is None:
                return torch.zeros(u.shape, dtype=i32, device=dev)
            base, bound = _link_delay_bounds(net, src, dst)
            return tlat.jitter_ms(u, base, bound, static.period_ms)

        lat = torch.where(active, oneway(viewer, clip(owner0), u_fwd[0]), 0)
        sender = torch.where(active, viewer, -1)  # sender of the in-flight attempt
        gray_to = torch.zeros((), dtype=i32, device=dev)
        send_err = torch.zeros((), dtype=i32, device=dev)
        for i in range(a_max):
            hc = clip(h)
            if track:
                loads.index_add_(0, hc.long(), act.to(i32))
            has_retry = retries < cap
            alive_h = gossip[hc.long()]
            te = t + _lut(bo_ticks, torch.clamp(retries, 0, static.max_retries))
            on_duty = tlat.duty_on(hc, te, period)
            serves = act & alive_h & on_duty
            timeout = act & alive_h & ~on_duty
            dead = act & ~alive_h
            gray_to = gray_to + _count(timeout)
            send_err = send_err + _count(dead | timeout)
            nxt, f = lookup_masked_idx(rh, ro, khash, v.rows(hc), window=w)
            done = serves & f & (nxt == h)
            settled = settled | done
            final = torch.where(done, h, final)
            unresolved = unresolved | (serves & ~f)
            go = serves & f & (nxt != h) & has_retry  # reroute
            retry_same = (dead | timeout) & has_retry  # frozen view resend
            stepping = go | retry_same
            bo = _lut(bo_ms, torch.clamp(retries, 0, len(bo_ms) - 1))
            new_sender = torch.where(go, h, sender)
            new_holder = torch.where(go, nxt, h)
            fwd = oneway(clip(new_sender), clip(new_holder), u_fwd[min(i + 1, a_max - 1)])
            lat = lat + torch.where(stepping, bo + fwd, 0)
            stepped = stepping.to(i32)
            retries = retries + stepped
            forwards = forwards + stepped
            h = torch.where(stepping, new_holder, h)
            sender = torch.where(stepping, new_sender, sender)
            act = stepping
        # a delivered proxied request pays the return leg to its viewer
        proxied_done = settled & ~handled_local
        ret = oneway(clip(final), viewer, u_ret)
        lat = torch.where(proxied_done, lat + ret, lat)
        lat = torch.where(settled, lat, 0)
        lat_extras = {
            "send_errors": send_err,
            "retry_succeeded": _count(settled & (retries > 0)),
            "gray_timeouts": gray_to,
            "lat_count": _count(settled),
            "lat_sum_ms": lat.sum(dtype=i32),
            "lat_max_ms": torch.clamp(lat.amax(), min=0),
            "lat_hist_ms": tlat.bucket_counts(lat, settled, b),
        }

    failed = served & ~settled & ~unresolved
    if shed_req is not None:
        failed = failed & ~shed_req
    out = {
        "lookups": _count(served),
        "dropped": m - _count(served),
        "handled_local": _count(handled_local),
        "proxy_sends": _count(active),
        "proxy_retries": retries.sum(dtype=i32),
        "proxy_failed": _count(failed),
        "delivered": _count(settled),
        "misroutes": _count(resolved & truth_found & (owner0 != truth_owner)),
        "delivered_misroutes": _count(settled & truth_found & (final != truth_owner)),
        "unresolved": _count(unresolved),
        "ring_divergence": v.divergence(gossip),
    }
    for hp in range(static.max_retries + 2):
        out[f"hops{hp}"] = _count(settled & (forwards == hp))
    if static.track_policy:
        out["policy_shed"] = (_count(shed_req) if shed_req is not None
                              else torch.zeros((), dtype=i32, device=dev))
    if static.lookup_n:
        # the preference walk builds an [M, W, W] dedup cube, so its
        # window is lookup_n_idx's n-scaled one, not the residue window
        wn = min(w, 32 + 8 * static.lookup_n)
        _, complete = lookup_n_masked_idx(rh, ro, khash, v.rows(viewer), static.lookup_n,
                                          window=wn)
        out["lookupns"] = _count(served)
        out["lookupn_incomplete"] = _count(served & ~complete)
    out.update(lat_extras)
    if track:
        out["node_sends"] = loads
    return out


def _zero_counters(static: TrafficStatic, n: int, device: torch.device) -> dict[str, torch.Tensor]:
    """An off-cadence tick's outputs: a zero per counter, a zero row per
    histogram plane, and zero ``node_sends`` under ``track_load``."""
    zero = torch.zeros((), dtype=torch.int32, device=device)
    zeros: dict[str, torch.Tensor] = {k: zero for k in counter_names(static)}
    for name, width in plane_names(static):
        zeros[name] = torch.zeros(width, dtype=torch.int32, device=device)
    if static.track_load:
        zeros["node_sends"] = torch.zeros(n, dtype=torch.int32, device=device)
    return zeros


def serve_tick(
    view_rows: Any,
    up: torch.Tensor,
    responsive: torch.Tensor,
    tensors: TrafficTensors,
    t: int,
    *,
    static: TrafficStatic,
    damped: torch.Tensor | None = None,
    net: Any | None = None,
    period: torch.Tensor | None = None,
    policy: tuple | None = None,
) -> dict[str, torch.Tensor]:
    """One traffic tick's counters (int32 scalars, ``counter_names``
    order, plus the ``plane_names`` rows with the latency plane on)
    against the given views, at host tick ``t``.

    ``view_rows`` is the int32[N, N] packed view table or a
    ``DeltaRows``, whose rows are built only on serving ticks: an
    off-cadence tick (``t % every != 0``) reports zeros and builds
    nothing.  ``damped`` (bool[N, N]) takes flap-damped
    members out of the viewers' rings, as the host ``ring_for``.  ``net``
    (the tick's ``NetState``, its active link rules) and ``period`` (the
    int32[N] period row) feed the latency plane only.  ``policy`` is the
    policy plane from the last tick's fold, ``(shed bool[N], quarantine
    bool[N], retry_cap int32 scalar)``, or None."""
    if t % static.every != 0:
        return _zero_counters(static, up.shape[0], up.device)
    return _serve_impl(view_rows, up, responsive, tensors, t, static, damped,
                       net=net, period=period, policy=policy)


def serve_once(
    view_rows: Any,
    up: torch.Tensor,
    responsive: torch.Tensor,
    tensors: TrafficTensors,
    t: int,
    *,
    static: TrafficStatic,
    damped: torch.Tensor | None = None,
    net: Any | None = None,
    period: torch.Tensor | None = None,
    policy: tuple | None = None,
) -> dict[str, torch.Tensor]:
    """Serve one traffic tick against a snapshot of membership state
    (benchmarks, ad-hoc serving against a live ``SimCluster``): the
    reference's standalone jitted entry, here ``serve_tick`` itself."""
    return serve_tick(view_rows, up, responsive, tensors, int(t), static=static,
                      damped=damped, net=net, period=period, policy=policy)

