"""Gossip provenance plane: rumor-level dissemination tracing.

The scenario scan can track up to K *rumors* — a rumor is a
``(subject, view_key)`` lattice point, e.g. "node 3 is SUSPECT at
incarnation 2" — and record, per node, WHEN it first heard the rumor
and WHO (plausibly) told it, entirely inside the jitted scan.  The
answer to the operator question "why was node X declared faulty, and
how long did that rumor take to reach the stragglers?" falls out as a
propagation tree plus a detection-causality chain per tracked rumor.

Semantics (the pinned conventions; tests/test_provenance.py holds the
per-tick host oracle to them bit-for-bit):

* **knows** is lattice dominance: node v knows rumor ``(s, k)`` iff its
  post-tick view key of s is ``>= k``.  Hearing STRONGER news (the
  faulty escalation ``k+1``, or a refutation at a higher incarnation)
  counts as having heard — first_heard is a pure function of the view
  trajectory, not of any payload bookkeeping.
* **first_heard[v]** is the first tick at which v knows (int16 ticks;
  the plane rejects runs of >= 32768 ticks).  -1 = never heard.
  Knowledge that predates a slot's arming collapses to the arming
  tick (a second, later-armed rumor may find believers on day one).
* **parent[v]** is a deterministic "canonical plausible infector":
  among this tick's *delivered* protocol edges whose sender knew the
  rumor at the START of the tick, the first edge in intra-tick phase
  order — direct ping (phase 3), ack/full-sync reply (phase 4), then
  the four ping-req relay hops (5a source->witness, 5b witness->
  target, 5c target->witness ack, 5d witness->source response) —
  breaking ties inside a phase by minimum sender index.  The
  attribution is payload-blind by design: the simulator's piggyback
  budgets decide what a message CARRIES, but any delivered edge from a
  knower is a plausible infection path, and the convention is exact,
  cheap, and identical on both backends.  Sentinels: -1 = origin
  (the declarer itself, or the subject — its own authority for
  refute/revive news), -2 = heard but unattributed (delayed-lane
  arrival, or a same-tick relay chain whose sender only learned this
  tick), -3 = never heard.
* **arming**: a slot arms on a *suspect declaration that stuck* (the
  declarer's post-tick view of its target is SUSPECT/FAULTY at the
  declared incarnation).  Faulty escalations are not separately
  tracked — every FAULTY is preceded by the suspect rumor the slot
  already holds, and the escalation is the slot's *resolution*.
  ``track`` scenario ops reserve slot j for a named subject (armed by
  the first qualifying declaration about it at tick >= ``at``); the
  remaining free slots auto-arm, assigning same-tick new subjects in
  ascending subject order.  Duplicate (subject, key) pairs never
  double-arm.
* **resolution** (the detection-causality chain): the slot records the
  origin declarer, its probe tick (= declaration tick; the failed
  probe, its witness set and the declaration share one tick by the
  step's phase layout), the ping-req witness set, and the first tick
  the cluster-wide view maximum of the subject escapes the suspect
  key: ``>= key+7`` (= alive at the next incarnation) is a REFUTATION,
  else ``>= key+1`` (faulty — or leave) is a CONFIRMATION.  A tick
  where both appear resolves as refuted (the lattice winner).

The port of ``ringpop_tpu/obs/provenance.py``.  The carry holds the
knows planes bit-packed (``ops/bitpack``: 32 nodes a word, in int64
words as every packed plane of the port; ``convert.py`` maps them to the
reference's uint32) and no bool leaf.  ``prov_update`` is the one
int-exact update shared by the scenario runner's fold and a per-tick
host walk.  It runs on the device with no read back to the host: the
reference's ``vmap`` of ``_attribute`` over the K slots is one batched
pass over [K, N] planes, and its ``.at[idx].min/max(mode="drop")``
scatters are ``scatter_reduce`` onto a buffer with one spare slot that
takes the dropped indices and is cut off.  ``build_report`` and
``summary_block`` are the reference's host numpy.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ringpop_tpu_torch import resolve_device
from ringpop_tpu_torch.obs import annotate
from ringpop_tpu_torch.ops import bitpack

# status bits of a view key (as swim_sim's)
_SUSPECT = 2
_FAULTY = 3

# first_heard / parent sentinels (module docstring)
UNHEARD = -1  # first_heard: never heard
P_ORIGIN = -1  # parent: the rumor's own origin / the subject itself
P_UNATTRIBUTED = -2  # parent: heard, but no in-tick edge explains it
P_UNHEARD = -3  # parent: never heard

# slot resolution states (pv_slot[:, 3])
RES_PENDING = 0
RES_REFUTED = 1
RES_CONFIRMED = 2

# pv_slot columns
_C_SUBJ, _C_KEY, _C_ORG, _C_RES = 0, 1, 2, 3

# the evidence keys both backend steps export when prov is armed
EVIDENCE_KEYS = (
    "pv_tgt", "pv_send", "pv_ping", "pv_ack", "pv_wit", "pv_witv",
    "pv_req", "pv_rping", "pv_rack", "pv_resp", "pv_decl",
)

MAX_RUMORS = 64  # slot cap (K x N int16 and int32 planes ride the carry)
MAX_TICKS = 32767  # int16 first_heard/tick range


class ProvCarry(NamedTuple):
    """The provenance carry, with no bool leaf.  ``knows`` stays packed
    (int64 words of 32 bits, 1 bit a node) and is unpacked only inside
    ``prov_update``.  K = tracked-rumor slots, N = nodes, kk =
    ping_req_size."""

    slot: torch.Tensor  # int32[K, 4]: subject (-1 unarmed), key, origin, res
    tickv: torch.Tensor  # int16[K, 2]: (origin_tick, resolution_tick); -1
    wits: torch.Tensor  # int32[K, kk]: origin's ping-req witness set; -1 pad
    first: torch.Tensor  # int16[K, N]: first_heard ticks; -1 unheard
    parent: torch.Tensor  # int32[K, N]: first infector; -3/-1/-2 sentinels
    knows: torch.Tensor  # int64[K, W]: packed knows plane


def init_carry(n: int, k: int, k_wit: int, device: torch.device | str | None = None) -> ProvCarry:
    """A fresh all-unarmed carry for K rumor slots over N nodes, on
    ``device`` (``cuda`` unless the caller names one)."""
    device = resolve_device(device)
    slot = torch.full((k, 4), -1, dtype=torch.int32, device=device)
    slot[:, _C_RES] = RES_PENDING
    return ProvCarry(
        slot=slot,
        tickv=torch.full((k, 2), -1, dtype=torch.int16, device=device),
        wits=torch.full((k, k_wit), -1, dtype=torch.int32, device=device),
        first=torch.full((k, n), UNHEARD, dtype=torch.int16, device=device),
        parent=torch.full((k, n), P_UNHEARD, dtype=torch.int32, device=device),
        knows=torch.zeros((k, bitpack.packed_width(n)), dtype=torch.int64, device=device),
    )


def track_tensors(
    tracks: tuple, k: int, device: torch.device | str = "cpu"
) -> tuple[torch.Tensor, torch.Tensor]:
    """``track`` op reservations as (pv_at, pv_node) int32[K] tensors:
    slot j holds reservation j of the compiled (at, node) pairs, and
    unreserved slots pad with node -1 (free for auto-arming)."""
    at = torch.zeros(k, dtype=torch.int32, device=device)
    node = torch.full((k,), -1, dtype=torch.int32, device=device)
    for j, (a, m) in enumerate(tracks):
        # element fills on the device: a host array would be copied over,
        # which waits for the card
        at[j] = a
        node[j] = m
    return at, node


def _scatter_min(n: int, k: int, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """int32[K, N]: ``full(n).at[idx].min(src)`` for each of K rows
    (``idx`` in range, [M] shared by the rows; ``src`` [K, M])."""
    out = torch.full((k, n), n, dtype=torch.int32, device=src.device)
    return out.scatter_reduce_(1, idx.long().reshape(1, -1).expand(k, -1), src, "amin")


def _attribute(ks: torch.Tensor, ev: dict[str, torch.Tensor], n: int) -> torch.Tensor:
    """Canonical plausible infector of each node for each of K rumors.

    ``ks`` is the knows-at-tick-start planes, bool[K, N]; returns
    int32[K, N] sender indices with ``n`` as the no-candidate sentinel.
    Phase precedence and the min-sender tie-break as in the module
    docstring; every scatter is a min onto the sentinel, so the order is
    data-independent."""
    k = ks.shape[0]
    dev = ks.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    tgt = ev["pv_tgt"]
    w = ev["pv_wit"]
    kk = w.shape[1]
    tgt_b = tgt[:, None].expand(n, kk)
    ks_tgt = ks.index_select(1, tgt.long())  # [K, N]: the target knew
    ks_w = ks.index_select(1, w.reshape(-1).long()).reshape(k, n, kk)  # the witness knew
    # phase 3: prober v -> its target (in-tick payload deliveries only)
    c3 = _scatter_min(n, k, tgt, torch.where(ev["pv_ping"] & ks, ids, n))
    # phase 4: the target's ack/full-sync reply back to v (elementwise)
    c4 = torch.where(ev["pv_ack"] & ks_tgt, tgt, n)
    # phase 5a: ping-req source v -> witness
    c5a = _scatter_min(n, k, w, torch.where(ev["pv_req"] & ks[:, :, None], ids[:, None], n)
                       .reshape(k, -1))
    # phase 5b: witness -> target relay ping
    c5b = _scatter_min(n, k, tgt_b, torch.where(ev["pv_rping"] & ks_w, w, n).reshape(k, -1))
    # phase 5c: target -> witness relay ack
    c5c = _scatter_min(n, k, w, torch.where(ev["pv_rack"] & ks_tgt[:, :, None], tgt_b, n)
                       .reshape(k, -1))
    # phase 5d: witness -> source response
    c5d = torch.where(ev["pv_resp"] & ks_w, w, n).amin(dim=2).to(torch.int32)
    out = c3
    for c in (c4, c5a, c5b, c5c, c5d):
        out = torch.where(out < n, out, c)
    return out


def prov_update(
    pvc: ProvCarry,
    ev: dict[str, torch.Tensor],
    tick: int,
    view_post: Callable[[torch.Tensor], torch.Tensor],
    pv_at: torch.Tensor,
    pv_node: torch.Tensor,
    n: int,
) -> tuple[ProvCarry, torch.Tensor]:
    """One tick of the provenance fold (the runner's and a host walk's).

    ``ev`` is the step's delivery-evidence bundle (``EVIDENCE_KEYS``);
    ``view_post`` maps viewer-major subject queries int32[N, M] to the
    post-tick view keys int32[N, M] (dense: a gather of ``view_key``;
    delta: ``view_lookup``).  ``tick`` is the scenario's tick (a host
    int).  Returns the next carry and the per-slot heard count int32[K]
    (the ``pv_heard`` telemetry plane)."""
    with annotate.scope("obs.prov_update"):
        return _prov_update(pvc, ev, int(tick), view_post, pv_at, pv_node, n)


def _prov_update(pvc, ev, tick, view_post, pv_at, pv_node, n):
    k = pvc.slot.shape[0]
    dev = pvc.slot.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    i32 = torch.int32

    # -- origin gate: suspect declarations that stuck -------------------
    # The declared key comes from the declarer's post-tick view: an
    # applied declaration leaves (inc*8+SUSPECT), or its same-tick FAULTY
    # escalation at suspicion_ticks=0, which shares the inc, so
    # (view >> 3) * 8 + SUSPECT is the declared key; a declaration the
    # lattice refused (refuted at a higher incarnation) leaves an ALIVE
    # status and is filtered here.
    tgt = ev["pv_tgt"]
    post_t = view_post(tgt[:, None].contiguous())[:, 0]
    st8 = post_t & 7
    dkey = (post_t >> 3) * 8 + _SUSPECT
    decl = ev["pv_decl"] & ((st8 == _SUSPECT) | (st8 == _FAULTY)) & (tgt != ids)

    # -- arming ---------------------------------------------------------
    armed = pvc.slot[:, _C_SUBJ] >= 0
    dup = (
        armed[None, :]
        & (tgt[:, None] == pvc.slot[None, :, _C_SUBJ])
        & (dkey[:, None] == pvc.slot[None, :, _C_KEY])
    ).any(dim=1)
    cand = decl & ~dup
    # per-subject aggregation: the rumor key is the max declared key and
    # the origin the min declarer index (simultaneous declarers); index n
    # is the dropped slot
    s_idx = torch.where(cand, tgt, n).long()
    key_by = torch.full((n + 1,), -1, dtype=i32, device=dev).scatter_reduce_(
        0, s_idx, dkey, "amax")[:n]
    org_by = torch.full((n + 1,), n, dtype=i32, device=dev).scatter_reduce_(
        0, s_idx, ids, "amin")[:n]
    has_subj = key_by >= 0
    # reserved slots fire first (track ops pin slot j to a subject)
    rsv_subj = pv_node.clamp(0, n - 1)
    rsv_fire = (~armed) & (pv_node >= 0) & (pv_at <= tick) & has_subj[rsv_subj.long()]
    consumed = torch.zeros(n + 1, dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(rsv_fire, rsv_subj, n).long(), True)[:n]
    # free slots auto-arm the remaining new subjects in ascending order
    rem = has_subj & ~consumed
    s_rank = torch.cumsum(rem.to(i32), 0, dtype=i32) - 1
    subj_by_rank = torch.full((k + 1,), -1, dtype=i32, device=dev).scatter_(
        0, torch.where(rem & (s_rank < k), s_rank, k).long(), ids)[:k]
    free = (~armed) & (pv_node < 0)
    f_rank = torch.cumsum(free.to(i32), 0, dtype=i32) - 1
    auto_subj = torch.where(free, subj_by_rank[f_rank.clamp(0, k - 1).long()], -1)
    new_subj = torch.where(rsv_fire, rsv_subj, auto_subj)
    arm_now = new_subj >= 0
    safe_new = new_subj.clamp(0, n - 1).long()
    new_org = org_by[safe_new]
    org_safe = new_org.clamp(0, n - 1).long()
    new_wits = torch.where(ev["pv_witv"][org_safe], ev["pv_wit"][org_safe], -1)
    slot = torch.where(
        arm_now[:, None],
        torch.stack([new_subj, key_by[safe_new], new_org, torch.zeros_like(new_subj)], dim=1),
        pvc.slot,
    )
    # (origin_tick, resolution_tick) of a slot armed now, filled on the
    # device (a host tensor would copy, and wait, every tick)
    armed_tv = torch.full((1, 2), -1, dtype=torch.int16, device=dev)
    armed_tv[:, 0] = tick
    tickv = torch.where(arm_now[:, None], armed_tv, pvc.tickv)
    wits = torch.where(arm_now[:, None], new_wits, pvc.wits)

    # -- knows / first_heard / parent -----------------------------------
    subj = slot[:, _C_SUBJ]
    keyv = slot[:, _C_KEY]
    armed2 = subj >= 0
    q = subj.clamp(0, n - 1)[None, :].expand(n, k).contiguous()
    col = view_post(q)  # [N, K] viewer-major post views of each subject
    knows_new = (armed2[None, :] & (col >= keyv[None, :])).T  # [K, N]
    knows_old = bitpack.unpack_bits(pvc.knows, n)  # [K, N]
    newly = knows_new & ~knows_old
    cand_p = _attribute(knows_old, ev, n)  # [K, N]
    origin_sig = (ids[None, :] == subj[:, None]) | (
        decl[None, :]
        & (tgt[None, :] == subj[:, None])
        & (dkey[None, :] == keyv[:, None])
    )
    parent_new = torch.where(
        origin_sig, P_ORIGIN, torch.where(cand_p < n, cand_p, P_UNATTRIBUTED)
    )
    parent = torch.where(newly, parent_new, pvc.parent)
    first = torch.where(newly, tick, pvc.first)

    # -- resolution ------------------------------------------------------
    mx = torch.where(armed2[None, :], col, -1).amax(dim=0)  # [K]
    pend = armed2 & (slot[:, _C_RES] == RES_PENDING)
    res_new = torch.where(
        mx >= keyv + 7, RES_REFUTED, torch.where(mx >= keyv + 1, RES_CONFIRMED, RES_PENDING)
    ).to(i32)
    fire = pend & (res_new != RES_PENDING)
    slot = torch.cat([slot[:, :_C_RES], torch.where(fire, res_new, slot[:, _C_RES])[:, None]],
                     dim=1)
    tickv = torch.stack([tickv[:, 0], torch.where(fire, tick, tickv[:, 1])], dim=1)

    heard = knows_new.sum(dim=1, dtype=i32)
    return (
        ProvCarry(slot, tickv, wits, first, parent, bitpack.pack_bits(knows_new)),
        heard,
    )


def _host(x: Any) -> np.ndarray:
    """A plane as a host numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# host-side report
# ---------------------------------------------------------------------------


def _pct(times: np.ndarray, q: float) -> int:
    """All-int lower-percentile over a nonempty int array."""
    s = np.sort(times)
    idx = min(len(s) - 1, max(0, int(np.ceil(q * len(s))) - 1))
    return int(s[idx])


def build_report(
    pv_slot: Any,
    pv_tickv: Any,
    pv_wits: Any,
    pv_first: Any,
    pv_parent: Any,
    pv_knows: Any,
    n: int,
) -> dict[str, Any]:
    """The host-side provenance report from the final net's pv tensors.

    Per armed slot: the rumor identity, its causality chain, the full
    propagation tree (tick-ordered parent edges — a parent always heard
    strictly earlier, so one pass assigns depths), infection-time
    percentiles vs the paper's log2(N) bound, and straggler counts.
    Everything is an int (golden-pinnable)."""
    slot = _host(pv_slot)
    tickv = _host(pv_tickv).astype(np.int32)
    wits = _host(pv_wits)
    first = _host(pv_first).astype(np.int32)
    parent = _host(pv_parent)
    del pv_knows  # knows == (first >= 0) by construction
    log2n = int(np.ceil(np.log2(max(2, n))))
    rumors = []
    for j in range(slot.shape[0]):
        if slot[j, _C_SUBJ] < 0:
            continue
        fh = first[j]
        par = parent[j]
        heard = fh >= 0
        origin_tick = int(tickv[j, 0])
        times = (fh[heard] - origin_tick).astype(np.int64)
        # depth: process heard nodes in first_heard order; parents heard
        # strictly earlier (knows-at-start attribution), origins depth 0
        depth = np.full(n, -1, np.int64)
        for v in np.lexsort((np.arange(n), np.where(heard, fh, 1 << 30))):
            if not heard[v]:
                break
            p = par[v]
            if p == P_ORIGIN:
                depth[v] = 0
            elif p >= 0 and depth[p] >= 0:
                depth[v] = depth[p] + 1
        infected = int(heard.sum())
        rumors.append(
            {
                "slot": j,
                "subject": int(slot[j, _C_SUBJ]),
                "key": int(slot[j, _C_KEY]),
                "origin": int(slot[j, _C_ORG]),
                "origin_tick": origin_tick,
                "resolution": int(slot[j, _C_RES]),
                "resolution_tick": int(tickv[j, 1]),
                "witnesses": [int(w) for w in wits[j] if w >= 0],
                "infected": infected,
                "unheard": n - infected,
                "unattributed": int((par[heard] == P_UNATTRIBUTED).sum()),
                "depth_max": int(depth.max()) if infected else -1,
                "infection_p50": _pct(times, 0.50) if infected else -1,
                "infection_p95": _pct(times, 0.95) if infected else -1,
                "infection_p99": _pct(times, 0.99) if infected else -1,
                "stragglers": int((times > 2 * log2n).sum()),
                "first_heard": fh.tolist(),
                "parent": par.tolist(),
            }
        )
    return {"n": n, "log2_n": log2n, "rumors": rumors}


def summary_block(report: dict[str, Any]) -> dict[str, int]:
    """The all-int aggregate block ``library.incident_summary`` embeds
    (worst-case over rumors, so the pin catches any slot regressing)."""
    rs = report["rumors"]
    if not rs:
        return {"rumors": 0}
    return {
        "rumors": len(rs),
        "confirmed": sum(1 for r in rs if r["resolution"] == RES_CONFIRMED),
        "refuted": sum(1 for r in rs if r["resolution"] == RES_REFUTED),
        "infected_min": min(r["infected"] for r in rs),
        "infected_max": max(r["infected"] for r in rs),
        "depth_max": max(r["depth_max"] for r in rs),
        "p50_max": max(r["infection_p50"] for r in rs),
        "p95_max": max(r["infection_p95"] for r in rs),
        "p99_max": max(r["infection_p99"] for r in rs),
        "stragglers": sum(r["stragglers"] for r in rs),
        "unattributed": sum(r["unattributed"] for r in rs),
    }
