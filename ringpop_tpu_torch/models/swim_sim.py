"""Dense SWIM simulation in PyTorch: one protocol period for every node.

The port of ``ringpop_tpu/models/swim_sim.py`` (dense backend).  Node
i's view of the cluster is row i of dense [N, N] tensors, and one call
of ``swim_step_impl`` advances every node through one protocol period
(phases 0-6: probe selection, piggyback issue, ping delivery and
receiver merge, reply and full sync, ping-req relay, suspicion expiry).
The state layout, lattice, conventions and PRNG key schedule are the
JAX package's, so the two agree exactly, field by field and tick by
tick; the reference module's docstring documents the semantics.

State (6 bytes per (viewer, subject) pair): ``view_key`` int32, the
lattice key ``inc * 8 + status`` (0 = unknown); ``pb`` int8, the
piggyback count (-1 = no recorded change); ``suspect_left`` int8, the
suspicion countdown (-1 = no timer).

This slice is written functionally: every update makes new tensors and
nothing is updated in place.  The receiver merge runs through the CUDA
kernel of ``ops/recv_merge.py`` on the card.  Under a gossip ring
(``parallel/mesh.py``'s sharded entry points) the cross-row seams
``_receiver_merge``, ``_gather_rows``, ``_row_at``, ``_diag`` and
``_row_update`` run as the ring primitives of
``ops/gossip_remote_copy.py``, as the reference's do.

The fault-model arms are ported: directed link rules
(``NetState.link_*``: extra drop probability, per-link delay and
jitter), per-node protocol periods (``NetState.period``) and the static
``phase_mod`` stagger, and the in-flight claim buffer
(``ClusterState.pending``) that carries delayed claims across ticks.
Arms of the reference that are not ported yet raise
``NotImplementedError``: ``sparse_cap``, traced knobs, ``prov``,
damping, ``relay_full_sync`` and n > 32768 (the block-prefix
selection).
"""

from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ringpop_tpu_torch import prng, resolve_device
from ringpop_tpu_torch.ops import gossip_remote_copy as _grc
from ringpop_tpu_torch.ops.farmhash import mul32
from ringpop_tpu_torch.ops.recv_merge import recv_merge

# Status encoding: lattice rank == code (alive < suspect < faulty < leave).
NONE = 0
ALIVE = 1
SUSPECT = 2
FAULTY = 3
LEAVE = 4

STATUS_NAMES = {ALIVE: "alive", SUSPECT: "suspect", FAULTY: "faulty", LEAVE: "leave"}

INC_MAX = (1 << 27) - 1  # inc * 8 + status must fit int32

_M32 = 0xFFFFFFFF
# Largest row length whose selection prefix fits int16 (the small-n
# branch of the reference's _choose_targets_and_witnesses).
_SPARSE_SMALL_N = 32767


def _scoped(name: str):
    """Label a phase for ``torch.profiler`` traces (the reference's
    ``obs.annotate`` scopes, under the same names); a no-op cost of
    about a microsecond when no profiler runs."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


class SwimParams(NamedTuple):
    """Protocol constants, with the reference's fields and defaults."""

    period_ms: int = 200
    suspicion_ticks: int = 25
    piggyback_factor: int = 15
    ping_req_size: int = 3
    loss: float = 0.0
    damp_penalty: float = 500.0
    damp_suppress: float = 2500.0
    damp_reuse: float = 500.0
    damp_decay_per_tick: float = 0.5 ** (0.2 / 60.0)
    sparse_cap: int = 0
    probe: str = "sweep"
    relay_full_sync: bool = False
    phase_mod: int = 1


class ClusterState(NamedTuple):
    """Per-(viewer i, subject j) membership views + dissemination buffers."""

    view_key: torch.Tensor  # int32[N, N]
    pb: torch.Tensor  # int8[N, N]
    suspect_left: torch.Tensor  # int8[N, N]
    tick: torch.Tensor  # int32[]
    damp: torch.Tensor | None = None  # float16[N, N] (not ported)
    damped: torch.Tensor | None = None  # bool[N, N] (not ported)
    # The in-flight claim buffer for per-link delay: slot ``tick % D``
    # matures at the start of tick ``tick``; a claim row delayed by d
    # folds (lattice max) into slot ``(tick + d) % D`` at its receiver.
    # Its presence widens the per-tick key split to six; kill and revive
    # leave it alone (messages in flight still land).
    pending: torch.Tensor | None = None  # int32[D, N, N]

    @property
    def n(self) -> int:
        return self.view_key.shape[0]

    @property
    def view_status(self) -> torch.Tensor:
        """int8[N, N] status codes (NONE where the member is unknown)."""
        return (self.view_key & 7).to(torch.int8)

    @property
    def view_inc(self) -> torch.Tensor:
        """int32[N, N] relative incarnations (0 where unknown)."""
        return self.view_key >> 3


class NetState(NamedTuple):
    """The simulated network.  ``up``: the process exists; ``responsive``:
    it is scheduled (SIGSTOP analog); ``adj``: None (fully connected), a
    bool[N, N] mask, or an int32[N] group-id vector (connected iff same
    group).

    The fault model (all None unless installed): K directed link rules,
    a message from s to r being governed by every rule k with
    ``link_src[k, s] & link_dst[k, r]`` (extra drop probabilities
    compose as ``1 - prod(1 - link_p[k])``; delays take the maxima of
    ``link_d`` and of ``link_j`` over the hit rules, and act only with
    ``ClusterState.pending`` installed); ``period``, each node's
    protocol period (it initiates a probe once per ``period[i]`` ticks);
    ``ov_cnt``/``ov_gray``, the overload feedback state a scenario
    carries, which the step never reads."""

    up: torch.Tensor  # bool[N]
    responsive: torch.Tensor  # bool[N]
    adj: torch.Tensor | None = None
    link_src: torch.Tensor | None = None  # bool[K, N]
    link_dst: torch.Tensor | None = None  # bool[K, N]
    link_p: torch.Tensor | None = None  # float32[K]
    link_d: torch.Tensor | None = None  # int32[K]
    link_j: torch.Tensor | None = None  # int32[K]
    period: torch.Tensor | None = None  # int32[N] (int16 in a scenario's carry)
    ov_cnt: torch.Tensor | None = None  # int32[N]
    ov_gray: torch.Tensor | None = None  # bool[N]


def make_net(
    n: int, *, partitioned: bool = False, device: torch.device | str | None = None
) -> NetState:
    """Healthy network; ``partitioned=True`` materializes the mask."""
    dev = resolve_device(device)
    return NetState(
        up=torch.ones(n, dtype=torch.bool, device=dev),
        responsive=torch.ones(n, dtype=torch.bool, device=dev),
        adj=torch.ones((n, n), dtype=torch.bool, device=dev) if partitioned else None,
    )


def _check_inc(inc: torch.Tensor) -> None:
    if inc.numel() == 0:
        return
    lo, hi = int(inc.min()), int(inc.max())
    if lo < 0 or hi > INC_MAX:
        raise ValueError(
            f"relative incarnations must be in [0, {INC_MAX}] (got [{lo}, {hi}]); "
            "rebase against a larger base_inc"
        )


def init_state(
    n: int,
    inc: Any = None,
    *,
    mode: str = "converged",
    damping: bool = False,
    device: torch.device | str | None = None,
) -> ClusterState:
    """Fresh cluster state: ``mode='converged'`` (every node knows every
    node alive) or ``mode='self'`` (each node knows only itself)."""
    if damping:
        raise NotImplementedError("damping tensors are not ported yet")
    dev = resolve_device(device)
    if inc is None:
        inc = torch.zeros(n, dtype=torch.int32, device=dev)
    inc = torch.as_tensor(np.asarray(inc) if not torch.is_tensor(inc) else inc)
    inc = inc.to(device=dev, dtype=torch.int32)
    _check_inc(inc)
    alive_key = inc * 8 + ALIVE
    if mode == "converged":
        view_key = alive_key[None, :].expand(n, n).clone()
    elif mode == "self":
        eye = torch.eye(n, dtype=torch.bool, device=dev)
        view_key = torch.where(eye, alive_key[None, :], 0).to(torch.int32)
    else:
        raise ValueError(f"unknown init mode: {mode}")
    return ClusterState(
        view_key=view_key,
        pb=torch.full((n, n), -1, dtype=torch.int8, device=dev),
        suspect_left=torch.full((n, n), -1, dtype=torch.int8, device=dev),
        tick=torch.zeros((), dtype=torch.int32, device=dev),
    )


# ---------------------------------------------------------------------------
# lattice and small helpers
# ---------------------------------------------------------------------------


def _apply_mask(cur_key: torch.Tensor, in_key: torch.Tensor) -> torch.Tensor:
    """Does the incoming claim override the current view entry?  Key
    greater, except that a ``leave`` entry yields only to ``alive``, and a
    zero claim is no claim."""
    beats = in_key > cur_key
    leave_guard = ((cur_key & 7) == LEAVE) & ((in_key & 7) != ALIVE)
    return beats & ~leave_guard & (in_key > 0)


@_scoped("swim.view_hash")
def _view_hash(view_key: torch.Tensor) -> torch.Tensor:
    """Commutative per-node view digest: int64[N] holding uint32 (the
    full-sync trigger; uint32 products wrap via ``mul32``)."""
    k = view_key.to(torch.int64)
    h = mul32(k, 0x85EBCA6B) ^ (k >> 7)
    h = mul32(h ^ (h >> 13), 0xC2B2AE35)
    h = h ^ (h >> 16)
    idx = mul32(torch.arange(view_key.shape[0], device=view_key.device), 0x27D4EB2F)
    h = torch.where(view_key > 0, h ^ idx, 0)
    return h.sum(dim=1) & _M32


def _max_piggyback(status_ok: torch.Tensor, factor: int) -> torch.Tensor:
    """``factor * ceil(log10(server_count + 1))`` per node, clamped to 126."""
    x = status_ok.sum(dim=1, dtype=torch.int32) + 1
    digits = torch.zeros_like(x)
    p = 1
    for _ in range(10):
        digits = digits + (x > p).to(torch.int32)
        p *= 10
    return torch.clamp(factor * digits, max=126)


def sorted_all(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """Elementwise-sorted copies of up to 3 equal-shaped int tensors."""
    if len(xs) <= 1:
        return list(xs)
    if len(xs) == 2:
        a, b = xs
        return [torch.minimum(a, b), torch.maximum(a, b)]
    if len(xs) == 3:
        a, b, c = xs
        lo = torch.minimum(torch.minimum(a, b), c)
        hi = torch.maximum(torch.maximum(a, b), c)
        return [lo, a + b + c - lo - hi, hi]
    stacked = torch.sort(torch.stack(xs, dim=1), dim=1).values
    return list(stacked.unbind(1))


def _distinct_ranks(
    count: torch.Tensor, m: int, key: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``m`` distinct uniform ranks in ``[0, count)`` per row, by
    sequential shifted-uniform draws: (ranks int32[N, m], valid bool[N, m])."""
    n = count.shape[0]
    u = prng.uniform(key, (n, m), device=count.device)
    ranks: list[torch.Tensor] = []
    valids = []
    for t in range(m):
        space = torch.clamp(count - t, min=1)
        r = torch.minimum((u[:, t] * space.to(torch.float32)).to(torch.int32), space - 1)
        for taken in sorted_all(ranks):
            r = r + (r >= taken).to(torch.int32)
        ranks.append(r)
        valids.append(count > t)
    return torch.stack(ranks, dim=1), torch.stack(valids, dim=1)


def _choose_targets_and_witnesses(
    pingable: torch.Tensor, k: int, key: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe target + ``k`` ping-req witnesses per node, by exact rank
    located in one int16 row prefix (the small-n branch)."""
    n = pingable.shape[0]
    if n - 1 > _SPARSE_SMALL_N:
        raise NotImplementedError(
            f"n={n}: the block-prefix selection for n > {_SPARSE_SMALL_N + 1} "
            "is not ported yet"
        )
    count = pingable.sum(dim=1, dtype=torch.int32)
    ranks, valid = _distinct_ranks(count, k + 1, key)
    csum = torch.cumsum(pingable.to(torch.int16), dim=1, dtype=torch.int16)
    picks = []
    for t in range(k + 1):
        want = (ranks[:, t] + 1).to(torch.int16)
        hit = pingable & (csum == want[:, None])
        # argmax of an all-False row is 0, as in the reference
        picks.append(torch.argmax(hit.to(torch.uint8), dim=1))
    target = torch.where(valid[:, 0], picks[0], -1)
    return target, valid[:, 0], torch.stack(picks[1:], dim=1), valid[:, 1:]


def _drop(key: torch.Tensor, shape: tuple, loss: float, device: torch.device) -> torch.Tensor:
    """Per-message Bernoulli loss draw (True = dropped); no draw at 0."""
    if loss <= 0.0:
        return torch.zeros(shape, dtype=torch.bool, device=device)
    u = prng.uniform(key, shape, device=device)
    # float32 threshold made by a fill: a host tensor would be copied in
    # and wait for the card
    return u < torch.full((), loss, dtype=torch.float32, device=device)


def _link_hit_p(net: NetState, rows, cols) -> torch.Tensor:
    """float32 extra drop probability of the link rules at gathered
    (sender, receiver) index pairs: ``1 - prod_k(1 - p_k)`` over the
    rules hit.  The product runs in rule order, one float32 multiply a
    rule, so that every device rounds it alike."""
    hit = net.link_src[:, rows.long()] & net.link_dst[:, cols.long()]  # [K, *shape]
    one = torch.ones((), dtype=torch.float32, device=hit.device)
    keep = torch.ones(hit.shape[1:], dtype=torch.float32, device=hit.device)
    for k in range(hit.shape[0]):
        keep = keep * torch.where(hit[k], one - net.link_p[k], one)
    return one - keep


def _drop_net(
    key: torch.Tensor, shape: tuple, loss: float, net: NetState, rows, cols
) -> torch.Tensor:
    """``_drop`` composed with the link rules: one uniform draw per
    message against ``loss + (1 - loss) * p_link``.  With no rules it is
    ``_drop``, the same draw; with rules it always draws."""
    dev = rows.device
    if net.link_src is None:
        return _drop(key, shape, loss, dev)
    lp = _link_hit_p(net, rows, cols)
    base = torch.full((), loss, dtype=torch.float32, device=dev)
    # separate float32 ops, no fused multiply-add: the threshold rounds
    # as the reference's does
    thr = base + (1.0 - base) * lp
    return prng.uniform(key, shape, device=dev) < thr


def _link_delay_bounds(net: NetState, rows, cols) -> tuple[torch.Tensor, torch.Tensor]:
    """(base, jitter bound) int32 per message: the maxima over the rules
    hitting the pair (a rule out of its window has d = j = 0)."""
    shape = torch.broadcast_shapes(rows.shape, cols.shape)
    if net.link_d is None:
        z = torch.zeros(shape, dtype=torch.int32, device=rows.device)
        return z, z
    hit = net.link_src[:, rows.long()] & net.link_dst[:, cols.long()]
    lift = (-1,) + (1,) * (hit.dim() - 1)
    base = torch.where(hit, net.link_d.view(lift), 0).amax(dim=0)
    bound = torch.where(hit, net.link_j.view(lift), 0).amax(dim=0)
    return base.to(torch.int32), bound.to(torch.int32)


def _message_delay(net: NetState, key: torch.Tensor, rows, cols, shape: tuple) -> torch.Tensor:
    """int32 latency per message: the rule base plus a uniform draw in
    {0..jitter}; one draw per message whatever the rules' activity."""
    base, bound = _link_delay_bounds(net, rows, cols)
    u = prng.uniform(key, shape, device=rows.device)
    extra = torch.minimum((u * (bound + 1).to(torch.float32)).to(torch.int32), bound)
    return base + extra


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to the int32 two's-complement range (the
    wraparound of the reference's int32 arithmetic)."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def _sweep_divisor(phase_mod: int, per: torch.Tensor | None) -> torch.Tensor | int | None:
    """Per-node sweep-advance divisor for staggered protocol periods:
    the period row where one is installed, else ``phase_mod`` when it
    is above 1, else None (the lockstep form).  Both backends share it,
    so a row of P reproduces ``phase_mod = P`` on each."""
    if per is not None:
        return per
    if phase_mod > 1:
        return int(phase_mod)
    return None


def _stagger_send_gate(
    sends: torch.Tensor, tick: torch.Tensor, n: int, phase_mod: int,
    per: torch.Tensor | None,
) -> torch.Tensor:
    """Probe-initiation gate for staggered periods: node i initiates only
    on ticks with ``tick mod div == (i * 0x9E37) mod div``, the product
    wrapping in int32 as the reference's does (from i = 53 022 on)."""
    div = _sweep_divisor(phase_mod, per)
    if div is None:
        return sends
    ids = torch.arange(n, dtype=torch.int64, device=sends.device)
    phase = _wrap_i32(ids * 0x9E37) % div  # floored, as in the reference
    return sends & (tick % div == phase)


def _adj(net: NetState, rows, cols) -> torch.Tensor | bool:
    """Connectivity at gathered (rows, cols) index pairs: ``adj=None`` is
    all-connected (True), a 1-D ``adj`` is a group-id vector (connected
    iff same group), a 2-D one the bool[N, N] mask."""
    if net.adj is None:
        return True
    if net.adj.dim() == 1:
        return net.adj[rows] == net.adj[cols]
    return net.adj[rows, cols]


def _ids(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _on_ring() -> bool:
    """Is a gossip ring active (``parallel.mesh`` opens one around its
    sharded calls)?  Then the cross-row seams below run as the ring
    primitives of ``ops/gossip_remote_copy.py``; exact either way."""
    return _grc.active_ring() is not None


def _diag(plane: torch.Tensor) -> torch.Tensor:
    """``torch.diagonal(plane)``, routed like ``_row_at``."""
    if _on_ring():
        return _grc.ring_take_per_row(plane, _ids(plane.shape[0], plane.device))
    return torch.diagonal(plane)


def _row_at(plane: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """``plane[arange(N), col]``: viewer i's entry for column col[i]."""
    if _on_ring():
        return _grc.ring_take_per_row(plane, col)
    return plane[_ids(plane.shape[0], plane.device), col]


def _row_update(plane: torch.Tensor, col: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """A copy of ``plane`` with ``plane[i, col[i]] = values[i]``."""
    if _on_ring():
        return _grc.ring_update_per_row(plane, col, values)
    return plane.index_put((_ids(plane.shape[0], plane.device), col), values)


def _gather_rows(plane: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``plane[idx]`` for a member plane indexed across rows: ring hops
    under a gossip ring, a plain gather otherwise."""
    if _on_ring():
        return _grc.ring_fetch_rows(plane, idx)
    return plane.index_select(0, idx.long())


class _Merge(NamedTuple):
    state: ClusterState
    applied: torch.Tensor  # bool[N, N]
    refuted: torch.Tensor  # bool[N]


@_scoped("swim.merge_incoming")
def _merge_incoming(
    state: ClusterState,
    in_key: torch.Tensor,  # int32[N, N]: claim about j arriving at receiver r
    active: torch.Tensor,  # bool[N]: receiver r processes input this tick
    sl_start: int,
) -> _Merge:
    """Apply one batch of incoming changes at every receiver: refutation
    of rumors about self, then the override lattice; applied changes are
    recorded with piggyback count 0 and drive the suspicion timers."""
    n = state.n
    dev = in_key.device
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    cur_key = state.view_key
    # Refutation: only the diagonal can carry a rumor about self.
    in_self = torch.diagonal(in_key)
    self_status = in_self & 7
    refuted = active & ((self_status == SUSPECT) | (self_status == FAULTY))
    self_inc = _diag(cur_key) >> 3
    rumor_inc = torch.where(refuted, in_self >> 3, -1)
    new_self_inc = torch.maximum(self_inc, rumor_inc) + 1

    apply = _apply_mask(cur_key, in_key) & active[:, None] & ~eye
    view_key = torch.where(apply, in_key, cur_key)
    pb = torch.where(apply, 0, state.pb)

    ids = _ids(n, dev)
    diag_key = torch.where(refuted, new_self_inc * 8 + ALIVE, _diag(view_key))
    view_key = _row_update(view_key, ids, diag_key.to(torch.int32))
    pb = _row_update(pb, ids, torch.where(refuted, 0, _diag(pb)))

    applied = apply | (eye & refuted[:, None])
    new_status = view_key & 7
    suspect_left = torch.where(
        applied & (new_status == SUSPECT), sl_start, state.suspect_left
    )
    suspect_left = torch.where(applied & (new_status != SUSPECT), -1, suspect_left)
    return _Merge(
        state._replace(view_key=view_key, pb=pb, suspect_left=suspect_left),
        applied,
        refuted,
    )


def _declare(
    state: ClusterState,
    viewer_mask: torch.Tensor,  # bool[N]
    subject: torch.Tensor,  # int64[N]
    new_status: int,
    sl_start: int,
) -> tuple[ClusterState, torch.Tensor]:
    """Local declaration (makeSuspect / makeFaulty): viewer i re-labels
    ``subject[i]`` at its known incarnation where the lattice admits it."""
    n = state.n
    ids = _ids(n, state.view_key.device)
    subj = torch.clamp(subject, 0, n - 1)
    cur = _row_at(state.view_key, subj)
    in_key = torch.where(cur > 0, (cur >> 3) * 8 + new_status, 0)
    ok = viewer_mask & (subj != ids) & _apply_mask(cur, in_key)
    vk = _row_update(state.view_key, subj, torch.where(ok, in_key, cur))
    pb = _row_update(state.pb, subj, torch.where(ok, 0, _row_at(state.pb, subj)))
    sus = state.suspect_left
    if new_status == SUSPECT:
        sus = _row_update(sus, subj, torch.where(ok, sl_start, _row_at(sus, subj)))
    return state._replace(view_key=vk, pb=pb, suspect_left=sus), ok


# ---------------------------------------------------------------------------
# the protocol period
# ---------------------------------------------------------------------------


class _Selection(NamedTuple):
    gossiping: torch.Tensor  # bool[N]
    sends: torch.Tensor  # bool[N]
    t_safe: torch.Tensor  # int64[N]
    wit: torch.Tensor  # int64[N, k]
    wit_valid: torch.Tensor  # bool[N, k]
    maxpb8: torch.Tensor  # int8[N, 1]
    h_pre: torch.Tensor  # int64[N] (uint32 values)


def _validate_params(n: int, params: SwimParams) -> int:
    """Host-side int8-range guards; returns the suspicion countdown start."""
    if int(params.suspicion_ticks) > 126:
        raise ValueError(
            f"suspicion_ticks={params.suspicion_ticks} exceeds the int8 "
            "countdown range (max 126); raise period_ms instead"
        )
    max_digits = len(str(n))
    if int(params.piggyback_factor) * max_digits > 126:
        raise ValueError(
            f"piggyback_factor={params.piggyback_factor} can exceed the int8 "
            f"piggyback budget at n={n} (factor * {max_digits} digits > 126)"
        )
    return int(params.suspicion_ticks) + 1


def _check_supported(
    state: ClusterState, net: NetState, params: SwimParams, knobs: Any, prov: bool
) -> None:
    """Raise on every arm of the reference step this slice does not port."""
    if params.sparse_cap:
        raise NotImplementedError("sparse_cap > 0 (sparse dissemination) is not ported yet")
    if knobs is not None:
        raise NotImplementedError("traced SwimKnobs are not ported yet")
    if prov:
        raise NotImplementedError("prov=True (delivery evidence) is not ported yet")
    if state.damp is not None or state.damped is not None:
        raise NotImplementedError("damping tensors are not ported yet")
    if params.relay_full_sync:
        raise NotImplementedError("relay_full_sync=True is not ported yet")
    if state.n - 1 > _SPARSE_SMALL_N:
        raise NotImplementedError(
            f"n={state.n}: the block-prefix selection for n > "
            f"{_SPARSE_SMALL_N + 1} is not ported yet"
        )
    if params.probe not in ("sweep", "uniform"):
        raise ValueError(f"unknown probe policy: {params.probe!r}")


@_scoped("swim.phase01_select")
def _phase01_select(
    state: ClusterState, net: NetState, k_sel: torch.Tensor, params: SwimParams
) -> _Selection:
    """Phase 0 (derived views) + phase 1 (probe targets and witnesses)."""
    n = state.n
    dev = state.view_key.device
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    status = state.view_key & 7
    status_ok = (status == ALIVE) | (status == SUSPECT)
    pingable = status_ok & ~eye
    maxpb = _max_piggyback(status_ok, int(params.piggyback_factor))
    h_pre = _view_hash(state.view_key)
    own_status = _diag(status)
    gossiping = net.up & net.responsive & ((own_status == ALIVE) | (own_status == SUSPECT))
    if net.period is not None and params.phase_mod > 1:
        raise ValueError(
            "per-node periods (NetState.period, the gray-failure model) "
            "do not compose with the static phase_mod stagger: a row of "
            "P in the period tensor subsumes phase_mod=P exactly"
        )
    per = torch.clamp(net.period, min=1) if net.period is not None else None
    target, has_target, wit, wit_valid = _choose_targets_and_witnesses(
        pingable, params.ping_req_size, k_sel
    )
    if params.probe == "sweep":
        # deterministic rotation; the multiplier must be coprime to n
        mult = 0x9E37
        while math.gcd(mult, n) != 1:
            mult += 1
        start = (_ids(n, dev) * mult) % n
        # with staggered periods the sweep advances once per period
        div = _sweep_divisor(params.phase_mod, per)
        swept = (start + state.tick.to(torch.int64) // (1 if div is None else div)) % n
        ok = _row_at(pingable, swept)
        target = torch.where(ok, swept, target)
        has_target = has_target | ok
        wit_valid = wit_valid & (wit != target[:, None])
    sends = _stagger_send_gate(gossiping & has_target, state.tick, n, params.phase_mod, per)
    t_safe = torch.where(sends, target, 0)
    return _Selection(
        gossiping, sends, t_safe, wit, wit_valid, maxpb.to(torch.int8)[:, None], h_pre
    )


def _stage_issue(
    st: ClusterState, nserve: torch.Tensor, maxpb8: torch.Tensor
) -> tuple[ClusterState, torch.Tensor]:
    """One exchange stage's issue bookkeeping: a node serving ``nserve``
    requests issues its in-budget changes once, advances each issued
    counter by ``nserve``, and evicts past the budget (all int8)."""
    has = st.pb >= 0
    ns8 = torch.clamp(nserve, max=127).to(torch.int8)[:, None]
    issued = has & (ns8 > 0) & (st.pb + 1 <= maxpb8)
    served = has & (ns8 > 0)
    evict = served & (st.pb > maxpb8 - ns8)
    pb = torch.where(evict, -1, torch.where(served, st.pb + ns8, st.pb))
    return st._replace(pb=pb), issued


def _inbound_counts(t_safe: torch.Tensor, fwd_ok: torch.Tensor) -> torch.Tensor:
    """int32[N] delivered-ping count per receiver (sorted receivers and
    run bounds, no scatter)."""
    n = t_safe.shape[0]
    recv_sorted = torch.sort(torch.where(fwd_ok, t_safe, n)).values
    bounds = torch.searchsorted(recv_sorted, _ids(n + 1, t_safe.device))
    return (bounds[1:] - bounds[:-1]).to(torch.int32)


@_scoped("swim.recv_merge")
def _receiver_merge(
    t_safe: torch.Tensor, fwd_ok: torch.Tensor, claim_rows: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(in_key int32[N, N], inbound int32[N]): per-receiver lattice max of
    the delivered claim rows, and the delivered-ping count.  Under a
    gossip ring, the D-1-hop ring merge; otherwise the kernel."""
    if _on_ring():
        return _grc.ring_recv_merge(t_safe, fwd_ok, claim_rows)
    return recv_merge(t_safe, fwd_ok, claim_rows)


class _PingReq(NamedTuple):
    state: ClusterState
    failed: torch.Tensor  # bool[N]
    declare_suspect: torch.Tensor  # bool[N]
    declared: torch.Tensor  # bool[N]
    was_alive_at_target: torch.Tensor  # bool[N]
    changes_applied: torch.Tensor  # int32[]


@_scoped("swim.pingreq")
def _phase5_pingreq(
    state: ClusterState,
    net: NetState,
    k_loss3: torch.Tensor,
    sel: _Selection,
    ack: torch.Tensor,
    sl_start: int,
    params: SwimParams,
) -> _PingReq:
    """Phase 5: failed probes -> ping-req relay with the full piggyback
    exchange at all four hops (stages 5a-5d) -> suspect.

    The reference runs the exchange and each stage under ``lax.cond``;
    here they branch on the predicate on the host.  A skipped stage is a
    proven no-op, so both give the same values."""
    n = state.n
    dev = state.view_key.device
    ids = _ids(n, dev)
    resp = net.up & net.responsive
    t_safe = sel.t_safe
    failed = sel.sends & ~ack
    k_a, k_b, k_c, k_d = prng.split(k_loss3, 4)
    kk = params.ping_req_size
    kshape = (n, kk)
    loss = float(params.loss)
    wit_safe = torch.clamp(sel.wit, 0, n - 1)
    # hop deliveries: source->witness request, witness->target ping,
    # target->witness ack, witness->source response
    req_del = (
        failed[:, None]
        & sel.wit_valid
        & _adj(net, ids[:, None], wit_safe)
        & ~_drop_net(k_a, kshape, loss, net, ids[:, None], wit_safe)
        & resp[wit_safe]
    )
    ping_del = (
        req_del
        & _adj(net, wit_safe, t_safe[:, None])
        & ~_drop_net(k_b, kshape, loss, net, wit_safe, t_safe[:, None])
        & resp[t_safe][:, None]
    )
    ack_del = (
        ping_del
        & _adj(net, t_safe[:, None], wit_safe)
        & ~_drop_net(k_c, kshape, loss, net, t_safe[:, None], wit_safe)
    )
    resp_del = (
        req_del
        & _adj(net, wit_safe, ids[:, None])
        & ~_drop_net(k_d, kshape, loss, net, wit_safe, ids[:, None])
    )
    any_success = (ack_del & resp_del).any(dim=1)
    definite_fail = (req_del & ~ack_del & resp_del).any(dim=1)
    declare_suspect = failed & ~any_success & definite_fail
    maxpb8 = sel.maxpb8
    applied = torch.zeros((), dtype=torch.int32, device=dev)

    def slot_counts(recv_idx: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        total = torch.zeros(n, dtype=torch.int32, device=dev)
        for m in range(kk):
            total = total + _inbound_counts(recv_idx[:, m], masks[:, m])
        return total

    def stage_merge(st, applied, pred, build_in, active):
        if not bool(pred):
            return st, applied
        mrg = _merge_incoming(st, build_in(st), active, sl_start)
        return mrg.state, applied + mrg.applied.sum(dtype=torch.int32)

    # With no active change anywhere the whole exchange is a proven no-op.
    if bool(req_del.any() & (state.pb >= 0).any()):
        st = state
        # -- 5a: the ping-req body carries the source's changes
        nreq = (failed[:, None] & sel.wit_valid).sum(dim=1, dtype=torch.int32)
        st, issue_src = _stage_issue(st, nreq, maxpb8)
        deliv_src = issue_src & req_del.any(dim=1)[:, None]
        nsrv = slot_counts(wit_safe, req_del)

        def in_a(st2):
            claims_src = torch.where(issue_src, st2.view_key, 0)
            acc = torch.zeros((n, n), dtype=torch.int32, device=dev)
            for m in range(kk):
                slot_in, _ = _receiver_merge(
                    wit_safe[:, m],
                    req_del[:, m],
                    torch.where(req_del[:, m][:, None], claims_src, 0),
                )
                acc = torch.maximum(acc, slot_in)
            return acc

        st, applied = stage_merge(st, applied, issue_src.any(), in_a, nsrv > 0)

        # -- 5b: the witness relay-pings the target with its changes
        st, issue_wit = _stage_issue(st, nsrv, maxpb8)
        nping_del = slot_counts(wit_safe, ping_del)
        deliv_wit = issue_wit & (nping_del > 0)[:, None]
        ntgt = slot_counts(t_safe[:, None].expand(kshape), ping_del)

        def in_b(st2):
            claims_wit = torch.where(issue_wit, st2.view_key, 0)
            acc = torch.zeros((n, n), dtype=torch.int32, device=dev)
            for m in range(kk):
                slot_in, _ = _receiver_merge(
                    t_safe,
                    ping_del[:, m],
                    torch.where(
                        ping_del[:, m][:, None],
                        _gather_rows(claims_wit, wit_safe[:, m]),
                        0,
                    ),
                )
                acc = torch.maximum(acc, slot_in)
            return acc

        st, applied = stage_merge(st, applied, issue_wit.any(), in_b, ntgt > 0)

        # -- 5c: the target's ack carries its changes back
        st, issue_tgt = _stage_issue(st, ntgt, maxpb8)
        nwit_ack = slot_counts(wit_safe, ack_del)

        def in_c(st2):
            rows = _gather_rows(torch.where(issue_tgt, st2.view_key, 0), t_safe)
            acc = torch.zeros((n, n), dtype=torch.int32, device=dev)
            for m in range(kk):
                w_m = wit_safe[:, m]
                # anti-echo: drop claims equal to what the witness itself
                # delivered to this target in 5b
                echo = _gather_rows(deliv_wit, w_m) & (
                    rows == _gather_rows(st2.view_key, w_m)
                )
                send = torch.where(ack_del[:, m][:, None] & ~echo, rows, 0)
                slot_in, _ = _receiver_merge(w_m, ack_del[:, m], send)
                acc = torch.maximum(acc, slot_in)
            return acc

        st, applied = stage_merge(st, applied, issue_tgt.any(), in_c, nwit_ack > 0)

        # -- 5d: the witness response carries its (fresh) changes
        st, issue_wit2 = _stage_issue(st, nsrv, maxpb8)
        any_resp = resp_del.any(dim=1)

        def in_d(st2):
            claims_wit2 = torch.where(issue_wit2, st2.view_key, 0)
            acc = torch.zeros((n, n), dtype=torch.int32, device=dev)
            for m in range(kk):
                rows = _gather_rows(claims_wit2, wit_safe[:, m])
                echo = deliv_src & (rows == st2.view_key)
                acc = torch.maximum(
                    acc, torch.where(resp_del[:, m][:, None] & ~echo, rows, 0)
                )
            return acc

        st, applied = stage_merge(st, applied, issue_wit2.any(), in_d, any_resp)
        state = st

    # the declaration sees the post-exchange view
    was_alive_at_target = (state.view_key[ids, t_safe] & 7) == ALIVE
    state, declared = _declare(state, declare_suspect, t_safe, SUSPECT, sl_start)
    return _PingReq(state, failed, declare_suspect, declared, was_alive_at_target, applied)


@_scoped("swim.expiry")
def _phase6_expiry(
    state: ClusterState, gossiping: torch.Tensor
) -> tuple[ClusterState, torch.Tensor]:
    """Phase 6: suspicion countdowns fire -> faulty."""
    sl = state.suspect_left
    sl1 = torch.where(sl > 0, sl - 1, sl)
    expired = (sl1 == 0) & ((state.view_key & 7) == SUSPECT) & gossiping[:, None]
    vk = torch.where(expired, (state.view_key >> 3) * 8 + FAULTY, state.view_key)
    pb = torch.where(expired, 0, state.pb)
    sl1 = torch.where(expired, -1, sl1)
    return state._replace(view_key=vk, pb=pb, suspect_left=sl1), expired


def converged_impl(state: ClusterState, net: NetState) -> torch.Tensor:
    """Exact view agreement among live (gossiping) nodes: bool[]."""
    own = torch.diagonal(state.view_key) & 7
    live = net.up & net.responsive & ((own == ALIVE) | (own == SUSPECT))
    ref = torch.argmax(live.to(torch.uint8))
    row_same = (state.view_key == state.view_key[ref][None, :]).all(dim=1)
    return torch.where(live, row_same, True).all() | (live.sum() <= 1)


def swim_step_impl(
    state: ClusterState,
    net: NetState,
    key: torch.Tensor,
    params: SwimParams,
    knobs: Any = None,
    prov: bool = False,
) -> tuple[ClusterState, dict[str, torch.Tensor]]:
    """One synchronized protocol period for every virtual node.

    Phases: 1. probe-target + witness selection; 2. sender piggyback
    issue; 3. ping delivery + receiver merge; 4. receiver reply (+ full
    sync) + sender merge; 5. failed probes -> ping-req -> suspect;
    6. suspicion countdowns fire -> faulty.  Returns the new state and
    the reference's metrics, as int32[] tensors."""
    _check_supported(state, net, params, knobs, prov)
    n = state.n
    dev = state.view_key.device
    has_delay = state.pending is not None
    if has_delay:
        # the buffer's presence (not rule activity) widens the split: two
        # more streams draw the per-message jitter
        k_sel, k_loss1, k_loss2, k_loss3, k_j1, k_j2 = prng.split(key, 6)
    else:
        k_sel, k_loss1, k_loss2, k_loss3 = prng.split(key, 4)
    ids = _ids(n, dev)
    sl_start = _validate_params(n, params)
    loss = float(params.loss)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    # -- in-flight claims mature at the start of the tick
    mat_applied = zero
    if has_delay:
        state, mat_applied = _mature(state, net, sl_start)

    # -- phases 0-1: derived views + probe/witness selection
    sel = _phase01_select(state, net, k_sel, params)
    gossiping, sends, t_safe = sel.gossiping, sel.sends, sel.t_safe
    maxpb8, h_pre = sel.maxpb8, sel.h_pre

    # -- phase 2: sender issues its active changes (int8 throughout)
    bump = (state.pb >= 0) & sends[:, None]
    pb_next = torch.where(bump, state.pb + 1, state.pb)
    issued_s = bump & (pb_next <= maxpb8)
    pb_next = torch.where(bump & (pb_next > maxpb8), -1, pb_next)
    state = state._replace(pb=pb_next)

    # -- phase 3: delivery + receiver-side merge
    resp = net.up & net.responsive
    fwd_ok = (
        sends
        & _adj(net, ids, t_safe)
        & ~_drop_net(k_loss1, (n,), loss, net, ids, t_safe)
        & resp[t_safe]
    )
    delivered = issued_s & fwd_ok[:, None]
    if has_delay:
        # the ping itself lands in-tick (inbound counts every delivered
        # ping); the claims of a delayed link park in the buffer
        d3 = _message_delay(net, k_j1, ids, t_safe, (n,))
        dly3 = fwd_ok & (d3 > 0)
        imm3 = fwd_ok & ~dly3
        in_key, _ = _receiver_merge(
            t_safe, imm3, torch.where(issued_s & imm3[:, None], state.view_key, 0)
        )
        inbound = _inbound_counts(t_safe, fwd_ok)
        _park(state.pending, state.tick, d3, dly3, t_safe,
              torch.where(issued_s & dly3[:, None], state.view_key, 0))
    else:
        in_key, inbound = _receiver_merge(
            t_safe, fwd_ok, torch.where(delivered, state.view_key, 0)
        )
    got_ping = inbound > 0
    merged = _merge_incoming(state, in_key, got_ping, sl_start)
    state = merged.state
    ping_applied = merged.applied.sum(dtype=torch.int32)
    del in_key

    # -- phase 4: receiver replies; sender merges the ack
    has_change2 = state.pb >= 0
    rep_issuable = has_change2 & got_ping[:, None] & (state.pb + 1 <= maxpb8)
    inb8 = torch.clamp(inbound, max=127).to(torch.int8)[:, None]
    served = got_ping[:, None] & has_change2
    evict = served & (state.pb > maxpb8 - inb8)
    pb_after = torch.where(evict, -1, torch.where(served, state.pb + inb8, state.pb))
    state = state._replace(pb=pb_after)

    h_post = _view_hash(state.view_key)
    reply_key = _gather_rows(state.view_key, t_safe)
    rep_row = _gather_rows(rep_issuable, t_safe) & ~(
        delivered & (reply_key == state.view_key)
    )
    full_sync = fwd_ok & ~rep_row.any(dim=1) & (h_post[t_safe] != h_pre)
    send_row = torch.where(full_sync[:, None], reply_key > 0, rep_row)
    ack = (
        fwd_ok
        & _adj(net, t_safe, ids)
        & ~_drop_net(k_loss2, (n,), loss, net, t_safe, ids)
    )
    in2_key = torch.where(send_row & ack[:, None], reply_key, 0)
    del reply_key, rep_row, send_row
    if has_delay:
        # the reply claims ride the receiver->sender link; the ack itself
        # lands in-tick
        d4 = _message_delay(net, k_j2, t_safe, ids, (n,))
        dly4 = ack & (d4 > 0)
        imm4 = ack & ~dly4
        merged2 = _merge_incoming(state, torch.where(imm4[:, None], in2_key, 0), imm4, sl_start)
        _park(state.pending, state.tick, d4, dly4, ids, torch.where(dly4[:, None], in2_key, 0))
    else:
        merged2 = _merge_incoming(state, in2_key, ack, sl_start)
    state = merged2.state
    ack_applied = merged2.applied.sum(dtype=torch.int32)
    del in2_key, merged, merged2

    # -- phase 5: ping-req for failed probes
    pr = _phase5_pingreq(state, net, k_loss3, sel, ack, sl_start, params)
    state = pr.state

    # -- phase 6: suspicion countdowns fire -> faulty
    state, expired = _phase6_expiry(state, gossiping)

    state = state._replace(tick=state.tick + 1)
    metrics = {
        "pings_sent": sends.sum(dtype=torch.int32),
        "acks": ack.sum(dtype=torch.int32),
        "ping_changes_applied": ping_applied,
        "ack_changes_applied": ack_applied,
        "full_syncs": full_sync.sum(dtype=torch.int32),
        "ping_reqs": pr.failed.sum(dtype=torch.int32),
        "pingreq_changes_applied": pr.changes_applied,
        "suspects_declared": pr.declare_suspect.sum(dtype=torch.int32),
        "faulty_declared": expired.sum(dtype=torch.int32),
        "damped_pairs": zero,
        "relay_full_syncs": zero,
    }
    if has_delay:
        metrics["delayed_claims"] = dly3.sum(dtype=torch.int32) + dly4.sum(dtype=torch.int32)
        metrics["matured_applied"] = mat_applied
    return state, metrics


@_scoped("swim.mature")
def _mature(state: ClusterState, net: NetState, sl_start: int) -> tuple[ClusterState, torch.Tensor]:
    """Slot ``tick % D`` of the in-flight buffer lands at every up and
    responsive receiver, and is cleared (a stopped receiver's claims are
    lost).  Returns the state, with a buffer this step owns and writes
    in place from here on, and the applied count.

    The reference merges under ``lax.cond(any(slot > 0))``; here the
    merge runs every tick: a slot of zeros is no claim anywhere, so the
    merge then changes nothing and applies 0, without a host sync."""
    slot0 = (state.tick % state.pending.shape[0]).long().view(1)
    mature = state.pending.index_select(0, slot0)[0]
    pending = state.pending.clone()
    pending.index_fill_(0, slot0, 0)
    merged = _merge_incoming(state, mature, net.up & net.responsive, sl_start)
    return merged.state._replace(pending=pending), merged.applied.sum(dtype=torch.int32)


def _park(
    pending: torch.Tensor,
    tick: torch.Tensor,
    d: torch.Tensor,  # int32[N] per-sender delay
    dly: torch.Tensor,  # bool[N] the sender's message is delayed
    recv: torch.Tensor,  # [N] receiver per sender row
    rows: torch.Tensor,  # int32[N, N] claim rows, zero where not delayed
) -> None:
    """Fold delayed claim rows into slot ``(tick + d) % D`` at their
    receiver by the lattice max, in place.  The reference aims the rows
    that are not delayed at slot D and drops them; here they are aimed at
    slot D - 1, which is harmless: those rows are all zero and every
    buffered key is >= 0, so their max changes nothing."""
    dd, n = pending.shape[0], pending.shape[1]
    slot = torch.where(dly, (tick + d) % dd, dd - 1).long()
    idx = (slot * n + recv.long())[:, None].expand(-1, n)
    pending.view(dd * n, n).scatter_reduce_(0, idx, rows, "amax")


def swim_run_impl(
    state: ClusterState,
    net: NetState,
    key: torch.Tensor,
    params: SwimParams,
    ticks: int,
    knobs: Any = None,
) -> tuple[ClusterState, dict[str, torch.Tensor]]:
    """``ticks`` protocol periods on ``split(key, ticks)``; returns the
    last tick's metrics, as the reference's scan does."""
    if ticks < 1:
        raise ValueError(f"ticks must be >= 1, got {ticks}")
    metrics: dict[str, torch.Tensor] = {}
    for sub in prng.split(key, ticks):
        state, metrics = swim_step_impl(state, net, sub, params, knobs)
    return state, metrics


# ---------------------------------------------------------------------------
# host-side membership ops (join / leave / revive)
# ---------------------------------------------------------------------------


def admin_join(state: ClusterState, joiner: int, seed: int) -> ClusterState:
    """Bootstrap join against a seed: the seed marks the joiner alive and
    answers with a full sync; the joiner adopts it wholesale."""
    vk = state.view_key.clone()
    pb = state.pb.clone()
    j_key = vk[joiner, joiner].clone()
    in_key = (j_key >> 3) * 8 + ALIVE
    cur = vk[seed, joiner].clone()
    ok = _apply_mask(cur, in_key)
    vk[seed, joiner] = torch.where(ok, in_key, cur)
    pb[seed, joiner] = torch.where(ok, 0, pb[seed, joiner])

    row = vk[seed].clone()
    learned = (row > 0) & (torch.arange(state.n, device=vk.device) != joiner)
    vk[joiner] = torch.where(learned, row, vk[joiner])
    vk[joiner, joiner] = torch.where(j_key == 0, ALIVE, j_key)
    pb[joiner] = torch.where(learned, 0, pb[joiner])
    return state._replace(view_key=vk, pb=pb)


def admin_leave(state: ClusterState, node: int) -> ClusterState:
    """makeLeave(self): the node marks itself leave and records it."""
    vk = state.view_key.clone()
    pb = state.pb.clone()
    vk[node, node] = (vk[node, node] >> 3) * 8 + LEAVE
    pb[node, node] = 0
    return state._replace(view_key=vk, pb=pb)


def revive(state: ClusterState, node: int, inc: int) -> ClusterState:
    """A killed process restarts fresh: its row is wiped to self-only
    with a new incarnation; re-entry is an ``admin_join``."""
    _check_inc(torch.tensor([int(inc)]))
    if state.damp is not None:
        raise NotImplementedError("damping tensors are not ported yet")
    n = state.n
    dev = state.view_key.device
    vk = state.view_key.clone()
    pb = state.pb.clone()
    sl = state.suspect_left.clone()
    vk[node] = torch.where(
        torch.arange(n, device=dev) == node, int(inc) * 8 + ALIVE, 0
    ).to(torch.int32)
    pb[node] = -1
    sl[node] = -1
    return state._replace(view_key=vk, pb=pb, suspect_left=sl)
