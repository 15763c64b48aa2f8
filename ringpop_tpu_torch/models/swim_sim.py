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
So are the remaining step arms: sparse dissemination
(``SwimParams.sparse_cap``, ``_swim_step_sparse``), the block-prefix
lowerings that the selection and the sparse passes take for rows longer
than ``_SPARSE_SMALL_N`` (the block search runs on the row-searchsorted
kernel of ``ops/searchsorted.py``), flap damping (``init_state(damping=
True)``: the ``damp``/``damped`` planes) and the relay's full rows
(``SwimParams.relay_full_sync``).  The knob plane (``SwimKnobs``,
``knobs=``) is ported: the value-like params as host numbers with the
reference's dtypes applied, taking the reference's knob path at each
site where it differs from ``params._replace`` (``ping_req_size``
capacity-padded).
``prov=True`` adds the delivery-evidence bundle of the provenance plane
(``obs.provenance.EVIDENCE_KEYS``) to the metrics.  The one arm of the
reference that is not ported raises ``NotImplementedError``: the sparse
step under a gossip ring.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from ringpop_tpu_torch import prng, resolve_device
from ringpop_tpu_torch.obs.annotate import scoped as _scoped
from ringpop_tpu_torch.ops import gossip_remote_copy as _grc
from ringpop_tpu_torch.ops.farmhash import mul32
from ringpop_tpu_torch.ops.recv_merge import recv_merge
from ringpop_tpu_torch.ops.searchsorted import row_searchsorted

# Status encoding: lattice rank == code (alive < suspect < faulty < leave).
NONE = 0
ALIVE = 1
SUSPECT = 2
FAULTY = 3
LEAVE = 4

STATUS_NAMES = {ALIVE: "alive", SUSPECT: "suspect", FAULTY: "faulty", LEAVE: "leave"}

INC_MAX = (1 << 27) - 1  # inc * 8 + status must fit int32

_M32 = 0xFFFFFFFF
# Largest row length whose selection and sparse prefixes fit int16 (the
# small-n branches); longer rows take the block-prefix lowerings.  Tests
# lower it to force those at small n, as the reference's tests do.
_SPARSE_SMALL_N = 32767
_PREFIX_BLOCK = 64  # int8-safe inner prefix width (inner <= 64 < 127)


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


class SwimKnobs(NamedTuple):
    """The value-like ``SwimParams`` fields a run may override without a
    new program (``run_scenario(param_knobs=...)``, a sweep's
    ``param_axes``).  The reference traces them as device scalars so
    that one XLA program serves every value; the port has no compile to
    save, so each knob is a host number with the reference's dtype
    applied (``SWIM_KNOB_DTYPES``), and reading one never syncs.

    A knob takes the reference's knob path, which is not always the
    path of ``params._replace``: ``ping_req_size`` is capacity-padded
    (every draw keeps the static ``SwimParams.ping_req_size`` shape and
    witness slots at or above the knob's k are masked out).  The
    reference also builds the relay's full-sync machinery for every
    knob run and masks it by the 0/1 ``relay_full_sync``, and divides
    the sweep by a knob ``phase_mod`` of 1; both give the values of the
    knob-free path at those values, which is what the port runs.
    ``period_ms`` stays a param: it never enters the step."""

    suspicion_ticks: int  # countdown start is this + 1
    piggyback_factor: int
    phase_mod: int  # stagger divisor (1 = lockstep)
    relay_full_sync: int  # 0/1, dense only
    ping_req_size: int  # effective k <= the static capacity
    damp_penalty: float  # float32
    damp_decay_per_tick: float  # float32
    damp_suppress: float  # float16: compared against the f16 damp plane
    damp_reuse: float  # float16


# knob name -> the dtype the reference gives it (its consumption site's)
SWIM_KNOB_DTYPES = {
    "suspicion_ticks": np.int32,
    "piggyback_factor": np.int32,
    "phase_mod": np.int32,
    "relay_full_sync": np.int32,
    "ping_req_size": np.int32,
    "damp_penalty": np.float32,
    "damp_decay_per_tick": np.float32,
    "damp_suppress": np.float16,
    "damp_reuse": np.float16,
}


def swim_knob_values(params: SwimParams) -> dict[str, float | int]:
    """Host knob values implied by ``params``: what every knob a run does
    not override pins to."""
    return {
        "suspicion_ticks": int(params.suspicion_ticks),
        "piggyback_factor": int(params.piggyback_factor),
        "phase_mod": int(params.phase_mod),
        "relay_full_sync": int(bool(params.relay_full_sync)),
        "ping_req_size": int(params.ping_req_size),
        "damp_penalty": float(params.damp_penalty),
        "damp_decay_per_tick": float(params.damp_decay_per_tick),
        "damp_suppress": float(params.damp_suppress),
        "damp_reuse": float(params.damp_reuse),
    }


def check_knob_value(name: str, v: float | int, params: SwimParams) -> None:
    """Range guard for one knob value (the digit budgets also need ``n``:
    ``_validate_params`` checks those)."""
    if name == "suspicion_ticks" and not 0 <= int(v) <= 126:
        raise ValueError(
            f"suspicion_ticks knob {v} outside the int8 countdown "
            "range [0, 126]"
        )
    if name == "ping_req_size" and not 1 <= int(v) <= int(params.ping_req_size):
        raise ValueError(
            f"ping_req_size knob {v} outside the compiled capacity "
            f"[1, {params.ping_req_size}] (capacity-padded knob: raise "
            "SwimParams.ping_req_size to widen the compiled k_max)"
        )
    if name == "phase_mod" and int(v) < 1:
        raise ValueError(f"phase_mod knob must be >= 1, got {v}")
    if name == "relay_full_sync" and int(v) not in (0, 1):
        raise ValueError(f"relay_full_sync knob is 0/1, got {v}")
    if name == "piggyback_factor" and int(v) < 0:
        raise ValueError(f"piggyback_factor knob must be >= 0, got {v}")


def knob_cast(name: str, v: float | int) -> float | int:
    """``v`` as the host number of the knob's dtype: int32 knobs as ints,
    float32 and float16 knobs rounded through their type."""
    dt = np.dtype(SWIM_KNOB_DTYPES[name])
    return float(dt.type(v)) if dt.kind == "f" else int(dt.type(v))


def swim_knob_arrays(
    params: SwimParams, overrides: dict[str, float | int] | None = None
) -> SwimKnobs:
    """The knobs of one run: ``params``' values with ``overrides``
    (host numbers) in their place, each cast to its knob dtype.
    Unknown names and out-of-range values raise here."""
    vals = swim_knob_values(params)
    if overrides:
        bad = sorted(set(overrides) - set(vals))
        if bad:
            raise ValueError(
                f"unknown traced swim knob(s) {bad}; valid: {sorted(vals)}"
            )
        for k, v in overrides.items():
            check_knob_value(k, v, params)
            vals[k] = v
    return SwimKnobs(**{k: knob_cast(k, v) for k, v in vals.items()})


class ClusterState(NamedTuple):
    """Per-(viewer i, subject j) membership views + dissemination buffers."""

    view_key: torch.Tensor  # int32[N, N]
    pb: torch.Tensor  # int8[N, N]
    suspect_left: torch.Tensor  # int8[N, N]
    tick: torch.Tensor  # int32[]
    # flap damping (``init_state(damping=True)``): the per-pair penalty
    # score, and the hysteresis bit that quarantines a subject from the
    # viewer's ring
    damp: torch.Tensor | None = None  # float16[N, N]
    damped: torch.Tensor | None = None  # bool[N, N]
    # The in-flight claim buffer for per-link delay: slot ``tick % D``
    # matures at the start of tick ``tick``; a claim row delayed by d
    # folds (lattice max) into slot ``(tick + d) % D`` at its receiver.
    # Its presence widens the per-tick key split to six; kill and revive
    # leave it alone (messages in flight still land).
    pending: torch.Tensor | None = None  # int32[D, N, N]

    @property
    def n(self) -> int:
        """The member count (the columns: a rank of a process group's
        ring holds a block of the rows)."""
        return self.view_key.shape[1]

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
    carries, ``po_*``, the remediation policy's carry (pressure,
    shed and quarantine flags, the amplification window rings and the
    retry cap), and ``pv_*``, the provenance plane's (``obs.provenance``:
    the K tracked-rumor slots, their origin and resolution ticks, the
    origin's witness sets, the first_heard and parent planes and the
    packed knows words), none of which the step reads: they live on the
    net so that checkpoints and a streamed resume continue them
    exactly."""

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
    po_press: torch.Tensor | None = None  # int32[N]
    po_shed: torch.Tensor | None = None  # bool[N]
    po_quar: torch.Tensor | None = None  # bool[N]
    po_sends_w: torch.Tensor | None = None  # int32[W]
    po_deliv_w: torch.Tensor | None = None  # int32[W]
    po_retry_cap: torch.Tensor | None = None  # int32 scalar
    pv_slot: torch.Tensor | None = None  # int32[K, 4]
    pv_tickv: torch.Tensor | None = None  # int16[K, 2]
    pv_wits: torch.Tensor | None = None  # int32[K, ping_req_size]
    pv_first: torch.Tensor | None = None  # int16[K, N]
    pv_parent: torch.Tensor | None = None  # int32[K, N]
    pv_knows: torch.Tensor | None = None  # int64[K, ceil(N/32)] packed words


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


# audit: allow=RPL001 the start incarnations' range check, once at init
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
    node alive) or ``mode='self'`` (each node knows only itself);
    ``damping=True`` adds the zeroed damping planes."""
    dev = resolve_device(device)
    if inc is None:
        inc = torch.zeros(n, dtype=torch.int32, device=dev)
    inc = torch.as_tensor(np.asarray(inc) if not torch.is_tensor(inc) else inc, device=dev)
    inc = inc.to(dtype=torch.int32)
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
        damp=torch.zeros((n, n), dtype=torch.float16, device=dev) if damping else None,
        damped=torch.zeros((n, n), dtype=torch.bool, device=dev) if damping else None,
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


# Elements of a row block that ``_view_hash`` widens to int64 at once
# (512 MiB per temporary): the digest of an [N, N] view never builds an
# int64 [N, N] tensor (13.4 GB at n = 40 960).
_HASH_CHUNK = 1 << 26


@_scoped("swim.view_hash")
def _view_hash(view_key: torch.Tensor) -> torch.Tensor:
    """Commutative per-node view digest: int64[N] holding uint32 (the
    full-sync trigger; uint32 products wrap via ``mul32``), over blocks
    of rows so that the int64 temporaries stay bounded."""
    rows, n = view_key.shape
    idx = mul32(torch.arange(n, dtype=torch.int64, device=view_key.device), 0x27D4EB2F)
    step = max(1, _HASH_CHUNK // max(n, 1))
    out = []
    for lo in range(0, rows, step):
        vk = view_key[lo : lo + step]
        k = vk.to(torch.int64)
        h = mul32(k, 0x85EBCA6B) ^ (k >> 7)
        h = mul32(h ^ (h >> 13), 0xC2B2AE35)
        h = h ^ (h >> 16)
        out.append(torch.where(vk > 0, h ^ idx, 0).sum(dim=1))
    if not out:
        return torch.zeros(0, dtype=torch.int64, device=view_key.device)
    return torch.cat(out) & _M32


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
    u = _uniform_rows(key, (n, m), count.device)
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


def _block_prefix(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-level row prefix of a bool [N, M] mask: ``(mb, inner, offs)``,
    the mask False-padded to a multiple of ``_PREFIX_BLOCK`` and viewed
    as [N, nb, B], the inclusive int8 prefix within each block, and the
    exclusive int32 offset of each block [N, nb].  The inclusive prefix
    of (i, j) is ``offs[i, j // B] + inner[i, j // B, j % B]``."""
    b = _PREFIX_BLOCK
    rows, m = mask.shape
    pad = (-m) % b
    if pad:
        mask = torch.cat([mask, torch.zeros((rows, pad), dtype=torch.bool, device=mask.device)], 1)
    mb = mask.reshape(rows, -1, b)
    inner = torch.cumsum(mb.to(torch.int8), dim=2, dtype=torch.int8)
    block_tot = inner[:, :, -1].to(torch.int32)
    offs = torch.cumsum(block_tot, dim=1, dtype=torch.int32) - block_tot
    return mb, inner, offs


def _choose_targets_and_witnesses(
    pingable: torch.Tensor, k: int, key: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe target + ``k`` ping-req witnesses per node, by exact rank:
    located in one int16 row prefix up to ``_SPARSE_SMALL_N``, else in
    the block prefix (the block by the row-searchsorted kernel over the
    block offsets, the column by a compare-count inside the gathered
    int8 block), the same picks bit for bit."""
    n = pingable.shape[1]
    count = pingable.sum(dim=1, dtype=torch.int32)
    ranks, valid = _distinct_ranks(count, k + 1, key)
    if n - 1 <= _SPARSE_SMALL_N:
        csum = torch.cumsum(pingable.to(torch.int16), dim=1, dtype=torch.int16)
        picks = []
        for t in range(k + 1):
            want = (ranks[:, t] + 1).to(torch.int16)
            hit = pingable & (csum == want[:, None])
            # argmax of an all-False row is 0, as in the reference
            picks.append(torch.argmax(hit.to(torch.uint8), dim=1))
        del csum
        target = torch.where(valid[:, 0], picks[0], -1)
        return target, valid[:, 0], torch.stack(picks[1:], dim=1), valid[:, 1:]
    b = _PREFIX_BLOCK
    _, inner, offs = _block_prefix(pingable)
    want = (ranks + 1).contiguous()  # int32 [N, k + 1], 1-based inclusive
    blk = row_searchsorted(offs, want, side="left") - 1
    blk = torch.clamp(blk, 0, offs.shape[1] - 1).long()
    residual = want - torch.gather(offs, 1, blk)  # 1..64 where valid
    # gather the int8 blocks first and widen the [N, k + 1, B] slice after
    inner_blk = torch.gather(inner, 1, blk[:, :, None].expand(-1, -1, b)).to(torch.int32)
    del inner, offs
    within = (inner_blk < residual[:, :, None]).sum(dim=2)  # a left search
    # invalid ranks (masked by ``valid``) would index past the row; clamp
    picks_all = torch.clamp(blk * b + within, max=n - 1)
    target = torch.where(valid[:, 0], picks_all[:, 0], -1)
    return target, valid[:, 0], picks_all[:, 1:], valid[:, 1:]


def _drop(key: torch.Tensor, shape: tuple, loss: float, device: torch.device) -> torch.Tensor:
    """Per-message Bernoulli loss draw (True = dropped); no draw at 0."""
    if loss <= 0.0:
        return torch.zeros(shape, dtype=torch.bool, device=device)
    u = _uniform_rows(key, shape, device)
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
    return _uniform_rows(key, shape, dev) < thr


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
    u = _uniform_rows(key, shape, rows.device)
    extra = torch.minimum((u * (bound + 1).to(torch.float32)).to(torch.int32), bound)
    return base + extra


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to the int32 two's-complement range (the
    wraparound of the reference's int32 arithmetic)."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def _sweep_divisor(
    phase_mod: int, per: torch.Tensor | None
) -> torch.Tensor | int | None:
    """Per-node sweep-advance divisor for staggered protocol periods:
    the period row where one is installed, else ``phase_mod`` when it
    is above 1, else None (the lockstep form; the reference's knob path
    divides by a knob of 1 instead, which gives the same values).  Both backends share it, so a row of P
    reproduces ``phase_mod = P`` on each."""
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
    ids = _row_ids(sends.shape[0], sends.device)
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
    if _grc.active_rank() is not None:
        # a rank holds its rows of the mask: other rows come over the ring
        return _grc.ring_take_at(net.adj, rows, cols)
    return net.adj[rows, cols]


def _ids(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# this process's rows.  On a process group's ring (``parallel.make_mesh(
# group=...)``) a rank holds a block of the rows of every [N, N] plane and
# the [N] vectors whole, and the step runs on its block: each read across
# rows is a ring primitive or one of the ring's collectives
# (``ring_allgather``, ``ring_sum``), the identity anywhere else, where the
# helpers below give the whole.
# ---------------------------------------------------------------------------


def _rank_off(rows: int) -> int:
    """The global id of this process's first row."""
    rk = _grc.active_rank()
    return 0 if rk is None else rk[0] * rows


def _row_ids(rows: int, device: torch.device) -> torch.Tensor:
    """int64[rows]: the global ids of this process's rows."""
    off = _rank_off(rows)
    return torch.arange(off, off + rows, dtype=torch.int64, device=device)


def _own(x: torch.Tensor) -> torch.Tensor:
    """This process's rows of a replicated [N, ...] vector."""
    rk = _grc.active_rank()
    if rk is None:
        return x
    rows = x.shape[0] // rk[1]
    return x[rk[0] * rows:(rk[0] + 1) * rows]


def _eye(rows: int, n: int, device: torch.device) -> torch.Tensor:
    """bool[rows, n]: the self entries of this process's rows."""
    if _grc.active_rank() is None:
        return torch.eye(n, dtype=torch.bool, device=device)
    return _row_ids(rows, device)[:, None] == _ids(n, device)[None, :]


def _uniform_rows(key: torch.Tensor, shape: tuple, device: torch.device) -> torch.Tensor:
    """``prng.uniform(key, shape)`` with ``shape[0]`` this process's
    rows: a rank draws the whole [N, ...] and keeps its rows, the same
    numbers in either threefry mode."""
    rk = _grc.active_rank()
    if rk is None:
        return prng.uniform(key, shape, device=device)
    rows = shape[0]
    u = prng.uniform(key, (rows * rk[1], *shape[1:]), device=device)
    return u[rk[0] * rows:(rk[0] + 1) * rows]


def _on_ring() -> bool:
    """Is a gossip ring active (``parallel.mesh`` opens one around its
    sharded calls)?  Then the cross-row seams below run as the ring
    primitives of ``ops/gossip_remote_copy.py``; exact either way."""
    return _grc.active_ring() is not None


def _diag(plane: torch.Tensor) -> torch.Tensor:
    """``torch.diagonal(plane)``, routed like ``_row_at``."""
    if _on_ring():
        return _grc.ring_take_per_row(plane, _row_ids(plane.shape[0], plane.device))
    return torch.diagonal(plane)


def _row_at(plane: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """``plane[arange(N), col]``: viewer i's entry for column col[i]."""
    if _on_ring():
        return _grc.ring_take_per_row(plane, col)
    return plane[_ids(plane.shape[0], plane.device), col]


def _row_update(
    plane: torch.Tensor, col: torch.Tensor, values: torch.Tensor, op: str = "set"
) -> torch.Tensor:
    """A copy of ``plane`` with ``plane[i, col[i]]`` set to ``values[i]``
    (``op="set"``) or raised to it (``op="max"``)."""
    if _on_ring():
        return _grc.ring_update_per_row(plane, col, values, op=op)
    ids = _ids(plane.shape[0], plane.device)
    if op == "max":
        values = torch.maximum(plane[ids, col], values.to(plane.dtype))
    elif op != "set":
        raise ValueError(f"op={op!r}: set|max")
    return plane.index_put((ids, col), values)


def _row_update_owned(
    plane: torch.Tensor, col: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """``_row_update`` of a plane the caller made and owns: written in
    place (no [N, N] copy) unless a gossip ring routes the update."""
    if _on_ring():
        return _grc.ring_update_per_row(plane, col, values)
    return plane.index_put_((_ids(plane.shape[0], plane.device), col), values)


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
    flapped: torch.Tensor | None  # bool[N, N] with damping planes, else None


def _or(a: torch.Tensor | None, b: torch.Tensor | None) -> torch.Tensor | None:
    """Union of two flap masks, None standing for all-False."""
    if a is None:
        return b
    return a if b is None else a | b


@_scoped("swim.merge_incoming")
def _merge_incoming(
    state: ClusterState,
    in_key: torch.Tensor,  # int32[N, N]: claim about j arriving at receiver r
    active: torch.Tensor,  # bool[N]: receiver r processes input this tick
    sl_start: int,
) -> _Merge:
    """Apply one batch of incoming changes at every receiver: refutation
    of rumors about self, then the override lattice; applied changes are
    recorded with piggyback count 0 and drive the suspicion timers.
    With damping planes, ``flapped`` marks the applied transitions
    between alive and suspect/faulty (either way)."""
    n = state.n
    rows = in_key.shape[0]
    dev = in_key.device
    eye = _eye(rows, n, dev)
    cur_key = state.view_key
    # Refutation: only the diagonal can carry a rumor about self.
    in_self = torch.diagonal(in_key, _rank_off(rows))
    self_status = in_self & 7
    refuted = active & ((self_status == SUSPECT) | (self_status == FAULTY))
    self_inc = _diag(cur_key) >> 3
    rumor_inc = torch.where(refuted, in_self >> 3, -1)
    new_self_inc = torch.maximum(self_inc, rumor_inc) + 1

    apply = _apply_mask(cur_key, in_key) & active[:, None] & ~eye
    flapped = None
    if state.damp is not None:
        was = cur_key & 7
        in_status = in_key & 7
        flapped = apply & (
            ((was == ALIVE) & ((in_status == SUSPECT) | (in_status == FAULTY)))
            | (((was == SUSPECT) | (was == FAULTY)) & (in_status == ALIVE))
        )
    view_key = torch.where(apply, in_key, cur_key)
    pb = torch.where(apply, 0, state.pb)

    ids = _row_ids(rows, dev)
    diag_key = torch.where(refuted, new_self_inc * 8 + ALIVE, _diag(view_key))
    # both planes are this merge's own new tensors: written in place
    view_key = _row_update_owned(view_key, ids, diag_key.to(torch.int32))
    pb = _row_update_owned(pb, ids, torch.where(refuted, 0, _diag(pb)))

    applied = apply | (eye & refuted[:, None])
    del apply, eye
    is_suspect = (view_key & 7) == SUSPECT
    suspect_left = torch.where(applied & is_suspect, sl_start, state.suspect_left)
    suspect_left = torch.where(applied & ~is_suspect, -1, suspect_left)
    return _Merge(
        state._replace(view_key=view_key, pb=pb, suspect_left=suspect_left),
        applied,
        refuted,
        flapped,
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
    ids = _row_ids(state.view_key.shape[0], state.view_key.device)
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


def _validate_params(
    n: int, params: SwimParams, knob_values: dict[str, Any] | None = None
) -> int:
    """Host-side int8-range guards; returns the suspicion countdown start.

    ``knob_values`` maps a knob name to every value it will take (one
    for a run, a sweep's whole axis): the budgets must hold at the
    axis maximum, so each value is checked and the error names the
    replica whose value broke them."""
    sus_vals = [(int(params.suspicion_ticks), None)]
    fac_vals = [(int(params.piggyback_factor), None)]
    if knob_values:
        if "suspicion_ticks" in knob_values:
            sus_vals = [(int(v), i) for i, v in enumerate(knob_values["suspicion_ticks"])]
        if "piggyback_factor" in knob_values:
            fac_vals = [(int(v), i) for i, v in enumerate(knob_values["piggyback_factor"])]

    def where(i):
        return "" if i is None else f" (param_axes replica {i})"

    for v, i in sus_vals:
        if v > 126:
            raise ValueError(
                f"suspicion_ticks={v}{where(i)} exceeds the int8 "
                "countdown range (max 126); raise period_ms instead"
            )
    # the digit count maxes at len(str(n))
    max_digits = len(str(n))
    for v, i in fac_vals:
        if v * max_digits > 126:
            raise ValueError(
                f"piggyback_factor={v}{where(i)} can exceed the "
                f"int8 piggyback budget at n={n} "
                f"(factor * {max_digits} digits > 126)"
            )
    return int(params.suspicion_ticks) + 1


def _check_supported(
    state: ClusterState, net: NetState, params: SwimParams, knobs: Any, prov: bool
) -> None:
    """The reference step's own refusals, then every arm this port does
    not carry."""
    if params.sparse_cap:
        if knobs is not None:
            raise ValueError(
                "sparse_cap selects the sparse-dissemination program, "
                "which keeps its knobs compile-time; run knob sweeps "
                "with sparse_cap=0"
            )
        if state.pending is not None:
            raise NotImplementedError(
                "sparse_cap does not compose with the latency model "
                "(ClusterState.pending); run delay scenarios dense"
            )
        if prov:
            raise NotImplementedError(
                "the provenance plane needs the dense delivery evidence; "
                "run traced scenarios with sparse_cap=0"
            )
        if _on_ring():
            raise NotImplementedError(
                "the sharded sparse step is not ported: its claim lists and "
                "point merges are plain row gathers and scatters that the "
                "reference leaves to XLA's partitioner, with no ring seam "
                "to route them through; run sparse_cap unsharded"
            )
        if state.damp is not None:
            raise NotImplementedError("sparse_cap does not support damping tensors")
    if _grc.active_rank() is not None:
        arms = (
            ("flap damping (ClusterState.damp)", state.damp is not None),
            ("the delay buffer (ClusterState.pending)", state.pending is not None),
            ("link rules (NetState.link_*)", net.link_src is not None),
            ("gray periods (NetState.period)", net.period is not None),
            ("phase_mod > 1", params.phase_mod > 1),
            ("relay_full_sync", bool(params.relay_full_sync)),
            ("knob runs (SwimKnobs)", knobs is not None),
            ("the provenance plane (prov=True)", prov),
        )
        for what, present in arms:
            if present:
                raise NotImplementedError(
                    f"{what} on a process group's ring is not ported (ROADMAP.md queue 1 "
                    "item 11); run it on the one-process mesh, make_mesh(devices=[device] * D)"
                )
    if net.period is not None and params.phase_mod > 1:
        raise ValueError(
            "per-node periods (NetState.period, the gray-failure model) "
            "do not compose with the static phase_mod stagger: a row of "
            "P in the period tensor subsumes phase_mod=P exactly"
        )
    if params.probe not in ("sweep", "uniform"):
        raise ValueError(f"unknown probe policy: {params.probe!r}")


@_scoped("swim.phase01_select")
def _phase01_select(
    state: ClusterState, net: NetState, k_sel: torch.Tensor, params: SwimParams,
    knobs: SwimKnobs | None = None,
) -> _Selection:
    """Phase 0 (derived views) + phase 1 (probe targets and witnesses)."""
    n = state.n
    rows = state.view_key.shape[0]
    dev = state.view_key.device
    eye = _eye(rows, n, dev)
    status = state.view_key & 7
    status_ok = (status == ALIVE) | (status == SUSPECT)
    pingable = status_ok & ~eye
    kn = params if knobs is None else knobs
    maxpb = _max_piggyback(status_ok, int(kn.piggyback_factor))
    h_pre = _view_hash(state.view_key)
    own_status = _diag(status)
    gossiping = _own(net.up & net.responsive) & ((own_status == ALIVE) | (own_status == SUSPECT))
    per = torch.clamp(net.period, min=1) if net.period is not None else None
    target, has_target, wit, wit_valid = _choose_targets_and_witnesses(
        pingable, params.ping_req_size, k_sel
    )
    if knobs is not None:
        # capacity-padded: the selection (and every phase-5 draw) keeps
        # the static k; witness slots at or above the knob's k drop out
        wit_valid = wit_valid & (
            torch.arange(params.ping_req_size, device=dev)[None, :] < knobs.ping_req_size
        )
    if params.probe == "sweep":
        # deterministic rotation; the multiplier must be coprime to n
        mult = 0x9E37
        while math.gcd(mult, n) != 1:
            mult += 1
        start = (_row_ids(rows, dev) * mult) % n
        # with staggered periods the sweep advances once per period
        div = _sweep_divisor(kn.phase_mod, per)
        swept = (start + state.tick.to(torch.int64) // (1 if div is None else div)) % n
        ok = _row_at(pingable, swept)
        target = torch.where(ok, swept, target)
        has_target = has_target | ok
        wit_valid = wit_valid & (wit != target[:, None])
    sends = _stagger_send_gate(gossiping & has_target, state.tick, n, kn.phase_mod, per)
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


def _claim_rows(view_key: torch.Tensor, issued: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``where(issued, view_key, 0)[idx]``: the issued claims of the rows
    ``idx``, gathered first and masked in place (no [N, N] claim plane
    beside the gathered rows)."""
    rows = _gather_rows(view_key, idx)
    return rows.masked_fill_(~_gather_rows(issued, idx), 0)


def _max_into(acc: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor:
    """The lattice max of ``acc`` and ``x``, in place in ``acc``; None
    (nothing yet) takes ``x`` itself (claims are >= 0, so an all-zero
    start changes nothing).  Both are the caller's own tensors."""
    if acc is None:
        return x
    return torch.maximum(acc, x, out=acc)


def _inbound_counts(
    t_safe: torch.Tensor, fwd_ok: torch.Tensor, n: int | None = None
) -> torch.Tensor:
    """int32[n] delivered-ping count per receiver (sorted receivers and
    run bounds, no scatter); ``n`` defaults to the senders' count."""
    n = t_safe.shape[0] if n is None else n
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


class _Handoff:
    """A state passed with its only reference: the callee takes it out,
    so that the caller's reference does not keep it alive through the
    call (at n = 40 960 a dense state is 10 GB)."""

    __slots__ = ("state",)

    def __init__(self, state: ClusterState):
        self.state = state

    def take(self) -> ClusterState:
        state, self.state = self.state, None
        return state


class _PingReq(NamedTuple):
    state: ClusterState
    failed: torch.Tensor  # bool[N]
    declare_suspect: torch.Tensor  # bool[N]
    declared: torch.Tensor  # bool[N]
    was_alive_at_target: torch.Tensor  # bool[N]
    changes_applied: torch.Tensor  # int32[]
    flapped: torch.Tensor | None  # bool[N, N] exchange flaps (damping), else None
    relay_full_syncs: torch.Tensor  # int32[] 5c full rows (relay_full_sync)
    hops: tuple  # bool[N, kk] x 4: the 5a-5d hop deliveries (req, ping, ack, resp)


@_scoped("swim.pingreq")
def _phase5_pingreq(
    hand: _Handoff,
    net: NetState,
    k_loss3: torch.Tensor,
    sel: _Selection,
    ack: torch.Tensor,
    sl_start: int,
    params: SwimParams,
    knobs: SwimKnobs | None = None,
) -> _PingReq:
    """Phase 5: failed probes -> ping-req relay with the full piggyback
    exchange at all four hops (stages 5a-5d) -> suspect.  With
    ``params.relay_full_sync``, stage 5c answers a witness with the
    target's whole row when the target has nothing non-echo to issue to
    it but its post-5b view hash differs from the witness's period-start
    hash (the phase-4 full-sync rule at the relay hop).  With knobs the
    0/1 ``relay_full_sync`` knob takes the flag's place (the reference
    builds the machinery for every knob run and zeroes its slots at 0,
    which gives the values of not building it).

    The reference runs the exchange and each stage under ``lax.cond``;
    here they branch on the predicate on the host.  A skipped stage is a
    proven no-op, so both give the same values."""
    state = hand.take()
    n = state.n
    nrows = state.view_key.shape[0]
    dev = state.view_key.device
    ids = _row_ids(nrows, dev)
    resp = net.up & net.responsive
    t_safe = sel.t_safe
    failed = sel.sends & ~ack
    k_a, k_b, k_c, k_d = prng.split(k_loss3, 4)
    kk = params.ping_req_size
    kshape = (nrows, kk)
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
    relay_fs = torch.zeros((), dtype=torch.int32, device=dev)
    flaps: list[torch.Tensor | None] = [None]

    def slot_counts(recv_idx: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        # a rank counts its senders' pings at every receiver, the ring sums
        # the counts, and the rank keeps its own receivers'
        total = torch.zeros(n, dtype=torch.int32, device=dev)
        for m in range(kk):
            total = total + _inbound_counts(recv_idx[:, m], masks[:, m], n)
        return _own(_grc.ring_sum(total))

    def stage_merge(st, applied, pred, build_in, active):
        if not bool(_grc.ring_sum(pred)):
            return st, applied
        mrg = _merge_incoming(st, build_in(st), active, sl_start)
        flaps[0] = _or(flaps[0], mrg.flapped)
        return mrg.state, applied + mrg.applied.sum(dtype=torch.int32)

    build_fs = bool(params.relay_full_sync if knobs is None else knobs.relay_full_sync)

    # With no active change anywhere the whole exchange is a proven no-op;
    # under relay_full_sync it is not (a diverged but quiet target must
    # still answer full rows).
    if build_fs:
        xch_pred = _grc.ring_sum(req_del.any())
    else:
        # each any() over every rank before the and
        xch_pred = _grc.ring_sum(torch.stack([req_del.any(), (state.pb >= 0).any()])).all()
    if bool(xch_pred):
        # The stage merges rebind ``st``, so the entry state is dropped as
        # they go, and each stage's masks as soon as it is done: at
        # n = 40 960 an int32 [N, N] plane is 6.7 GB.  The receiver merge
        # reads only delivered senders' rows, so the claim rows it gets
        # need no per-slot delivery mask.
        st = state
        del state
        # -- 5a: the ping-req body carries the source's changes
        nreq = (failed[:, None] & sel.wit_valid).sum(dim=1, dtype=torch.int32)
        st, issue_src = _stage_issue(st, nreq, maxpb8)
        deliv_src = issue_src & req_del.any(dim=1)[:, None]
        nsrv = slot_counts(wit_safe, req_del)

        def in_a(st2):
            claims_src = torch.where(issue_src, st2.view_key, 0)
            acc = None
            for m in range(kk):
                slot_in, _ = _receiver_merge(wit_safe[:, m], req_del[:, m], claims_src)
                acc = _max_into(acc, slot_in)
                del slot_in  # not kept alive through the next slot's merge
            return acc

        st, applied = stage_merge(st, applied, issue_src.any(), in_a, nsrv > 0)
        del in_a, issue_src

        # -- 5b: the witness relay-pings the target with its changes
        st, issue_wit = _stage_issue(st, nsrv, maxpb8)
        nping_del = slot_counts(wit_safe, ping_del)
        deliv_wit = issue_wit & (nping_del > 0)[:, None]
        ntgt = slot_counts(t_safe[:, None].expand(kshape), ping_del)

        def in_b(st2):
            acc = None
            for m in range(kk):
                rows = _claim_rows(st2.view_key, issue_wit, wit_safe[:, m])
                slot_in, _ = _receiver_merge(t_safe, ping_del[:, m], rows)
                del rows
                acc = _max_into(acc, slot_in)
                del slot_in  # not kept alive through the next slot's merge
            return acc

        st, applied = stage_merge(st, applied, issue_wit.any(), in_b, ntgt > 0)
        del in_b, issue_wit

        # -- 5c: the target's ack carries its changes back
        st, issue_tgt = _stage_issue(st, ntgt, maxpb8)
        nwit_ack = slot_counts(wit_safe, ack_del)

        fs_slots = None
        if build_fs:
            # the relay's full sync: nothing non-echo to issue to this
            # witness, but the target's post-5b hash differs from the
            # witness's period-start hash
            h_mid = _view_hash(st.view_key)
            rows0 = _gather_rows(torch.where(issue_tgt, st.view_key, 0), t_safe)
            issue_tgt_t = _gather_rows(issue_tgt, t_safe)
            fs_cols = []
            for m in range(kk):
                w_m = wit_safe[:, m]
                echo0 = _gather_rows(deliv_wit, w_m) & (rows0 == _gather_rows(st.view_key, w_m))
                has_claim = (ack_del[:, m][:, None] & issue_tgt_t & ~echo0).any(dim=1)
                col = ack_del[:, m] & ~has_claim & (h_mid[t_safe] != sel.h_pre[w_m])
                fs_cols.append(col)
            del rows0, issue_tgt_t, echo0
            fs_slots = torch.stack(fs_cols, dim=1)  # bool[N, kk]
            relay_fs = fs_slots.sum(dtype=torch.int32)

        def in_c(st2):
            rows = _claim_rows(st2.view_key, issue_tgt, t_safe)
            full_rows = _gather_rows(st2.view_key, t_safe) if fs_slots is not None else None
            acc = None
            for m in range(kk):
                w_m = wit_safe[:, m]
                # anti-echo: drop claims equal to what the witness itself
                # delivered to this target in 5b
                send = _gather_rows(st2.view_key, w_m)
                echo = rows == send
                echo &= _gather_rows(deliv_wit, w_m)
                send.copy_(rows)
                send.masked_fill_(echo, 0)
                del echo
                if fs_slots is not None:
                    send = torch.where(fs_slots[:, m][:, None] & (full_rows > 0), full_rows, send)
                slot_in, _ = _receiver_merge(w_m, ack_del[:, m], send)
                del send
                acc = _max_into(acc, slot_in)
                del slot_in  # not kept alive through the next slot's merge
            return acc

        pred_c = issue_tgt.any()
        if fs_slots is not None:
            pred_c = pred_c | fs_slots.any()
        st, applied = stage_merge(st, applied, pred_c, in_c, nwit_ack > 0)
        del in_c, issue_tgt, deliv_wit

        # -- 5d: the witness response carries its (fresh) changes
        st, issue_wit2 = _stage_issue(st, nsrv, maxpb8)
        any_resp = resp_del.any(dim=1)

        def in_d(st2):
            acc = torch.zeros((nrows, n), dtype=torch.int32, device=dev)
            for m in range(kk):
                rows = _claim_rows(st2.view_key, issue_wit2, wit_safe[:, m])
                drop = rows == st2.view_key
                drop &= deliv_src
                drop |= ~resp_del[:, m][:, None]
                rows.masked_fill_(drop, 0)
                del drop
                torch.maximum(acc, rows, out=acc)
            return acc

        st, applied = stage_merge(st, applied, issue_wit2.any(), in_d, any_resp)
        del in_d, issue_wit2, deliv_src
        state = st

    # the declaration sees the post-exchange view
    was_alive_at_target = (state.view_key[_ids(nrows, dev), t_safe] & 7) == ALIVE
    state, declared = _declare(state, declare_suspect, t_safe, SUSPECT, sl_start)
    return _PingReq(
        state, failed, declare_suspect, declared, was_alive_at_target, applied,
        flaps[0], relay_fs, (req_del, ping_del, ack_del, resp_del),
    )


@_scoped("swim.expiry")
def _phase6_expiry(
    state: ClusterState, gossiping: torch.Tensor
) -> tuple[ClusterState, torch.Tensor]:
    """Phase 6: suspicion countdowns fire -> faulty."""
    sl = state.suspect_left
    sl1 = torch.where(sl > 0, sl - 1, sl)
    expired = (sl1 == 0) & ((state.view_key & 7) == SUSPECT) & gossiping[:, None]
    faulty = state.view_key | 7
    faulty -= 7 - FAULTY  # inc * 8 + FAULTY, one int32 temporary
    vk = torch.where(expired, faulty, state.view_key)
    del faulty
    pb = torch.where(expired, 0, state.pb)
    sl1 = torch.where(expired, -1, sl1)
    return state._replace(view_key=vk, pb=pb, suspect_left=sl1), expired


def converged_impl(state: ClusterState, net: NetState) -> torch.Tensor:
    """Exact view agreement among live (gossiping) nodes: bool[]."""
    if _grc.active_rank() is not None:
        return _converged_ranks(state, net)
    own = torch.diagonal(state.view_key) & 7
    live = net.up & net.responsive & ((own == ALIVE) | (own == SUSPECT))
    # the reference row by a one-row gather (indexing with a tensor
    # scalar would read it back to the host)
    ref = torch.argmax(live.to(torch.uint8)).reshape(1)
    row_same = (state.view_key == state.view_key.index_select(0, ref)).all(dim=1)
    return torch.where(live, row_same, True).all() | (live.sum() <= 1)


def _converged_ranks(state: ClusterState, net: NetState) -> torch.Tensor:
    """``converged_impl`` on this rank's rows: the live mask goes round
    the ring, the reference row comes over it, and the ranks' splits are
    summed."""
    rows = state.view_key.shape[0]
    own = torch.diagonal(state.view_key, _rank_off(rows)) & 7
    live = _own(net.up & net.responsive) & ((own == ALIVE) | (own == SUSPECT))
    live_all = _grc.ring_allgather(live)
    ref = torch.argmax(live_all.to(torch.uint8)).reshape(1)
    row_same = (state.view_key == _grc.ring_fetch_global(state.view_key, ref)).all(dim=1)
    split = _grc.ring_sum((live & ~row_same).any())
    return ~split | (live_all.sum() <= 1)


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
    the reference's metrics, as int32[] tensors.  ``params.sparse_cap``
    takes the sparse-dissemination step (``_swim_step_sparse``)."""
    return _swim_step_handed(_Handoff(state), net, key, params, knobs, prov)


def _swim_step_handed(
    hand: _Handoff,
    net: NetState,
    key: torch.Tensor,
    params: SwimParams,
    knobs: Any = None,
    prov: bool = False,
) -> tuple[ClusterState, dict[str, torch.Tensor]]:
    """``swim_step_impl`` on a state handed over: when the caller keeps no
    reference of its own (``SimCluster.tick``, ``_swim_run_handed``), the
    entry state is freed once it is replaced.  A refusal leaves
    ``hand.state`` in place; past ``hand.take()`` it is gone."""
    _check_supported(hand.state, net, params, knobs, prov)
    sl_start = _validate_params(hand.state.n, params)
    if knobs is not None:
        # the knob's countdown start (the host guard held its range)
        sl_start = int(knobs.suspicion_ticks) + 1
    if params.sparse_cap:
        return _swim_step_sparse(hand, net, key, params, sl_start)
    state = hand.take()
    n = state.n
    rows = state.view_key.shape[0]
    dev = state.view_key.device
    has_delay = state.pending is not None
    if has_delay:
        # the buffer's presence (not rule activity) widens the split: two
        # more streams draw the per-message jitter
        k_sel, k_loss1, k_loss2, k_loss3, k_j1, k_j2 = prng.split(key, 6)
    else:
        k_sel, k_loss1, k_loss2, k_loss3 = prng.split(key, 4)
    ids = _row_ids(rows, dev)
    loss = float(params.loss)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    # -- in-flight claims mature at the start of the tick
    mat_applied, mat_flapped = zero, None
    if has_delay:
        state, mat_applied, mat_flapped = _mature(state, net, sl_start)

    # -- phases 0-1: derived views + probe/witness selection
    sel = _phase01_select(state, net, k_sel, params, knobs)
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
        & ~_drop_net(k_loss1, (rows,), loss, net, ids, t_safe)
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
    flap3 = merged.flapped
    del in_key, merged

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
    full_sync = fwd_ok & ~rep_row.any(dim=1) & (_grc.ring_allgather(h_post)[t_safe] != h_pre)
    send_row = torch.where(full_sync[:, None], reply_key > 0, rep_row)
    ack = (
        fwd_ok
        & _adj(net, t_safe, ids)
        & ~_drop_net(k_loss2, (rows,), loss, net, t_safe, ids)
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
    flap4 = merged2.flapped
    del in2_key, merged2

    # -- phase 5: ping-req for failed probes
    hand = _Handoff(state)
    del state
    pr = _phase5_pingreq(hand, net, k_loss3, sel, ack, sl_start, params, knobs)
    state = pr.state

    # -- phase 6: suspicion countdowns fire -> faulty
    state, expired = _phase6_expiry(state, gossiping)

    # -- flap damping (with the damping planes only)
    n_damped = zero
    if state.damp is not None:
        flaps = _or(_or(_or(flap3, flap4), pr.flapped), mat_flapped)
        if flaps is None:
            flaps = torch.zeros((n, n), dtype=torch.bool, device=dev)
        # a viewer that itself declares alive -> suspect flaps too
        declare_flap = pr.declared & pr.was_alive_at_target
        flaps = _row_update(flaps, t_safe, declare_flap, op="max")
        state = _damp_update(state, flaps, params if knobs is None else knobs)
        n_damped = state.damped.sum(dtype=torch.int32)

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
        "damped_pairs": n_damped,
        "relay_full_syncs": pr.relay_full_syncs,
    }
    if _grc.active_rank() is not None:
        # the whole cluster's counts: one sum over the ranks
        total = _grc.ring_sum(torch.stack(list(metrics.values())))
        metrics = dict(zip(metrics, total.unbind(0)))
    if has_delay:
        metrics["delayed_claims"] = dly3.sum(dtype=torch.int32) + dly4.sum(dtype=torch.int32)
        metrics["matured_applied"] = mat_applied
    if prov:
        # The delivery evidence of the provenance plane.  The reference
        # draws the four relay hop masks again from the same k_loss3
        # stream (they depend on the net, the selection, the ack and the
        # key only), which gives phase 5's own masks: those are exported.
        req_del, ping_del, ack_del, resp_del = pr.hops
        metrics.update(
            # the reference's int32 node ids (the dense step indexes in int64)
            pv_tgt=t_safe.to(torch.int32),
            pv_send=sends,
            # in-tick payload deliveries only: a delayed claim (and a
            # delayed reply, full syncs included) parks in the in-flight
            # buffer, and its arrival has no in-tick edge
            pv_ping=fwd_ok & ~dly3 if has_delay else fwd_ok,
            pv_ack=ack & ~dly4 if has_delay else ack,
            pv_wit=torch.clamp(sel.wit, 0, n - 1).to(torch.int32),
            pv_witv=sel.wit_valid,
            pv_req=req_del,
            pv_rping=ping_del,
            pv_rack=ack_del,
            pv_resp=resp_del,
            # the applied suspect declarations (the lattice took them)
            pv_decl=pr.declared,
        )
    return state, metrics


@_scoped("swim.damp")
def _damp_update(
    state: ClusterState, flaps: torch.Tensor, params: SwimParams | SwimKnobs
) -> ClusterState:
    """Decay every score, add the penalty where a flap happened, and
    move the hysteresis bit: set above ``damp_suppress``, cleared below
    ``damp_reuse``.  The score accumulates in float32 (decay and penalty
    rounded to float32 first, a multiply then an add) and is stored as
    float16; the thresholds compare in float16, as the reference's
    weakly typed scalars (and its float16 knobs) beside a float16 plane
    do.  ``params`` is the ``SwimParams`` or the run's ``SwimKnobs``."""
    dev = state.damp.device
    decay = torch.full((), params.damp_decay_per_tick, dtype=torch.float32, device=dev)
    penalty = torch.full((), params.damp_penalty, dtype=torch.float32, device=dev)
    nil = torch.zeros((), dtype=torch.float32, device=dev)
    damp = (state.damp.to(torch.float32) * decay + torch.where(flaps, penalty, nil)).to(
        torch.float16
    )
    suppress = torch.full((), params.damp_suppress, dtype=torch.float16, device=dev)
    reuse = torch.full((), params.damp_reuse, dtype=torch.float16, device=dev)
    damped = (damp > suppress) | (~(damp < reuse) & state.damped)
    return state._replace(damp=damp, damped=damped)


@_scoped("swim.mature")
def _mature(
    state: ClusterState, net: NetState, sl_start: int
) -> tuple[ClusterState, torch.Tensor, torch.Tensor | None]:
    """Slot ``tick % D`` of the in-flight buffer lands at every up and
    responsive receiver, and is cleared (a stopped receiver's claims are
    lost).  Returns the state, with a buffer this step owns and writes
    in place from here on, the applied count and the merge's flaps.

    The reference merges under ``lax.cond(any(slot > 0))``; here the
    merge runs every tick: a slot of zeros is no claim anywhere, so the
    merge then changes nothing and applies 0, without a host sync."""
    slot0 = (state.tick % state.pending.shape[0]).long().view(1)
    mature = state.pending.index_select(0, slot0)[0]
    pending = state.pending.clone()
    pending.index_fill_(0, slot0, 0)
    merged = _merge_incoming(state, mature, net.up & net.responsive, sl_start)
    return (
        merged.state._replace(pending=pending),
        merged.applied.sum(dtype=torch.int32),
        merged.flapped,
    )


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


# ---------------------------------------------------------------------------
# sparse dissemination (SwimParams.sparse_cap)
# ---------------------------------------------------------------------------

# Elements of the [N, columns] position block that the large-row
# ``_compact_rows`` scatters at once (int64: 512 MiB)
_COMPACT_CHUNK = 1 << 26


def _capped_within(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """``mask & (row-prefix-count(mask) <= cap)``, the first ``cap`` True
    entries per row: by an int16 prefix for short rows, else by the block
    prefix with a per-block int8 threshold (no int32 [N, N] prefix)."""
    n = mask.shape[1]
    if n <= _SPARSE_SMALL_N:
        return mask & (torch.cumsum(mask.to(torch.int16), dim=1, dtype=torch.int16) <= cap)
    mb, inner, offs = _block_prefix(mask)
    # inner >= 1 at every True entry, so a floor of -1 makes exhausted
    # blocks compare False; the ceiling 127 means "all fit"
    thr = torch.clamp(cap - offs, -1, 127).to(torch.int8)
    within = mb & (inner <= thr[:, :, None])
    return within.reshape(mask.shape[0], -1)[:, :n]


def _compact_rows(mask: torch.Tensor, cap: int) -> torch.Tensor:
    """int32[N, cap]: the column indices of the first ``cap`` True
    entries per row, -1 padded.  Positions at or past ``cap`` land in a
    spare column that is cut off (the reference's ``mode="drop"``).
    Long rows scatter block range by block range from the block prefix,
    so no [N, N] position tensor is built."""
    rows, n = mask.shape
    dev = mask.device
    out = torch.full((rows, cap + 1), -1, dtype=torch.int32, device=dev)
    if n <= _SPARSE_SMALL_N:
        cidx = torch.cumsum(mask.to(torch.int16), dim=1, dtype=torch.int16)
        pos = torch.where(mask & (cidx <= cap), cidx.to(torch.int64) - 1, cap)
        del cidx
        cols = torch.arange(n, dtype=torch.int32, device=dev).expand(rows, n)
        out.scatter_(1, pos, cols)
        return out[:, :cap]
    b = _PREFIX_BLOCK
    mb, inner, offs = _block_prefix(mask)
    nb = mb.shape[1]
    step = max(1, _COMPACT_CHUNK // max(rows * b, 1))
    for lo in range(0, nb, step):
        hi = min(nb, lo + step)
        pos = offs[:, lo:hi, None].to(torch.int64) + inner[:, lo:hi].to(torch.int64) - 1
        pos = torch.clamp(torch.where(mb[:, lo:hi], pos, cap), max=cap)
        cols = torch.arange(lo * b, hi * b, dtype=torch.int32, device=dev)
        out.scatter_(1, pos.reshape(rows, -1), cols.expand(rows, -1))
    return out[:, :cap]


def _point_merge(
    state: ClusterState,
    r_idx: torch.Tensor,  # int[B, C] receiver per claim
    subj: torch.Tensor,  # int[B, C] subject per claim (-1 = none)
    claim_key: torch.Tensor,  # int32[B, C]
    valid: torch.Tensor,  # bool[B, C]
    sl_start: int,
) -> tuple[ClusterState, torch.Tensor, torch.Tensor]:
    """Apply compact claim lists at their (receiver, subject) points: the
    sparse ``_merge_incoming``.  The override mask is evaluated per claim
    against the pre-merge view (the reference's documented sparse
    convention); the claims at one point then fold to their lattice max,
    here by an ``amax`` scatter, and the most refuting self claim decides
    a refutation.  Returns (state, applied bool[N, N], refuted bool[N])."""
    n = state.n
    dev = state.view_key.device
    ids = _ids(n, dev)
    subj_safe = torch.clamp(subj, 0, n - 1).long()
    r_safe = torch.clamp(r_idx, 0, n - 1).long()
    flat = (r_safe * n + subj_safe).reshape(-1)
    cur = state.view_key.reshape(-1)[flat].reshape(subj_safe.shape)
    self_claim = valid & (subj_safe == r_safe)
    normal = valid & (subj_safe != r_safe) & _apply_mask(cur, claim_key)

    # every key is >= 0, so a zero value is no update under the max
    v_norm = torch.where(normal, claim_key, 0).reshape(-1)
    vk = state.view_key.clone()
    vk.view(-1).scatter_reduce_(0, flat, v_norm, "amax")

    self_key = torch.zeros(n, dtype=torch.int32, device=dev)
    self_key.scatter_reduce_(
        0, r_safe.reshape(-1), torch.where(self_claim, claim_key, 0).reshape(-1), "amax"
    )
    rumor_status = self_key & 7
    refuted = (rumor_status == SUSPECT) | (rumor_status == FAULTY)
    self_inc = torch.diagonal(state.view_key) >> 3
    new_self_inc = torch.maximum(self_inc, self_key >> 3) + 1
    diag = torch.diagonal(vk)
    diag.copy_(torch.where(refuted, new_self_inc * 8 + ALIVE, diag))

    # applied points: every write is True, so colliding writes agree;
    # the claims that apply nothing aim at a spare element
    applied = torch.zeros(n * n + 1, dtype=torch.bool, device=dev)
    applied.scatter_(0, torch.where(normal.reshape(-1), flat, n * n), True)
    applied = applied[: n * n].view(n, n)
    eye_applied = torch.diagonal(applied)
    eye_applied.copy_(eye_applied | refuted)
    pb = torch.where(applied, 0, state.pb)
    new_status = vk & 7
    sl = torch.where(applied & (new_status == SUSPECT), sl_start, state.suspect_left)
    sl = torch.where(applied & (new_status != SUSPECT), -1, sl)
    return state._replace(view_key=vk, pb=pb, suspect_left=sl), applied, refuted


def _swim_step_sparse(
    hand: _Handoff, net: NetState, key: torch.Tensor, params: SwimParams, sl_start: int
) -> tuple[ClusterState, dict[str, torch.Tensor]]:
    """The protocol period with compact change lists: each ping and ack
    carries at most ``sparse_cap`` changes as (subject, key) lists applied
    by ``_point_merge``.  Phases 0-2, 5 and 6 are the dense code; the
    step equals the dense one whenever no row holds more than
    ``sparse_cap`` active changes, and entries past the cap neither send
    nor spend budget.  A tick with a full sync takes the dense reply."""
    state = hand.take()
    n = state.n
    dev = state.view_key.device
    cap = int(params.sparse_cap)
    k_sel, k_loss1, k_loss2, k_loss3 = prng.split(key, 4)
    ids = _ids(n, dev)
    loss = float(params.loss)

    # -- phases 0-1: shared with the dense step
    sel = _phase01_select(state, net, k_sel, params)
    gossiping, sends, t_safe = sel.gossiping, sel.sends, sel.t_safe
    maxpb8, h_pre = sel.maxpb8, sel.h_pre

    # -- phase 2: capped issue; only sent changes spend budget
    bump = (state.pb >= 0) & sends[:, None]
    pb1 = torch.where(bump, state.pb + 1, state.pb)
    issue_ok = bump & (pb1 <= maxpb8)
    del pb1
    issued_s = _capped_within(issue_ok, cap)
    bump_eff = bump & ~(issue_ok & ~issued_s)
    del bump, issue_ok
    pb_next = torch.where(bump_eff, state.pb + 1, state.pb)
    pb_next = torch.where(bump_eff & (pb_next > maxpb8), -1, pb_next)
    state = state._replace(pb=pb_next)
    del bump_eff, pb_next

    # -- phase 3: compact delivery + point merge
    resp = net.up & net.responsive
    fwd_ok = (
        sends
        & _adj(net, ids, t_safe)
        & ~_drop_net(k_loss1, (n,), loss, net, ids, t_safe)
        & resp[t_safe]
    )
    subj = _compact_rows(issued_s, cap)  # int32[N, cap], -1 padded
    del issued_s
    subj_safe = torch.clamp(subj, 0, n - 1).long()
    claim_key = torch.gather(state.view_key, 1, subj_safe)
    valid_claim = (subj >= 0) & fwd_ok[:, None]
    # the sent set as a bitmap (the anti-echo reference); pad claims aim
    # at spare columns past n
    spare = n + torch.arange(cap, dtype=torch.int64, device=dev)[None, :]
    delivered = torch.zeros((n, n + cap), dtype=torch.bool, device=dev)
    delivered.scatter_(1, torch.where(subj >= 0, subj_safe, spare), valid_claim)
    delivered = delivered[:, :n]
    inbound = _inbound_counts(t_safe, fwd_ok)
    got_ping = inbound > 0

    r_idx = t_safe[:, None].expand(n, cap)
    state, applied3, _ = _point_merge(state, r_idx, subj, claim_key, valid_claim, sl_start)
    ping_applied = applied3.sum(dtype=torch.int32)
    del applied3

    # -- phase 4a: receiver piggyback bookkeeping (entries past the cap
    # window are not sent this tick and keep their budget)
    has_change2 = state.pb >= 0
    rep_issuable = has_change2 & got_ping[:, None] & (state.pb + 1 <= maxpb8)
    within_rep = _capped_within(rep_issuable, cap)
    overflow_rep = rep_issuable & ~within_rep
    del rep_issuable
    inb8 = torch.clamp(inbound, max=127).to(torch.int8)[:, None]
    served = got_ping[:, None] & has_change2 & ~overflow_rep
    del has_change2, overflow_rep
    evict = served & (state.pb > maxpb8 - inb8)
    pb_after = torch.where(evict, -1, torch.where(served, state.pb + inb8, state.pb))
    state = state._replace(pb=pb_after)
    del served, evict, pb_after
    h_post = _view_hash(state.view_key)

    # -- phase 4b: full-sync detection without a dense reply matrix: any
    # non-echo claim for sender s = the receiver's issuable count minus
    # the issuable echo entries among s's sent subjects
    rep_count = within_rep.sum(dim=1, dtype=torch.int32)
    rflat = (r_idx.long() * n + subj_safe).reshape(-1)
    rcv_key_at = state.view_key.reshape(-1)[rflat].reshape(n, cap)
    snd_key_at = torch.gather(state.view_key, 1, subj_safe)
    echo_issuable = (
        valid_claim
        & within_rep.reshape(-1)[rflat].reshape(n, cap)
        & (rcv_key_at == snd_key_at)
    )
    rep_any = rep_count[t_safe] > echo_issuable.sum(dim=1, dtype=torch.int32)
    full_sync = fwd_ok & ~rep_any & (h_post[t_safe] != h_pre)
    ack = fwd_ok & _adj(net, t_safe, ids) & ~_drop_net(k_loss2, (n,), loss, net, t_safe, ids)

    # audit: allow=RPL001 the reference's lax.cond predicate: the branch is skipped when empty
    if bool(full_sync.any()):
        # the dense reply
        reply_key = state.view_key.index_select(0, t_safe.long())
        rep_row = within_rep.index_select(0, t_safe.long()) & ~(
            delivered & (reply_key == state.view_key)
        )
        send_row = torch.where(full_sync[:, None], reply_key > 0, rep_row)
        del rep_row
        in2_key = torch.where(send_row & ack[:, None], reply_key, 0)
        del reply_key, send_row
        merged2 = _merge_incoming(state, in2_key, ack, sl_start)
        del in2_key
        state = merged2.state
        ack_applied = merged2.applied.sum(dtype=torch.int32)
        del merged2
    else:
        # the sparse reply
        rsubj = _compact_rows(within_rep, cap)  # per receiver
        subj2 = rsubj.index_select(0, t_safe.long())  # [N(sender), cap]
        subj2_safe = torch.clamp(subj2, 0, n - 1).long()
        key2 = state.view_key.reshape(-1)[
            (t_safe.long()[:, None] * n + subj2_safe).reshape(-1)
        ].reshape(n, cap)
        echo2 = torch.gather(delivered, 1, subj2_safe) & (
            key2 == torch.gather(state.view_key, 1, subj2_safe)
        )
        valid2 = (subj2 >= 0) & ack[:, None] & ~echo2
        sidx = ids[:, None].expand(n, cap)
        state, applied4, _ = _point_merge(state, sidx, subj2, key2, valid2, sl_start)
        ack_applied = applied4.sum(dtype=torch.int32)
        del applied4
    del delivered, within_rep

    # -- phase 5: ping-req (shared with the dense step)
    hand = _Handoff(state)
    del state
    pr = _phase5_pingreq(hand, net, k_loss3, sel, ack, sl_start, params)
    state = pr.state

    # -- phase 6: suspicion countdowns (shared)
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
        "damped_pairs": torch.zeros((), dtype=torch.int32, device=dev),
        "relay_full_syncs": pr.relay_full_syncs,
    }
    return state, metrics


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
    return _swim_run_handed(_Handoff(state), net, key, params, ticks, knobs)


def _swim_run_handed(
    hand: _Handoff,
    net: NetState,
    key: torch.Tensor,
    params: SwimParams,
    ticks: int,
    knobs: Any = None,
) -> tuple[ClusterState, dict[str, torch.Tensor]]:
    """``swim_run_impl`` on a state handed over; each tick's state is
    handed on to the next."""
    if ticks < 1:
        raise ValueError(f"ticks must be >= 1, got {ticks}")
    metrics: dict[str, torch.Tensor] = {}
    for sub in prng.split(key, ticks):
        state, metrics = _swim_step_handed(hand, net, sub, params, knobs)
        hand = _Handoff(state)
        del state
    return hand.take(), metrics


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
    with a new incarnation (and its damping rows cleared); re-entry is an
    ``admin_join``."""
    # audit: allow=RPL005 a host int's range check
    _check_inc(torch.tensor([int(inc)]))
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
    state = state._replace(view_key=vk, pb=pb, suspect_left=sl)
    if state.damp is not None:  # a fresh process has no damp memory
        damp = state.damp.clone()
        damped = state.damped.clone()
        damp[node] = 0
        damped[node] = False
        state = state._replace(damp=damp, damped=damped)
    return state
