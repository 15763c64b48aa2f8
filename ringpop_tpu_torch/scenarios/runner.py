"""Drive a scenario: the compiled runner and the host loop.

The port of ``ringpop_tpu/scenarios/runner.py``.  ``run_compiled`` runs
a whole compiled fault timeline (``compile.compile_spec``) in one call:
each tick applies its events to the device tensors (kills, suspends and
resumes as masked writes, then revives, the partition's group-id row,
the period row and the link rules in force), runs the protocol step,
and stacks that tick's metrics, converged flag, live count and loss on
the device.  The telemetry is read back once a call, never a tick; the
only host syncs the runner adds are a tick's revives (``sim.revive``
and ``sim.admin_join`` take host ints) and a few per call.
``run_host_loop`` drives the same timeline through the public
``SimCluster`` surface, segment by segment: the parity baseline.

Event order within a tick (shared with the host loop): node bit edits,
then revives, then partition rows.  ``param_knobs`` overrides the
protocol knobs (``swim_sim.SwimKnobs``) for a run, validated on the
host before any key is drawn (``validate_param_knobs``).  The serving
plane (``traffic``), the overload feedback loop, policies and
provenance are not ported yet: asking for them raises
``NotImplementedError`` before any key is drawn.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any

import numpy as np
import torch

from ringpop_tpu_torch.models import swim_delta as sdelta
from ringpop_tpu_torch.models import swim_sim as sim
from ringpop_tpu_torch.models.swim_delta import DeltaParams, DeltaState
from ringpop_tpu_torch.models.swim_sim import NetState, SwimParams
from ringpop_tpu_torch.scenarios import faults as sfaults
from ringpop_tpu_torch.scenarios.compile import (
    _OP_RANK,
    EV_KILL,
    EV_RESUME,
    EV_REVIVE,
    EV_SUSPEND,
    CompiledScenario,
    expand_events,
)
from ringpop_tpu_torch.scenarios.spec import ScenarioSpec
from ringpop_tpu_torch.scenarios.trace import Trace

_dispatches = 0


def dispatch_count() -> int:
    """Compiled scenario runs (segments, when streamed) so far."""
    return _dispatches


def refuse_unported(*, traffic: Any = None, policy: Any = None) -> None:
    """The scenario planes this port does not carry yet, refused before
    any key is drawn."""
    if traffic is not None:
        raise NotImplementedError(
            "traffic= (the serving plane inside a scenario) is not ported yet "
            "(ROADMAP queue 1 item 7)"
        )
    if policy is not None:
        raise NotImplementedError(
            "policy= (the remediation policy plane) is not ported yet "
            "(ROADMAP queue 1 item 6)"
        )


def as_spec(spec: ScenarioSpec | dict | str) -> ScenarioSpec:
    """A ``ScenarioSpec`` from itself, its dict form or its JSON file."""
    if isinstance(spec, str):
        return ScenarioSpec.load(spec)
    if isinstance(spec, dict):
        return ScenarioSpec.from_dict(spec)
    return spec


def make_trace(stacks: dict[str, np.ndarray], cluster: Any, start_tick: int,
               spec: dict | None) -> Trace:
    """The ``Trace`` of host telemetry stacks: [T] series are metrics,
    [T, B] ones planes."""
    return Trace(
        metrics={k: v for k, v in stacks.items()
                 if k not in ("converged", "live", "loss") and v.ndim == 1},
        planes={k: v for k, v in stacks.items() if v.ndim == 2},
        converged=stacks["converged"],
        live=stacks["live"],
        loss=stacks["loss"],
        n=cluster.n,
        backend=cluster.backend,
        start_tick=start_tick,
        spec=spec,
    ).validate()


def _normalize_adj(net: NetState, n: int) -> torch.Tensor:
    """The int32[N] group-id adjacency the runner carries: ``adj=None``
    and an all-True mask (a healed mask-form partition) are one group,
    zeros; a partial mask has no group-id form and is refused."""
    if net.adj is None:
        return torch.zeros(n, dtype=torch.int32, device=net.up.device)
    if net.adj.dim() == 1:
        return net.adj
    if bool(net.adj.all()):
        return torch.zeros(n, dtype=torch.int32, device=net.up.device)
    raise ValueError(
        "scenario runs take the group-id adjacency form shared by both "
        "backends; heal the dense bool[N, N] mask partition first"
    )


def precheck(
    state: Any,
    net: NetState,
    compiled: CompiledScenario,
    params: Any | None = None,
    *,
    standing_ok: bool = False,
) -> torch.Tensor:
    """Every static refusal of ``run_compiled``, made before any key is
    drawn (a failed run must not advance the cluster key); returns the
    normalized group-id adjacency for ``run_compiled(adj=...)``.
    ``standing_ok=True`` is the resume path's: the checkpointed net
    carries this very spec's mirrored rules and mid-window period row."""
    if compiled.has_revive and isinstance(state, DeltaState):
        raise NotImplementedError(
            "in-scan revive is dense-backend-only (the delta backend's "
            "revive/join are host-side row ops); use run_host_loop or "
            "backend='dense'"
        )
    if compiled.has_delay:
        sw = getattr(params, "swim", params)
        if sw is not None and getattr(sw, "sparse_cap", 0):
            raise NotImplementedError("per-link delay does not compose with sparse_cap")
        if isinstance(state, DeltaState):
            if state.pend_subj is not None:
                if state.pend_subj.shape[0] != compiled.delay_depth:
                    raise ValueError(
                        f"the cluster carries delta in-flight lanes of "
                        f"depth {state.pend_subj.shape[0]} but this "
                        f"scenario needs {compiled.delay_depth}; drain "
                        "them or start from a fresh cluster"
                    )
                w_eff = min(getattr(params, "wire_cap", 16), state.capacity)
                if state.pend_subj.shape[-1] != w_eff:
                    raise ValueError(
                        f"delta in-flight lanes are {state.pend_subj.shape[-1]} "
                        f"claims wide but wire_cap lowers {w_eff}-wide "
                        "messages; re-install the buffer"
                    )
        elif state.pending is not None and state.pending.shape[0] != compiled.delay_depth:
            raise ValueError(
                f"the cluster carries an in-flight buffer of depth "
                f"{state.pending.shape[0]} but this scenario needs "
                f"{compiled.delay_depth}; drain it (tick past the old "
                "horizon) or start from a fresh cluster"
            )
    if compiled.has_gray or compiled.overload is not None:
        sw = getattr(params, "swim", params)
        if sw is not None and getattr(sw, "phase_mod", 1) > 1:
            raise ValueError(
                "gray/overload events (per-node periods) do not compose "
                "with the static phase_mod stagger: a period row of P "
                "subsumes it"
            )
    if not standing_ok:
        # the runner takes its network configuration from the spec alone:
        # standing config the spec does not model is refused rather than
        # silently ignored
        if net.link_src is not None:
            active = bool(net.link_p.any()) or (
                net.link_d is not None and bool(net.link_d.any() | net.link_j.any())
            )
            if active:
                raise ValueError(
                    "the cluster carries active standing link rules "
                    "(set_link_rules): a compiled scenario applies only "
                    "spec-declared link_loss/delay events — "
                    "clear_link_rules() first, or express the rules as "
                    "spec events (run_host_loop drives standing rules)"
                )
        if compiled.has_gray and net.period is not None and bool((net.period != 1).any()):
            raise ValueError(
                "gray events rebuild the period plane from lockstep, "
                "which would clobber the standing set_period row mid-run "
                "— set_period(None) first, or encode the standing row "
                "as gray events"
            )
    return _normalize_adj(net, compiled.n)


def precheck_overload(
    compiled: CompiledScenario, traffic: Any | None, net: NetState, *, standing_ok: bool = False
) -> None:
    """Static refusals of the overload feedback loop (the ``precheck``
    contract): it meters the serving plane's sends, so it needs a
    workload, and the serving plane is not ported yet."""
    del net, standing_ok
    if compiled.overload is None:
        return
    if traffic is None:
        raise ValueError(
            "overload events meter the serve plane's per-node sends: "
            "pass a traffic workload (run_scenario(spec, traffic=...))"
        )
    refuse_unported(traffic=traffic)


def precheck_prov(
    compiled: CompiledScenario, net: NetState, params: Any | None = None,
    *, standing_ok: bool = False,
) -> None:
    """Static refusals of the provenance plane (``track`` events): the
    reference's sparse-step refusal, then the plane itself, which this
    port does not carry yet."""
    del net, standing_ok
    if not compiled.trace_rumors:
        return
    sw = getattr(params, "swim", params)
    if sw is not None and getattr(sw, "sparse_cap", 0):
        raise NotImplementedError(
            "trace_rumors needs the dense delivery evidence; run traced "
            "scenarios with sparse_cap=0"
        )
    raise NotImplementedError(
        "track events (trace_rumors) need the provenance plane, which is "
        "not ported yet (ROADMAP queue 1 item 6)"
    )


_DAMP_KNOBS = ("damp_penalty", "damp_decay_per_tick", "damp_suppress", "damp_reuse")


def validate_param_knobs(
    n: int,
    swim_params: SwimParams,
    knob_values: dict[str, Any],
    *,
    backend: str,
    period_active: bool,
    damping: bool,
) -> None:
    """Host-side guards for protocol knobs, shared by a run's
    ``param_knobs`` (one value each) and a sweep's ``param_axes`` (one
    list per knob), checked against every value a knob will take:

    - the range and the int8 digit budgets at the axis maximum
      (``swim_sim.check_knob_value``, ``swim_sim._validate_params``);
    - ``phase_mod`` stays 1 when the run carries per-node period rows
      (gray or overload events): the period row subsumes the stagger;
    - the delta backend has no relay full sync and no damping plane, so
      those knobs raise instead of doing nothing;
    - the damp knobs need the damping planes on the dense backend."""
    for name, vals in knob_values.items():
        for v in vals:
            sim.check_knob_value(name, v, swim_params)
    sim._validate_params(n, swim_params, knob_values=knob_values)
    if period_active:
        for i, v in enumerate(knob_values.get("phase_mod", ())):
            if int(v) != 1:
                raise ValueError(
                    f"phase_mod={int(v)} (axis value {i}): scenarios with "
                    "per-node period rows (gray degradation / overload) "
                    "subsume the stagger divisor, so the knob would be "
                    "silently ignored; pin phase_mod to 1 here"
                )
    if backend == "delta":
        for i, v in enumerate(knob_values.get("relay_full_sync", ())):
            if int(v) != 0:
                raise ValueError(
                    f"relay_full_sync={int(v)} (axis value {i}): the delta "
                    "backend has no full-sync exchange arm; sweep this "
                    "knob on the dense backend"
                )
        bad = sorted(set(knob_values) & set(_DAMP_KNOBS))
        if bad:
            raise ValueError(
                f"damp knob(s) {bad}: the delta backend has no damping "
                "plane; sweep damp thresholds on the dense backend"
            )
    elif not damping:
        bad = sorted(set(knob_values) & set(_DAMP_KNOBS))
        if bad:
            raise ValueError(
                f"damp knob(s) {bad} need the damping plane armed: "
                "init the dense cluster with damping=True"
            )


def period_active(net: NetState, compiled: CompiledScenario) -> bool:
    """Whether the run carries a per-node period row: the net's own, or
    the ones ``prepare_faults`` installs for gray or overload events."""
    return net.period is not None or compiled.has_gray or compiled.overload is not None


def prepare_faults(
    state: Any, net: NetState, compiled: CompiledScenario, params: Any | None = None
) -> tuple[Any, torch.Tensor | None]:
    """Set-up before the first tick: the in-flight buffer when the spec
    delays messages (from tick 0: its presence widens the step's key
    split, as ``HostPlan.prepare``) and the int16 period carry (the
    net's row, or ones when the spec brings gray periods to a lockstep
    cluster).  The overload carry comes with the serving plane."""
    dev = net.up.device
    if compiled.has_delay:
        if isinstance(state, DeltaState):
            if state.pend_subj is None:
                state = sdelta.install_pending(
                    state, compiled.delay_depth, getattr(params, "wire_cap", 16)
                )
        elif state.pending is None:
            state = state._replace(pending=torch.zeros(
                (compiled.delay_depth, compiled.n, compiled.n), dtype=torch.int32, device=dev))
    period = net.period
    if (compiled.has_gray or compiled.overload is not None) and period is None:
        period = torch.ones(compiled.n, dtype=torch.int16, device=dev)
    elif period is not None and period.dtype != torch.int16:
        pmax = int(period.max()) if period.numel() else 0
        if pmax > np.iinfo(np.int16).max:
            raise ValueError(f"per-node period {pmax} exceeds the int16 carry range")
        period = period.to(torch.int16)
    return state, period


def _link_kw(ft: sfaults.FaultTensors | None, t: int) -> dict[str, torch.Tensor]:
    """The net's link fields at tick ``t``: every rule, with p, d and j
    zeroed outside its ``[start, end)`` window."""
    if ft is None or not ft.lr_p.shape[0]:
        return {}
    active = (ft.lr_start <= t) & (ft.lr_end > t)
    kw = {"link_src": ft.lr_src, "link_dst": ft.lr_dst,
          "link_p": torch.where(active, ft.lr_p, 0.0)}
    if ft.lr_d is not None:
        kw["link_d"] = torch.where(active, ft.lr_d, 0)
        kw["link_j"] = torch.where(active, ft.lr_j, 0)
    return kw


def final_net(
    up: torch.Tensor,
    resp: torch.Tensor,
    adj: torch.Tensor,
    period: torch.Tensor | None,
    compiled: CompiledScenario,
) -> NetState:
    """The net after the run, the link rules as they stand at the last
    tick: what the host loop's last configuration leaves in force."""
    return NetState(up=up, responsive=resp, adj=adj, period=period,
                    **_link_kw(compiled.faults, compiled.ticks - 1))


def _masked_set(x: torch.Tensor, hit: torch.Tensor, nodes: torch.Tensor, value: bool) -> torch.Tensor:
    """``x[nodes[hit]] = value``: the misses write a spare slot past the
    end, which is cut off."""
    n = x.shape[0]
    ext = torch.cat([x, x.new_zeros(1)])
    ext.index_fill_(0, torch.where(hit, nodes, n).long(), value)
    return ext[:n]


def _switch_row(hit: torch.Tensor, rows: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """The first row whose tick ``hit`` marks, else ``cur`` (a one-row
    gather: indexing with a tensor scalar would read it back)."""
    first = torch.argmax(hit.to(torch.uint8)).reshape(1)
    return torch.where(hit.any(), rows.index_select(0, first)[0], cur)


def _apply_revives(
    state: Any, up: torch.Tensor, resp: torch.Tensor, nodes: list[int]
) -> tuple[Any, torch.Tensor, torch.Tensor]:
    """The dense backend's revives of one tick, in event order, each
    reading the state the one before wrote: a fresh incarnation past the
    cluster's largest, the row wiped, the net bits up, and a bootstrap
    join against the first live node other than itself (none: it stays
    unjoined).  ``sim.revive``/``admin_join`` take host ints, so each
    revive reads two values back."""
    ids = torch.arange(state.n, dtype=torch.int32, device=up.device)
    up, resp = up.clone(), resp.clone()
    for node in nodes:
        inc = (int(state.view_key.max()) >> 3) + 1000
        state = sim.revive(state, node, inc)
        up[node] = True
        resp[node] = True
        own = torch.diagonal(state.view_key) & 7
        cand = up & resp & ((own == sim.ALIVE) | (own == sim.SUSPECT)) & (ids != node)
        seed = int(torch.where(cand.any(), torch.argmax(cand.to(torch.uint8)), -1))
        if seed >= 0:
            state = sim.admin_join(state, node, seed)
    return state, up, resp


def _revive_schedule(compiled: CompiledScenario) -> dict[int, list[int]]:
    """tick -> revived nodes in event order (one readback a call)."""
    if not compiled.has_revive:
        return {}
    ev = torch.stack([compiled.ev_tick, compiled.ev_kind, compiled.ev_node]).cpu().tolist()
    out: dict[int, list[int]] = defaultdict(list)
    for t, kind, node in zip(*ev):
        if kind == EV_REVIVE:
            out[t].append(node)
    return out


def _scenario_scan_impl(
    hand: sim._Handoff,
    up: torch.Tensor,
    responsive: torch.Tensor,
    adj: torch.Tensor,
    period: torch.Tensor | None,
    compiled: CompiledScenario,
    keys: torch.Tensor,
    loss: np.ndarray,
    tick0: int = 0,
    *,
    params: SwimParams | DeltaParams,
    knobs: sim.SwimKnobs | None = None,
) -> tuple[Any, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None, dict]:
    """Ticks ``tick0 .. tick0 + len(keys) - 1`` of the scenario on the
    state in ``hand``, which each step takes over.  ``loss`` is the
    schedule's float32 values for these ticks (host copy: the step
    draws against the same float32 as after ``set_loss``); ``knobs``
    goes to every step.  Returns the state, up, responsive, adjacency,
    period row (int16) and the telemetry: each metric, ``converged``,
    ``live`` and ``loss`` as [T] device tensors."""
    n = compiled.n
    dev = up.device
    is_delta = isinstance(params, DeltaParams)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    ft = compiled.faults
    boundaries = set(compiled.boundaries)
    revives = _revive_schedule(compiled)
    u, r, gid, per = up, responsive, adj, period
    per_eff = None if per is None else per.to(torch.int32)
    link_kw: dict[str, torch.Tensor] = {}
    rows, names = [], None
    for i in range(keys.shape[0]):
        t = tick0 + i
        if t == 0 or t in boundaries:
            if compiled.ev_tick.shape[0]:
                m = compiled.ev_tick == t
                kind, node = compiled.ev_kind, compiled.ev_node
                u = _masked_set(u, m & (kind == EV_KILL), node, False)
                r = _masked_set(r, m & (kind == EV_SUSPEND), node, False)
                r = _masked_set(r, m & (kind == EV_RESUME), node, True)
                if t in revives:
                    hand.state, u, r = _apply_revives(hand.take(), u, r, revives[t])
            if compiled.p_tick.shape[0]:
                gid = _switch_row(compiled.p_tick == t, compiled.p_gid, gid)
            if ft is not None and ft.pe_tick.shape[0]:
                per = _switch_row(ft.pe_tick == t, ft.pe_row, per)
                per_eff = per.to(torch.int32)
        if i == 0 or t in boundaries:
            # every rule window edge is a boundary: the rules in force
            # change nowhere else
            link_kw = _link_kw(ft, t)
        net = NetState(up=u, responsive=r, adj=gid, period=per_eff, **link_kw)
        if is_delta:
            sp = params._replace(swim=params.swim._replace(loss=float(loss[i])))
            hand.state, metrics = sdelta.delta_step_impl(hand.state, net, keys[i], sp,
                                                         knobs=knobs)
            conv = sdelta._converged_impl(hand.state, u, r)
            own = sdelta.view_lookup(hand.state, ids) & 7
        else:
            sp = params._replace(loss=float(loss[i]))
            hand.state, metrics = sim._swim_step_handed(hand, net, keys[i], sp, knobs)
            conv = sim.converged_impl(hand.state, net)
            own = torch.diagonal(hand.state.view_key) & 7
        live = (u & r & ((own == sim.ALIVE) | (own == sim.SUSPECT))).sum(dtype=torch.int32)
        if names is None:
            names = sorted(metrics)
        rows.append(torch.stack([*(metrics[k].to(torch.int32) for k in names),
                                 conv.to(torch.int32), live]))
    block = torch.stack(rows)
    ys = {k: block[:, j] for j, k in enumerate(names)}
    ys["converged"] = block[:, -2].to(torch.bool)
    ys["live"] = block[:, -1]
    ys["loss"] = compiled.loss[tick0:tick0 + keys.shape[0]]
    return hand.take(), u, r, gid, per, dict(sorted(ys.items()))


def stack_telemetry(ys: dict[str, torch.Tensor]) -> torch.Tensor:
    """The telemetry as one int32 [K, T] block on its device (bool as
    0/1, float32 by its bits): what one copy reads back."""
    return torch.stack([
        v.view(torch.int32) if v.dtype == torch.float32 else v.to(torch.int32)
        for v in ys.values()
    ])


def unstack_telemetry(ys: dict[str, torch.Tensor], block: np.ndarray) -> dict[str, np.ndarray]:
    """Host arrays of ``stack_telemetry``'s block, in the dtypes of ``ys``."""
    out = {}
    for (k, v), row in zip(ys.items(), block):
        if v.dtype == torch.bool:
            out[k] = row.astype(bool)
        elif v.dtype == torch.float32:
            out[k] = row.view(np.float32)
        else:
            out[k] = row
    return out


def telemetry_numpy(ys: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The telemetry on the host, read back in one copy."""
    return unstack_telemetry(ys, stack_telemetry(ys).cpu().numpy())


def run_compiled(
    state: Any,
    net: NetState,
    keys: torch.Tensor,
    compiled: CompiledScenario,
    params: SwimParams | DeltaParams,
    traffic: Any | None = None,
    adj: torch.Tensor | None = None,
    policy: Any | None = None,
    param_knobs: dict[str, float | int] | None = None,
) -> tuple[Any, NetState, dict[str, torch.Tensor]]:
    """The whole scenario in one call: (state, net, per-tick telemetry,
    each a [ticks] tensor on the device).

    ``params`` is ``SwimParams`` for a dense ``ClusterState`` and
    ``DeltaParams`` for a ``DeltaState``; its loss is the compiled
    schedule's at each tick.  ``keys`` is ``compile.key_schedule``'s.
    ``adj`` is the normalized adjacency from a ``precheck`` the caller
    already ran.  A dense ``state`` may come as ``sim._Handoff`` holding
    the caller's only reference, so that no entry state stays alive
    through the run.  ``param_knobs`` overrides protocol knobs
    (``swim_sim.SwimKnobs`` names, host numbers) for this run, checked
    by ``validate_param_knobs`` first.  ``traffic`` and ``policy`` are
    not ported yet and raise."""
    global _dispatches
    refuse_unported(traffic=traffic, policy=policy)
    hand = state if isinstance(state, sim._Handoff) else sim._Handoff(state)
    if keys.shape[0] != compiled.ticks:
        raise ValueError(f"key schedule has {keys.shape[0]} rows for {compiled.ticks} ticks")
    if adj is None:
        adj = precheck(hand.state, net, compiled, params)
        precheck_overload(compiled, traffic, net)
        precheck_prov(compiled, net, params)
    knobs = None
    if param_knobs is not None:
        swp = getattr(params, "swim", params)
        validate_param_knobs(
            compiled.n, swp, {k: [v] for k, v in param_knobs.items()},
            backend="delta" if isinstance(params, DeltaParams) else "dense",
            period_active=period_active(net, compiled),
            damping=getattr(hand.state, "damp", None) is not None,
        )
        knobs = sim.swim_knob_arrays(swp, param_knobs)
    hand.state, period = prepare_faults(hand.take(), net, compiled, params)
    _dispatches += 1
    st, up, resp, adj, period, ys = _scenario_scan_impl(
        hand, net.up, net.responsive, adj, period, compiled, keys,
        compiled.loss.cpu().numpy(), params=params, knobs=knobs,
    )
    return st, final_net(up, resp, adj, period, compiled), ys


def run_host_loop(cluster, spec: ScenarioSpec):
    """Apply each boundary tick's events through the public ``SimCluster``
    surface, then ``tick()`` the segment to the next boundary.  It draws
    the cluster key once a segment, as ``compile.key_schedule`` does, so
    from equal state and key the trajectory is ``run_compiled``'s and
    the reference's.

    Ops of one tick apply in the canonical order (``_OP_RANK``): node bit
    edits, then revives, then partitions, loss and the fault
    configuration (``faults.HostPlan``)."""
    spec.validate(cluster.n)
    if any(e.op == "overload" for e in spec.events):
        raise NotImplementedError(
            "run_host_loop does not serve traffic, so it cannot drive "
            "the overload feedback loop"
        )
    plan = sfaults.HostPlan(spec, cluster.n)
    plan.prepare(cluster)
    by_tick: dict[int, list[tuple[str, Any]]] = defaultdict(list)
    for at, op, arg in expand_events(spec, cluster.params.loss):
        by_tick[at].append((op, arg))
    boundaries = sorted(t for t in by_tick if 0 < t < spec.ticks)
    pts = [0, *boundaries, spec.ticks]
    for a, b in zip(pts, pts[1:]):
        ops = sorted(by_tick.get(a, ()), key=lambda x: _OP_RANK[x[0]])
        cfg_done = False
        for op, arg in ops:
            if op == "kill":
                cluster.kill(arg)
            elif op == "suspend":
                cluster.suspend(arg)
            elif op == "resume":
                cluster.resume(arg)
            elif op == "revive":
                cluster.revive(arg)
            elif op == "partition":
                cluster.partition([list(g) for g in arg])
            elif op == "heal":
                cluster.heal_partition()
            elif op == "loss":
                cluster.set_loss(arg)
            elif op == "faultcfg" and not cfg_done:
                plan.apply(cluster, a)
                cfg_done = True
        cluster.tick(b - a)
    return cluster
