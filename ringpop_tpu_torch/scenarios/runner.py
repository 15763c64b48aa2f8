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
host before any key is drawn (``validate_param_knobs``).

``traffic`` (a ``traffic.CompiledTraffic``) serves a key batch after each
tick's step, against the views that step produced, and adds the serving
counters and histogram rows to the telemetry; the workload draws from
its own key, so the protocol's trajectory is the one without traffic.
An ``overload`` event closes the feedback loop: the serve's per-node
sends drive a pressure meter whose hysteresis bit degrades a node's
period the next tick.  ``policy`` (a ``policies.CompiledPolicy``) folds
the same sends into the remediation planes the next tick's serve
consults.  A spec with ``trace_rumors = K`` (and ``track`` events) folds
each step's delivery evidence into the provenance plane
(``obs.provenance``): K tracked rumors, their per-node first_heard and
parent planes and their resolutions, carried on the device and left on
the net (``pv_*``), with the per-slot heard count as the [T, K]
``pv_heard`` plane of the telemetry.
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
from ringpop_tpu_torch.obs import provenance as pvn
from ringpop_tpu_torch.obs.ledger import default_ledger
from ringpop_tpu_torch.policies import core as pol
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
from ringpop_tpu_torch.traffic import engine as traffic_engine

_dispatches = 0
_last_meta: dict[str, Any] = {}


def dispatch_count() -> int:
    """Compiled scenario runs (segments, when streamed) so far."""
    return _dispatches


def last_meta() -> dict[str, Any]:
    """What the last ``run_compiled`` ran (backend, n, ticks, replicas,
    and ``traffic_m``/``policy``/``param_knobs`` where given): the
    reference's dispatch meta, which its ledger records."""
    return dict(_last_meta)


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
    workload; and feedback state a previous run left on the net would
    seed the new run's pressure, so it is refused unless resuming
    (``standing_ok``: the checkpointed net carries this run's own)."""
    if compiled.overload is None:
        return
    if traffic is None:
        raise ValueError(
            "overload events meter the serve plane's per-node sends: "
            "pass a traffic workload (run_scenario(spec, traffic=...))"
        )
    if not standing_ok and net.ov_cnt is not None:
        if bool(net.ov_cnt.any() | net.ov_gray.any()):
            raise ValueError(
                "the cluster carries overload feedback state from a "
                "previous run (net.ov_cnt/ov_gray): clear_overload() "
                "first, or resume the run that wrote it"
            )


def overload_traffic(traffic: Any | None, compiled: CompiledScenario) -> Any:
    """The workload a scenario serves: with an overload event it counts
    the per-node sends (``track_load``)."""
    if traffic is None or compiled.overload is None or traffic.static.track_load:
        return traffic
    return traffic._replace(static=traffic.static._replace(track_load=1))


def precheck_policy(
    policy: Any | None, traffic: Any | None, net: NetState, *, standing_ok: bool = False
) -> None:
    """Static refusals of the remediation policy plane (the ``precheck``
    contract): a policy meters the serve plane, so it needs a workload,
    and policy state a previous run left on the net is refused unless
    resuming."""
    if policy is None:
        return
    if traffic is None:
        raise ValueError(
            "policies meter the serve plane (per-node sends + delivered): "
            "pass a traffic workload (run_scenario(spec, traffic=..., "
            "policy=...))"
        )
    if not standing_ok and net.po_press is not None:
        leftover = (net.po_press.any() | net.po_shed.any() | net.po_quar.any()
                    | net.po_sends_w.any() | net.po_deliv_w.any())
        if bool(leftover):
            raise ValueError(
                "the cluster carries policy state from a previous run "
                "(net.po_*): clear_policy() first, or resume the run "
                "that wrote it"
            )


def policy_traffic(traffic: Any | None, policy: Any | None) -> Any:
    """The workload a policy-armed scenario serves: per-node sends
    (``track_load``) and the policy hooks with the ``policy_shed``
    counter (``track_policy``)."""
    if traffic is None or policy is None:
        return traffic
    st = traffic.static
    if st.track_load and st.track_policy:
        return traffic
    return traffic._replace(static=st._replace(track_load=1, track_policy=1))


def prepare_policy(policy: Any | None, net: NetState, n: int, max_retries: int) -> tuple | None:
    """The initial policy carry: zeros for a fresh run, or the net's
    checkpointed mid-window state on resume."""
    if policy is None:
        return None
    cfg = policy.config
    if net.po_sends_w is not None and net.po_sends_w.shape[-1] != cfg.amp_window:
        raise ValueError(
            f"the cluster carries a policy amp window of "
            f"{net.po_sends_w.shape[-1]} ticks but this policy uses "
            f"{cfg.amp_window}; clear_policy() or match amp_window"
        )
    return pol.init_policy_state(n, cfg, max_retries, net=net)


def precheck_prov(
    compiled: CompiledScenario, net: NetState, params: Any | None = None,
    *, standing_ok: bool = False,
) -> None:
    """Static refusals of the provenance plane (the ``precheck``
    contract): the fold reads the dense delivery evidence, which the
    sparse step never builds; and tracked-rumor state a finished run left
    on the net would silently extend the old wavefronts, so it is refused
    unless resuming (``standing_ok``: the checkpointed net carries this
    very run's planes)."""
    if not compiled.trace_rumors:
        return
    sw = getattr(params, "swim", params)
    if sw is not None and getattr(sw, "sparse_cap", 0):
        raise NotImplementedError(
            "trace_rumors needs the dense delivery evidence; run traced "
            "scenarios with sparse_cap=0"
        )
    if not standing_ok and net.pv_slot is not None:
        if bool((net.pv_slot[:, 0] >= 0).any()):
            raise ValueError(
                "the cluster carries tracked-rumor state from a previous "
                "run (net.pv_*): clear_provenance() first, or resume the "
                "run that wrote it"
            )


def prepare_prov(
    compiled: CompiledScenario, net: NetState, params: Any | None = None
) -> tuple[pvn.ProvCarry | None, torch.Tensor | None, torch.Tensor | None]:
    """The initial provenance carry and the track reservations: all slots
    unarmed for a fresh run, or the net's checkpointed planes on resume.
    Returns ``(ProvCarry | None, pv_at, pv_node)``."""
    if not compiled.trace_rumors:
        return None, None, None
    k = compiled.trace_rumors
    dev = net.up.device
    if net.pv_slot is not None:
        if net.pv_slot.shape[0] != k:
            raise ValueError(
                f"the cluster carries {net.pv_slot.shape[0]} tracked-rumor "
                f"slots but this scenario compiles {k}; clear_provenance() "
                "or match trace_rumors"
            )
        pvc = pvn.ProvCarry(*(getattr(net, f"pv_{f}").to(dev) for f in pvn.ProvCarry._fields))
    else:
        sw = getattr(params, "swim", params)
        pvc = pvn.init_carry(compiled.n, k, int(getattr(sw, "ping_req_size", 3)), device=dev)
    pv_at, pv_node = pvn.track_tensors(compiled.tracks, k, device=dev)
    return pvc, pv_at, pv_node


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
) -> tuple[Any, torch.Tensor | None, tuple[torch.Tensor, torch.Tensor] | None]:
    """Set-up before the first tick: the in-flight buffer when the spec
    delays messages (from tick 0: its presence widens the step's key
    split, as ``HostPlan.prepare``), the int16 period carry (the net's
    row, or ones when the spec brings gray periods or overload to a
    lockstep cluster), and the overload carry ``(pressure int32[N],
    gray bool[N])``: zeros for a fresh run, the net's on resume."""
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
    ov = None
    if compiled.overload is not None:
        if net.ov_cnt is not None:
            ov = (net.ov_cnt.to(torch.int32), net.ov_gray.to(torch.bool))
        else:
            ov = (torch.zeros(compiled.n, dtype=torch.int32, device=dev),
                  torch.zeros(compiled.n, dtype=torch.bool, device=dev))
    return state, period, ov


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
    ov: tuple | None = None,
    po: tuple | None = None,
    pv: pvn.ProvCarry | None = None,
) -> NetState:
    """The net after the run, the link rules as they stand at the last
    tick (what the host loop's last configuration leaves in force), and
    the overload, policy and provenance carries, so that checkpoints and
    a streamed resume continue them exactly."""
    return NetState(up=up, responsive=resp, adj=adj, period=period,
                    **_link_kw(compiled.faults, compiled.ticks - 1),
                    **carry_fields(ov, po, pv))


def carry_fields(
    ov: tuple | None, po: tuple | None, pv: pvn.ProvCarry | None = None
) -> dict[str, torch.Tensor]:
    """The net fields of the overload, policy and provenance carries (the
    knows plane stays packed)."""
    kw = {}
    if ov is not None:
        kw.update(ov_cnt=ov[0], ov_gray=ov[1])
    if po is not None:
        kw.update(po_press=po[0], po_shed=po[1], po_quar=po[2],
                  po_sends_w=po[3], po_deliv_w=po[4], po_retry_cap=po[5])
    if pv is not None:
        kw.update({f"pv_{f}": v for f, v in pv._asdict().items()})
    return kw


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
    traffic: Any | None = None,
    ov: tuple | None = None,
    po: tuple | None = None,
    policy: Any | None = None,
    pv: pvn.ProvCarry | None = None,
    pv_at: torch.Tensor | None = None,
    pv_node: torch.Tensor | None = None,
) -> tuple:
    """Ticks ``tick0 .. tick0 + len(keys) - 1`` of the scenario on the
    state in ``hand``, which each step takes over.  ``loss`` is the
    schedule's float32 values for these ticks (host copy: the step
    draws against the same float32 as after ``set_loss``); ``knobs``
    goes to every step.  ``traffic`` (a ``CompiledTraffic``, its statics
    already through ``overload_traffic``/``policy_traffic``) serves
    after each step; ``ov`` and ``po`` are the overload and policy
    carries, ``policy`` the ``CompiledPolicy`` (knobs as host ints).
    ``pv`` is the provenance carry (``prepare_prov``, with the track
    reservations ``pv_at``/``pv_node``): each step then exports its
    delivery evidence, which the fold consumes (it never enters the
    telemetry), and the per-slot heard count joins the telemetry as the
    [T, K] plane ``pv_heard``.

    Returns the state, up, responsive, adjacency, period row (int16),
    overload, policy and provenance carries, and the telemetry: each
    metric, ``converged``, ``live`` and ``loss`` as [T] device tensors,
    each histogram plane as [T, B]."""
    n = compiled.n
    dev = up.device
    is_delta = isinstance(params, DeltaParams)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    ft = compiled.faults
    ovc = compiled.overload
    boundaries = set(compiled.boundaries)
    revives = _revive_schedule(compiled)
    u, r, gid, per = up, responsive, adj, period
    per_base = None if per is None else per.to(torch.int32)
    link_kw: dict[str, torch.Tensor] = {}
    rows, planes, names = [], {}, None
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
                per_base = per.to(torch.int32)
        if i == 0 or t in boundaries:
            # every rule window edge is a boundary: the rules in force
            # change nowhere else
            link_kw = _link_kw(ft, t)
        per_eff = per_base
        if ovc is not None:
            # a node the feedback flagged last tick runs this tick (its
            # step and its serve duty phase) at the degraded period
            per_eff = torch.where(ov[1], torch.clamp(per_base, min=ovc.factor), per_base)
        net = NetState(up=u, responsive=r, adj=gid, period=per_eff, **link_kw)
        if is_delta:
            sp = params._replace(swim=params.swim._replace(loss=float(loss[i])))
            hand.state, metrics = sdelta.delta_step_impl(hand.state, net, keys[i], sp,
                                                         knobs=knobs, prov=pv is not None)
            conv = sdelta._converged_impl(hand.state, u, r)
            own = sdelta.view_lookup(hand.state, ids) & 7
        else:
            sp = params._replace(loss=float(loss[i]))
            hand.state, metrics = sim._swim_step_handed(hand, net, keys[i], sp, knobs,
                                                        pv is not None)
            conv = sim.converged_impl(hand.state, net)
            own = torch.diagonal(hand.state.view_key) & 7
        live = (u & r & ((own == sim.ALIVE) | (own == sim.SUSPECT))).sum(dtype=torch.int32)
        y = dict(metrics)
        if pv is not None:
            # the fold consumes the step's evidence bundle in place and
            # adds the per-slot heard count as its one [K] plane
            ev = {k: y.pop(k) for k in pvn.EVIDENCE_KEYS}
            pv, y["pv_heard"] = pvn.prov_update(
                pv, ev, t, _view_post(hand.state, is_delta), pv_at, pv_node, n)
        if traffic is not None:
            # the serve reads the views this tick's step produced (the
            # delta backend's from its tables, on serving ticks only)
            st = hand.state
            views = traffic_engine.DeltaRows(st) if is_delta else st.view_key
            y.update(traffic_engine.serve_tick(
                views, u, r, traffic.tensors, t, static=traffic.static,
                damped=getattr(st, "damped", None), net=net, period=per_eff,
                policy=(po[1], po[2], po[5]) if policy is not None else None,
            ))
        # the overload meter and the policy fold read the same sends
        sends = y.pop("node_sends") if (ovc is not None or policy is not None) else None
        if ovc is not None:
            in_win = ovc.start <= t < ovc.end
            ov = sfaults.overload_update(ovc, in_win, ov[0], ov[1], sends)
            y["ov_gray_nodes"] = ov[1].sum(dtype=torch.int32)
            y["ov_pressure_max"] = ov[0].amax()
        if policy is not None:
            press, shed, quar, sends_w, deliv_w, cap, amp_x16 = pol.policy_update(
                policy.config, policy.knobs, po[0], po[1], po[2], po[3], po[4], sends,
                sends.sum(dtype=torch.int32), y["delivered"], t, traffic.static.max_retries)
            po = (press, shed, quar, sends_w, deliv_w, cap)
            y["policy_shed_nodes"] = shed.sum(dtype=torch.int32)
            y["policy_quarantined"] = quar.sum(dtype=torch.int32)
            y["policy_pressure_max"] = press.amax()
            y["policy_retry_cap"] = cap
            y["policy_amp_x16"] = amp_x16
        if names is None:
            names = sorted(k for k, v in y.items() if v.dim() == 0)
        for k, v in y.items():
            if v.dim() == 1:
                planes.setdefault(k, []).append(v)
        rows.append(torch.stack([*(y[k].to(torch.int32) for k in names),
                                 conv.to(torch.int32), live]))
    block = torch.stack(rows)
    ys = {k: block[:, j] for j, k in enumerate(names)}
    ys.update({k: torch.stack(v) for k, v in planes.items()})
    ys["converged"] = block[:, -2].to(torch.bool)
    ys["live"] = block[:, -1]
    ys["loss"] = compiled.loss[tick0:tick0 + keys.shape[0]]
    return hand.take(), u, r, gid, per, ov, po, pv, dict(sorted(ys.items()))


def _view_post(state: Any, is_delta: bool):
    """The post-tick view keys of viewer-major subject queries [N, M]:
    the delta backend's ``view_lookup``, or a gather of the dense rows."""
    if is_delta:
        return lambda q: sdelta.view_lookup(state, q)
    return lambda q: torch.gather(state.view_key, 1, q.long())


def stack_telemetry(ys: dict[str, torch.Tensor]) -> torch.Tensor:
    """The telemetry as one flat int32 block on its device (bool as 0/1,
    float32 by its bits, histogram planes flattened): what one copy
    reads back."""
    return torch.cat([
        (v.view(torch.int32) if v.dtype == torch.float32 else v.to(torch.int32)).reshape(-1)
        for v in ys.values()
    ])


def unstack_telemetry(ys: dict[str, torch.Tensor], block: np.ndarray) -> dict[str, np.ndarray]:
    """Host arrays of ``stack_telemetry``'s block, in the shapes and
    dtypes of ``ys``."""
    out = {}
    at = 0
    for k, v in ys.items():
        row = block[at:at + v.numel()].reshape(tuple(v.shape))
        at += v.numel()
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
    each a [ticks] tensor on the device, a histogram plane [ticks, B]).

    ``params`` is ``SwimParams`` for a dense ``ClusterState`` and
    ``DeltaParams`` for a ``DeltaState``; its loss is the compiled
    schedule's at each tick.  ``keys`` is ``compile.key_schedule``'s.
    ``adj`` is the normalized adjacency from a ``precheck`` the caller
    already ran.  A dense ``state`` may come as ``sim._Handoff`` holding
    the caller's only reference, so that no entry state stays alive
    through the run.  ``traffic`` (a ``traffic.CompiledTraffic``) serves
    its workload every tick against the views that tick produced, adding
    the serving counters (``traffic.engine.counter_names``) without
    touching the protocol key schedule.  ``policy`` (a
    ``policies.CompiledPolicy``) arms the remediation plane; its carry
    comes back on the net (``net.po_*``).  ``param_knobs`` overrides
    protocol knobs (``swim_sim.SwimKnobs`` names, host numbers) for this
    run, checked by ``validate_param_knobs`` first."""
    global _dispatches, _last_meta
    hand = state if isinstance(state, sim._Handoff) else sim._Handoff(state)
    if keys.shape[0] != compiled.ticks:
        raise ValueError(f"key schedule has {keys.shape[0]} rows for {compiled.ticks} ticks")
    if adj is None:
        adj = precheck(hand.state, net, compiled, params)
        precheck_overload(compiled, traffic, net)
        precheck_policy(policy, traffic, net)
        precheck_prov(compiled, net, params)
    traffic = policy_traffic(overload_traffic(traffic, compiled), policy)
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
    pv, pv_at, pv_node = prepare_prov(compiled, net, params)
    hand.state, period, ov = prepare_faults(hand.take(), net, compiled, params)
    po = None
    if policy is not None:
        po = prepare_policy(policy, net, compiled.n, traffic.static.max_retries)
    _dispatches += 1
    meta: dict[str, Any] = {
        "backend": "delta" if isinstance(params, DeltaParams) else "dense",
        "n": compiled.n, "ticks": compiled.ticks, "replicas": 1,
    }
    if traffic is not None:
        meta["traffic_m"] = traffic.static.m
    if policy is not None:
        meta["policy"] = policy.name
    if param_knobs is not None:
        meta["param_knobs"] = sorted(param_knobs)
    if compiled.trace_rumors:
        meta["trace_rumors"] = compiled.trace_rumors
    _last_meta = meta
    # ledger off (the default): a plain call-through; on, one row with
    # the execute time and the memory footprint (obs/ledger.py)
    args = (hand, net.up, net.responsive, adj, period, compiled, keys,
            compiled.loss.cpu().numpy(), 0)
    traced = dict(knobs=knobs, traffic=traffic, ov=ov, po=po, pv=pv, pv_at=pv_at,
                  pv_node=pv_node)
    statics = dict(params=params, policy=policy)
    st, up, resp, adj, period, ov, po, pv, ys = default_ledger().dispatch(
        "run_scenario", _scenario_scan_impl, *args, **traced, **statics, _meta=meta,
        _sig=((*args, *traced.values()), statics),
    )
    return st, final_net(up, resp, adj, period, compiled, ov=ov, po=po, pv=pv), ys


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
            "the overload feedback loop; run_scenario with traffic= is "
            "the compiled path"
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
