"""Scenario sweeps: R replicas of one scenario, and their ``SweepTrace``.

The port of ``ringpop_tpu/scenarios/sweep.py``.  A sweep runs R
replicas of one compiled scenario; they may differ in

* the PRNG seed: replica r draws its segment-exact key schedule from
  its own replica key, so it equals a standalone ``run_scenario`` of
  ``replica_spec(spec, ...)`` started from that key;
* a **loss scale**: every loss value (base, events, ramp targets)
  times ``loss_scales[r]``;
* a **kill jitter**: replica r's ``kill`` events shift by
  ``kill_jitter[r]`` ticks;
* a **flap jitter**: replica r's ``flap`` windows (start and end) shift
  by ``flap_jitter[r]`` ticks;
* a **protocol knob** (``param_axes``, ``swim_sim.SwimKnobs`` names):
  replica r runs with ``replica_param_knobs(param_axes, r)``;
* a **policy knob** (``policy_axes``, ``policies.PolicyKnobs`` names):
  replica r runs with ``replica_policy(policy, policy_axes, r)``.

Everything else (tick count, partitions, the other events, the cluster
size, the static params and the traffic workload: one key stream, so
every replica serves the same key batches against its own trajectory)
is shared.

**A replica loop, not a batched step.**  The reference ``vmap``s its
scan body over a leading replica axis and jits it once.  The port's
runner is a host loop over device work (``runner._scenario_scan_impl``),
so a sweep runs each replica through that same function, segment by
segment (an unsegmented sweep is one segment) and replica by replica
within a segment.  The replicas differ only in their inputs: their own
copy of the start state, taken when the replica's run begins; their own
event rows, loss row and segment boundaries; their own key rows; their
own knobs.  Parity therefore holds by construction, as it does in the
reference, where each replica is compiled through ``replica_spec``.
The dense state is handed to each step, so the peak is one running
replica beside the finished replicas' final states (and the cluster's
own state, which a sweep leaves as it was).  The reference returns the
final states stacked on a leading replica axis; the port keeps them
apart (``SweepTrace.final_states[r]``), which saves a copy of them all.
Sharing a step across replicas (R replicas a launch) is later speed
work.  A traced spec (``trace_rumors``) gives each replica a fresh
provenance carry: its planes land on ``final_nets[r]`` (``pv_*``) and
its heard counts in the [R, T, K] plane ``pv_heard``.

A sweep goes through the dispatch ledger (``obs/ledger.py``) as the
program ``run_sweep``, or ``run_sweep:<program_tag>`` when the caller
tags it.  Not here: the replica
axis over several cards (``shard=True`` is the reference's no-op on one
card and raises on several, item 11).  The
reference's compile-once test of a knob grid checks XLA's compile cache
and has no counterpart: the port compiles nothing per run.
"""

from __future__ import annotations

import json
import os
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from ringpop_tpu_torch import prng
from ringpop_tpu_torch.models import swim_sim as sim
from ringpop_tpu_torch.models.swim_delta import DeltaParams
from ringpop_tpu_torch.obs.ledger import default_ledger
from ringpop_tpu_torch.scenarios import runner
from ringpop_tpu_torch.scenarios.compile import CompiledScenario, compile_spec, key_schedule
from ringpop_tpu_torch.scenarios.spec import ScenarioSpec
from ringpop_tpu_torch.scenarios.trace import Trace
from ringpop_tpu_torch.stats import Histogram

_dispatches = 0


def dispatch_count() -> int:
    """Sweep runs (segments, when streamed) so far."""
    return _dispatches


# ---------------------------------------------------------------------------
# per-replica spec derivation
# ---------------------------------------------------------------------------


def replica_spec(
    spec: ScenarioSpec,
    *,
    kill_jitter: int = 0,
    loss_scale: float = 1.0,
    flap_jitter: int = 0,
) -> ScenarioSpec:
    """Replica r's effective spec: ``kill`` events shifted by
    ``kill_jitter`` ticks, ``flap`` windows (start and end, so the duty
    cycle keeps its length) by ``flap_jitter``, every loss value scaled
    by ``loss_scale`` (as Python floats, before any float32 cast).

    A standalone ``run_scenario`` of this spec from replica r's key,
    on a cluster whose loss is ``params.loss * loss_scale``, is replica
    r; the sweep compiles each replica through this function."""
    if kill_jitter == 0 and loss_scale == 1.0 and flap_jitter == 0:
        return spec
    events = []
    for e in spec.events:
        if e.op == "kill" and kill_jitter:
            at = e.at + kill_jitter
            if not 0 <= at < spec.ticks:
                raise ValueError(
                    f"kill jitter {kill_jitter:+d} pushes the kill at tick "
                    f"{e.at} outside [0, {spec.ticks})"
                )
            e = e._replace(at=at)
        if e.op == "flap" and flap_jitter:
            at = e.at + flap_jitter
            until = (e.until if e.until is not None else spec.ticks) + flap_jitter
            if not 0 <= at < until <= spec.ticks:
                raise ValueError(
                    f"flap jitter {flap_jitter:+d} pushes the flap window "
                    f"[{e.at}, {e.until}) outside [0, {spec.ticks})"
                )
            e = e._replace(at=at, until=until)
        if e.op in ("loss", "loss_ramp") and loss_scale != 1.0:
            e = e._replace(p=e.p * loss_scale)
        events.append(e)
    return ScenarioSpec(ticks=spec.ticks, events=tuple(events))


class CompiledSweep(NamedTuple):
    """R compiled replicas of one scenario: ``base`` carries the facts
    they share (ticks, n, partition rows, fault tensors, has_revive),
    the event rows and the loss schedule a leading replica axis."""

    base: CompiledScenario
    replicas: int
    ev_tick: torch.Tensor  # int32[R, E]
    ev_kind: torch.Tensor  # int32[R, E]
    ev_node: torch.Tensor  # int32[R, E]
    loss: torch.Tensor  # float32[R, ticks]
    boundaries: tuple[tuple[int, ...], ...]  # per-replica segment ticks
    loss_scales: tuple[float, ...]
    kill_jitter: tuple[int, ...]
    flap_jitter: tuple[int, ...] = ()

    def replica(self, r: int) -> CompiledScenario:
        """Replica r as the ``CompiledScenario`` the runner steps: its
        own event rows, loss row and boundaries."""
        return self.base._replace(
            ev_tick=self.ev_tick[r], ev_kind=self.ev_kind[r], ev_node=self.ev_node[r],
            loss=self.loss[r], boundaries=self.boundaries[r],
        )


def _norm_axis(name: str, values: Sequence[float] | None, replicas: int, default: Any) -> tuple:
    if values is None:
        return (default,) * replicas
    out = tuple(values)
    if len(out) != replicas:
        raise ValueError(
            f"{name} must have one entry per replica "
            f"(got {len(out)} for {replicas})"
        )
    return out


def compile_sweep(
    spec: ScenarioSpec,
    n: int,
    *,
    replicas: int,
    base_loss: float = 0.0,
    loss_scales: Sequence[float] | None = None,
    kill_jitter: Sequence[int] | None = None,
    flap_jitter: Sequence[int] | None = None,
    device: torch.device | str | None = None,
) -> CompiledSweep:
    """Lower a spec to R replica timelines on ``device`` (host-side, no
    keys drawn: a failed compile advances no key)."""
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1 (got {replicas})")
    scales = _norm_axis("loss_scales", loss_scales, replicas, 1.0)
    jitters = _norm_axis("kill_jitter", kill_jitter, replicas, 0)
    fjitters = _norm_axis("flap_jitter", flap_jitter, replicas, 0)
    for s in scales:
        if s < 0.0:
            raise ValueError(f"loss scales must be >= 0 (got {s})")
    if all(s == 1.0 for s in scales) and not any(jitters) and not any(fjitters):
        # a seed-only sweep: every replica's rows are the same, compiled once
        base = compile_spec(spec, n, base_loss=base_loss, device=device)

        def rows(a: torch.Tensor) -> torch.Tensor:
            return a[None].expand((replicas,) + tuple(a.shape))

        return CompiledSweep(
            base=base, replicas=replicas,
            ev_tick=rows(base.ev_tick), ev_kind=rows(base.ev_kind),
            ev_node=rows(base.ev_node), loss=rows(base.loss),
            boundaries=(base.boundaries,) * replicas,
            loss_scales=scales, kill_jitter=jitters, flap_jitter=fjitters,
        )
    per: list[CompiledScenario] = []
    for r in range(replicas):
        try:
            spec_r = replica_spec(spec, kill_jitter=jitters[r], loss_scale=scales[r],
                                  flap_jitter=fjitters[r])
            per.append(compile_spec(spec_r, n, base_loss=base_loss * scales[r], device=device))
        except ValueError as e:
            raise ValueError(f"replica {r}: {e}") from e
    base = per[0]
    for r, c in enumerate(per[1:], start=1):
        # jitter and scale may not change shapes or static facts; they
        # touch no partition row and no fault tensor (replica_spec)
        if (
            c.ticks != base.ticks
            or c.has_revive != base.has_revive
            or c.ev_tick.shape != base.ev_tick.shape
            or c.has_delay != base.has_delay
            or c.delay_depth != base.delay_depth
        ):
            raise ValueError(f"replica {r} diverges in static scenario shape")
    return CompiledSweep(
        base=base, replicas=replicas,
        ev_tick=torch.stack([c.ev_tick for c in per]),
        ev_kind=torch.stack([c.ev_kind for c in per]),
        ev_node=torch.stack([c.ev_node for c in per]),
        loss=torch.stack([c.loss for c in per]),
        boundaries=tuple(c.boundaries for c in per),
        loss_scales=scales, kill_jitter=jitters, flap_jitter=fjitters,
    )


def _schedule_from_key(rkey: torch.Tensor, compiled: CompiledScenario) -> torch.Tensor:
    """One replica's segment-exact schedule from its replica key: the
    chained draws ``SimCluster._split`` makes on a cluster whose key is
    ``rkey``, consumed by ``compile.key_schedule``."""
    state = {"key": rkey}

    def split() -> torch.Tensor:
        state["key"], sub = prng.split(state["key"])
        return sub

    return key_schedule(split, compiled)


def sweep_key_schedule(replica_keys: Sequence[torch.Tensor], cs: CompiledSweep) -> torch.Tensor:
    """int64[R, ticks, 2] (uint32 words, on the CPU): replica r's
    segment-exact schedule over its own boundaries, drawn from replica
    key r as a standalone cluster with that key would draw it.
    Threefry is elementwise in the key, so this equals the reference's
    vmapped form."""
    if len(replica_keys) != cs.replicas:
        raise ValueError(f"{len(replica_keys)} replica keys for {cs.replicas} replicas")
    return torch.stack([
        _schedule_from_key(rkey, cs.base._replace(boundaries=cs.boundaries[r]))
        for r, rkey in enumerate(replica_keys)
    ])


# ---------------------------------------------------------------------------
# static refusals and the knob axes
# ---------------------------------------------------------------------------


def precheck_shard(replicas: int) -> None:
    """``shard=True``'s refusal, made before any key is drawn: on one
    visible card (or none) it is the reference's accepted no-op; the
    replica axis over several cards is not ported."""
    del replicas
    if torch.cuda.is_available() and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "shard=True over several cards (the replica axis split across "
            "devices) is not ported yet (ROADMAP.md queue 1 item 11, "
            "'Sharding across cards'); run the sweep on one card"
        )


def policy_knob_axes(policy: Any, policy_axes: dict[str, Sequence[int]] | None, replicas: int):
    """Each replica's ``PolicyKnobs`` (host ints): the swept knobs from
    ``policy_axes`` (one int per replica), the rest the compiled
    policy's operating point; None without a policy (``policy_axes``
    alone is refused)."""
    from ringpop_tpu_torch.policies import core as pol

    if policy is None:
        if policy_axes:
            raise ValueError("policy_axes requires policy=")
        return None
    axes = dict(policy_axes or {})
    cols: dict[str, list[int]] = {}
    for field in pol.PolicyKnobs._fields:
        if field in axes:
            v = np.asarray(axes.pop(field), np.int32)
            if v.shape != (replicas,):
                raise ValueError(
                    f"policy axis {field!r} must have one value per "
                    f"replica (got shape {v.shape} for {replicas})"
                )
            cols[field] = [int(x) for x in v]
        else:
            cols[field] = [int(getattr(policy.knobs, field))] * replicas
    if axes:
        raise ValueError(
            f"unknown policy axes {sorted(axes)} "
            f"(knobs: {', '.join(pol.PolicyKnobs._fields)})"
        )
    return [pol.PolicyKnobs(**{f: cols[f][r] for f in cols}) for r in range(replicas)]


def replica_policy(policy: Any, policy_axes: dict[str, Sequence[int]] | None, r: int):
    """Replica r's effective policy: the one a standalone
    ``run_scenario(policy=...)`` takes to reproduce replica r."""
    if policy is None:
        return None
    knobs = policy.knobs._asdict()
    for key, vals in (policy_axes or {}).items():
        knobs[key] = int(vals[r])
    return policy._replace(knobs=type(policy.knobs)(**knobs))


def param_knob_axes(
    params: Any,
    param_axes: dict[str, Sequence[float | int]] | None,
    replicas: int,
    *,
    n: int,
    backend: str,
    period_active: bool,
    damping: bool,
) -> list[sim.SwimKnobs] | None:
    """Each replica's ``SwimKnobs``: the swept knobs from ``param_axes``
    (one value per replica), the rest ``params``' values, each cast to
    its knob dtype.  Every axis value is validated first (range, the
    int8 digit budgets at the axis maximum, the backend and scenario
    composition: ``runner.validate_param_knobs``)."""
    if not param_axes:
        return None
    swp = params.swim if backend == "delta" else params
    axes = dict(param_axes)
    defaults = sim.swim_knob_values(swp)
    knob_values: dict[str, list] = {}
    cols: dict[str, list] = {}
    for field in sim.SwimKnobs._fields:
        if field in axes:
            v = np.asarray(axes.pop(field))
            if v.shape != (replicas,):
                raise ValueError(
                    f"param axis {field!r} must have one value per "
                    f"replica (got shape {v.shape} for {replicas})"
                )
            knob_values[field] = [x.item() for x in v]
            cols[field] = [sim.knob_cast(field, x) for x in knob_values[field]]
        else:
            cols[field] = [sim.knob_cast(field, defaults[field])] * replicas
    if axes:
        raise ValueError(
            f"unknown param axes {sorted(axes)} "
            f"(knobs: {', '.join(sim.SwimKnobs._fields)})"
        )
    runner.validate_param_knobs(n, swp, knob_values, backend=backend,
                                period_active=period_active, damping=damping)
    return [sim.SwimKnobs(**{f: cols[f][r] for f in cols}) for r in range(replicas)]


def replica_param_knobs(
    param_axes: dict[str, Sequence[float | int]] | None, r: int
) -> dict[str, float | int] | None:
    """Replica r's knob overrides: the ``param_knobs`` a standalone
    ``run_scenario`` needs to reproduce replica r."""
    if not param_axes:
        return None
    out: dict[str, float | int] = {}
    for key, vals in param_axes.items():
        v = vals[r]
        out[key] = float(v) if np.dtype(sim.SWIM_KNOB_DTYPES[key]).kind == "f" else int(v)
    return out


# ---------------------------------------------------------------------------
# the replica loop
# ---------------------------------------------------------------------------


def _clone(state: Any) -> Any:
    """A copy of every tensor of a state: a replica's own start state
    (the steps write some of their tensors in place)."""
    return type(state)(*(v.clone() if torch.is_tensor(v) else v for v in state))


class Replicas:
    """The running replicas of one sweep.  Replica r's carry (state, up,
    responsive, adjacency, period row, overload, policy and provenance
    carries) is made when its run begins, from a copy of the start state;
    ``segment`` runs every replica over one tick range and returns the
    telemetry as [R, ticks] tensors ([R, ticks, B] for a histogram plane,
    ``pv_heard`` among them).  Replica r's policy is
    ``replica_policy(policy, policy_axes, r)``; the track reservations
    are the spec's, shared by every replica, each of which traces its own
    wavefronts."""

    def __init__(self, state: Any, net: sim.NetState, adj: torch.Tensor, cs: CompiledSweep,
                 keys: torch.Tensor, params: Any, knobs: list[sim.SwimKnobs] | None,
                 *, traffic: Any | None = None, policy: Any | None = None,
                 policy_axes: dict[str, Sequence[int]] | None = None):
        self.start, self.net, self.adj, self.cs = state, net, adj, cs
        self.keys, self.params = keys, params
        self.knobs = knobs
        self.traffic = runner.policy_traffic(runner.overload_traffic(traffic, cs.base), policy)
        self.policies = [replica_policy(policy, policy_axes, r) for r in range(cs.replicas)]
        self.loss = cs.loss.cpu().numpy()  # one readback for every replica
        self.carries: list[tuple | None] = [None] * cs.replicas
        self.pv_at = self.pv_node = None  # the track reservations, set with the carries

    def segment(self, a: int, b: int) -> dict[str, torch.Tensor]:
        global _dispatches
        _dispatches += 1
        rows = []
        for r in range(self.cs.replicas):
            comp = self.cs.replica(r)
            if self.carries[r] is None:
                st, period, ov = runner.prepare_faults(_clone(self.start), self.net, comp,
                                                       self.params)
                po = None
                if self.policies[r] is not None:
                    po = runner.prepare_policy(self.policies[r], self.net, comp.n,
                                               self.traffic.static.max_retries)
                pv, self.pv_at, self.pv_node = runner.prepare_prov(comp, self.net, self.params)
                self.carries[r] = (st, self.net.up, self.net.responsive, self.adj, period,
                                   ov, po, pv)
            st, up, resp, adj, period, ov, po, pv = self.carries[r]
            hand = sim._Handoff(st)
            self.carries[r] = None
            del st
            st, up, resp, adj, period, ov, po, pv, ys = runner._scenario_scan_impl(
                hand, up, resp, adj, period, comp, self.keys[r, a:b], self.loss[r, a:b], a,
                params=self.params, knobs=None if self.knobs is None else self.knobs[r],
                traffic=self.traffic, ov=ov, po=po, policy=self.policies[r], pv=pv,
                pv_at=self.pv_at, pv_node=self.pv_node)
            self.carries[r] = (st, up, resp, adj, period, ov, po, pv)
            rows.append(ys)
        return {k: torch.stack([y[k] for y in rows]) for k in rows[0]}

    def program_args(self, a: int, b: int) -> tuple:
        """What ``segment(a, b)`` runs on, for its dispatch ledger row: the
        start state, net and adjacency (each replica's carry has their
        shapes), the segment's [R, S] keys and loss rows, its first tick
        and the workload."""
        return (self.start, self.net, self.adj, self.keys[:, a:b], self.loss[:, a:b], a,
                self.traffic)

    def program_statics(self) -> dict[str, Any]:
        """The static configuration of ``segment``: parameters, each
        replica's policy and protocol knobs."""
        return dict(params=self.params, policies=tuple(self.policies), knobs=self.knobs)

    def finish(self) -> tuple[list[Any], list[sim.NetState]]:
        """The final states and nets, replica by replica.  As in the
        reference's sweep, a final net carries the up and responsive
        bits, the adjacency, the period row and the overload, policy and
        provenance carries, not the link rules."""
        states = [c[0] for c in self.carries]
        nets = [sim.NetState(up=up, responsive=resp, adj=adj, period=period,
                             **runner.carry_fields(ov, po, pv))
                for _, up, resp, adj, period, ov, po, pv in self.carries]
        self.carries = [None] * self.cs.replicas
        return states, nets


def prepare(
    state: Any,
    net: sim.NetState,
    cs: CompiledSweep,
    params: Any,
    *,
    shard: bool = False,
    traffic: Any | None = None,
    policy: Any | None = None,
    policy_axes: dict[str, Sequence[int]] | None = None,
    param_axes: dict[str, Sequence[float | int]] | None = None,
) -> tuple[torch.Tensor, list[sim.SwimKnobs] | None]:
    """Every static refusal of a sweep, in the reference's order, before
    any key is drawn; returns the normalized adjacency and each
    replica's knobs.  ``traffic`` is lowered and ``policy`` compiled
    (``SimCluster.compile_traffic``, ``policies.compile_policy``)."""
    adj = runner.precheck(state, net, cs.base, params)
    runner.precheck_overload(cs.base, traffic, net)
    runner.precheck_policy(policy, traffic, net)
    policy_knob_axes(policy, policy_axes, cs.replicas)
    runner.precheck_prov(cs.base, net, params)
    if shard:
        precheck_shard(cs.replicas)
    knobs = param_knob_axes(
        params, param_axes, cs.replicas, n=cs.base.n,
        backend="delta" if isinstance(params, DeltaParams) else "dense",
        period_active=runner.period_active(net, cs.base),
        damping=getattr(state, "damp", None) is not None,
    )
    return adj, knobs


def run_sweep_compiled(
    state: Any,
    net: sim.NetState,
    keys: torch.Tensor,
    cs: CompiledSweep,
    params: Any,
    *,
    shard: bool = False,
    traffic: Any | None = None,
    policy: Any | None = None,
    policy_axes: dict[str, Sequence[int]] | None = None,
    param_axes: dict[str, Sequence[float | int]] | None = None,
    program_tag: str | None = None,
) -> tuple[list[Any], list[sim.NetState], dict[str, torch.Tensor]]:
    """R replicas of the compiled scenario: (final states, final nets,
    telemetry as [R, ticks] tensors on the device).  ``state`` and
    ``net`` are the shared start, left as they are; ``keys`` is
    ``sweep_key_schedule``'s.  Replica r with ``param_axes`` equals a
    standalone ``run_scenario(param_knobs=replica_param_knobs(param_axes,
    r))``, and with ``policy_axes`` ``run_scenario(policy=replica_policy(
    policy, policy_axes, r))``; ``traffic`` (a ``CompiledTraffic``)
    serves in every replica.  ``program_tag`` names the dispatch ledger's
    program, ``run_sweep:<program_tag>`` (``run_sweep`` untagged)."""
    if tuple(keys.shape[:2]) != (cs.replicas, cs.base.ticks):
        raise ValueError(
            f"key schedule is {tuple(keys.shape[:2])} for "
            f"({cs.replicas} replicas, {cs.base.ticks} ticks)"
        )
    adj, knobs = prepare(state, net, cs, params, shard=shard, traffic=traffic, policy=policy,
                         policy_axes=policy_axes, param_axes=param_axes)
    reps = Replicas(state, net, adj, cs, keys, params, knobs, traffic=traffic, policy=policy,
                    policy_axes=policy_axes)
    meta: dict[str, Any] = {
        "backend": "delta" if isinstance(params, DeltaParams) else "dense",
        "n": cs.base.n, "ticks": cs.base.ticks, "replicas": cs.replicas,
    }
    if traffic is not None:
        meta["traffic_m"] = traffic.static.m
    if policy is not None:
        meta["policy"] = policy.name
    if param_axes:
        meta["param_axes"] = sorted(param_axes)
    if cs.base.trace_rumors:
        meta["trace_rumors"] = cs.base.trace_rumors
    # ledger off (the default): a plain call-through; on, one row
    ys = default_ledger().dispatch(
        "run_sweep" if program_tag is None else f"run_sweep:{program_tag}",
        reps.segment, 0, cs.base.ticks, _meta=meta,
        _sig=(reps.program_args(0, cs.base.ticks), reps.program_statics()))
    states, nets = reps.finish()
    return states, nets, ys


def sweep_trace(stacks: dict[str, np.ndarray], cluster: Any, replica_keys: np.ndarray,
                cs: CompiledSweep, start_tick: int, spec: dict | None) -> "SweepTrace":
    """The ``SweepTrace`` of host telemetry stacks: [R, T] series are
    metrics, [R, T, B] ones planes."""
    return SweepTrace(
        metrics={k: v for k, v in stacks.items()
                 if k not in ("converged", "live", "loss") and v.ndim == 2},
        planes={k: v for k, v in stacks.items() if v.ndim == 3},
        converged=stacks["converged"],
        live=stacks["live"],
        loss=stacks["loss"],
        n=cluster.n,
        backend=cluster.backend,
        replica_keys=replica_keys,
        loss_scales=cs.loss_scales,
        kill_jitter=cs.kill_jitter,
        flap_jitter=cs.flap_jitter,
        start_tick=start_tick,
        spec=spec,
    )


# ---------------------------------------------------------------------------
# SweepTrace: R stacked per-replica telemetry series
# ---------------------------------------------------------------------------

SWEEP_FORMAT_VERSION = 1

_REQUIRED = ("converged", "live", "loss")


class SweepTrace:
    """Per-tick telemetry of R replicas: every ``Trace`` series with a
    leading replica axis, plus the per-replica sweep parameters and
    replica keys (enough to run any replica again standalone).  The
    ``.npz`` layout is the reference's, so either package reads the
    other's files."""

    def __init__(
        self,
        *,
        metrics: dict[str, np.ndarray],
        converged: np.ndarray,
        live: np.ndarray,
        loss: np.ndarray,
        n: int,
        backend: str,
        replica_keys: np.ndarray,
        loss_scales: Sequence[float],
        kill_jitter: Sequence[int],
        flap_jitter: Sequence[int] | None = None,
        start_tick: int = 0,
        spec: dict[str, Any] | None = None,
        planes: dict[str, np.ndarray] | None = None,
    ):
        self.metrics = {k: np.asarray(v) for k, v in metrics.items()}
        self.planes = {k: np.asarray(v) for k, v in (planes or {}).items()}
        self.converged = np.asarray(converged, dtype=bool)
        self.live = np.asarray(live, dtype=np.int32)
        self.loss = np.asarray(loss, dtype=np.float32)
        self.n = int(n)
        self.backend = str(backend)
        self.replica_keys = np.asarray(replica_keys)
        self.loss_scales = tuple(float(s) for s in loss_scales)
        self.kill_jitter = tuple(int(j) for j in kill_jitter)
        self.flap_jitter = tuple(
            int(j) for j in (flap_jitter if flap_jitter else (0,) * len(self.kill_jitter))
        )
        self.start_tick = int(start_tick)
        self.spec = spec
        # in memory only (run_sweep attaches them, one per replica)
        self.final_states: list[Any] | None = None
        self.final_nets: list[sim.NetState] | None = None

    @property
    def replicas(self) -> int:
        return int(self.converged.shape[0])

    @property
    def ticks(self) -> int:
        return int(self.converged.shape[1])

    def validate(self) -> "SweepTrace":
        r, t = self.converged.shape if self.converged.ndim == 2 else (0, 0)
        if r < 1 or t < 1:
            raise ValueError("sweep trace needs [R, ticks]-shaped series")
        for name in _REQUIRED:
            arr = getattr(self, name)
            if arr.shape != (r, t):
                raise ValueError(f"sweep series {name!r} is not [{r}, {t}]-shaped")
        for name, arr in self.metrics.items():
            if arr.shape != (r, t):
                raise ValueError(f"sweep metric {name!r} is not [{r}, {t}]-shaped")
        for name, arr in self.planes.items():
            if arr.ndim != 3 or arr.shape[:2] != (r, t):
                raise ValueError(f"sweep plane {name!r} is not [{r}, {t}, B]-shaped")
        if self.replica_keys.shape[0] != r:
            raise ValueError("replica_keys does not cover every replica")
        if len(self.loss_scales) != r or len(self.kill_jitter) != r or len(self.flap_jitter) != r:
            raise ValueError("sweep params do not cover every replica")
        if not np.all((self.live >= 0) & (self.live <= self.n)):
            raise ValueError("sweep live counts outside [0, n]")
        return self

    def replica(self, r: int) -> Trace:
        """Replica r as a standalone ``Trace`` (its effective spec where
        one is recorded)."""
        spec = self.spec
        if spec is not None and (
            self.kill_jitter[r] or self.flap_jitter[r] or self.loss_scales[r] != 1.0
        ):
            spec = replica_spec(
                ScenarioSpec.from_dict(spec), kill_jitter=self.kill_jitter[r],
                loss_scale=self.loss_scales[r], flap_jitter=self.flap_jitter[r],
            ).to_dict()
        return Trace(
            metrics={k: v[r] for k, v in self.metrics.items()},
            planes={k: v[r] for k, v in self.planes.items()},
            converged=self.converged[r],
            live=self.live[r],
            loss=self.loss[r],
            n=self.n,
            backend=self.backend,
            start_tick=self.start_tick,
            spec=spec,
        )

    @classmethod
    def concat_ticks(cls, slabs, *, spec: dict[str, Any] | None = None) -> "SweepTrace":
        """Contiguous per-segment slabs (a streamed sweep's segment
        store) joined along the tick axis: the [R, T] stacks of the
        unsegmented sweep.  Slabs must share the replica axis (keys and
        sweep parameters) and follow each other tick for tick."""
        slabs = list(slabs)
        if not slabs:
            raise ValueError("no slabs to concatenate")
        first = slabs[0]
        expect = first.start_tick
        for s in slabs:
            if s.n != first.n or s.backend != first.backend:
                raise ValueError("slabs disagree on n/backend")
            if set(s.metrics) != set(first.metrics):
                raise ValueError("slabs disagree on metric series")
            if set(s.planes) != set(first.planes):
                raise ValueError("slabs disagree on histogram planes")
            if (
                s.replicas != first.replicas
                or not np.array_equal(s.replica_keys, first.replica_keys)
                or s.loss_scales != first.loss_scales
                or s.kill_jitter != first.kill_jitter
                or s.flap_jitter != first.flap_jitter
            ):
                raise ValueError("slabs disagree on the replica axis")
            if s.start_tick != expect:
                raise ValueError(
                    f"slab at start_tick {s.start_tick} is not contiguous "
                    f"(expected {expect})"
                )
            expect += s.ticks
        return cls(
            metrics={k: np.concatenate([s.metrics[k] for s in slabs], axis=1)
                     for k in first.metrics},
            planes={k: np.concatenate([s.planes[k] for s in slabs], axis=1)
                    for k in first.planes},
            converged=np.concatenate([s.converged for s in slabs], axis=1),
            live=np.concatenate([s.live for s in slabs], axis=1),
            loss=np.concatenate([s.loss for s in slabs], axis=1),
            n=first.n,
            backend=first.backend,
            replica_keys=first.replica_keys,
            loss_scales=first.loss_scales,
            kill_jitter=first.kill_jitter,
            flap_jitter=first.flap_jitter,
            start_tick=first.start_tick,
            spec=spec if spec is not None else first.spec,
        )

    # -- per-replica outcome ticks --------------------------------------------

    def detect_ticks(self, metric: str = "faulty_declared") -> np.ndarray:
        """int[R]: first tick with a faulty declaration, or -1."""
        hits = self.metrics[metric] > 0
        any_ = hits.any(axis=1)
        return np.where(any_, hits.argmax(axis=1), -1).astype(np.int64)

    def heal_ticks(self) -> np.ndarray:
        """int[R]: first tick from which ``converged`` holds to the end
        of the run, or -1."""
        rev = self.converged[:, ::-1]
        suffix = np.where(rev.all(axis=1), self.ticks, (~rev).argmax(axis=1))
        return np.where(suffix > 0, self.ticks - suffix, -1).astype(np.int64)

    def summary(self) -> dict[str, dict[str, float]]:
        """The detection- and heal-tick distributions across replicas in
        ``stats.Histogram.print_obj`` key shape (replicas that never
        detect or heal are counted apart)."""
        out: dict[str, dict[str, Any]] = {}
        for name, ticks in (("detect_tick", self.detect_ticks()),
                            ("heal_tick", self.heal_ticks())):
            got = ticks[ticks >= 0]
            hist = Histogram(sample_size=max(len(got), 1))
            for v in got:
                hist.update(float(v))
            out[name] = hist.print_obj()
        out["replicas"] = {
            "count": self.replicas,
            "detected": int((self.detect_ticks() >= 0).sum()),
            "healed": int((self.heal_ticks() >= 0).sum()),
            "converged_final": int(self.converged[:, -1].sum()),
        }
        return out

    def serving_summary(self) -> list[dict[str, Any]] | None:
        """Per-replica serving scorecards (None for a sweep that served
        no workload): goodput, retry amplification, the latency
        percentiles of the replica's histogram plane when the latency
        plane ran, and the overload and policy peaks when they ran."""
        if "lookups" not in self.metrics:
            return None
        from ringpop_tpu_torch.traffic.engine import total_sends
        from ringpop_tpu_torch.traffic.latency import hist_stats

        rows = []
        for r in range(self.replicas):
            m = {k: v[r] for k, v in self.metrics.items()}
            lookups = int(m["lookups"].sum())
            delivered = int(m["delivered"].sum())
            sends = total_sends(m)
            row: dict[str, Any] = {
                "replica": r,
                "lookups": lookups,
                "delivered": delivered,
                "goodput": delivered / lookups if lookups else 0.0,
                "misroutes": int(m["misroutes"].sum()),
                "amplification": sends / delivered if delivered else 0.0,
            }
            if "gray_timeouts" in m:
                row["gray_timeouts"] = int(m["gray_timeouts"].sum())
            if "ov_gray_nodes" in m:
                row["ov_gray_peak"] = int(m["ov_gray_nodes"].max())
                row["ov_pressure_peak"] = int(m["ov_pressure_max"].max())
            if "policy_shed" in m:
                row["policy_shed"] = int(m["policy_shed"].sum())
                row["policy_quarantine_peak"] = int(m["policy_quarantined"].max())
                row["policy_retry_cap_min"] = int(m["policy_retry_cap"].min())
            if "lat_hist_ms" in self.planes:
                agg = hist_stats(self.planes["lat_hist_ms"][r].sum(axis=0))
                row["lat_p50_ms"] = agg["median"]
                row["lat_p95_ms"] = agg["p95"]
                row["lat_p99_ms"] = agg["p99"]
            rows.append(row)
        return rows

    # -- npz round trip ---------------------------------------------------------

    def to_arrays(self, prefix: str = "") -> dict[str, np.ndarray]:
        arrays = {
            f"{prefix}converged": self.converged,
            f"{prefix}live": self.live,
            f"{prefix}loss": self.loss,
            f"{prefix}replica_keys": self.replica_keys,
        }
        for name, arr in self.metrics.items():
            arrays[f"{prefix}m.{name}"] = arr
        for name, arr in self.planes.items():
            arrays[f"{prefix}p.{name}"] = arr
        return arrays

    def meta(self) -> dict[str, Any]:
        return {
            "version": SWEEP_FORMAT_VERSION,
            "kind": "sweep",
            "n": self.n,
            "backend": self.backend,
            "start_tick": self.start_tick,
            "loss_scales": list(self.loss_scales),
            "kill_jitter": list(self.kill_jitter),
            "flap_jitter": list(self.flap_jitter),
            "spec": self.spec,
        }

    @classmethod
    def from_arrays(cls, data: Any, meta: dict[str, Any], prefix: str = "") -> "SweepTrace":
        keys = list(getattr(data, "files", data.keys()))
        metrics = {key[len(prefix) + 2:]: np.asarray(data[key])
                   for key in keys if key.startswith(f"{prefix}m.")}
        planes = {key[len(prefix) + 2:]: np.asarray(data[key])
                  for key in keys if key.startswith(f"{prefix}p.")}
        return cls(
            metrics=metrics,
            planes=planes,
            converged=np.asarray(data[f"{prefix}converged"]),
            live=np.asarray(data[f"{prefix}live"]),
            loss=np.asarray(data[f"{prefix}loss"]),
            n=meta["n"],
            backend=meta["backend"],
            replica_keys=np.asarray(data[f"{prefix}replica_keys"]),
            loss_scales=meta["loss_scales"],
            kill_jitter=meta["kill_jitter"],
            flap_jitter=meta.get("flap_jitter"),
            start_tick=meta.get("start_tick", 0),
            spec=meta.get("spec"),
        )

    def save(self, path: str) -> None:
        arrays = self.to_arrays()
        arrays["meta"] = np.frombuffer(json.dumps(self.meta()).encode(), dtype=np.uint8)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)  # atomic, like Trace.save

    @classmethod
    def load(cls, path: str) -> "SweepTrace":
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(bytes(data["meta"]).decode())
            if meta.get("kind") != "sweep":
                raise ValueError("not a sweep trace (use scenarios.Trace.load)")
            if meta["version"] != SWEEP_FORMAT_VERSION:
                raise ValueError(f"unsupported sweep trace version {meta['version']}")
            return cls.from_arrays(data, meta)
