"""Declarative scenario specs (JSON) + the ``--script`` DSL compiler.

A copy of the JAX package's ``scenarios/spec.py`` (which imports no
JAX itself): the port keeps its own, so it imports nothing of that
package.  The provenance plane's limits it validates against are
copied below (``MAX_RUMORS``, ``MAX_TICKS``).

A scenario is a tick count plus a list of timed fault events.  Events
apply at the START of their tick, before that tick's protocol period —
the same convention as the host sequence ``apply fault; tick()``.

JSON shape (``ScenarioSpec.from_json`` / ``to_json``)::

    {
      "ticks": 120,
      "events": [
        {"at": 10, "op": "kill",      "node": 3},
        {"at": 12, "op": "suspend",   "node": 4},
        {"at": 30, "op": "resume",    "node": 4},
        {"at": 20, "op": "partition", "groups": [[0,1,2,3], [4,5,6,7]]},
        {"at": 60, "op": "heal"},
        {"at": 40, "op": "loss",      "p": 0.2},
        {"at": 70, "op": "loss_ramp", "until": 90, "to": 0.0},
        {"at": 95, "op": "revive",    "node": 3}
      ]
    }

Ops:

* ``kill`` / ``suspend`` / ``resume`` — the ``NetState.up`` /
  ``responsive`` bit edits (tick-cluster.js:432-462 signal surface).
* ``revive`` — a killed process restarts fresh with a higher
  incarnation and re-joins against the first live node
  (tick-cluster.js:418-430); dense backend only inside the scan (the
  delta backend's join is a host-side row op — use the host loop).
* ``partition`` — block netsplit in the group-id adjacency form;
  ``groups`` must cover every node exactly once (the only form both
  backends accept inside one compiled program).  ``heal`` restores
  full connectivity.
* ``loss`` — set the iid packet-loss probability from this tick on.
* ``loss_ramp`` — stepwise-linear ramp from the loss in force at
  ``at`` to ``to``, reaching ``to`` at tick ``until - 1`` (compiled
  into one per-tick ``loss`` step per tick of the ramp).

Failure-model ops (the asymmetric-incident families; scenarios/faults.py
compiles them, docs/simulation.md documents the host conventions):

* ``link_loss`` — DIRECTED extra drop probability ``p`` on every link
  from a ``src`` node set to a ``dst`` node set during ``[at, until)``
  (``until`` defaults to the end of the run): ``{"op": "link_loss",
  "at": 10, "src": [0,1], "dst": [4,5], "p": 0.9}`` makes dst hear src
  only 10% of the time while src still hears dst perfectly — the
  one-way-loss incident a symmetric ``loss`` cannot express.
* ``delay`` — per-link message latency: claims sent over src->dst
  links land ``delay + U{0..jitter}`` ticks later (0 = immediate)
  during ``[at, until)``; the ping/ack RTT itself still completes
  in-tick (the simulation's time-compression convention — latency
  slows information, not liveness).  Both backends: the dense
  ``[D, N, N]`` in-flight claim matrix, or the delta backend's
  per-arrival-slot claim lanes (``swim_delta.install_pending``).
* ``flap`` — kill/revive duty cycles: each node in ``nodes`` (offset
  ``stagger`` ticks apart) is killed for ``down`` ticks then up for
  ``up`` ticks, cycling while the kill tick is < ``until``; every kill
  emits its matching revive, so the storm always heals itself.
* ``gray`` — slow-process failure: the node's protocol period becomes
  ``factor`` ticks during ``[at, until)`` — it still answers pings and
  witness duties every tick (stays alive in others' views) but
  initiates its own probes only every ``factor``-th tick.
* ``rolling_restart`` — a staggered deploy wave: node k of ``nodes``
  is killed at ``at + k * every`` and revived (fresh incarnation,
  bootstrap re-join) ``down`` ticks later.
* ``overload`` — the load-coupled gray feedback loop (needs a
  ``traffic`` workload co-running in the scan): during ``[at, until)``
  every node accumulates overload pressure ``max(0, pressure + sends
  - capacity)`` from the serve plane's per-tick sends landing on it;
  at ``pressure >= threshold`` the node's protocol period degrades to
  ``factor`` (it goes gray — and with the SLO latency plane on, gray
  holders time out off their duty phase, attracting the retry storms
  that feed the pressure back), recovering with hysteresis only once
  pressure drains to ``<= recover``.  At most one per spec.

``flap``/``rolling_restart`` expand to the kill/revive primitives at
compile time (one shared expansion, so the compiled scan and the host
loop see identical timelines).  Same-tick mixes of revives and other
node events apply in a canonical order — kill/suspend/resume bit edits
first, then revives in (tick, node-expansion) order, then partitions —
on both the scan and the host loop; only two events on the same
(tick, node) remain rejected as ambiguous.
"""

from __future__ import annotations

import json
from typing import Any, NamedTuple

# the provenance plane's static limits (``obs/provenance.py``): tracked
# rumor slots, and the int16 tick range of its carried planes
MAX_RUMORS = 64
MAX_TICKS = 32767

_NODE_OPS = ("kill", "revive", "suspend", "resume")
_FAULT_OPS = ("link_loss", "delay", "flap", "gray", "rolling_restart",
              "overload")
# observation ops: no protocol effect, no event tensor — compile-time
# configuration for the provenance plane (obs/provenance.py).  ``track``
# reserves a tracked-rumor slot for ``node``: the slot arms at the first
# qualifying suspect declaration about that subject at tick >= ``at``.
# Requires ``trace_rumors > 0`` on the spec.
_OBS_OPS = ("track",)
_OPS = (
    _NODE_OPS + ("partition", "heal", "loss", "loss_ramp")
    + _FAULT_OPS + _OBS_OPS
)

# ops that take a p value under the JSON key "p" (loss_ramp uses "to")
_P_OPS = ("loss", "link_loss", "delay")


class Event(NamedTuple):
    at: int
    op: str
    node: int | None = None
    groups: tuple[tuple[int, ...], ...] | None = None
    p: float | None = None
    until: int | None = None  # window end tick (exclusive)
    # failure-model fields (None unless the op uses them)
    nodes: tuple[int, ...] | None = None  # flap/gray/rolling targets
    src: tuple[int, ...] | None = None  # link rule: sender set
    dst: tuple[int, ...] | None = None  # link rule: receiver set
    down: int | None = None  # flap/rolling: ticks spent dead
    up: int | None = None  # flap: ticks spent alive per cycle
    every: int | None = None  # rolling: ticks between node starts
    stagger: int | None = None  # flap: per-node cycle offset
    factor: int | None = None  # gray/overload: protocol-period multiplier
    delay: int | None = None  # delay: base latency ticks
    jitter: int | None = None  # delay: uniform extra latency bound
    capacity: int | None = None  # overload: sends absorbed per tick
    threshold: int | None = None  # overload: pressure that flips gray
    recover: int | None = None  # overload: pressure that clears gray

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {"at": self.at, "op": self.op}
        if self.node is not None:
            d["node"] = self.node
        if self.groups is not None:
            d["groups"] = [list(g) for g in self.groups]
        if self.p is not None:
            d["p" if self.op in _P_OPS else "to"] = self.p
        if self.until is not None:
            d["until"] = self.until
        for name in ("nodes", "src", "dst"):
            v = getattr(self, name)
            if v is not None:
                d[name] = list(v)
        for name in ("down", "up", "every", "stagger", "factor",
                     "delay", "jitter", "capacity", "threshold", "recover"):
            v = getattr(self, name)
            if v is not None:
                d[name] = v
        return d

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Event":
        op = d.get("op")
        if op not in _OPS:
            raise ValueError(f"unknown scenario op {op!r} (one of {_OPS})")
        groups = d.get("groups")

        def _ints(name):
            return (
                tuple(int(m) for m in d[name]) if name in d else None
            )

        return cls(
            at=int(d["at"]),
            op=op,
            node=int(d["node"]) if "node" in d else None,
            groups=tuple(tuple(int(m) for m in g) for g in groups)
            if groups is not None
            else None,
            p=float(d["p"]) if "p" in d else (
                float(d["to"]) if "to" in d else None
            ),
            until=int(d["until"]) if "until" in d else None,
            nodes=_ints("nodes"),
            src=_ints("src"),
            dst=_ints("dst"),
            down=int(d["down"]) if "down" in d else None,
            up=int(d["up"]) if "up" in d else None,
            every=int(d["every"]) if "every" in d else None,
            stagger=int(d["stagger"]) if "stagger" in d else None,
            factor=int(d["factor"]) if "factor" in d else None,
            delay=int(d["delay"]) if "delay" in d else None,
            jitter=int(d["jitter"]) if "jitter" in d else None,
            capacity=int(d["capacity"]) if "capacity" in d else None,
            threshold=int(d["threshold"]) if "threshold" in d else None,
            recover=int(d["recover"]) if "recover" in d else None,
        )

    def target_nodes(self) -> tuple[int, ...]:
        """The node set of a flap/gray/rolling event (``nodes`` or the
        singular ``node``)."""
        if self.nodes is not None:
            return self.nodes
        if self.node is not None:
            return (self.node,)
        return ()


def expand_fault_primitives(e: Event, ticks: int) -> list[Event]:
    """``flap``/``rolling_restart`` as their primitive kill/revive
    events — the ONE expansion shared by the event-tensor compiler and
    the host-loop oracle (``compile.expand_events``), so both sides see
    identical timelines by construction.  Emission order (per node, per
    cycle) is deterministic; it is the intra-tick revive order."""
    out: list[Event] = []
    if e.op == "flap":
        cycle = e.down + e.up
        for idx, node in enumerate(e.target_nodes()):
            t = e.at + idx * (e.stagger or 0)
            while t < e.until:
                out.append(Event(at=t, op="kill", node=node))
                out.append(Event(at=t + e.down, op="revive", node=node))
                t += cycle
    elif e.op == "rolling_restart":
        for k, node in enumerate(e.target_nodes()):
            t = e.at + k * e.every
            out.append(Event(at=t, op="kill", node=node))
            out.append(Event(at=t + e.down, op="revive", node=node))
    return out


class ScenarioSpec(NamedTuple):
    ticks: int
    events: tuple[Event, ...] = ()
    # provenance plane (obs/provenance.py): number of tracked-rumor
    # slots to carry through the scan.  0 (the default) compiles the
    # exact legacy program — the plane doesn't exist.
    trace_rumors: int = 0

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "ticks": self.ticks,
            "events": [e.to_dict() for e in self.events],
        }
        if self.trace_rumors:
            d["trace_rumors"] = self.trace_rumors
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ScenarioSpec":
        return cls(
            ticks=int(d["ticks"]),
            events=tuple(Event.from_dict(e) for e in d.get("events", [])),
            trace_rumors=int(d.get("trace_rumors", 0)),
        )

    @classmethod
    def from_json(cls, text: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str) -> "ScenarioSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    def validate(self, n: int) -> "ScenarioSpec":
        """Static validation against a cluster size; raises ValueError."""
        if self.ticks < 1:
            raise ValueError(f"ticks must be >= 1 (got {self.ticks})")
        if self.trace_rumors < 0 or self.trace_rumors > MAX_RUMORS:
            raise ValueError(
                f"trace_rumors must be in [0, {MAX_RUMORS}] "
                f"(got {self.trace_rumors})"
            )
        if self.trace_rumors and self.ticks > MAX_TICKS:
            raise ValueError(
                f"the provenance plane carries int16 ticks: trace_rumors "
                f"needs ticks <= {MAX_TICKS} (got {self.ticks})"
            )
        n_track = sum(1 for e in self.events if e.op == "track")
        if n_track and not self.trace_rumors:
            raise ValueError(
                "track events need trace_rumors > 0 on the spec (the "
                "slot count is the compiled plane's static width)"
            )
        if n_track > self.trace_rumors:
            raise ValueError(
                f"{n_track} track events exceed trace_rumors="
                f"{self.trace_rumors} slots"
            )
        seen_node_tick: set[tuple[int, int]] = set()
        seen_part_tick: set[int] = set()

        def claim_node_tick(at: int, node: int, op: str) -> None:
            # two events touching one (tick, node) are genuinely
            # ambiguous (kill+revive of the same node, say); same-tick
            # events on DIFFERENT nodes apply in the canonical order
            # shared by the scan and the host loop (module docstring)
            if (at, node) in seen_node_tick:
                raise ValueError(
                    f"conflicting node events at tick {at} on node "
                    f"{node} ({op}): apply order inside one tick on one "
                    "node is undefined"
                )
            seen_node_tick.add((at, node))

        def check_window(e: Event, what: str) -> int:
            until = e.until if e.until is not None else self.ticks
            if not e.at < until <= self.ticks:
                raise ValueError(
                    f"{what} needs at < until <= ticks "
                    f"(got at={e.at}, until={until}, ticks={self.ticks})"
                )
            return until

        def check_nodes(e: Event, what: str) -> tuple[int, ...]:
            targets = e.target_nodes()
            if not targets or not all(0 <= m < n for m in targets):
                raise ValueError(
                    f"{what} needs nodes in [0, {n}) (got {targets})"
                )
            return targets

        gray_windows: dict[int, list[tuple[int, int]]] = {}
        overload_seen = False
        for e in self.events:
            if not 0 <= e.at < self.ticks:
                raise ValueError(
                    f"event {e.op!r} at tick {e.at} outside [0, {self.ticks})"
                )
            if e.op in _NODE_OPS:
                if e.node is None or not 0 <= e.node < n:
                    raise ValueError(
                        f"event {e.op!r} needs a node in [0, {n}) (got {e.node})"
                    )
                claim_node_tick(e.at, e.node, e.op)
            elif e.op == "flap":
                if not (e.down and e.down >= 1 and e.up and e.up >= 1):
                    raise ValueError(
                        f"flap needs down >= 1 and up >= 1 "
                        f"(got down={e.down}, up={e.up})"
                    )
                if (e.stagger or 0) < 0:
                    raise ValueError(f"flap stagger must be >= 0 (got {e.stagger})")
                until = check_window(e, "flap")
                check_nodes(e, "flap")
                if until + e.down > self.ticks:
                    raise ValueError(
                        f"flap window ending at {until} needs until + down "
                        f"<= ticks so its last revive lands inside the run "
                        f"(down={e.down}, ticks={self.ticks})"
                    )
            elif e.op == "rolling_restart":
                if not (e.down and e.down >= 1 and e.every and e.every >= 1):
                    raise ValueError(
                        f"rolling_restart needs down >= 1 and every >= 1 "
                        f"(got down={e.down}, every={e.every})"
                    )
                targets = check_nodes(e, "rolling_restart")
                last = e.at + (len(targets) - 1) * e.every + e.down
                if last >= self.ticks:
                    raise ValueError(
                        f"rolling_restart's last revive at tick {last} falls "
                        f"outside [0, {self.ticks})"
                    )
            elif e.op == "gray":
                if not (e.factor and e.factor >= 1):
                    raise ValueError(f"gray needs factor >= 1 (got {e.factor})")
                until = check_window(e, "gray")
                for node in check_nodes(e, "gray"):
                    for a, b in gray_windows.get(node, ()):
                        if e.at < b and a < until:
                            raise ValueError(
                                f"gray windows overlap on node {node} "
                                f"([{a}, {b}) and [{e.at}, {until})): which "
                                "factor wins would be order-dependent"
                            )
                    gray_windows.setdefault(node, []).append((e.at, until))
            elif e.op == "overload":
                if overload_seen:
                    raise ValueError(
                        "at most one overload event per spec (which "
                        "capacity/threshold wins would be order-dependent)"
                    )
                overload_seen = True
                check_window(e, "overload")
                if not (e.capacity and e.capacity >= 1):
                    raise ValueError(
                        f"overload needs capacity >= 1 (got {e.capacity})"
                    )
                if not (e.threshold and e.threshold >= 1):
                    raise ValueError(
                        f"overload needs threshold >= 1 (got {e.threshold})"
                    )
                rec = e.recover if e.recover is not None else 0
                if not 0 <= rec < e.threshold:
                    raise ValueError(
                        f"overload needs 0 <= recover < threshold (got "
                        f"recover={e.recover}, threshold={e.threshold})"
                    )
                if not (e.factor and e.factor >= 2):
                    raise ValueError(
                        f"overload needs factor >= 2 (got {e.factor}; "
                        "1 would degrade nothing)"
                    )
            elif e.op == "track":
                if e.node is None or not 0 <= e.node < n:
                    raise ValueError(
                        f"track needs a node in [0, {n}) (got {e.node})"
                    )
                if sum(
                    1 for o in self.events
                    if o.op == "track" and o.node == e.node
                ) > 1:
                    raise ValueError(
                        f"duplicate track reservations for node {e.node}: "
                        "a subject's rumor slot arms once"
                    )
            elif e.op in ("link_loss", "delay"):
                check_window(e, e.op)
                for name in ("src", "dst"):
                    side = getattr(e, name)
                    if not side or not all(0 <= m < n for m in side):
                        raise ValueError(
                            f"{e.op} needs {name} nodes in [0, {n}) (got {side})"
                        )
                if e.op == "link_loss":
                    if e.p is None or not 0.0 <= e.p < 1.0:
                        raise ValueError(
                            f"link_loss needs p in [0, 1) (got {e.p})"
                        )
                else:
                    d, j = e.delay or 0, e.jitter or 0
                    if d < 0 or j < 0 or d + j < 1:
                        raise ValueError(
                            f"delay needs delay >= 0, jitter >= 0 and "
                            f"delay + jitter >= 1 (got delay={e.delay}, "
                            f"jitter={e.jitter})"
                        )
                    if e.p is not None and not 0.0 <= e.p < 1.0:
                        raise ValueError(
                            f"delay's optional p must be in [0, 1) (got {e.p})"
                        )
        # the expanded flap/rolling kill/revive primitives join the
        # (tick, node) conflict check — two flaps on one node, or a flap
        # colliding with an explicit kill, are caught here
        for e in self.events:
            if e.op in ("flap", "rolling_restart"):
                for pe in expand_fault_primitives(e, self.ticks):
                    if not 0 <= pe.at < self.ticks:  # pragma: no cover
                        raise ValueError(
                            f"{e.op} expansion places {pe.op!r} at tick "
                            f"{pe.at} outside [0, {self.ticks})"
                        )
                    claim_node_tick(pe.at, pe.node, f"{e.op} expansion")
        for e in self.events:
            if e.op == "partition":
                if not e.groups:
                    raise ValueError("partition event needs non-empty groups")
                flat = [m for g in e.groups for m in g]
                if sorted(flat) != list(range(n)):
                    raise ValueError(
                        "partition groups must cover every node exactly once "
                        "(the group-id adjacency form both backends compile)"
                    )
            if e.op in ("partition", "heal"):
                if e.at in seen_part_tick:
                    raise ValueError(
                        f"two partition/heal events at tick {e.at}: apply "
                        "order inside one tick is undefined"
                    )
                seen_part_tick.add(e.at)
            if e.op == "loss" and not (e.p is not None and 0.0 <= e.p < 1.0):
                raise ValueError(f"loss event needs p in [0, 1) (got {e.p})")
            if e.op == "loss_ramp":
                if e.p is None or not 0.0 <= e.p < 1.0:
                    raise ValueError(f"loss_ramp needs 'to' in [0, 1) (got {e.p})")
                if e.until is None or not e.at < e.until <= self.ticks:
                    raise ValueError(
                        f"loss_ramp needs at < until <= ticks "
                        f"(got at={e.at}, until={e.until})"
                    )
        return self


def script_to_spec(
    script: str, n: int, *, period_ms: int = 200
) -> ScenarioSpec:
    """Compile a ``tick-cluster --script`` command list into a spec.

    The mini-DSL is linear in wall/virtual time; the compiler replays it
    against a host-side liveness model to resolve the relative targets
    (``k`` kills the highest-indexed not-yet-killed node, ``K`` revives
    the oldest kill, ``l``/``L`` suspend/resume — the TpuSimCluster
    cluster's selection rule, minus protocol-state gating the compiler
    cannot know).  ``t`` is one tick; ``wN`` is ``max(1, N // period_ms)``
    ticks; reporting commands (``j g s p d D``) carry no protocol effect
    and compile to nothing; ``q`` ends the scenario.

    The live cluster applies back-to-back commands instantly; the
    compiled form needs a defined per-tick order, so a command that
    would collide with an earlier same-tick event (same node twice, or
    a revive mixing with other node events — the combinations
    ``ScenarioSpec.validate`` rejects) is placed one tick later,
    advancing the clock for everything after it (``k,K`` compiles to
    kill at t, revive at t+1).
    """
    events: list[Event] = []
    tick = 0
    killed: list[int] = []
    suspended: list[int] = []
    node_ticks: set[tuple[int, int]] = set()
    tick_kinds: dict[int, set[str]] = {}

    def place(op: str, node: int) -> None:
        nonlocal tick
        kind = "revive" if op == "revive" else "other"
        other = "other" if kind == "revive" else "revive"
        while (tick, node) in node_ticks or other in tick_kinds.get(tick, ()):
            tick += 1
        events.append(Event(at=tick, op=op, node=node))
        node_ticks.add((tick, node))
        tick_kinds.setdefault(tick, set()).add(kind)

    for op in script.split(","):
        op = op.strip()
        if not op:
            continue
        if op == "q":
            break
        if op[0] == "w":
            tick += max(1, int(float(op[1:]) / period_ms))
        elif op == "t":
            tick += 1
        elif op == "k":
            live = [i for i in range(n) if i not in killed and i not in suspended]
            if live:
                place("kill", live[-1])
                killed.append(live[-1])
        elif op == "K":
            if killed:
                place("revive", killed.pop(0))
        elif op == "l":
            live = [i for i in range(n) if i not in killed and i not in suspended]
            if live:
                place("suspend", live[-1])
                suspended.append(live[-1])
        elif op == "L":
            for node in suspended:
                place("resume", node)
            suspended.clear()
        elif op in ("j", "g", "s", "p", "d", "D"):
            pass  # reporting / no protocol effect in the compiled form
        else:
            raise ValueError(f"unknown script command {op!r}")
    # trailing events need a tick to act in; a bare fault list gets one
    ticks = max(tick, max((e.at for e in events), default=0) + 1, 1)
    return ScenarioSpec(ticks=ticks, events=tuple(events)).validate(n)
