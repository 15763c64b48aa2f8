"""A scenario as concrete per-tick ops, and as device tensors.

The port of ``ringpop_tpu/scenarios/compile.py``.  ``expand_events``
gives the timeline the host loop applies; ``compile_spec`` lowers it to
what the compiled runner (``runner.run_compiled``) applies tick by tick:

* node events as flat ``(tick, kind, node)`` tensors, applied as masked
  writes;
* partition and heal events as ``(tick, gid_row)``, each row an
  int32[N] group-id adjacency (a heal is all zeros: one group);
* the loss in force at every tick, float32[ticks] (steps and ramps
  alike);
* the boundaries: every tick in (0, ticks) at which an op fires.

``key_schedule`` draws the cluster key once a segment between
boundaries, as the host loop's ``tick(k)`` calls do, so the compiled
run and the host loop step on the same keys.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ringpop_tpu_torch import prng, resolve_device
from ringpop_tpu_torch.models.cluster import groups_to_gid
from ringpop_tpu_torch.scenarios import faults as sfaults
from ringpop_tpu_torch.scenarios.spec import ScenarioSpec, expand_fault_primitives

# node-event kinds (ev_kind values)
EV_KILL = 0
EV_SUSPEND = 1
EV_RESUME = 2
EV_REVIVE = 3
_KIND = {"kill": EV_KILL, "suspend": EV_SUSPEND, "resume": EV_RESUME, "revive": EV_REVIVE}

# Canonical intra-tick apply order, shared by the compiled runner and the
# host loop: bit edits first (order-free among themselves), then revives
# (whose bootstrap join reads the post-edit live set), then partition
# rows; loss and faultcfg touch neither, so their rank only has to be
# fixed.  The sort is stable: ops of one kind keep their expansion order.
_OP_RANK = {"kill": 0, "suspend": 1, "resume": 2, "revive": 3,
            "partition": 4, "heal": 4, "loss": 5, "faultcfg": 6}


class CompiledScenario(NamedTuple):
    """A scenario's tensors (on the cluster's device) and static facts."""

    ticks: int
    n: int
    ev_tick: torch.Tensor  # int32[E] node-event ticks
    ev_kind: torch.Tensor  # int32[E] EV_* codes
    ev_node: torch.Tensor  # int32[E] target node
    p_tick: torch.Tensor  # int32[P] partition/heal ticks
    p_gid: torch.Tensor  # int32[P, N] group-id rows (heal = zeros)
    loss: torch.Tensor  # float32[ticks] per-tick loss in force
    has_revive: bool  # any revive event (the runner's only host syncs)
    boundaries: tuple[int, ...]  # distinct event ticks in (0, ticks)
    faults: Any | None = None  # faults.FaultTensors | None
    has_delay: bool = False  # route through the in-flight buffer
    has_gray: bool = False  # carry the per-node period row
    delay_depth: int = 0  # in-flight ring depth (0 = no delay)
    overload: Any | None = None  # faults.OverloadConfig | None
    # provenance plane: tracked-rumor slots and the (at, node) track
    # reservations in slot order
    trace_rumors: int = 0
    tracks: tuple[tuple[int, int], ...] = ()


def expand_events(spec: ScenarioSpec, base_loss: float) -> list[tuple[int, str, Any]]:
    """The spec as ``(tick, op, arg)`` ops: ramps unrolled to one ``loss``
    op a tick, flap and rolling-restart cycles unrolled to kill/revive
    primitives, and a ``faultcfg`` marker at every tick the link-rule or
    period configuration changes."""
    out: list[tuple[int, str, Any]] = []
    loss = float(base_loss)
    for e in sorted(spec.events, key=lambda e: e.at):
        if e.op == "loss":
            loss = float(e.p)
            out.append((e.at, "loss", loss))
        elif e.op == "loss_ramp":
            start, span = loss, e.until - e.at
            for tau in range(e.at, e.until):
                loss = start + (float(e.p) - start) * (tau - e.at + 1) / span
                out.append((tau, "loss", loss))
        elif e.op == "partition":
            out.append((e.at, "partition", e.groups))
        elif e.op == "heal":
            out.append((e.at, "heal", None))
        elif e.op in ("flap", "rolling_restart"):
            out.extend((pe.at, pe.op, pe.node) for pe in expand_fault_primitives(e, spec.ticks))
        elif e.op in ("link_loss", "delay", "gray", "overload", "track"):
            # link rules and periods arrive through the faultcfg markers
            # below; overload is per-tick state of the scan and track a
            # slot reservation of the provenance plane: no timeline op
            pass
        else:
            out.append((e.at, e.op, e.node))
    out.extend((t, "faultcfg", None) for t in sfaults.fault_marker_ticks(spec))
    return out


def compile_spec(
    spec: ScenarioSpec, n: int, *, base_loss: float = 0.0,
    device: torch.device | str | None = None,
) -> CompiledScenario:
    """Lower a validated spec to the runner's tensors on ``device``."""
    spec.validate(n)
    dev = resolve_device(device)
    ops = expand_events(spec, base_loss)
    ev_tick, ev_kind, ev_node = [], [], []
    p_tick, p_gid = [], []
    loss_tl = np.full(spec.ticks, float(base_loss), dtype=np.float32)
    # tick order, not event order: a loss event inside a ramp's span
    # holds only until the ramp's next step, as the host loop's per-tick
    # set_loss calls do; within a tick the canonical _OP_RANK order
    for at, op, arg in sorted(ops, key=lambda x: (x[0], _OP_RANK[x[1]])):
        if op == "loss":
            loss_tl[at:] = arg
        elif op == "partition":
            p_tick.append(at)
            p_gid.append(groups_to_gid(arg, n))
        elif op == "heal":
            p_tick.append(at)
            p_gid.append(np.zeros(n, dtype=np.int32))
        elif op == "faultcfg":
            pass  # a boundary only; the tensors come from compile_faults
        else:
            ev_tick.append(at)
            ev_kind.append(_KIND[op])
            ev_node.append(arg)
    boundaries = tuple(sorted({at for at, _, _ in ops if 0 < at < spec.ticks}))
    ft = sfaults.compile_faults(spec, n, device=dev)

    def on(a, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=dtype))).to(dev)

    return CompiledScenario(
        ticks=spec.ticks,
        n=n,
        ev_tick=on(ev_tick, np.int32),
        ev_kind=on(ev_kind, np.int32),
        ev_node=on(ev_node, np.int32),
        p_tick=on(p_tick, np.int32),
        p_gid=on(np.stack(p_gid) if p_gid else np.zeros((0, n), np.int32), np.int32),
        loss=on(loss_tl, np.float32),
        has_revive=any(k == EV_REVIVE for k in ev_kind),
        boundaries=boundaries,
        faults=ft,
        has_delay=ft is not None and ft.lr_d is not None,
        has_gray=ft is not None and bool(ft.pe_tick.shape[0]),
        delay_depth=sfaults.delay_depth(spec),
        overload=sfaults.overload_config(spec),
        trace_rumors=spec.trace_rumors,
        tracks=tuple((e.at, e.node) for e in spec.events if e.op == "track"),
    )


def key_schedule(split: Callable[[], torch.Tensor], compiled: CompiledScenario) -> torch.Tensor:
    """int64[ticks, 2] per-tick step keys (uint32 words, on the CPU).

    ``split`` is the cluster's key draw (``SimCluster._split``): one draw
    a segment between boundaries, used directly for a one-tick segment
    and fanned with ``prng.split(sub, k)`` for a k-tick one, which is
    what the host loop's ``tick(1)``/``tick(k)`` calls consume."""
    pts = [0, *compiled.boundaries, compiled.ticks]
    parts = []
    for a, b in zip(pts, pts[1:]):
        sub = split()
        parts.append(sub[None] if b - a == 1 else prng.split(sub, b - a))
    return torch.cat(parts, dim=0)
