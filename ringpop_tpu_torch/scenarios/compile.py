"""A scenario as concrete per-tick ops: the timeline the host loop applies.

The port of ``_OP_RANK`` and ``expand_events`` of
``ringpop_tpu/scenarios/compile.py``.  The compiled form of a scenario
(``compile_spec``, its event tensors and the segment key schedule of
the one-dispatch scan) is not ported yet.
"""

from __future__ import annotations

from typing import Any

from ringpop_tpu_torch.scenarios import faults as sfaults
from ringpop_tpu_torch.scenarios.spec import ScenarioSpec, expand_fault_primitives

# Canonical intra-tick apply order, shared with the reference's scan:
# bit edits first (order-free among themselves), then revives (whose
# bootstrap join reads the post-edit live set), then partition rows;
# loss and faultcfg touch neither, so their rank only has to be fixed.
# The sort is stable: ops of one kind keep their expansion order.
_OP_RANK = {"kill": 0, "suspend": 1, "resume": 2, "revive": 3,
            "partition": 4, "heal": 4, "loss": 5, "faultcfg": 6}


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
