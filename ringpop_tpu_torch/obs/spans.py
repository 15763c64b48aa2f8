"""Provenance report → Chrome trace-event JSON (Perfetto-openable).

The provenance plane (``obs.provenance``) answers "who told whom,
when, and what did the detector conclude" as flat int tensors; this
module renders its host-side report as the trace-event format both
``chrome://tracing`` and https://ui.perfetto.dev open directly:

* one **track** (tid) per tracked rumor, under one "gossip provenance"
  process — the rumor's identity (subject / incarnation / status) is
  the thread name;
* one **complete event** ("X") per rumor spanning origination →
  resolution: the suspect→faulty (or suspect→refute) detection-
  causality window, carrying the origin prober, the ping-req witness
  set, and the resolution verdict as args;
* one **complete event** per infected node at its ``first_heard``
  tick (1-tick wide), with **flow arrows** ("s"/"f") along the
  propagation-tree edges — the dissemination wavefront reads as a
  cascade of arrows fanning out from the origin;
* the all-int summary block riding in ``otherData`` so a trace file is
  self-describing without the npz it came from.

Ticks map to microseconds at ``tick_us`` per tick (default 1000, so
one protocol tick renders as 1 ms and Perfetto's time ruler reads as
"protocol milliseconds").  Everything here is host-side numpy/JSON.
A copy of ``ringpop_tpu/obs/spans.py``: the files it writes are the
reference's, byte for byte (its ``source`` tag included).
"""

from __future__ import annotations

import json
import os
from typing import Any

from ringpop_tpu_torch.obs import provenance as pvn

# trace-event phase codes (the Chrome trace-event format spec)
_COMPLETE = "X"
_META = "M"
_FLOW_START = "s"
_FLOW_END = "f"

_STATUS_NAME = {1: "alive", 2: "suspect", 3: "faulty", 4: "leave"}
_RES_NAME = {
    pvn.RES_PENDING: "pending",
    pvn.RES_REFUTED: "refuted",
    pvn.RES_CONFIRMED: "confirmed",
}


def _rumor_label(r: dict[str, Any]) -> str:
    status = _STATUS_NAME.get(r["key"] & 7, f"status{r['key'] & 7}")
    return (
        f"rumor {r['slot']}: n{r['subject']} {status} "
        f"inc{r['key'] >> 3}"
    )


def trace_events(
    report: dict[str, Any], *, tick_us: int = 1000
) -> list[dict[str, Any]]:
    """The report's rumors as a flat trace-event list (see module doc).

    Deterministic: events are emitted in slot order, infections in node
    order — two runs of the same report serialize identically."""
    pid = 1
    ev: list[dict[str, Any]] = [
        {
            "ph": _META, "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "gossip provenance"},
        }
    ]
    for r in report["rumors"]:
        tid = r["slot"] + 1  # tid 0 is the process-meta row
        ev.append(
            {
                "ph": _META, "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": _rumor_label(r)},
            }
        )
        t0 = r["origin_tick"]
        t_res = r["resolution_tick"]
        # the detection-causality window: origination → resolution (an
        # unresolved rumor spans to the last infection instead, so the
        # track still shows how far the run got)
        fh = r["first_heard"]
        last = max((t for t in fh if t >= 0), default=t0)
        end = t_res if t_res >= 0 else max(last, t0)
        verdict = _RES_NAME.get(r["resolution"], "?")
        ev.append(
            {
                "ph": _COMPLETE,
                "name": f"{_STATUS_NAME.get(r['key'] & 7, '?')}→{verdict}",
                "cat": "detection",
                "pid": pid,
                "tid": tid,
                "ts": t0 * tick_us,
                "dur": max(end - t0, 1) * tick_us,
                "args": {
                    "subject": r["subject"],
                    "key": r["key"],
                    "origin_prober": r["origin"],
                    "witnesses": r["witnesses"],
                    "resolution": verdict,
                    "resolution_tick": t_res,
                    "infected": r["infected"],
                    "depth_max": r["depth_max"],
                },
            }
        )
        # the infection wavefront: one 1-tick slice per heard node,
        # with a flow arrow from its parent's slice (the propagation
        # tree); unattributed/origin nodes just get the slice
        par = r["parent"]
        for v, t in enumerate(fh):
            if t < 0:
                continue
            ev.append(
                {
                    "ph": _COMPLETE,
                    "name": f"n{v}",
                    "cat": "infection",
                    "pid": pid,
                    "tid": tid,
                    "ts": t * tick_us,
                    "dur": tick_us,
                    "args": {"node": v, "parent": par[v]},
                }
            )
        for v, t in enumerate(fh):
            p = par[v]
            if t < 0 or p < 0:
                continue  # unheard, origin, or unattributed: no edge
            flow = {
                "cat": "gossip",
                "name": "heard-from",
                "id": r["slot"] * (len(fh) + 1) + v + 1,
                "pid": pid,
                "tid": tid,
            }
            # the parent heard strictly earlier (knows-at-start
            # attribution), so its slice encloses ts = fh[p] and the
            # arrow lands inside the child's slice at ts = t
            ev.append({**flow, "ph": _FLOW_START, "ts": fh[p] * tick_us})
            ev.append(
                {**flow, "ph": _FLOW_END, "bp": "e", "ts": t * tick_us}
            )
    return ev


def write_spans(
    report: dict[str, Any], path: str, *, tick_us: int = 1000
) -> int:
    """Write the report as a trace-event JSON file (the object form,
    with the summary block in ``otherData``).  Returns the event
    count.  Atomic like every other writer here (tmp + rename)."""
    events = trace_events(report, tick_us=tick_us)
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "ringpop_tpu gossip provenance plane",
            "tick_us": tick_us,
            "n": report["n"],
            "summary": pvn.summary_block(report),
        },
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
    os.replace(tmp, path)
    return len(events)
