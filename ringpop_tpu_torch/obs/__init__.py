"""Observability: stat emitters, the Trace->stats bridge, the gossip
provenance plane and its span exporter.

The port of ``ringpop_tpu/obs/``:

* ``obs.emitters`` — sinks behind the reference's injected-statsd
  ``increment/gauge/timing`` interface (statsd UDP line protocol,
  in-memory capture, JSON lines);
* ``obs.bridge`` — replays per-tick ``Trace`` counters into any emitter
  under the reference's key names (``ping.send``, ``full-sync``,
  ``membership-update.*`` ...), behind ``SimCluster(stats_emitter=)``;
* ``obs.provenance`` — rumor-level dissemination tracing
  (``trace_rumors`` and ``track`` in a scenario), folded on the device
  after each step, and its host-side report;
* ``obs.spans`` — the report as Chrome trace-event JSON (Perfetto).

The dispatch ledger and the profiler scopes of the reference
(``obs.ledger``, ``obs.annotate``) are not ported yet.
"""

from __future__ import annotations

from ringpop_tpu_torch.obs.emitters import (
    CaptureEmitter,
    JsonlEmitter,
    MultiEmitter,
    StatsdEmitter,
    make_emitter,
)

__all__ = [
    "CaptureEmitter",
    "JsonlEmitter",
    "MultiEmitter",
    "StatsdEmitter",
    "make_emitter",
]
