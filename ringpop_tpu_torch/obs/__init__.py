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
* ``obs.spans`` — the report as Chrome trace-event JSON (Perfetto);
* ``obs.ledger`` — the dispatch ledger: a JSON line per scenario or
  sweep dispatch (and per streamed segment) with its execute time and
  memory, cold on a new shape; off unless ``RINGPOP_LEDGER=path`` or
  ``default_ledger().enable(path)``; ``python -m ringpop_tpu_torch
  obs-ledger FILE`` summarizes it;
* ``obs.annotate`` — the protocol phases' ``torch.profiler`` scopes
  under the reference's names and ``profile_trace(dir)``.
"""

from __future__ import annotations

from ringpop_tpu_torch.obs.emitters import (
    CaptureEmitter,
    JsonlEmitter,
    MultiEmitter,
    StatsdEmitter,
    make_emitter,
)
from ringpop_tpu_torch.obs.ledger import DispatchLedger, default_ledger

__all__ = [
    "CaptureEmitter",
    "JsonlEmitter",
    "MultiEmitter",
    "StatsdEmitter",
    "make_emitter",
    "DispatchLedger",
    "default_ledger",
]
