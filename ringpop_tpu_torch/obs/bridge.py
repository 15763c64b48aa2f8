"""Trace→stats bridge: replay simulated telemetry as reference metrics.

A real ringpop deployment is observed through its statsd namespace
(``ringpop.<host_port>.ping.send``, ``.membership-update.suspect``,
``.full-sync`` ...).  The compiled simulation stacks the same protocol
facts into per-tick ``Trace`` counters — this bridge replays them into
any emitter under the SAME key names, so a simulated 10k-node chaos
scenario produces the metric namespace a production cluster would, and
every downstream consumer (dashboards, alert rules, the CI namespace
assertion) works unchanged.

A copy of ``ringpop_tpu/obs/bridge.py``, which imports nothing of jax.

Key table (trace series → reference stat):

| trace series                 | type      | reference key               |
|------------------------------|-----------|-----------------------------|
| pings_sent                   | increment | ping.send                   |
| acks                         | increment | ping.recv                   |
| ping_reqs                    | increment | ping-req.send               |
| full_syncs                   | increment | full-sync                   |
| suspects_declared            | increment | membership-update.suspect   |
| faulty_declared              | increment | membership-update.faulty    |
| live (tick-0 baseline + ups) | increment | membership-update.alive     |
| *_changes_applied (summed)   | gauge     | changes.apply               |
| live                         | gauge     | num-members                 |
| checksum (caller-provided)   | gauge     | checksum                    |

Traffic-coupled traces (scenarios co-run with a ``traffic`` workload)
additionally carry the serving plane's counters:

| lookups                      | increment | lookup                       |
| lookupns                     | increment | lookupn                      |
| proxy_sends                  | increment | requestProxy.send.success    |
| proxy_retries                | increment | requestProxy.retry.attempted |
| proxy_failed                 | increment | requestProxy.retry.failed    |

SLO-latency-enabled workloads (``WorkloadSpec.latency_buckets > 0``)
add the request-latency namespace — the failed-send / succeeded-retry
counters of proxy.py:59 / send.py:90, and the per-tick latency
histogram rows replayed as timing samples:

| send_errors                  | increment | requestProxy.send.error      |
| retry_succeeded              | increment | requestProxy.retry.succeeded |
| lat_hist_ms (trace plane)    | timing    | requestProxy.send            |

with the rest of the traffic series (misroutes, delivered_misroutes,
ring_divergence, hops0..hopsK, unresolved, dropped ...) flowing as
``sim.``-prefixed gauges like every other sim-only series.

Increments carry the tick's count as the statsd count value (``:N|c``);
zero-count ticks emit nothing (the reference increments per event, so
an eventless tick is silence there too).  ``membership-update.alive``
is emitted at tick 0 with the starting live count — the simulation's
analog of every node's bootstrap ``make_alive`` — and afterwards with
the positive live-count delta (revives re-entering the gossip set).
Sim-only series that have no reference analog keep a ``sim.`` prefix
(``sim.converged``, ``sim.loss``, ``sim.claims_dropped`` ...), so the
reference namespace stays exactly reference-shaped.
"""

from __future__ import annotations

from typing import Any

import numpy as np

# trace counter -> reference increment key (per tick, count as value)
PROTOCOL_COUNTER_KEYS: dict[str, str] = {
    "pings_sent": "ping.send",
    "acks": "ping.recv",
    "ping_reqs": "ping-req.send",
    "full_syncs": "full-sync",
    "suspects_declared": "membership-update.suspect",
    "faulty_declared": "membership-update.faulty",
}

# traffic-plane counters (traffic/engine.counter_names) -> the serving
# layer's reference keys: lookup/lookupn are the index.js lookup stats,
# the requestProxy.* entries are request_proxy send.py/proxy.py retry
# and send accounting.  Kept out of REFERENCE_KEYS: a scenario without
# traffic emits none of these (the host stack only emits them when
# lookups/proxies happen).  The last two flow only from SLO-latency-
# enabled workloads (WorkloadSpec.latency_buckets > 0) — the bridge is
# presence-gated per series, so a latency-off trace emits exactly the
# base set.
TRAFFIC_COUNTER_KEYS: dict[str, str] = {
    "lookups": "lookup",
    "lookupns": "lookupn",
    "proxy_sends": "requestProxy.send.success",
    "proxy_retries": "requestProxy.retry.attempted",
    "proxy_failed": "requestProxy.retry.failed",
    # SLO latency plane (traffic/latency.py): failed send attempts
    # (dead holders + gray timeouts -> proxy.py:59) and
    # delivered-after-retry (send.py:90)
    "send_errors": "requestProxy.send.error",
    "retry_succeeded": "requestProxy.retry.succeeded",
}

# the serving timing stat: each tick's latency-histogram row replays as
# ``requestProxy.send`` timing values (bucket-floor ms, at most
# TIMING_REPLAY_CAP emissions per bucket per tick — statsd timing
# streams are sampled anyway; exact percentiles come from the trace
# plane itself, scenarios/trace.py summary / traffic/latency.hist_stats)
TRAFFIC_TIMING_KEYS: dict[str, str] = {
    "lat_hist_ms": "requestProxy.send",
}
TIMING_REPLAY_CAP = 8

COUNTER_KEYS: dict[str, str] = {
    **PROTOCOL_COUNTER_KEYS,
    **TRAFFIC_COUNTER_KEYS,
}

# the changes-applied trio folds into the reference's changes.apply gauge
CHANGES_APPLIED = (
    "ping_changes_applied",
    "ack_changes_applied",
    "pingreq_changes_applied",
)

# every reference-parity key the bridge emits for ANY scenario — the
# namespace the CI smoke asserts a scenario's --stats-out stream is a
# superset of (traffic keys join only when a workload co-ran)
REFERENCE_KEYS: tuple[str, ...] = (
    *PROTOCOL_COUNTER_KEYS.values(),
    "membership-update.alive",
    "changes.apply",
    "num-members",
    "checksum",
)

# the additional keys an SLO-latency-enabled workload emits
TRAFFIC_LATENCY_KEYS: tuple[str, ...] = (
    TRAFFIC_COUNTER_KEYS["send_errors"],
    TRAFFIC_COUNTER_KEYS["retry_succeeded"],
    *TRAFFIC_TIMING_KEYS.values(),
)

# the serving-plane keys EVERY traffic-coupled scenario emits — derived
# so a future base counter lands here automatically; the latency-gated
# keys stay out (the smoke/namespace assertions over this tuple must
# hold for latency-off runs)
TRAFFIC_KEYS: tuple[str, ...] = tuple(
    v for v in TRAFFIC_COUNTER_KEYS.values() if v not in TRAFFIC_LATENCY_KEYS
)

DEFAULT_PREFIX = "ringpop.sim"


class StatSink:
    """``RingPop.stat``'s prefix + key-cache fast path (index.js:561-575)
    over a bare emitter: fully-qualified keys are built once per key,
    not per call."""

    def __init__(self, emitter: Any, prefix: str = DEFAULT_PREFIX):
        self.emitter = emitter
        self.prefix = prefix
        self._keys: dict[str, str] = {}

    def _fq(self, key: str) -> str:
        fq = self._keys.get(key)
        if fq is None:
            fq = self._keys[key] = f"{self.prefix}.{key}"
        return fq

    def increment(self, key: str, value: Any = None) -> None:
        self.emitter.increment(self._fq(key), value)

    def gauge(self, key: str, value: Any = None) -> None:
        self.emitter.gauge(self._fq(key), value)

    def timing(self, key: str, value: Any = None) -> None:
        self.emitter.timing(self._fq(key), value)


def emit_counters(
    metrics: dict[str, Any], sink: StatSink, *, live: int | None = None
) -> int:
    """Bridge ONE tick's counter dict (a ``SimCluster.tick`` metrics
    entry, or one row of a trace) into the sink.  Returns the number of
    stat calls made.

    A multi-tick entry (``metrics["ticks"] > 1`` — ``swim_run`` reports
    only the LAST tick's counters) emits gauges only: gauges are
    last-write-wins so the latest tick's value is exactly right, but
    replaying a one-tick sample as the whole span's increments would
    understate protocol traffic by up to ticks× (use ``run_scenario``
    for an exact per-tick stream)."""
    calls = 0
    changes = 0
    one_tick = int(metrics.get("ticks", 1)) == 1
    for name, value in metrics.items():
        v = int(value)
        key = COUNTER_KEYS.get(name)
        if key is not None:
            if v and one_tick:
                sink.increment(key, v)
                calls += 1
        elif name in CHANGES_APPLIED:
            changes += v
        elif name not in ("converged", "live", "loss", "ticks"):
            # always emitted, zeros included: a statsd gauge holds its
            # last write, so suppressing zeros would freeze a spike
            # (e.g. claims-dropped) on the dashboard forever
            sink.gauge(f"sim.{name.replace('_', '-')}", v)
            calls += 1
    sink.gauge("changes.apply", changes)
    calls += 1
    if live is not None:
        sink.gauge("num-members", int(live))
        calls += 1
    return calls


def replay_trace(
    trace: Any,
    emitter: Any,
    *,
    prefix: str = DEFAULT_PREFIX,
    checksum: int | None = None,
    declare_namespace: bool = True,
    prev_live: int | None = None,
    checksum_pending: bool = False,
) -> int:
    """Replay a ``scenarios.Trace`` tick by tick into ``emitter`` under
    reference-parity keys (see the module key table).  ``checksum``
    (the cluster's post-run membership checksum) emits one final
    ``checksum`` gauge — the reference recomputes-and-gauges it on
    every membership update; the simulation computes it on demand.

    ``declare_namespace`` (default) first touches every counter key
    with a zero-count increment (``key:0|c`` — a legal statsd no-op),
    so the emitted key set is the full reference namespace even for a
    quiet scenario whose run produced no faulty/full-sync events —
    the deterministic superset the CI smoke asserts.  With no
    ``checksum`` available (e.g. every node dead) the declaration also
    touches the ``checksum`` gauge with 0 (documented sentinel for
    "not computed"), keeping the namespace guarantee total.

    ``checksum_pending`` declares the namespace WITHOUT the checksum
    sentinel: the caller promises to gauge the real checksum itself
    after the run (the streamed runner, which replays slab by slab
    with ``checksum=None`` and gauges once at completion — emitting
    the sentinel here would put a spurious ``checksum:0`` at soak
    start that the whole-trace replay never emits).

    ``prev_live`` marks a CONTINUATION replay — ``trace`` is a
    per-segment slab of a streamed run (scenarios/stream.py), not the
    start of one: the first tick's ``membership-update.alive`` emits
    the positive delta against the previous segment's final live count
    instead of the bootstrap baseline, so replaying every slab in
    order (with ``declare_namespace`` only on the first) produces the
    exact stat stream the whole-trace replay would.

    Returns the total number of stat calls."""
    sink = StatSink(emitter, prefix)
    calls0 = 0
    if declare_namespace:
        declared = [*PROTOCOL_COUNTER_KEYS.values(), "membership-update.alive"]
        if "lookups" in trace.metrics:  # a traffic-coupled trace
            declared += [
                TRAFFIC_COUNTER_KEYS[s]
                for s in TRAFFIC_COUNTER_KEYS
                if s in trace.metrics
            ]
        for key in declared:
            sink.increment(key, 0)
            calls0 += 1
        if checksum is None and not checksum_pending:
            sink.gauge("checksum", 0)
            calls0 += 1
    live = np.asarray(trace.live, dtype=np.int64)
    converged = np.asarray(trace.converged, dtype=bool)
    loss = np.asarray(trace.loss, dtype=np.float64)
    # latency-histogram planes replay as timing stats: each nonzero
    # bucket emits its bucket-floor ms value up to TIMING_REPLAY_CAP
    # times per tick (bounded call volume; the trace plane keeps the
    # exact counts)
    timing_planes = []
    planes = getattr(trace, "planes", None) or {}
    for name, key in TRAFFIC_TIMING_KEYS.items():
        if name in planes:
            from ringpop_tpu_torch.traffic.latency import bucket_edges_ms

            arr = np.asarray(planes[name], dtype=np.int64)
            reps = np.concatenate([[0], bucket_edges_ms(arr.shape[1])])
            timing_planes.append((key, arr, reps))
    calls = calls0
    for t in range(trace.ticks):
        tick_metrics = {k: v[t] for k, v in trace.metrics.items()}
        calls += emit_counters(tick_metrics, sink, live=int(live[t]))
        for key, arr, reps in timing_planes:
            row = arr[t]
            for b in np.flatnonzero(row):
                for _ in range(min(int(row[b]), TIMING_REPLAY_CAP)):
                    sink.timing(key, int(reps[b]))
                    calls += 1
        if t == 0:
            alive = (
                int(live[0]) if prev_live is None
                else int(live[0]) - int(prev_live)
            )
        else:
            alive = int(live[t]) - int(live[t - 1])
        if alive > 0:
            sink.increment("membership-update.alive", alive)
            calls += 1
        sink.gauge("sim.converged", int(converged[t]))
        sink.gauge("sim.loss", float(loss[t]))
        calls += 2
    if checksum is not None:
        sink.gauge("checksum", int(checksum))
        calls += 1
    return calls


def emit_provenance(
    report: dict[str, Any], emitter: Any, *, prefix: str = DEFAULT_PREFIX
) -> int:
    """Gauge the provenance plane's summary block (one value per
    ``obs.provenance.summary_block`` field, ``sim.provenance.*`` keys —
    sim-only: the reference has no rumor-level tracing namespace).
    Returns the number of stat calls."""
    from ringpop_tpu_torch.obs.provenance import summary_block

    sink = StatSink(emitter, prefix)
    calls = 0
    for name, value in summary_block(report).items():
        sink.gauge(f"sim.provenance.{name.replace('_', '-')}", int(value))
        calls += 1
    return calls
