"""Incident library: the golden real-world outage suite.

The port of ``ringpop_tpu/scenarios/library.py``, the same incidents,
summaries and golden configuration on the port's scenario runner (the
golden runs take ``device=``: ``cuda`` unless the caller names one).

The scenario engine grew every fault primitive a production SWIM
deployment dies from — kills, partitions, asymmetric links,
delay/jitter, flap storms, gray failures, rolling deploys, loss ramps,
latency-coupled traffic, and (this module's sibling, the ``overload``
op) load-coupled gray degradation.  This module composes them into the
NAMED incidents operators actually debate: each incident is a
parameterized function producing a ``(ScenarioSpec, WorkloadSpec)``
pair for any cluster size, runnable on either backend (the two
incidents built on in-scan revive are dense-only and say so, the
bench_faults precedent), streamed like any scenario, and replayable
with one command::

    python -m ringpop_tpu_torch tick-cluster --backend tpu-sim -n 64 \
        --incident cascading_overload

Reference-size JSON renderings live in ``scenarios/specs/`` (kept in
sync by tests), and each incident's detect/heal/serve summary is
pinned per backend under ``tests/golden/incidents/`` — the regression
lane every future perf or protocol PR is judged against
(``incident_summary`` is all exact ints, so the pin is bit-equality,
not tolerance).

Naming the incidents is the point: "did your change help
``deploy_during_partition``?" is a question both a person and a CI
job can answer.
"""

from __future__ import annotations

import os
from typing import Any, Callable, NamedTuple

import numpy as np

from ringpop_tpu_torch.scenarios.spec import Event, ScenarioSpec
from ringpop_tpu_torch.traffic.workloads import WorkloadSpec

# every incident serves traffic with the SLO latency plane on: the
# detect/heal story is only half an outage — the golden summaries pin
# goodput, tail latency, and retry amplification too
LATENCY_BUCKETS = 16


class Incident(NamedTuple):
    """One named outage: a documented function of (n, ticks)."""

    name: str
    title: str
    about: str  # one paragraph: composition + what to expect
    backends: tuple[str, ...]  # ("dense", "delta") or ("dense",)
    default_ticks: int
    build: Callable[[int, int], tuple[ScenarioSpec, WorkloadSpec]]


def _halves(n: int) -> tuple[list[int], list[int]]:
    return list(range(n // 2)), list(range(n // 2, n))


def _wl(n: int, **kw: Any) -> WorkloadSpec:
    base = dict(
        keys_per_tick=8 * n,
        pool=max(32 * n, 256),
        latency_buckets=LATENCY_BUCKETS,
    )
    base.update(kw)
    return WorkloadSpec(**base)


# ---------------------------------------------------------------------------
# the incidents (each returns a VALIDATED spec + workload for cluster size n)
# ---------------------------------------------------------------------------


def _region_partition_asym_heal(n: int, ticks: int):
    """Region split, then an asymmetric heal: the backbone comes back
    one direction first.

    The partition window (18 ticks) deliberately straddles the default
    25-tick suspicion timeout REACHED THROUGH the lossy heal: when the
    groups reconnect, region A still hears region B at only 15%
    delivery, so A's suspicion timers keep running out (one-sided
    faulty declarations) while B clears its view of A immediately —
    the lopsided remerge a symmetric loss cannot express.  (A partition
    that simply outlives suspicion splits the brain PERMANENTLY — both
    sides declare each other faulty and SWIM never probes faulty
    members again; the reference grew admin heal for exactly that.
    This incident pins the recoverable-but-lopsided regime.)"""
    a, b = _halves(n)
    t_part = ticks // 14 + 2
    t_heal = t_part + 18  # suspicions running, faulty not yet declared
    t_clean = int(ticks * 0.6)
    spec = ScenarioSpec(
        ticks=ticks,
        events=(
            Event(at=t_part, op="partition", groups=(tuple(a), tuple(b))),
            Event(at=t_heal, op="heal"),
            # after the heal, region A hears region B through a lossy
            # rehomed path (15% delivery) until t_clean — the one-way
            # brownout a symmetric loss cannot express
            Event(at=t_heal, op="link_loss", until=t_clean,
                  src=tuple(b), dst=tuple(a), p=0.85),
        ),
    )
    return spec, _wl(n)


def _cascading_overload(n: int, ticks: int):
    """The feedback loop: hot-key traffic overloads ring owners past
    capacity, they degrade gray, gray holders time out off their duty
    phase so retries amplify the send load, and more nodes cross the
    threshold — the suite's measurement of whether RETRY_SCHEDULE
    backoff arrests or amplifies the cascade (BASELINE.md)."""
    wl = _wl(n, kind="zipf", zipf_s=1.2)
    m = wl.keys_per_tick
    capacity = max(3, (3 * m) // (2 * n))  # ~1.5x the fair-share load
    spec = ScenarioSpec(
        ticks=ticks,
        events=(
            Event(at=ticks // 12 + 1, op="overload",
                  until=int(ticks * 0.92),
                  capacity=capacity, threshold=6 * capacity,
                  recover=2 * capacity, factor=6),
        ),
    )
    return spec, wl


def _deploy_during_partition(n: int, ticks: int):
    """A rolling restart wave that keeps deploying while a netsplit is
    in force — rejoining nodes can only bootstrap against their own
    side, and the heal lands mid-wave.  Dense-only (in-scan revive)."""
    a, b = _halves(n)
    wave = list(range(max(2, n // 4)))  # the deploy order: first quarter
    every, down = 4, 6
    t_part = ticks // 10 + 1
    t_deploy = t_part + 6
    t_heal = min(int(ticks * 0.7),
                 t_deploy + (len(wave) - 1) * every + down + 4)
    last = t_deploy + (len(wave) - 1) * every + down
    if last >= ticks:
        raise ValueError(
            f"deploy_during_partition needs ticks > {last} at n={n}"
        )
    spec = ScenarioSpec(
        ticks=ticks,
        events=(
            Event(at=t_part, op="partition", groups=(tuple(a), tuple(b))),
            Event(at=t_deploy, op="rolling_restart", nodes=tuple(wave),
                  every=every, down=down),
            Event(at=t_heal, op="heal"),
        ),
    )
    return spec, _wl(n)


def _slow_network_hot_key(n: int, ticks: int):
    """Cross-rack latency plus a hot-key tenant: every cross-half
    message crawls (asymmetric delay/jitter), while a zipf workload
    hammers a handful of owners — the tail-latency incident."""
    a, b = _halves(n)
    t0, t1 = ticks // 12 + 1, int(ticks * 0.83)
    spec = ScenarioSpec(
        ticks=ticks,
        events=(
            Event(at=t0, op="delay", until=t1, src=tuple(a), dst=tuple(b),
                  delay=2, jitter=3),
            Event(at=t0, op="delay", until=t1, src=tuple(b), dst=tuple(a),
                  delay=1, jitter=2),
        ),
    )
    return spec, _wl(n, kind="zipf", zipf_s=1.3)


def _thundering_rejoin(n: int, ticks: int):
    """Half the cluster dies at once (a power event), then every node
    revives in the SAME tick — the mass-rejoin stampede against the
    survivors' dissemination budget.  Dense-only (in-scan revive)."""
    dead = list(range(n // 2, n))
    t_kill = ticks // 8 + 1
    t_revive = int(ticks * 0.45)
    spec = ScenarioSpec(
        ticks=ticks,
        events=tuple(
            Event(at=t_kill, op="kill", node=i) for i in dead
        ) + tuple(
            Event(at=t_revive, op="revive", node=i) for i in dead
        ),
    )
    return spec, _wl(n)


def _gray_failure_storm(n: int, ticks: int):
    """The insidious mix: a clique of gray (slow but alive) nodes, a
    storm of process stalls (suspend/resume duty cycles — the
    SIGSTOP analog of a flap, so the incident stays delta-runnable),
    and one-way loss FROM the gray clique — detectors see silence one
    way while the gray nodes keep answering the other."""
    gray = list(range(max(2, n // 8)))
    stall = [i for i in range(n // 2, n // 2 + max(2, n // 8))]
    t0 = ticks // 14 + 1
    t1 = int(ticks * 0.86)
    events: list[Event] = [
        Event(at=t0, op="gray", nodes=tuple(gray), factor=5, until=t1),
        Event(at=t0 + 8, op="link_loss", until=int(ticks * 0.71),
              src=tuple(gray), dst=tuple(i for i in range(n) if i not in gray),
              p=0.5),
    ]
    # hand-rolled stall cycles (4 down, 6 up, staggered): suspend keeps
    # state and needs no re-join, so the storm runs on both backends
    down, up = 4, 6
    for k, node in enumerate(stall):
        t = t0 + 4 + 2 * k
        while t + down < int(ticks * 0.8):
            events.append(Event(at=t, op="suspend", node=node))
            events.append(Event(at=t + down, op="resume", node=node))
            t += down + up
    spec = ScenarioSpec(ticks=ticks, events=tuple(events))
    return spec, _wl(n)


def _brownout_loss_ramp(n: int, ticks: int):
    """A whole-fabric brownout: packet loss ramps toward 45% and back
    down while a few nodes run gray — the slow rot where nothing is
    down but everything is late."""
    gray = list(range(2, 2 + max(1, n // 10)))
    t0 = ticks // 14 + 1
    mid = ticks // 2
    t1 = int(ticks * 0.79)
    spec = ScenarioSpec(
        ticks=ticks,
        events=(
            Event(at=t0, op="loss_ramp", until=mid, p=0.45),
            Event(at=mid, op="loss_ramp", until=t1, p=0.0),
            Event(at=t0 + 5, op="gray", nodes=tuple(gray), factor=4,
                  until=int(ticks * 0.64)),
        ),
    )
    return spec, _wl(n)


def _hot_tenant_blackhole(n: int, ticks: int):
    """One rack goes one-way dark exactly while a skewed tenant is
    hammering it: the rest of the cluster stops hearing the rack (90%
    one-way loss) and its replies crawl — requests keep routing to
    owners the mesh can no longer agree about."""
    rack = list(range(n - max(2, n // 8), n))
    rest = [i for i in range(n) if i not in rack]
    t0, t1 = ticks // 9 + 1, int(ticks * 0.69)
    spec = ScenarioSpec(
        ticks=ticks,
        events=(
            Event(at=t0, op="link_loss", until=t1, src=tuple(rack),
                  dst=tuple(rest), p=0.9),
            Event(at=t0, op="delay", until=t1, src=tuple(rack),
                  dst=tuple(rest), delay=1, jitter=1),
        ),
    )
    return spec, _wl(n, kind="tenant", tenants=8, zipf_s=1.4)


INCIDENTS: dict[str, Incident] = {
    i.name: i
    for i in (
        Incident(
            "region_partition_asym_heal",
            "Region partition with asymmetric healing",
            "A clean half/half netsplit whose heal is one-directional "
            "first: after the partition lifts, region A hears region B "
            "at 15% delivery for another window.  Pins how long the "
            "remerge takes when the backbone comes back lopsided.",
            ("dense", "delta"), 140, _region_partition_asym_heal,
        ),
        Incident(
            "cascading_overload",
            "Cascading overload feedback loop",
            "Zipf traffic pushes hot ring owners past their capacity "
            "knob; the overload op degrades them gray; gray holders "
            "miss their duty phase, so requests time out and retry "
            "with RETRY_SCHEDULE backoff — each retry is another send "
            "landing on an overloaded inbox.  The golden summary pins "
            "whether backoff arrests the cascade (peak gray count, "
            "goodput, amplification) — the no-feedback control run is "
            "the BASELINE.md comparison.",
            ("dense", "delta"), 120, _cascading_overload,
        ),
        Incident(
            "deploy_during_partition",
            "Rolling deploy overlapping a netsplit",
            "A quarter of the fleet rolls (kill + fresh-incarnation "
            "rejoin, staggered) while a half/half partition is in "
            "force, and the heal lands mid-wave: rejoining nodes "
            "bootstrap against whichever side they can see.  "
            "Dense-backend only (in-scan revive).",
            ("dense",), 160, _deploy_during_partition,
        ),
        Incident(
            "slow_network_hot_key",
            "Slow cross-rack network under a hot key",
            "Asymmetric cross-half delay/jitter (2+U{0..3} ticks one "
            "way, 1+U{0..2} the other) while a zipf workload hammers "
            "a few owners: dissemination crawls, rings diverge, and "
            "the latency histogram grows a real tail.",
            ("dense", "delta"), 120, _slow_network_hot_key,
        ),
        Incident(
            "thundering_rejoin",
            "50% kill, then a thundering same-tick rejoin",
            "Half the cluster dies in one tick (power event) and every "
            "node revives in the SAME later tick with fresh "
            "incarnations — the mass bootstrap stampede against the "
            "survivors' piggyback budget.  Dense-backend only "
            "(in-scan revive).",
            ("dense",), 150, _thundering_rejoin,
        ),
        Incident(
            "gray_failure_storm",
            "Gray clique + stall storm + one-way silence",
            "A clique of gray nodes (5x period, still answering), a "
            "staggered SIGSTOP stall storm on another eighth of the "
            "fleet, and 50% one-way loss FROM the gray clique: the "
            "failure detector hears silence in one direction while "
            "the gray nodes keep refuting suspicion in the other.",
            ("dense", "delta"), 140, _gray_failure_storm,
        ),
        Incident(
            "brownout_loss_ramp",
            "Fabric brownout: loss ramp + gray rot",
            "Packet loss ramps 0 -> 45% -> 0 across the whole fabric "
            "while a tenth of the fleet runs gray: nothing is down, "
            "everything is late — the incident where false-faulty "
            "declarations are the thing to watch.",
            ("dense", "delta"), 140, _brownout_loss_ramp,
        ),
        Incident(
            "hot_tenant_blackhole",
            "Hot tenant vs a one-way-dark rack",
            "The rack owning a skewed tenant's keys goes 90% one-way "
            "dark (cluster stops hearing it; it still hears the "
            "cluster) with crawling replies: requests keep routing to "
            "owners the mesh cannot agree about, and the tenant eats "
            "the misroutes.",
            ("dense", "delta"), 130, _hot_tenant_blackhole,
        ),
    )
}


def incident_names() -> list[str]:
    return list(INCIDENTS)


def build_incident(
    name: str, n: int, *, ticks: int | None = None, backend: str = "dense",
    overload: bool = True,
) -> tuple[ScenarioSpec, WorkloadSpec]:
    """Materialize incident ``name`` for a cluster of ``n`` nodes
    (validated).  ``overload=False`` strips the feedback loop from
    incidents that carry one — the no-feedback CONTROL arm the
    BASELINE comparison runs."""
    if name not in INCIDENTS:
        raise ValueError(
            f"unknown incident {name!r}; one of {', '.join(INCIDENTS)}"
        )
    inc = INCIDENTS[name]
    if backend not in inc.backends:
        raise ValueError(
            f"incident {name!r} runs on {'/'.join(inc.backends)} only "
            f"(got {backend}): in-scan revive is dense-backend-only"
        )
    if n < 8:
        raise ValueError(f"incidents need n >= 8 (got {n})")
    t = int(ticks) if ticks is not None else inc.default_ticks
    spec, wl = inc.build(n, t)
    if not overload:
        spec = ScenarioSpec(
            ticks=spec.ticks,
            events=tuple(e for e in spec.events if e.op != "overload"),
        )
    return spec.validate(n), wl.validate(n)


def format_catalog() -> str:
    """The ``--list-incidents`` text."""
    lines = []
    for inc in INCIDENTS.values():
        back = "both backends" if len(inc.backends) == 2 else "dense only"
        lines.append(f"{inc.name}  ({back}, default {inc.default_ticks} "
                     f"ticks)\n  {inc.title}\n  {inc.about}\n")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the golden detect/heal/serve summary (exact ints -> bit-equality pins)
# ---------------------------------------------------------------------------

SUMMARY_SCHEMA = 1


def incident_summary(trace: Any, prov: Any | None = None) -> dict[str, int]:
    """One incident run's detect/heal/serve summary — every value an
    exact int so the golden files under ``tests/golden/incidents/``
    pin bit-equality, not tolerances.

    Keys: ``detect_tick`` (first faulty declaration, -1 if none),
    ``heal_tick`` (first tick from which ``converged`` holds through
    the end, -1 if never), ``final_live``, the serving totals
    (``sends`` = handled_local + proxy_sends + proxy_retries, the
    amplification numerator), the latency percentile floors in ms,
    and the overload peaks when the feedback loop ran.

    ``prov`` (a ``obs.provenance.build_report`` dict from a traced
    run) embeds the plane's all-int aggregate as ``pv_*`` keys — the
    dissemination scorecard (infection depth / percentiles vs the
    paper's log2(N) bound) pinned right next to detect/heal."""
    m = trace.metrics
    hits = np.flatnonzero(m["faulty_declared"] > 0)
    detect = int(hits[0]) if hits.size else -1
    rev = trace.converged[::-1]
    suffix = trace.ticks if rev.all() else int(np.argmax(~rev))
    heal = trace.ticks - suffix if suffix > 0 else -1
    out: dict[str, int] = {
        "schema": SUMMARY_SCHEMA,
        "ticks": int(trace.ticks),
        "n": int(trace.n),
        "detect_tick": detect,
        "heal_tick": heal,
        "final_live": int(trace.live[-1]),
        "faulty_declared": int(m["faulty_declared"].sum()),
        "suspects_declared": int(m["suspects_declared"].sum()),
    }
    if "lookups" in m:
        from ringpop_tpu_torch.traffic.engine import total_sends

        out.update(
            lookups=int(m["lookups"].sum()),
            delivered=int(m["delivered"].sum()),
            dropped=int(m["dropped"].sum()),
            misroutes=int(m["misroutes"].sum()),
            proxy_failed=int(m["proxy_failed"].sum()),
            sends=total_sends(m),
        )
    for key in ("send_errors", "gray_timeouts", "retry_succeeded"):
        if key in m:
            out[key] = int(m[key].sum())
    if "lat_hist_ms" in trace.planes:
        from ringpop_tpu_torch.traffic.latency import hist_stats

        agg = hist_stats(trace.planes["lat_hist_ms"].sum(axis=0))
        out["lat_p50_ms"] = int(agg["median"])
        out["lat_p95_ms"] = int(agg["p95"])
        out["lat_p99_ms"] = int(agg["p99"])
    if "ov_gray_nodes" in m:
        out["ov_gray_peak"] = int(m["ov_gray_nodes"].max())
        out["ov_pressure_peak"] = int(m["ov_pressure_max"].max())
    if "policy_shed" in m:
        # the remediation plane ran: its sheds are already inside
        # ``sends`` (total_sends counts them — amplification stays
        # honest), and the peaks pin how hard each mechanism engaged
        out["policy_shed"] = int(m["policy_shed"].sum())
        out["policy_quar_peak"] = int(m["policy_quarantined"].max())
        out["policy_shed_peak"] = int(m["policy_shed_nodes"].max())
        out["policy_retry_cap_min"] = int(m["policy_retry_cap"].min())
        out["policy_amp_peak_x16"] = int(m["policy_amp_x16"].max())
    if prov is not None:
        from ringpop_tpu_torch.obs.provenance import summary_block

        for key, value in summary_block(prov).items():
            out[f"pv_{key}"] = int(value)
    return out


def format_summary(name: str, summary: dict[str, int]) -> str:
    """The human line the CLI prints under an ``--incident`` run."""
    s = summary
    parts = [
        f"incident {name}: detect tick "
        f"{s['detect_tick'] if s['detect_tick'] >= 0 else '-'}",
        f"heal tick {s['heal_tick'] if s['heal_tick'] >= 0 else '-'}",
        f"live {s['final_live']}/{s['n']}",
    ]
    if "lookups" in s and s["lookups"]:
        goodput = 100.0 * s["delivered"] / s["lookups"]
        amp = s["sends"] / max(s["delivered"], 1)
        parts.append(f"goodput {goodput:.1f}%")
        parts.append(f"amplification {amp:.2f}")
    if "lat_p99_ms" in s:
        parts.append(f"lat p50/p95/p99 {s['lat_p50_ms']}/"
                     f"{s['lat_p95_ms']}/{s['lat_p99_ms']}ms")
    if "gray_timeouts" in s:
        parts.append(f"{s['gray_timeouts']} gray timeouts")
    if "ov_gray_peak" in s:
        parts.append(f"peak overload-gray {s['ov_gray_peak']}")
    if "policy_shed" in s:
        parts.append(f"shed {s['policy_shed']}")
        parts.append(f"peak quarantine {s['policy_quar_peak']}")
    if s.get("pv_rumors"):
        parts.append(
            f"rumors {s['pv_rumors']} (depth {s['pv_depth_max']}, "
            f"infect p99 {s['pv_p99_max']}t)"
        )
    return ", ".join(parts)


# ---------------------------------------------------------------------------
# the golden run configuration (tests/golden/incidents/*.json)
# ---------------------------------------------------------------------------

# Every golden summary is produced by EXACTLY this configuration —
# n/seed/params/segmenting are part of the pin (the summaries are
# exact ints of a deterministic seeded run, so a mismatch is a real
# behavior change, not noise).  The pins are the reference's.
GOLDEN_N = 16
GOLDEN_SEED = 3
GOLDEN_SEGMENT = 32


def golden_cluster(backend: str = "dense", device: Any = None):
    """The cluster every golden (and the incident smoke) runs on, on
    ``device`` (``cuda`` unless the caller names one)."""
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.models.swim_sim import SwimParams

    kw = (
        {}
        if backend == "dense"
        else dict(capacity=GOLDEN_N, wire_cap=GOLDEN_N,
                  claim_grid=3 * GOLDEN_N * GOLDEN_N)
    )
    return SimCluster(
        GOLDEN_N, SwimParams(), seed=GOLDEN_SEED, backend=backend, device=device, **kw
    )


def run_golden(
    name: str, backend: str = "dense", policy: str | None = None, device: Any = None
) -> dict[str, int]:
    """One incident at the golden configuration, streamed (the CLI's
    default segmenting — bit-identical to the one-dispatch run), down
    to its summary dict.  ``policy`` arms a remediation policy at its
    default operating point (``ringpop_tpu_torch.policies``) — the
    policy-armed goldens pinned next to the bare incident pins.  The
    files under ``tests/golden/incidents/`` were pinned in jax 0.4.37's
    threefry mode: run under ``prng.partitionable_mode(False)`` to
    replay them."""
    spec, wl = build_incident(name, GOLDEN_N, backend=backend)
    cluster = golden_cluster(backend, device)
    trace = cluster.run_scenario(
        spec, traffic=wl, segment_ticks=min(GOLDEN_SEGMENT, spec.ticks),
        policy=policy,
    )
    return incident_summary(trace)


def golden_path(
    name: str, backend: str, directory: str, policy: str | None = None
) -> str:
    stem = f"{name}+{policy}" if policy else name
    return os.path.join(directory, f"{stem}.{backend}.json")


# The winning operating point (BASELINE.md round 9) and the pinned
# policy-armed grid: cascading_overload under EVERY policy on both
# backends (the incident the plane exists to beat), plus every other
# incident under the winner (the no-regression scorecard — a policy
# must not win cascading_overload by tanking a different outage).
GOLDEN_POLICY = "combined"


def policy_golden_grid() -> list[tuple[str, str, str]]:
    """(incident, policy, backend) triples pinned under
    ``tests/golden/incidents/``."""
    grid: list[tuple[str, str, str]] = []
    from ringpop_tpu_torch.policies import core as pol

    for p in pol.list_policies():
        for b in ("dense", "delta"):
            grid.append(("cascading_overload", p, b))
    for name, inc in INCIDENTS.items():
        if name != "cascading_overload":
            grid.append((name, GOLDEN_POLICY, "dense"))
    return grid


# ---------------------------------------------------------------------------
# reference JSON specs (scenarios/specs/*.json, kept in sync by tests)
# ---------------------------------------------------------------------------

SPEC_DIR = os.path.join(os.path.dirname(__file__), "specs")
SPEC_N = 64  # the reference rendering's cluster size


def spec_document(name: str, n: int = SPEC_N) -> dict[str, Any]:
    """The self-describing JSON form of one incident at size ``n``."""
    inc = INCIDENTS[name]
    spec, wl = build_incident(name, n)
    return {
        "incident": name,
        "title": inc.title,
        "about": inc.about,
        "backends": list(inc.backends),
        "n": n,
        "scenario": spec.to_dict(),
        "workload": wl.to_dict(),
    }


def write_specs(directory: str = SPEC_DIR, n: int = SPEC_N) -> list[str]:
    """(Re)render every incident's reference JSON spec; returns the
    paths written.  The tests hold the checked-in files to this
    rendering, so the library is the single source of truth and the
    JSON is its durable, diffable artifact."""
    import json

    os.makedirs(directory, exist_ok=True)
    paths = []
    for name in INCIDENTS:
        path = os.path.join(directory, f"{name}.json")
        with open(path, "w") as f:
            json.dump(spec_document(name, n), f, indent=2)
            f.write("\n")
        paths.append(path)
    return paths
