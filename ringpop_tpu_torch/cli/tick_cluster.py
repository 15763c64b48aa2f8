"""``tick-cluster`` subcommand: the simulated cluster harness and fault
injector, on the port's tensor simulation.

The port of the ``tpu-sim`` path of ``ringpop_tpu/cli/tick_cluster.py``
(reference: scripts/tick-cluster.js).  ``TpuSimCluster`` puts
``models/cluster.SimCluster`` behind the reference's keyboard commands:

  j join-all   t tick-all (checksum-convergence groups)
  s membership stats by checksum   p protocol counters
  g start gossip   d/D debug set/clear
  l suspend  L resume  k kill  K revive  q quit

with ``--loss`` (packet loss), ``--damping`` (flap damping),
``--scenario``/``--incident`` (a compiled fault timeline, streamed with
``--segment-ticks``, checkpointed and resumed), ``--sweep`` (R
replicas), ``--traffic``/``--policy`` (the serving plane and the
remediation policies), ``--trace-rumors`` (the provenance plane),
``--stats-out`` (the stats bridge) and ``--profile-dir`` (a
``torch.profiler`` trace).  Every printed line is the reference's.

``SimCluster`` (``--backend host-sim`` or ``--sim``) puts the host
library's in-process ``harness.Cluster`` on virtual time behind the same
commands, as the reference's does, with each node's ring hashed on the
card.  Either runs on ``--device`` (``cuda`` unless told ``cpu``; with
no card and no ``--device`` it raises).  The reference's ``--backend
proc`` drives real worker processes over TCP, which wait for their port
(ROADMAP queue 1 item 12 (b)): it raises ``NotImplementedError``.

Non-interactive automation: ``--script "j,w3000,t,t,q"`` runs comma-
separated commands (``wN`` = wait N ms) and exits.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any

# the reference's process backend waits for its port here
HOST_LIBRARY_ITEM = "ROADMAP queue 1 item 12 (b) (the host library's TCP half)"

def print_op_percentiles(stats: dict[str, Any], indent: str = "    ") -> None:
    """The per-operation p50/p95/p99 lines of the `p` command, shared
    by the proc and host-sim drivers (full get_stats() shape): the
    protocol timings plus the serving-layer lookup/lookupN aggregates."""
    protocol = stats.get("protocol", {})
    ops = [
        ("ping", protocol.get("ping")),
        ("pingReq", protocol.get("pingReq")),
        ("lookup", stats.get("lookup")),
        ("lookupN", stats.get("lookupN")),
    ]
    for op, agg in ops:
        if agg and agg.get("count"):
            print(
                f"{indent}{op}: p50={agg['median']:.1f}"
                f" p95={agg['p95']:.1f} p99={agg['p99']:.1f}"
                f" count={agg['count']}"
            )


def group_by_checksum(checksums: dict[str, Any]) -> dict[Any, list[str]]:
    """tick-cluster.js:100-113: hosts grouped by membership checksum."""
    groups: dict[Any, list[str]] = {}
    for host, checksum in checksums.items():
        groups.setdefault(checksum, []).append(host)
    return groups


def format_groups(groups: dict[Any, list[str]], elapsed_ms: float) -> str:
    sizes = " ".join(str(len(v)) for v in groups.values())
    state = "CONVERGED" if len(groups) == 1 else f"{len(groups)} groups"
    return f"tick: {state} [{sizes}] in {elapsed_ms:.0f}ms"


class ClusterCommands:
    """Common command surface over either backend."""

    def cmd(self, ch: str) -> None:
        dispatch = {
            "j": self.join_all,
            "g": self.gossip_all,
            "t": self.tick_all,
            "s": self.stats,
            "p": self.protocol_stats,
            "d": lambda: self.debug_set("p"),
            "D": self.debug_clear,
            "l": self.suspend_next,
            "L": self.resume_all,
            "k": self.kill_next,
            "K": self.revive_next,
        }
        fn = dispatch.get(ch)
        if fn is None:
            print(f"unknown command {ch!r}")
        else:
            fn()

    # subclass responsibilities
    def join_all(self) -> None: ...
    def gossip_all(self) -> None: ...
    def tick_all(self) -> None: ...
    def stats(self) -> None: ...
    def protocol_stats(self) -> None: ...
    def debug_set(self, flag: str) -> None: ...
    def debug_clear(self) -> None: ...
    def suspend_next(self) -> None: ...
    def resume_all(self) -> None: ...
    def kill_next(self) -> None: ...
    def revive_next(self) -> None: ...
    def wait(self, ms: float) -> None: ...
    def shutdown(self) -> None: ...


def print_final_checksums(cluster, groups: dict[int, list[str]] | None = None) -> None:
    """Deterministic end-of-run line: the distinct membership checksums
    among live nodes, sorted — what the CI soak-resume smoke greps to
    compare a killed+resumed run against its uninterrupted twin.
    ``groups`` (a ``checksum_groups()`` result) skips recomputing the
    per-node checksum pass when the caller already ran it."""
    sums = sorted(groups) if groups is not None else sorted(
        set(cluster.checksums().values())
    )
    print("final checksums: " + " ".join(str(s) for s in sums))


class SimCluster(ClusterCommands):
    """Deterministic in-process cluster on virtual time (--sim): the
    host library's ``harness.Cluster``, each node's ring hashed on
    ``device`` (``cuda`` unless the caller names one)."""

    def __init__(self, size: int, base_port: int, seed: int = 1,
                 device: Any = None):
        from ringpop_tpu_torch.harness import Cluster

        self.cluster = Cluster(size=size, base_port=base_port, seed=seed,
                               device=device)
        self.cluster.bootstrap_all()
        self._suspended: list[int] = []
        self._killed: list[int] = []

    def join_all(self) -> None:
        print(f"join: {len(self.cluster.live_nodes())} nodes bootstrapped")

    def gossip_all(self) -> None:
        for node in self.cluster.live_nodes():
            node.gossip.start()
        print("gossip started on all nodes")

    def tick_all(self) -> None:
        t0 = time.perf_counter()
        self.cluster.tick_all()
        print(format_groups(self.cluster.checksum_groups(),
                            (time.perf_counter() - t0) * 1000))

    def stats(self) -> None:
        for checksum, hosts in self.cluster.checksum_groups().items():
            print(f"  checksum {checksum}: {len(hosts)} nodes {sorted(hosts)}")

    def protocol_stats(self) -> None:
        for node in self.cluster.live_nodes():
            stats = node.get_stats()
            timing = stats["protocol"]["timing"]
            print(
                f"  {node.host_port}: p50={timing['median']:.1f}"
                f" p95={timing['p95']:.1f} count={timing['count']}"
            )
            print_op_percentiles(stats)

    def debug_set(self, flag: str) -> None:
        for node in self.cluster.live_nodes():
            node.set_debug_flag(flag)

    def debug_clear(self) -> None:
        for node in self.cluster.live_nodes():
            node.clear_debug_flags()

    def suspend_next(self) -> None:
        live = [i for i, n in enumerate(self.cluster.nodes)
                if i not in self._suspended and i not in self._killed]
        if not live:
            return print("no live node to suspend")
        self.cluster.suspend(live[-1])
        self._suspended.append(live[-1])
        print(f"suspended {self.cluster.host_ports[live[-1]]}")

    def resume_all(self) -> None:
        for index in self._suspended:
            self.cluster.resume(index)
        print(f"resumed {len(self._suspended)} nodes")
        self._suspended.clear()

    def kill_next(self) -> None:
        live = [i for i, n in enumerate(self.cluster.nodes)
                if i not in self._suspended and i not in self._killed]
        if not live:
            return print("no live node to kill")
        self.cluster.kill(live[-1])
        self._killed.append(live[-1])
        print(f"killed {self.cluster.host_ports[live[-1]]}")

    def revive_next(self) -> None:
        if not self._killed:
            return print("no dead node to revive")
        index = self._killed.pop(0)
        self.cluster.revive(index)
        print(f"revived {self.cluster.host_ports[index]}")

    def wait(self, ms: float) -> None:
        self.cluster.run(ms)

    def shutdown(self) -> None:
        self.cluster.destroy_all()


class TpuSimCluster(ClusterCommands):
    """The tensor simulation behind the same command surface
    (models/cluster.py SimCluster): tens of thousands of virtual nodes
    on one card.  ``wN`` advances N ms of protocol time
    (= N / period_ms ticks).  ``device`` is ``cuda`` unless the caller
    names one."""

    def __init__(self, size: int, seed: int = 1, loss: float = 0.0,
                 damping: bool = False, sparse_cap: int = 0,
                 probe: str = "sweep", layout: str = "dense",
                 capacity: int = 256, stats_out: str | None = None,
                 device: Any = None):
        from ringpop_tpu_torch.models import swim_sim as sim
        from ringpop_tpu_torch.models.cluster import SimCluster
        from ringpop_tpu_torch.obs.emitters import make_emitter

        self.sim = sim
        self.stats_emitter = make_emitter(stats_out) if stats_out else None
        self.cluster = SimCluster(
            size,
            sim.SwimParams(loss=loss, sparse_cap=sparse_cap, probe=probe),
            seed=seed,
            damping=damping,
            backend=layout,
            capacity=capacity,
            stats_emitter=self.stats_emitter,
            device=device,
        )
        # an identically-seeded sibling cluster: the --policy control
        # arm replays the same incident (same key stream) without the
        # policy, so the before/after line is a true A/B
        self._mk_cluster = lambda: SimCluster(
            size,
            sim.SwimParams(loss=loss, sparse_cap=sparse_cap, probe=probe),
            seed=seed,
            damping=damping,
            backend=layout,
            capacity=capacity,
            device=self.cluster.device,
        )
        self._suspended: list[int] = []
        self._killed: list[int] = []

    def join_all(self) -> None:
        print(f"join: {len(self.cluster.live_indices())} virtual nodes live")

    def gossip_all(self) -> None:
        print("gossip is implicit: every tick is one protocol period per node")

    def tick_all(self) -> None:
        t0 = time.perf_counter()
        metrics = self.cluster.tick()
        groups = self.cluster.checksum_groups()
        line = format_groups(groups, (time.perf_counter() - t0) * 1000)
        print(f"{line}  (pings={metrics['pings_sent']}"
              f" full_syncs={metrics['full_syncs']})")

    def stats(self) -> None:
        groups = self.cluster.checksum_groups()
        for checksum, addrs in sorted(groups.items(), key=lambda g: -len(g[1])):
            sample = ", ".join(sorted(addrs)[:3])
            more = f" (+{len(addrs) - 3} more)" if len(addrs) > 3 else ""
            print(f"  checksum {checksum}: {len(addrs)} nodes [{sample}{more}]")

    def protocol_stats(self) -> None:
        log = self.cluster.metrics_log[-5:]
        for i, metrics in enumerate(log):
            print(f"  t-{len(log) - i}: {metrics}")
        # request-latency percentiles next to the protocol counters:
        # the latest SLO-latency-enabled traffic trace's histogram
        # plane (traffic/latency.py), whole-run aggregate
        from ringpop_tpu_torch.traffic.latency import plane_stats

        for trace in reversed(self.cluster.traces):
            agg = plane_stats(trace)
            if agg is not None:
                print(
                    f"  requestProxy.send: p50={agg['median']:.0f}ms "
                    f"p95={agg['p95']:.0f}ms p99={agg['p99']:.0f}ms "
                    f"count={agg['count']}"
                )
                break

    def debug_set(self, flag: str) -> None:
        print("debug flags are a host-library feature; use metrics_log")

    def debug_clear(self) -> None:
        pass

    def _live(self) -> list[int]:
        return [int(i) for i in self.cluster.live_indices()]

    def suspend_next(self) -> None:
        live = [i for i in self._live() if i not in self._suspended]
        if not live:
            return print("no live node to suspend")
        self.cluster.suspend(live[-1])
        self._suspended.append(live[-1])
        print(f"suspended node {live[-1]}")

    def resume_all(self) -> None:
        for index in self._suspended:
            self.cluster.resume(index)
        print(f"resumed {len(self._suspended)} nodes")
        self._suspended.clear()

    def kill_next(self) -> None:
        live = self._live()
        if not live:
            return print("no live node to kill")
        self.cluster.kill(live[-1])
        self._killed.append(live[-1])
        print(f"killed node {live[-1]}")

    def revive_next(self) -> None:
        if not self._killed:
            return print("no dead node to revive")
        index = self._killed.pop(0)
        self.cluster.revive(index)
        print(f"revived node {index}")

    def wait(self, ms: float) -> None:
        ticks = max(1, int(ms / self.cluster.params.period_ms))
        self.cluster.tick(ticks)

    def shutdown(self) -> None:
        if self.stats_emitter is not None:
            self.stats_emitter.close()

    def run_scenario(
        self,
        path: str | None,
        trace_out: str | None = None,
        sweep: int = 0,
        sweep_loss_scales: list[float] | None = None,
        sweep_kill_jitter: list[int] | None = None,
        sweep_flap_jitter: list[int] | None = None,
        sweep_param_axes: dict[str, list[float | int]] | None = None,
        traffic: str | None = None,
        latency_buckets: int = 0,
        segment_ticks: int | None = None,
        checkpoint: str | None = None,
        checkpoint_every: int = 1,
        segment_store: str | None = None,
        incident: str | None = None,
        policy: str | None = None,
        trace_rumors: int = 0,
        spans_out: str | None = None,
    ) -> None:
        """Run a JSON scenario spec in one call (scenarios/);
        with ``sweep=R`` run R replicas (scenarios/sweep.py); with
        ``traffic`` co-run a key workload (spec shorthand like
        ``zipf:512``, or a JSON workload file) inside the same
        run and report the serving counters; with
        ``segment_ticks=S`` stream the run as pipelined S-tick segments,
        checkpointing every
        ``checkpoint_every`` segments when ``checkpoint`` is given —
        a killed soak continues with ``--resume``.

        ``incident=NAME`` replays a named outage from the incident
        library (scenarios/library.py) at this cluster's size instead
        of a spec file: the incident supplies both the fault timeline
        and its latency-coupled workload, the run streams by default
        (segments of 32), and the detect/heal/serve summary prints at
        the end — the same summary the golden regression lane pins.

        ``policy=NAME[:k=v,...]`` arms a remediation policy
        (ringpop_tpu_torch/policies); with ``incident`` a no-policy CONTROL
        arm replays first on an identically-seeded sibling cluster, and
        the before/after goodput + amplification line prints under the
        summary.

        ``trace_rumors=K`` arms the provenance plane with K rumor
        slots (obs/provenance.py; composes with ``incident``: the
        incident's own declarations auto-arm slots), prints the
        per-rumor dissemination report, and with ``spans_out=FILE``
        writes the Perfetto-openable trace-event JSON
        (obs/spans.py)."""
        from ringpop_tpu_torch.scenarios.spec import ScenarioSpec

        incident_name = incident
        if incident_name is not None:
            from ringpop_tpu_torch.scenarios import library as ilib

            spec, traffic = ilib.build_incident(
                incident_name, self.cluster.n,
                backend=self.cluster.backend,
            )
            if segment_ticks is None:
                # incidents stream by default: O(segment) host
                # telemetry, and the same bit-identical trace
                segment_ticks = min(32, spec.ticks)
        else:
            spec = ScenarioSpec.load(path)
        if trace_rumors:
            # arm the provenance plane on top of whatever the spec (or
            # the incident) already says — a spec-file trace_rumors
            # stands unless the flag overrides it
            spec = spec._replace(trace_rumors=int(trace_rumors))
        if traffic and latency_buckets and incident_name is None:
            # enable the SLO latency plane on the parsed workload
            # (compile_traffic pins the tick->ms period to the cluster)
            from ringpop_tpu_torch.traffic.workloads import WorkloadSpec

            traffic = WorkloadSpec.from_spec(traffic)._replace(
                latency_buckets=int(latency_buckets)
            )
        if sweep:
            self._run_sweep(
                spec, trace_out, sweep, sweep_loss_scales, sweep_kill_jitter,
                flap_jitter=sweep_flap_jitter, traffic=traffic,
                segment_ticks=segment_ticks, segment_store=segment_store,
                policy=policy, param_axes=sweep_param_axes,
            )
            return
        control = None
        if policy is not None and incident_name is not None:
            from ringpop_tpu_torch.scenarios import library as ilib

            ctrl_trace = self._mk_cluster().run_scenario(
                spec, traffic=traffic, segment_ticks=segment_ticks
            )
            control = ilib.incident_summary(ctrl_trace)
        t0 = time.perf_counter()
        if segment_ticks:
            trace = self.cluster.run_scenario(
                spec,
                traffic=traffic,
                segment_ticks=segment_ticks,
                checkpoint_path=checkpoint,
                checkpoint_every=checkpoint_every,
                store=segment_store,
                policy=policy,
            )
        else:
            trace = self.cluster.run_scenario(
                spec, traffic=traffic, policy=policy
            )
        wall_ms = (time.perf_counter() - t0) * 1000
        state = (
            "CONVERGED" if trace.converged[-1]
            else f"NOT converged ({int(trace.live[-1])} live)"
        )
        if segment_ticks:
            from ringpop_tpu_torch.scenarios.stream import segment_bounds

            segments = len(segment_bounds(trace.ticks, segment_ticks))
            print(
                f"scenario: {trace.ticks} ticks streamed as {segments} "
                f"segments of {segment_ticks} (pipelined, one compile) in "
                f"{wall_ms:.0f}ms — {state}, first converged tick "
                f"{trace.first_converged_tick()}, "
                f"live {int(trace.live[-1])}/{self.cluster.n}"
            )
            if checkpoint:
                print(f"checkpoint (resume with --resume) -> {checkpoint}")
        else:
            print(
                f"scenario: {trace.ticks} ticks, {len(spec.events)} events, "
                f"one dispatch in {wall_ms:.0f}ms — {state}, first converged "
                f"tick {trace.first_converged_tick()}, "
                f"live {int(trace.live[-1])}/{self.cluster.n}"
            )
        groups = self.cluster.checksum_groups()
        print(format_groups(groups, wall_ms))
        if segment_ticks:
            print_final_checksums(self.cluster, groups=groups)
        if traffic and "lookups" in trace.metrics:
            m = trace.metrics
            lookups = int(m["lookups"].sum())
            misroutes = int(m["misroutes"].sum())
            peak = int(m["misroutes"].argmax())
            hops = {
                k[4:]: int(v.sum())
                for k, v in sorted(
                    m.items(),
                    key=lambda kv: int(kv[0][4:]) if kv[0][4:].isdigit() else 0,
                )
                if k.startswith("hops") and v.sum()
            }
            print(
                f"traffic: {lookups} lookups served, "
                f"{int(m['delivered'].sum())} delivered, "
                f"{misroutes} misroutes (peak {int(m['misroutes'][peak])} "
                f"at tick {peak}), {int(m['proxy_retries'].sum())} retries, "
                f"{int(m['proxy_failed'].sum())} failed; "
                f"forward hops {hops}"
            )
            from ringpop_tpu_torch.traffic.latency import plane_stats

            agg = plane_stats(trace)
            if agg is not None:
                from ringpop_tpu_torch.traffic.engine import total_sends

                delivered = max(int(m["delivered"].sum()), 1)
                sends = total_sends(m)
                print(
                    f"latency: p50={agg['median']:.0f}ms "
                    f"p95={agg['p95']:.0f}ms p99={agg['p99']:.0f}ms "
                    f"over {agg['count']} delivered; "
                    f"retry amplification {sends / delivered:.2f} "
                    f"sends/delivered, "
                    f"{int(m['gray_timeouts'].sum())} gray timeouts"
                )
        prov_report = None
        if spec.trace_rumors:
            from ringpop_tpu_torch.obs import spans as obs_spans

            prov_report = self.cluster.provenance_report()
            rumors = prov_report["rumors"]
            print(
                f"provenance: {len(rumors)}/{spec.trace_rumors} rumor "
                f"slots armed (log2(n) bound {prov_report['log2_n']} ticks)"
            )
            res_name = {0: "pending", 1: "refuted", 2: "confirmed"}
            for r in rumors:
                res = res_name.get(r["resolution"], "?")
                at = (f"@t{r['resolution_tick']}"
                      if r["resolution_tick"] >= 0 else "")
                print(
                    f"  slot {r['slot']}: n{r['subject']} key {r['key']} — "
                    f"origin n{r['origin']}@t{r['origin_tick']}, {res}{at}, "
                    f"infected {r['infected']}/{prov_report['n']} "
                    f"(depth {r['depth_max']}, p50/p95/p99 "
                    f"{r['infection_p50']}/{r['infection_p95']}/"
                    f"{r['infection_p99']} ticks, "
                    f"{r['stragglers']} stragglers), "
                    f"witnesses {r['witnesses']}"
                )
            if spans_out:
                nev = obs_spans.write_spans(prov_report, spans_out)
                print(f"spans ({nev} trace events, Perfetto-openable) "
                      f"-> {spans_out}")
            if self.cluster.stats_sink is not None:
                from ringpop_tpu_torch.obs import bridge as obs_bridge

                sink = self.cluster.stats_sink
                obs_bridge.emit_provenance(
                    prov_report, sink.emitter, prefix=sink.prefix
                )
        if incident_name is not None:
            from ringpop_tpu_torch.scenarios import library as ilib

            summary = ilib.incident_summary(trace, prov=prov_report)
            print(ilib.format_summary(incident_name, summary))
            if control is not None and control.get("lookups"):
                g0 = 100.0 * control["delivered"] / control["lookups"]
                g1 = 100.0 * summary["delivered"] / max(summary["lookups"], 1)
                a0 = control["sends"] / max(control["delivered"], 1)
                a1 = summary["sends"] / max(summary["delivered"], 1)
                print(
                    f"policy {policy}: goodput {g0:.1f}% -> {g1:.1f}%, "
                    f"amplification {a0:.2f} -> {a1:.2f} "
                    f"(control arm vs policy arm, same seed)"
                )
        if trace_out:
            trace.save(trace_out)
            print(f"trace ({trace.ticks} ticks x "
                  f"{len(trace.metrics) + 3} series) -> {trace_out}")

    def _run_sweep(self, spec, trace_out, replicas, loss_scales, kill_jitter,
                   flap_jitter=None, traffic=None, segment_ticks=None,
                   segment_store=None, policy=None, param_axes=None):
        t0 = time.perf_counter()
        strace = self.cluster.run_sweep(
            spec, replicas,
            loss_scales=loss_scales, kill_jitter=kill_jitter,
            flap_jitter=flap_jitter, traffic=traffic,
            segment_ticks=segment_ticks, store=segment_store,
            policy=policy, param_axes=param_axes,
        )
        wall_ms = (time.perf_counter() - t0) * 1000
        summary = strace.summary()
        rep = summary["replicas"]
        det, heal = summary["detect_tick"], summary["heal_tick"]

        def dist(d, hit):
            if not hit:
                return "-"
            return (f"min={d['min']:.0f} p50={d['median']:.0f} "
                    f"p95={d['p95']:.0f} max={d['max']:.0f}")

        how = (
            f"streamed in segments of {segment_ticks}"
            if segment_ticks else "one vmapped dispatch"
        )
        print(
            f"sweep: {replicas} replicas x {strace.ticks} ticks, "
            f"{how} in {wall_ms:.0f}ms — "
            f"converged {rep['converged_final']}/{replicas}"
        )
        print(f"  detect tick ({rep['detected']}/{replicas} detected): "
              f"{dist(det, rep['detected'])}")
        print(f"  heal tick ({rep['healed']}/{replicas} healed): "
              f"{dist(heal, rep['healed'])}")
        serving = strace.serving_summary()
        if serving is not None:
            # per-replica serving scorecards: the traffic-coupled sweep's
            # one-dispatch answer (SweepTrace.serving_summary)
            for row in serving:
                line = (
                    f"  replica {row['replica']}: goodput "
                    f"{100 * row['goodput']:.1f}%, "
                    f"{row['misroutes']} misroutes, "
                    f"amplification {row['amplification']:.2f}"
                )
                if "lat_p99_ms" in row:
                    line += (f", lat p50/p95/p99 {row['lat_p50_ms']:.0f}/"
                             f"{row['lat_p95_ms']:.0f}/"
                             f"{row['lat_p99_ms']:.0f}ms")
                if "ov_gray_peak" in row:
                    line += f", peak overload-gray {row['ov_gray_peak']}"
                print(line)
        if trace_out:
            strace.save(trace_out)
            print(
                f"sweep trace ({replicas} x {strace.ticks} x "
                f"{len(strace.metrics) + 3} series) -> {trace_out}"
            )
        if self.cluster.stats_sink is not None:
            # run_sweep is a measurement fan-out, not the cluster's own
            # trajectory, so SimCluster does not bridge it; stream one
            # representative replica so --stats-out still observes it.
            # The cluster state did not advance, so its current
            # checksum (the sweep's shared starting point) is the
            # honest value for the checksum gauge.
            from ringpop_tpu_torch.obs import bridge as obs_bridge

            checksum = None
            live = self.cluster.live_indices()
            if live.size:
                first = int(live[0])
                checksum = self.cluster.checksums(indices=[first])[
                    self.cluster.book.addresses[first]
                ]
            sink = self.cluster.stats_sink
            obs_bridge.replay_trace(
                strace.replica(0), sink.emitter, prefix=sink.prefix,
                checksum=checksum,
            )
            print("stats: bridged sweep replica 0 to --stats-out")


MENU = """commands:
  j join-all    g gossip-all   t tick (convergence)   s stats by checksum
  p protocol timing   d/D debug set/clear
  l suspend   L resume-all   k kill   K revive   q quit"""


def run_script(surface: ClusterCommands, script: str) -> None:
    for op in script.split(","):
        op = op.strip()
        if not op:
            continue
        if op[0] == "w":
            surface.wait(float(op[1:]))
        elif op == "q":
            break
        else:
            surface.cmd(op)


def run_interactive(surface: ClusterCommands) -> None:
    import termios
    import tty

    print(MENU)
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        while True:
            ch = sys.stdin.read(1)
            if ch in ("q", "\x03"):
                break
            surface.cmd(ch)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def add_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-n", "--size", type=int, default=5,
                        help="number of nodes (tick-cluster.js:32 default 5)")
    parser.add_argument("--base-port", type=int, default=3000)
    parser.add_argument("--sim", action="store_true",
                        help="in-process deterministic cluster on virtual time")
    parser.add_argument("--backend", choices=["proc", "host-sim", "tpu-sim"],
                        default=None,
                        help="tpu-sim: the tensor simulation (scales to "
                             "tens of thousands); host-sim (= --sim): the "
                             "host library's in-process cluster on virtual "
                             "time; proc (the default) needs real worker "
                             "processes over TCP, which are not ported, "
                             "and raises")
    parser.add_argument("--device", default=None,
                        help="tpu-sim, host-sim: the torch device to run on (cuda "
                             "unless told, e.g. cpu; with no card and no "
                             "--device the run raises)")
    parser.add_argument("--loss", type=float, default=0.0,
                        help="tpu-sim: iid packet-loss probability")
    parser.add_argument("--sparse-cap", type=int, default=0,
                        help="tpu-sim: cap changes per message (sparse "
                             "dissemination fast path; 0 = dense)")
    parser.add_argument("--probe", choices=["uniform", "sweep"],
                        default="sweep",
                        help="tpu-sim: probe-target policy (sweep = "
                             "round-robin per-round coverage guarantee, "
                             "the SwimParams default)")
    parser.add_argument("--layout", choices=["dense", "delta"],
                        default="dense",
                        help="tpu-sim state layout: dense N x N views, or "
                             "the O(N*C) delta-from-base tables "
                             "(models/swim_delta.py) for 65k+ nodes")
    parser.add_argument("--capacity", type=int, default=256,
                        help="tpu-sim --layout delta: divergence slots "
                             "per viewer (C)")
    parser.add_argument("--damping", action="store_true",
                        help="tpu-sim: enable the flap-damping extension")
    parser.add_argument("--script", default=None,
                        help='non-interactive command list, e.g. "j,w3000,t,q"')
    parser.add_argument("--scenario", default=None, metavar="FILE",
                        help="tpu-sim: run a JSON scenario spec (compiled "
                             "fault timeline in one call; see "
                             "docs/simulation.md) instead of --script")
    parser.add_argument("--incident", default=None, metavar="NAME",
                        help="tpu-sim: replay a named outage from the "
                             "incident library (scenarios/library.py; "
                             "docs/incidents.md) at this cluster size — "
                             "fault timeline plus its latency-coupled "
                             "workload, streamed by default, with the "
                             "detect/heal/serve summary printed (the "
                             "golden-lane summary); see --list-incidents")
    parser.add_argument("--list-incidents", action="store_true",
                        help="print the incident catalog and exit")
    parser.add_argument("--policy", default=None, metavar="NAME[:k=v,...]",
                        help="tpu-sim: arm a remediation policy "
                             "(ringpop_tpu_torch/policies; docs/incidents.md) in "
                             "the compiled scenario scan — admission "
                             "load-shedding, adaptive retry budgets, "
                             "serve-side quarantine, or all three "
                             "(combined), with optional integer knob "
                             "overrides.  Needs a serve workload "
                             "(--incident or --traffic); with --incident a "
                             "no-policy control arm replays first and the "
                             "before/after goodput + amplification line "
                             "prints; see --list-policies")
    parser.add_argument("--list-policies", action="store_true",
                        help="print the policy catalog (with concrete "
                             "default knobs at this --size) and exit")
    parser.add_argument("--trace-out", default=None, metavar="FILE",
                        help="with --scenario: write the per-tick telemetry "
                             "trace (.npz) here")
    parser.add_argument("--trace-rumors", type=int, default=0, metavar="K",
                        help="with --scenario/--incident: arm the gossip "
                             "provenance plane with K rumor slots "
                             "(obs/provenance.py) — per-rumor infection "
                             "wavefronts and suspect→faulty/refute "
                             "causality chains recorded INSIDE the "
                             "compiled scan; the dissemination report "
                             "(depth, infection-time percentiles vs the "
                             "paper's log2(N) bound) prints at the end")
    parser.add_argument("--spans-out", default=None, metavar="FILE",
                        help="with --trace-rumors: write the run's "
                             "provenance as Chrome trace-event JSON "
                             "(obs/spans.py) — open in ui.perfetto.dev "
                             "or chrome://tracing; one track per rumor, "
                             "detection window spans + infection flow "
                             "arrows")
    parser.add_argument("--traffic", default=None, metavar="SPEC",
                        help="with --scenario: co-run a key workload in "
                             "the same compiled program — SPEC is "
                             "kind:M[:pool] shorthand (uniform/zipf/"
                             "tenant, M keys per tick) or a JSON "
                             "workload file (traffic/workloads.py); "
                             "serving counters (lookup, requestProxy.*, "
                             "misroutes, forward hops) join the trace "
                             "and the --stats-out stream")
    parser.add_argument("--latency-buckets", type=int, default=0, metavar="B",
                        help="with --traffic: enable the SLO latency plane "
                             "(traffic/latency.py) — per-request latency "
                             "(link RTTs + RETRY_SCHEDULE backoff, gray "
                             "holders time out off their duty phase) lands "
                             "in B log2 buckets per tick; request-latency "
                             "p50/p95/p99 join the serving summary, the "
                             "'p' command, and the requestProxy.send "
                             "timing stream of --stats-out (0 = off)")
    parser.add_argument("--segment-ticks", type=int, default=None, metavar="S",
                        help="with --scenario: stream the run as pipelined "
                             "S-tick segment dispatches of ONE compiled "
                             "executable (scenarios/stream.py) — per-segment "
                             "telemetry drain overlaps the next segment's "
                             "device compute, host trace memory is "
                             "O(segment), and the run can checkpoint/resume "
                             "at segment granularity")
    parser.add_argument("--checkpoint", default=None, metavar="FILE",
                        help="with --segment-ticks: write a v5 checkpoint "
                             "(state + stream cursor) every "
                             "--checkpoint-every segments; segment slabs "
                             "persist next to it (FILE.segments/) so "
                             "--resume reproduces the full trace")
    parser.add_argument("--checkpoint-every", type=int, default=1, metavar="K",
                        help="with --checkpoint: checkpoint cadence in "
                             "completed segments (default 1: every segment)")
    parser.add_argument("--segment-store", default=None, metavar="DIR",
                        help="with --segment-ticks: write per-segment "
                             "telemetry slabs (.npz + JSONL manifest) here "
                             "instead of/as well as the in-memory trace")
    parser.add_argument("--resume", default=None, metavar="FILE",
                        help="continue a killed streamed soak from its "
                             "checkpoint (bit-identical to the "
                             "uninterrupted run) and print the final "
                             "summary; no other cluster flags needed")
    parser.add_argument("--sweep", type=int, default=0, metavar="R",
                        help="with --scenario: run R replicas of the "
                             "scenario (scenarios/sweep.py) "
                             "(per-replica PRNG seeds; scenarios/sweep.py), "
                             "reporting detection/heal-tick distributions")
    parser.add_argument("--sweep-loss-scales", default=None, metavar="S,S,...",
                        help="with --sweep: comma list of R per-replica "
                             "loss multipliers (every loss value of the "
                             "spec, base included, scales per replica)")
    parser.add_argument("--sweep-kill-jitter", default=None, metavar="J,J,...",
                        help="with --sweep: comma list of R per-replica "
                             "tick offsets applied to the spec's kill "
                             "events")
    parser.add_argument("--sweep-flap-jitter", default=None, metavar="J,J,...",
                        help="with --sweep: comma list of R per-replica "
                             "tick offsets applied to the spec's flap "
                             "windows (at AND until move together, so "
                             "every replica keeps the same duty cycle at "
                             "a different storm phase)")
    parser.add_argument("--sweep-param-axes", default=None,
                        metavar="K=V,V,..;K=V,..",
                        help="with --sweep: semicolon list of traced "
                             "protocol knob axes, each a comma list of R "
                             "per-replica values (e.g. "
                             "suspicion_ticks=6,12,25) — one compiled "
                             "program serves the whole knob grid "
                             "(docs/simulation.md, 'Traced protocol "
                             "knobs')")
    parser.add_argument("--stats-out", default=None, metavar="SPEC",
                        help="tpu-sim: stream protocol stats under "
                             "reference statsd keys (obs/bridge.py key "
                             "table) to SPEC — a JSON-lines file path, "
                             "'-' (stdout), or statsd://HOST:PORT (UDP "
                             "line protocol); ticks stream as they run, "
                             "--scenario replays its whole trace")
    parser.add_argument("--profile-dir", default=None, metavar="DIR",
                        help="tpu-sim: bracket the run with a "
                             "torch.profiler trace written to DIR "
                             "(TensorBoard/Perfetto-loadable, protocol "
                             "phases named via obs/annotate.py scopes)")
    parser.add_argument("--script-to-scenario", default=None, metavar="FILE",
                        help="compile --script into a scenario spec JSON at "
                             "FILE and exit (no cluster is started)")
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--log-level", default="warn")
    parser.add_argument("--startup-timeout-s", type=float, default=60,
                        help="proc mode: max wait for workers to answer /health")


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog="ringpop-tpu-torch tick-cluster")
    add_args(parser)
    args = parser.parse_args(argv)

    if args.list_incidents:
        from ringpop_tpu_torch.scenarios.library import format_catalog

        print(format_catalog())
        return

    if args.list_policies:
        from ringpop_tpu_torch.policies import format_catalog as policy_catalog

        # the incident workloads serve 8n keys/tick, so show the
        # defaults a --incident run at this --size would compile
        print(policy_catalog(args.size, 8 * args.size))
        return

    if args.script_to_scenario:
        if not args.script:
            parser.error("--script-to-scenario needs --script")
        from ringpop_tpu_torch.scenarios.spec import script_to_spec

        spec = script_to_spec(args.script, args.size)
        spec.save(args.script_to_scenario)
        print(
            f"compiled {len(spec.events)} events over {spec.ticks} ticks "
            f"-> {args.script_to_scenario}"
        )
        return

    if args.resume:
        from ringpop_tpu_torch.scenarios import stream as sstream

        t0 = time.perf_counter()
        cluster, result = sstream.resume(args.resume, device=args.device)
        wall_ms = (time.perf_counter() - t0) * 1000
        trace = (
            result if not isinstance(result, sstream.SegmentStore)
            else result.assemble()
        )
        state = (
            "CONVERGED" if trace.converged[-1]
            else f"NOT converged ({int(trace.live[-1])} live)"
        )
        print(
            f"resumed soak: {trace.ticks} ticks complete in {wall_ms:.0f}ms "
            f"— {state}, live {int(trace.live[-1])}/{cluster.n}"
        )
        print_final_checksums(cluster)
        if args.trace_out:
            trace.save(args.trace_out)
            print(f"trace ({trace.ticks} ticks x "
                  f"{len(trace.metrics) + 3} series) -> {args.trace_out}")
        return

    backend = args.backend or ("host-sim" if args.sim else "proc")
    has_run = bool(args.scenario or args.incident)
    if has_run and backend != "tpu-sim":
        parser.error("--scenario/--incident need --backend tpu-sim (the "
                     "compiled scenario engine is a tensor-simulation "
                     "feature)")
    if args.incident and args.scenario:
        parser.error("--incident replays a library outage; it does not "
                     "compose with --scenario (the incident IS the spec)")
    if args.incident and args.traffic:
        parser.error("--incident brings its own latency-coupled workload; "
                     "drop --traffic (edit the library's incident to vary it)")
    if args.sweep and not has_run:
        parser.error("--sweep needs --scenario/--incident (it replicates a "
                     "compiled scenario, not an interactive session)")
    if args.traffic and not args.scenario:
        parser.error("--traffic needs --scenario (the workload co-runs "
                     "inside the compiled scenario scan)")
    if args.policy:
        if not (args.incident or args.traffic):
            parser.error("--policy meters the serve plane (per-node sends "
                         "+ delivered): pair it with --incident or "
                         "--scenario + --traffic")
        from ringpop_tpu_torch.policies import parse_policy_arg

        try:
            parse_policy_arg(args.policy)
        except ValueError as e:
            parser.error(str(e))
    if args.latency_buckets and not args.traffic:
        parser.error("--latency-buckets needs --traffic (it extends the "
                     "serving workload with the SLO latency plane)")
    if args.trace_rumors and not has_run:
        parser.error("--trace-rumors needs --scenario/--incident (the "
                     "provenance plane records inside a compiled "
                     "scenario run)")
    if args.trace_rumors and args.sweep:
        parser.error("--trace-rumors does not compose with --sweep on the "
                     "CLI (the per-replica reports are a library feature: "
                     "run_sweep + final_nets.pv_*)")
    if args.trace_rumors and args.sparse_cap:
        parser.error("--trace-rumors needs --sparse-cap 0 (the plane "
                     "reads the dense delivery evidence)")
    if args.spans_out and not args.trace_rumors:
        parser.error("--spans-out needs --trace-rumors (it exports the "
                     "provenance plane's report)")
    if args.segment_ticks is not None and not has_run:
        parser.error("--segment-ticks needs --scenario/--incident (it "
                     "segments a compiled scenario run)")
    if args.segment_ticks is not None and args.segment_ticks < 1:
        # the run_scenario plumbing treats a falsy segment_ticks as
        # "unsegmented", which would silently drop --checkpoint
        parser.error("--segment-ticks must be >= 1")
    if (
        (args.checkpoint or args.segment_store)
        and args.segment_ticks is None
        and not args.incident  # incidents stream by default
    ):
        parser.error("--checkpoint/--segment-store need --segment-ticks "
                     "(they are streaming-run options)")
    if args.checkpoint and args.sweep:
        parser.error("--checkpoint does not compose with --sweep "
                     "(sweeps are measurement fan-outs; re-run them)")
    if (args.stats_out or args.profile_dir) and backend != "tpu-sim":
        parser.error("--stats-out/--profile-dir need --backend tpu-sim "
                     "(the obs bridge and profiler scopes instrument the "
                     "tensor simulation; proc nodes inject a statsd "
                     "emitter via RingPop(statsd=...))")
    sweep_scales = sweep_jitter = sweep_fjitter = sweep_paxes = None
    if args.sweep_loss_scales is not None:
        sweep_scales = [float(x) for x in args.sweep_loss_scales.split(",")]
    if args.sweep_kill_jitter is not None:
        sweep_jitter = [int(x) for x in args.sweep_kill_jitter.split(",")]
    if args.sweep_flap_jitter is not None:
        sweep_fjitter = [int(x) for x in args.sweep_flap_jitter.split(",")]
    if args.sweep_param_axes is not None:
        # knob names and per-replica counts are validated host-side by
        # the sweep (before any key draw), with loud errors there —
        # the CLI only splits the grid syntax
        sweep_paxes = {}
        for part in args.sweep_param_axes.split(";"):
            name, sep, vals = part.partition("=")
            if not sep or not vals:
                parser.error("--sweep-param-axes entries look like "
                             "knob=v1,v2,... (semicolon-separated)")
            sweep_paxes[name.strip()] = [
                float(x) if "." in x else int(x) for x in vals.split(",")
            ]
    if backend == "proc":
        raise NotImplementedError(
            "--backend proc drives real worker processes over the TCP "
            f"transport, which is not ported: {HOST_LIBRARY_ITEM}; use "
            "--backend host-sim or tpu-sim"
        )
    surface: ClusterCommands
    if backend == "host-sim":
        surface = SimCluster(args.size, args.base_port, seed=args.seed,
                             device=args.device)
    else:
        surface = TpuSimCluster(args.size, seed=args.seed, loss=args.loss,
                                sparse_cap=args.sparse_cap, probe=args.probe,
                                damping=args.damping, layout=args.layout,
                                capacity=args.capacity,
                                stats_out=args.stats_out, device=args.device)

    import contextlib

    profile_ctx: Any = contextlib.nullcontext()
    if args.profile_dir:
        from ringpop_tpu_torch.obs.annotate import profile_trace

        profile_ctx = profile_trace(args.profile_dir)
    try:
        with profile_ctx:
            if args.scenario or args.incident:
                surface.run_scenario(
                    args.scenario, args.trace_out, sweep=args.sweep,
                    sweep_loss_scales=sweep_scales,
                    sweep_kill_jitter=sweep_jitter,
                    sweep_flap_jitter=sweep_fjitter,
                    sweep_param_axes=sweep_paxes,
                    traffic=args.traffic,
                    latency_buckets=args.latency_buckets,
                    segment_ticks=args.segment_ticks,
                    checkpoint=args.checkpoint,
                    checkpoint_every=args.checkpoint_every,
                    segment_store=args.segment_store,
                    incident=args.incident,
                    policy=args.policy,
                    trace_rumors=args.trace_rumors,
                    spans_out=args.spans_out,
                )
            elif args.script:
                run_script(surface, args.script)
            else:
                run_interactive(surface)
        if args.profile_dir:
            print(f"profiler trace -> {args.profile_dir}")
    finally:
        surface.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
