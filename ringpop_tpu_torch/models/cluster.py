"""SimCluster: the host-side front end of the SWIM simulation.

The port of ``ringpop_tpu/models/cluster.py`` (``backend="dense"`` and
``backend="delta"``):
drive protocol periods, group live nodes by membership checksum (the
convergence metric of ringpop's tick-cluster), inject faults (kill,
suspend, revive, partitions, packet loss, directed link rules, per-link
delay, per-node periods) as edits of ``NetState`` (and of the in-flight
claim buffer, ``enable_delay``), and
resolve keys through a node's hash ring (``ring_for``, ``lookup``, and
``lookup_batch`` over the cached global ``traffic_ring``).
The PRNG key schedule is the reference's: ``tick(1)`` splits the
cluster key and steps with the sub-key; ``tick(k > 1)`` hands the
sub-key to ``swim_run_impl``, which splits it into k keys.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch

from ringpop_tpu_torch import prng, resolve_device
from ringpop_tpu_torch.hashring import HashRing
from ringpop_tpu_torch.models import checksum as cksum
from ringpop_tpu_torch.models import swim_delta as sdelta
from ringpop_tpu_torch.models import swim_sim as sim
from ringpop_tpu_torch.models.swim_sim import NetState, SwimParams
from ringpop_tpu_torch.obs import bridge as obs_bridge
from ringpop_tpu_torch.obs import provenance as pvn
from ringpop_tpu_torch.obs.ledger import default_ledger
from ringpop_tpu_torch.ops import checksum_device as ckdev
from ringpop_tpu_torch.ops import ring_ops
from ringpop_tpu_torch.ops.farmhash import farmhash32_batch
from ringpop_tpu_torch.traffic import engine as tengine
from ringpop_tpu_torch.traffic.workloads import DEFAULT_WINDOW

DEFAULT_BASE_INC = 1_400_000_000_000  # host clock epoch (ms)
# View-row keys materialized at once by a device checksum sweep
ROW_CHUNK_ELEMENTS = 1 << 26
_STATE_LOST = (
    "SimCluster: a dense step failed after it had taken the cluster's "
    "state over, so the state (and any ticks of this call already done) is "
    "lost; build a new SimCluster"
)


def groups_to_gid(groups: Sequence[Sequence[int]], n: int) -> np.ndarray:
    """int32[N] group-id vector (-1 = ungrouped) from member lists."""
    gid = np.full(n, -1, dtype=np.int32)
    for g, members in enumerate(groups):
        gid[np.asarray(list(members), dtype=np.int64)] = g
    return gid


class SimCluster:
    def __init__(
        self,
        n: int,
        params: SwimParams = SwimParams(),
        *,
        seed: int = 0,
        addresses: Sequence[str] | None = None,
        base_inc: int = DEFAULT_BASE_INC,
        inc: Sequence[int] | None = None,
        init: str = "converged",
        device: torch.device | str | None = None,
        damping: bool = False,
        backend: str = "dense",
        capacity: int = 256,
        wire_cap: int = 16,
        claim_grid: int = 64,
        stats_emitter: Any | None = None,
        stats_prefix: str = obs_bridge.DEFAULT_PREFIX,
    ):
        """A cluster of ``n`` simulated nodes on ``device`` (``cuda``
        unless the caller names another; raises when no card is visible
        and none was named).  ``backend='dense'``: the N x N state;
        ``backend='delta'``: the O(N * C) delta-from-base state, whose
        resource caps are ``capacity``/``wire_cap``/``claim_grid``.
        ``damping=True`` (dense only) carries the flap-damping planes:
        damped members are quarantined from the viewer's ring.
        ``stats_emitter`` (any ``increment/gauge/timing`` sink,
        ``obs.emitters``) receives every tick's protocol counters and
        every scenario trace under the reference's statsd key names
        (``obs.bridge``), prefixed with ``stats_prefix``."""
        if backend not in ("dense", "delta"):
            raise ValueError(f"unknown backend: {backend!r}")
        if backend == "delta" and damping:
            raise ValueError("the delta backend does not support damping tensors")
        if backend == "delta" and params.sparse_cap:
            raise ValueError(
                "sparse_cap is a dense-backend knob; the delta backend bounds "
                "messages with wire_cap"
            )
        self.device = resolve_device(device)
        self.backend = backend
        self.params = params
        self.dparams = sdelta.DeltaParams(swim=params, wire_cap=wire_cap, claim_grid=claim_grid)
        self.book = cksum.AddressBook(addresses or cksum.default_addresses(n))
        if len(self.book) != n:
            raise ValueError("addresses must have length n")
        self.base_inc = base_inc
        rel = np.zeros(n, dtype=np.int32) if inc is None else (
            np.asarray(inc, dtype=np.int64) - base_inc
        ).astype(np.int32)
        if backend == "delta":
            self.state = sdelta.init_delta(
                n, rel, capacity=capacity, mode=init, device=self.device
            )
        else:
            self.state = sim.init_state(n, rel, mode=init, damping=damping, device=self.device)
        self.net: NetState = sim.make_net(n, device=self.device)
        self.key = prng.PRNGKey(seed)
        self.metrics_log: list[dict[str, int]] = []
        self.traces: list[Any] = []  # scenarios.Trace per run_scenario
        # the cursor of a streamed run (checkpoint v5), set by
        # checkpoint.load when the checkpoint was written mid-stream
        self.stream_cursor: dict[str, Any] | None = None
        self._device_book: ckdev.DeviceBook | None = None
        self._traffic_ring: ring_ops.DeviceRing | None = None  # lazy global ring
        self.stats_sink = (obs_bridge.StatSink(stats_emitter, stats_prefix)
                           if stats_emitter is not None else None)

    @property
    def n(self) -> int:
        return len(self.book)

    # -- time ---------------------------------------------------------------

    def _split(self) -> torch.Tensor:
        self.key, sub = prng.split(self.key)
        return sub

    def tick(self, ticks: int = 1) -> dict[str, int]:
        """Advance every node ``ticks`` protocol periods; returns the last
        tick's counters (plus ``ticks``), which also go to the stats sink
        (``obs.bridge.emit_counters``) when there is one.  Each call is one
        dispatch of the ledger (``obs.ledger``), as ``swim_step``,
        ``swim_run``, ``delta_step`` or ``delta_run``: a plain call while
        the ledger is off."""
        led = default_ledger()
        meta = {"backend": self.backend, "n": self.n, "ticks": ticks, "replicas": 1}
        if self.backend == "delta":
            if ticks == 1:
                self.state, metrics = led.dispatch(
                    "delta_step", sdelta.delta_step_impl, self.state, self.net, self._split(),
                    params=self.dparams, _meta=meta)
            else:
                self.state, metrics = led.dispatch(
                    "delta_run", sdelta.delta_run_impl, self.state, self.net, self._split(),
                    params=self.dparams, ticks=ticks, _meta=meta)
        else:
            # the signature is read off the handed-over box, before the
            # step takes the state out of it
            if ticks == 1:
                def step(hand):
                    key = self._split()
                    return led.dispatch(
                        "swim_step", sim._swim_step_handed, hand, self.net, key, self.params,
                        _meta=meta, _sig=((hand, self.net, key), {"params": self.params}))
            else:
                def step(hand):
                    key = self._split()
                    return led.dispatch(
                        "swim_run", sim._swim_run_handed, hand, self.net, key, self.params,
                        ticks, _meta=meta,
                        _sig=((hand, self.net, key), {"params": self.params, "ticks": ticks}))
            (metrics,) = self._handed(step)
        # audit: allow=RPL001 the tick's one read of its counters, in one copy
        values = torch.stack(list(metrics.values())).tolist()
        # sorted by name, as the reference's jitted steps return them (the
        # order the stats sink sees)
        out = dict(sorted(zip(metrics.keys(), (int(v) for v in values))))
        out["ticks"] = int(ticks)
        self.metrics_log.append(out)
        if self.stats_sink is not None:
            obs_bridge.emit_counters(out, self.stats_sink, live=len(self.live_indices()))
        return out

    def _handed(self, call: Callable[[sim._Handoff], tuple]) -> tuple:
        """``call(hand)`` on the dense state handed over: it takes the
        cluster's only reference, so the entry state is freed once
        replaced (10 GB at n = 40 960).  ``call`` returns the new state
        first; the rest of its result is returned.  A call that refuses
        before taking the state leaves it in place, one that fails after
        it leaves the cluster without a state."""
        if self.state is None:
            raise RuntimeError(_STATE_LOST)
        hand = sim._Handoff(self.state)
        self.state = None
        try:
            self.state, *rest = call(hand)
        except Exception as exc:
            if hand.state is None:
                raise RuntimeError(_STATE_LOST) from exc
            raise
        finally:
            if self.state is None:
                self.state = hand.state
        return tuple(rest)

    def run_scenario(
        self,
        spec,
        traffic: Any | None = None,
        *,
        segment_ticks: int | None = None,
        store: str | None = None,
        checkpoint_path: str | None = None,
        checkpoint_every: int = 1,
        assemble: bool = True,
        pipeline: bool = True,
        policy: Any | None = None,
        param_knobs: dict[str, float | int] | None = None,
    ) -> Any:
        """Run a declarative fault timeline in one call
        (``scenarios.runner.run_compiled``); returns its per-tick
        ``Trace``, also appended to ``self.traces`` (and an entry with
        the last tick's counters and ``ticks`` to ``metrics_log``).

        ``spec`` is a ``scenarios.ScenarioSpec``, its dict form or the
        path of its JSON file.  The key schedule is segment-exact, so the
        trajectory is that of the same faults applied through
        ``kill()``/``partition()``/``tick()`` (``runner.run_host_loop``).
        Every refusal comes before the first key is drawn: a failed call
        leaves ``self.key`` as it was.

        ``segment_ticks=S`` streams the run (``scenarios.stream``): S-tick
        segments, telemetry drained per segment into ``store``, a v5
        checkpoint every ``checkpoint_every`` segments with
        ``checkpoint_path``; the same trajectory and trace.
        ``assemble=False`` returns the ``SegmentStore`` instead of the
        whole trace.  ``pipeline=False`` drains each segment before the
        next starts.

        ``param_knobs`` overrides protocol knobs for this run
        (``{"suspicion_ticks": 9, ...}``, ``swim_sim.SwimKnobs`` names),
        validated before the key is drawn
        (``runner.validate_param_knobs``); not with ``segment_ticks``.

        ``traffic`` (a ``traffic.WorkloadSpec``, its dict, JSON path or
        ``kind:M[:pool]`` shorthand, or a ``CompiledTraffic`` lowered for
        this cluster's size) serves its workload every tick against the
        views that tick produced; the counters join the trace (and
        ``spec["traffic"]`` records the workload).  ``policy`` (a name with
        optional ``:k=v`` knobs, a ``policies.to_dict`` dict or a
        ``CompiledPolicy``) arms the remediation plane; it needs a
        workload, and its carry stays on ``self.net`` (``po_*``).  A spec
        with ``trace_rumors`` traces that many rumors (``track`` events
        reserve slots): the planes stay on ``self.net`` (``pv_*``,
        ``provenance_report()``; ``clear_provenance()`` before the next
        traced run) and the heard counts join the trace as ``pv_heard``.
        With a stats sink the trace is replayed into it
        (``obs.bridge.replay_trace``), closing with the membership
        checksum of the first live node."""
        from ringpop_tpu_torch.scenarios import compile as scompile
        from ringpop_tpu_torch.scenarios import runner as srunner

        if segment_ticks is not None:
            if param_knobs is not None:
                raise ValueError(
                    "param_knobs is not wired through the streamed "
                    "runner yet; run unsegmented (drop segment_ticks)"
                )
            from ringpop_tpu_torch.scenarios import stream as sstream

            return sstream.run_streamed(
                self, spec, segment_ticks=segment_ticks, traffic=traffic, store=store,
                checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                assemble=assemble, pipeline=pipeline, policy=policy,
            )
        if store is not None or checkpoint_path is not None or not assemble:
            raise ValueError(
                "store/checkpoint_path/assemble are streaming options; "
                "pass segment_ticks to stream the run"
            )
        spec = srunner.as_spec(spec)
        spec.validate(self.n)
        if traffic is not None:
            traffic = self.compile_traffic(traffic)
        compiled = scompile.compile_spec(spec, self.n, base_loss=self.params.loss,
                                         device=self.device)
        params = self.dparams if self.backend == "delta" else self.params
        adj = srunner.precheck(self.state, self.net, compiled, params)
        srunner.precheck_overload(compiled, traffic, self.net)
        policy = self._compile_policy(policy, traffic)
        srunner.precheck_policy(policy, traffic, self.net)
        srunner.precheck_prov(compiled, self.net, params)
        if param_knobs is not None:
            srunner.validate_param_knobs(
                self.n, self.params, {k: [v] for k, v in param_knobs.items()},
                backend=self.backend, period_active=srunner.period_active(self.net, compiled),
                damping=getattr(self.state, "damp", None) is not None,
            )
        keys = scompile.key_schedule(self._split, compiled)
        start_tick = int(self.state.tick)

        def run(state):
            return srunner.run_compiled(state, self.net, keys, compiled, params,
                                        traffic=traffic, adj=adj, policy=policy,
                                        param_knobs=param_knobs)

        if self.backend == "delta":
            self.state, self.net, ys = run(self.state)
        else:
            self.net, ys = self._handed(run)
        self.set_loss(float(compiled.loss[-1]))
        trace = srunner.make_trace(srunner.telemetry_numpy(ys), self, start_tick,
                                   self._spec_dict(spec, traffic, policy))
        self.traces.append(trace)
        self.log_run(trace, spec.ticks)
        if self.stats_sink is not None:
            obs_bridge.replay_trace(trace, self.stats_sink.emitter,
                                    prefix=self.stats_sink.prefix,
                                    checksum=self.first_live_checksum())
        return trace

    def first_live_checksum(self) -> int | None:
        """The membership checksum of the first live node (None with every
        node dead): the stats bridge's closing gauge."""
        live = self.live_indices()
        if not live.size:
            return None
        first = int(live[0])
        return self.checksums(indices=[first])[self.book.addresses[first]]

    def _compile_policy(self, policy: Any, traffic: Any) -> Any:
        """``policy`` resolved at this cluster's scale (a policy without a
        workload stays as given: ``precheck_policy`` refuses it)."""
        if policy is None or traffic is None:
            return policy
        from ringpop_tpu_torch.policies import core as pol

        return pol.compile_policy(policy, n=self.n, m=traffic.static.m)

    @staticmethod
    def _spec_dict(spec: Any, traffic: Any, policy: Any) -> dict:
        """The trace's spec record: the spec, and the workload and policy
        it ran with."""
        out = spec.to_dict()
        if traffic is not None:
            out["traffic"] = traffic.spec.to_dict()
        if policy is not None:
            from ringpop_tpu_torch.policies import core as pol

            out["policy"] = pol.to_dict(policy)
        return out

    def run_sweep(
        self,
        spec,
        replicas: int,
        *,
        loss_scales: Sequence[float] | None = None,
        kill_jitter: Sequence[int] | None = None,
        flap_jitter: Sequence[int] | None = None,
        traffic: Any | None = None,
        shard: bool = False,
        segment_ticks: int | None = None,
        store: str | None = None,
        assemble: bool = True,
        pipeline: bool = True,
        policy: Any | None = None,
        policy_axes: dict[str, Any] | None = None,
        param_axes: dict[str, Any] | None = None,
        program_tag: str | None = None,
    ) -> Any:
        """Run R replicas of a scenario (``scenarios.sweep``); returns a
        ``SweepTrace`` with [R, ticks] telemetry and the replicas' final
        states and nets attached in memory (``final_states[r]``,
        ``final_nets[r]``).

        Each replica starts from a copy of the current state and draws
        its own replica key from the cluster key, so replica r equals a
        standalone ``run_scenario`` from that key.  ``loss_scales``,
        ``kill_jitter`` and ``flap_jitter`` vary the scenario per
        replica; ``param_axes`` sweeps protocol knobs (``{"suspicion_ticks":
        [3, 6, 9, 12]}`` gives replica r the r-th value), and replica r
        equals ``run_scenario(param_knobs=sweep.replica_param_knobs(
        param_axes, r))``.

        The cluster does not advance: only its key moves (R draws), and
        ``metrics_log`` and ``traces`` stay as they were.  Every refusal
        comes before the first replica key is drawn.

        ``segment_ticks=S`` streams the sweep (``stream.run_sweep_streamed``):
        [R, S] slabs drained per segment into ``store``, the same
        replicas; not with ``param_axes``.  ``shard=True`` is a no-op on
        one card and raises on several; ``program_tag`` names the sweep's
        dispatch-ledger program (``run_sweep:<program_tag>``; unsegmented
        sweeps only, as in the reference).  ``traffic`` serves one
        workload stream in every replica (replica r's serving counters are
        a standalone ``run_scenario(spec_r, traffic=...)``'s; see
        ``SweepTrace.serving_summary``); ``policy`` arms a policy in every
        replica and ``policy_axes`` sweeps its knobs (``{"shed_hi": [2,
        4]}``), replica r equal to ``run_scenario(policy=sweep.replica_policy(
        policy, policy_axes, r))``."""
        from ringpop_tpu_torch import convert
        from ringpop_tpu_torch.scenarios import runner as srunner
        from ringpop_tpu_torch.scenarios import sweep as ssweep

        if segment_ticks is not None:
            if param_axes:
                raise ValueError(
                    "param_axes is not wired through the streamed "
                    "sweep yet; run unsegmented (drop segment_ticks)"
                )
            from ringpop_tpu_torch.scenarios import stream as sstream

            return sstream.run_sweep_streamed(
                self, spec, replicas, segment_ticks=segment_ticks, loss_scales=loss_scales,
                kill_jitter=kill_jitter, flap_jitter=flap_jitter, traffic=traffic, store=store,
                assemble=assemble, pipeline=pipeline, shard=shard, policy=policy,
                policy_axes=policy_axes,
            )
        if store is not None or not assemble:
            raise ValueError(
                "store/assemble are streaming options; pass segment_ticks "
                "to stream the sweep"
            )
        spec = srunner.as_spec(spec)
        spec.validate(self.n)
        if traffic is not None:
            traffic = self.compile_traffic(traffic)
        cs = ssweep.compile_sweep(
            spec, self.n, replicas=replicas, base_loss=self.params.loss,
            loss_scales=loss_scales, kill_jitter=kill_jitter, flap_jitter=flap_jitter,
            device=self.device,
        )
        params = self.dparams if self.backend == "delta" else self.params
        policy = self._compile_policy(policy, traffic)
        # every refusal before the replica keys are drawn
        ssweep.prepare(self.state, self.net, cs, params, shard=shard, traffic=traffic,
                       policy=policy, policy_axes=policy_axes, param_axes=param_axes)
        replica_keys = [self._split() for _ in range(replicas)]
        keys = ssweep.sweep_key_schedule(replica_keys, cs)
        states, nets, ys = ssweep.run_sweep_compiled(
            self.state, self.net, keys, cs, params, shard=shard, traffic=traffic,
            policy=policy, policy_axes=policy_axes, param_axes=param_axes,
            program_tag=program_tag,
        )
        trace = ssweep.sweep_trace(
            srunner.telemetry_numpy(ys), self,
            np.stack([convert.key_to_numpy(k) for k in replica_keys]), cs,
            int(self.state.tick), spec.to_dict(),
        ).validate()
        trace.final_states = states
        trace.final_nets = nets
        return trace

    def log_run(self, trace: Any, ticks: int) -> None:
        """A scenario run's ``metrics_log`` entry: its last tick's
        counters and the ticks it spans."""
        entry = {k: int(v[-1]) for k, v in trace.metrics.items()}
        entry["ticks"] = ticks
        self.metrics_log.append(entry)

    def run_until_converged(self, max_ticks: int = 1000, check_every: int = 5) -> int:
        """Ticks until convergence (or -1)."""
        done = 0
        while done < max_ticks:
            step = min(check_every, max_ticks - done)
            self.tick(step)
            done += step
            if self.converged():
                return done
        return -1

    # -- convergence -----------------------------------------------------------

    def _device_rows(self, idx: np.ndarray) -> torch.Tensor:
        """int32[len(idx), N] view rows on the device."""
        rows = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=self.device)
        if self.backend == "delta":
            return sdelta.materialize_rows(self.state, rows)
        return self.state.view_key.index_select(0, rows)

    # audit: allow=RPL001 host-side by design: the caller asks for host values
    def _view_rows(self, idx: np.ndarray) -> np.ndarray:
        """int32[len(idx), N] view rows (host copies)."""
        return self._device_rows(idx).cpu().numpy()

    def _own_keys(self) -> torch.Tensor:
        """int32[N]: each node's view of itself (the gossip gate)."""
        if self.backend == "delta":
            return sdelta.view_lookup(
                self.state, torch.arange(self.n, dtype=torch.int32, device=self.device)
            )
        return torch.diagonal(self.state.view_key)

    # audit: allow=RPL001 host-side by design: the caller asks for host values
    def live_indices(self) -> np.ndarray:
        up = (self.net.up & self.net.responsive).cpu().numpy()
        own = self._own_keys().cpu().numpy() & 7
        gossiping = up & ((own == sim.ALIVE) | (own == sim.SUSPECT))
        return np.flatnonzero(gossiping)

    def converged(self) -> bool:
        """Exact view agreement among live nodes (no hash involved)."""
        if self.backend == "delta":
            return bool(sdelta._converged_impl(self.state, self.net.up, self.net.responsive))
        return bool(sim.converged_impl(self.state, self.net))

    # audit: allow=RPL001 host-side by design: the caller asks for host values
    def checksums(
        self, indices: Sequence[int] | None = None, backend: str | None = None
    ) -> dict[str, int]:
        """Reference-format membership checksum per (live) node address.

        ``backend='device'``: string assembly and FarmHash on the
        cluster's device (the FarmHash32 kernel on the card).
        ``backend='host'``: pure Python over pulled rows, the oracle for
        small clusters.  The default is ``'device'`` on a card and
        ``'host'`` on the CPU.  Delta rows are materialized in chunks
        of at most ``ROW_CHUNK_ELEMENTS`` keys."""
        idx = self.live_indices() if indices is None else np.asarray(indices, dtype=np.int64)
        if backend is None:
            backend = "device" if self.device.type == "cuda" else "host"
        if backend == "device":
            if self._device_book is None:
                self._device_book = ckdev.DeviceBook(
                    self.book.addresses, self.base_inc, device=self.device
                )
            chunk = max(1, ROW_CHUNK_ELEMENTS // self.n)
            parts = [
                ckdev.view_checksums_device(
                    self._device_book, self._device_rows(idx[lo : lo + chunk])
                )
                for lo in range(0, len(idx), chunk)
            ]
            sums = torch.cat(parts).cpu().numpy() if parts else np.zeros(0, np.int64)
        elif backend == "host":
            sums = cksum.view_checksums_packed(self.book, self._view_rows(idx), self.base_inc)
        else:
            raise ValueError(f"unknown checksum backend: {backend!r}")
        return {self.book.addresses[i]: int(c) for i, c in zip(idx, sums)}

    def checksum_groups(self, backend: str | None = None) -> dict[int, list[str]]:
        groups: dict[int, list[str]] = {}
        for addr, c in self.checksums(backend=backend).items():
            groups.setdefault(c, []).append(addr)
        return groups

    def members(self, viewer: int) -> list[dict]:
        """The viewer's member list, in the reference's getStats shape."""
        row = self._view_rows(np.asarray([viewer]))[0]
        return cksum.row_members(self.book, row & 7, row >> 3, self.base_inc)

    # -- lookup (the ring derived from a node's view, lib/ring.js) -------------

    def _damped_row(self, viewer: int) -> torch.Tensor | None:
        """bool[N]: the subjects ``viewer`` has damped (None without the
        damping planes)."""
        damped = getattr(self.state, "damped", None)
        return None if damped is None else damped[viewer]

    # audit: allow=RPL001 host-side by design: the caller asks for host values
    def ring_for(self, viewer: int) -> HashRing:
        """The viewer's host ring: its alive and suspect members (faulty
        and leave members are out of the ring, and so are the members it
        has damped), hashed on the cluster's device."""
        ring = HashRing(device=self.device)
        damped = self._damped_row(viewer)
        damped = None if damped is None else damped.cpu().numpy()
        servers = [
            m["address"] for m in self.members(viewer)
            if m["status"] in ("alive", "suspect")
            and (damped is None or not damped[self.book.index[m["address"]]])
        ]
        ring.add_remove_servers(servers, [])
        return ring

    # audit: allow=RPL001 host-side by design: the caller asks for host values
    def damped_pairs(self) -> int:
        """Total (viewer, subject) damped entries (0 without damping)."""
        damped = getattr(self.state, "damped", None)
        return 0 if damped is None else int(damped.sum())

    def lookup(self, key: str, viewer: int = 0) -> str | None:
        return self.ring_for(viewer).lookup(key)

    def traffic_ring(self) -> ring_ops.DeviceRing:
        """The cluster's GLOBAL device ring: every address's replica
        points, sorted; per-viewer rings are masks over it.  The address
        book never changes, so it is built once and cached."""
        if self._traffic_ring is None:
            self._traffic_ring = ring_ops.build_ring(self.book.addresses, device=self.device)
        return self._traffic_ring

    def compile_traffic(self, spec: Any) -> Any:
        """Lower a ``traffic.WorkloadSpec`` (or its dict, JSON path or
        shorthand) against this cluster's address book on its device,
        reusing the cached global ring.  A ``CompiledTraffic`` passes
        through only if it was lowered for a cluster of this size (foreign
        viewer ids and ring tables would report bogus counters).  With
        the latency plane on, the tick-to-ms conversion is this cluster's
        ``params.period_ms``."""
        from ringpop_tpu_torch.traffic import workloads as tworkloads

        if isinstance(spec, tworkloads.CompiledTraffic):
            if spec.n != self.n:
                raise ValueError(
                    f"CompiledTraffic was lowered for n={spec.n}, "
                    f"this cluster has n={self.n}; re-compile the spec"
                )
            return spec
        spec = tworkloads.WorkloadSpec.from_spec(spec)
        if spec.latency_buckets:
            spec = spec._replace(period_ms=self.params.period_ms)
        return tworkloads.compile_traffic(spec, self.n, self.book.addresses,
                                          ring=self.traffic_ring())

    # audit: allow=RPL001 host-side by design: the caller asks for host values
    def lookup_batch(self, keys: Sequence[str], viewer: int = 0) -> list[str | None]:
        """Resolve a batch of keys through ``viewer``'s ring in one pass on
        the device: the keys are hashed there and resolved by a masked
        walk of the cached global ring, equal to ``ring_for(viewer).lookup``
        key for key, ``None`` per key on an empty ring included.  Keys the
        windowed walk cannot settle (rare unless the viewer's ring is
        nearly empty) are resolved through the host ring."""
        keys = list(keys)
        if not keys:
            return []
        ring = self.traffic_ring()
        # the viewer's bool[N] row, indexed by the walk's owners (no [M, N] mask)
        in_ring = tengine.in_ring_from_rows(self._device_rows(np.asarray([viewer]))[0])
        damped = self._damped_row(viewer)
        if damped is not None:
            # damped members are quarantined from the ring (ring_for)
            in_ring = in_ring & ~damped
        bufs, lens = ring_ops.encode_strings(keys)
        hashes = farmhash32_batch(
            torch.from_numpy(bufs).to(self.device), torch.from_numpy(lens).to(self.device)
        )
        owners, found = tengine.lookup_masked_idx(
            ring.hashes, ring.owners, hashes, in_ring, window=min(ring.size, DEFAULT_WINDOW)
        )
        owners = owners.cpu().numpy()
        found = found.cpu().numpy()
        out: list[str | None] = [
            self.book.addresses[int(o)] if ok else None for o, ok in zip(owners, found)
        ]
        if not found.all():
            host_ring = self.ring_for(viewer)
            for i in np.flatnonzero(~found):
                out[i] = host_ring.lookup(keys[i])
        return out

    # audit: allow=RPL001 host-side by design: the caller asks for host values
    def status_counts(self, viewer: int) -> dict[str, int]:
        vs = self._view_rows(np.asarray([viewer]))[0] & 7
        return {name: int((vs == code).sum()) for code, name in sim.STATUS_NAMES.items()}

    # -- fault injection ---------------------------------------------------------

    def _set_flag(self, field: str, i: int, value: bool) -> None:
        flag = getattr(self.net, field).clone()
        flag[i] = value
        self.net = self.net._replace(**{field: flag})

    def kill(self, i: int) -> None:
        self._set_flag("up", i, False)

    def suspend(self, i: int) -> None:
        self._set_flag("responsive", i, False)

    def resume(self, i: int) -> None:
        self._set_flag("responsive", i, True)

    # audit: allow=RPL001 host-side by design: the caller asks for host values
    def revive(self, i: int, inc: int | None = None, seed: int | None = None) -> None:
        """Restart a killed node as a fresh process and re-join it."""
        if inc is None:
            if self.backend == "delta":
                top = max(int(self.state.base_key.max()), int(self.state.d_key.max()))
            else:
                top = int(self.state.view_key.max())
            inc = top // 8 + 1000
        else:
            inc = inc - self.base_inc
        if self.backend == "delta":
            self.state = sdelta.revive(self.state, i, inc)
        else:
            self.state = sim.revive(self.state, i, inc)
        self._set_flag("up", i, True)
        self._set_flag("responsive", i, True)
        if seed is None:
            live = [j for j in self.live_indices() if j != i]
            if not live:
                return
            seed = int(live[0])
        self.join(i, seed)

    def join(self, joiner: int, seed: int) -> None:
        if self.backend == "delta":
            self.state = sdelta.admin_join(self.state, joiner, seed)
        else:
            self.state = sim.admin_join(self.state, joiner, seed)

    def leave(self, i: int) -> None:
        if self.backend == "delta":
            self.state = sdelta.admin_leave(self.state, i)
        else:
            self.state = sim.admin_leave(self.state, i)

    def partition(self, groups: Sequence[Sequence[int]]) -> None:
        """Disconnect the given groups from each other.  A partition that
        covers every node takes the int32[N] group-id form; a partial one
        (ungrouped nodes reach everyone) the bool[N, N] mask.  A net that
        already carries a mask keeps the mask form.  The delta backend
        takes the group-id form only."""
        gid = groups_to_gid(groups, self.n)
        keep_mask = self.net.adj is not None and self.net.adj.dim() == 2
        if (gid >= 0).all() and not keep_mask:
            self.net = self.net._replace(adj=torch.as_tensor(gid, device=self.device))
            return
        if self.backend == "delta":
            raise NotImplementedError(
                "delta-backend partitions must cover every node (group-id "
                "adjacency); partial groupings need the dense mask form"
            )
        same = (gid[:, None] == gid[None, :]) | (gid[:, None] < 0) | (gid[None, :] < 0)
        self.net = self.net._replace(adj=torch.as_tensor(same, device=self.device))

    def heal_partition(self) -> None:
        """Reconnect everything, keeping the adjacency's form."""
        if self.net.adj is None:
            return
        if self.net.adj.dim() == 1:
            adj = torch.zeros(self.n, dtype=torch.int32, device=self.device)
        else:
            adj = torch.ones((self.n, self.n), dtype=torch.bool, device=self.device)
        self.net = self.net._replace(adj=adj)

    def set_loss(self, p: float) -> None:
        self.params = self.params._replace(loss=float(p))
        self.dparams = self.dparams._replace(swim=self.params)

    # -- the fault model: directed link rules, delay, per-node periods ----------

    # audit: allow=RPL001 host-side by design: the caller asks for host values
    def set_link_rules(self, src, dst, p, d=None, j=None) -> None:
        """Install K directed link rules: a message from a node in
        ``src[k]`` to a node in ``dst[k]`` drops with extra probability
        ``p[k]`` (composing over rules) and, with ``d``/``j``, lands
        ``d[k] + U{0..j[k]}`` ticks later (``enable_delay`` first).
        ``src``/``dst`` are bool[K, N]; without ``d`` and ``j`` the rules
        are loss-only."""
        src = np.asarray(src, dtype=bool)
        dst = np.asarray(dst, dtype=bool)
        p = np.asarray(p, dtype=np.float32)
        if src.ndim != 2 or src.shape != dst.shape or p.shape != src.shape[:1]:
            raise ValueError(
                "link rules need src/dst bool[K, N] and p float[K] "
                f"(got {src.shape}, {dst.shape}, {p.shape})"
            )
        if src.shape[1] != self.n:
            raise ValueError(f"link rule masks are not n={self.n} wide")
        kw = {"link_d": None, "link_j": None}
        if d is not None or j is not None:
            d = np.zeros(src.shape[0], np.int32) if d is None else np.asarray(d)
            j = np.zeros(src.shape[0], np.int32) if j is None else np.asarray(j)
            if self.backend == "delta":
                depth = self.state.delay_depth
            else:
                depth = 0 if self.state.pending is None else self.state.pending.shape[0]
            if int(d.max(initial=0) + j.max(initial=0)) >= max(depth, 1):
                raise ValueError(
                    f"delay rules need enable_delay(depth > max(d + j)) "
                    f"first (depth={depth})"
                )
            kw = {"link_d": self._on_device(d.astype(np.int32)),
                  "link_j": self._on_device(j.astype(np.int32))}
        self.net = self.net._replace(
            link_src=self._on_device(src), link_dst=self._on_device(dst),
            link_p=self._on_device(p), **kw,
        )

    def clear_link_rules(self) -> None:
        self.net = self.net._replace(
            link_src=None, link_dst=None, link_p=None, link_d=None, link_j=None
        )

    def clear_overload(self) -> None:
        """Drop the overload feedback state (``NetState.ov_cnt``/
        ``ov_gray``) a finished ``overload`` run left on the net."""
        self.net = self.net._replace(ov_cnt=None, ov_gray=None)

    def clear_policy(self) -> None:
        """Drop the policy state a finished ``policy=`` run left on the net
        (``NetState.po_*``): needed before a fresh policy-armed run on this
        cluster (a resume keeps it on purpose)."""
        self.net = self.net._replace(
            po_press=None, po_shed=None, po_quar=None,
            po_sends_w=None, po_deliv_w=None, po_retry_cap=None,
        )

    def clear_provenance(self) -> None:
        """Drop the tracked-rumor state a finished ``trace_rumors`` run
        left on the net (``NetState.pv_*``): needed before a fresh traced
        run on this cluster (a resume keeps it on purpose)."""
        self.net = self.net._replace(**{f"pv_{f}": None for f in pvn.ProvCarry._fields})

    def provenance_report(self) -> dict:
        """The host-side provenance report of the last traced run's planes
        on the net (``obs.provenance.build_report``): per tracked rumor,
        the propagation tree (first_heard, parent), the detection-
        causality chain and the infection-time percentiles against the
        log2(N) bound."""
        if self.net.pv_slot is None:
            raise ValueError(
                "no provenance state on the net: run a scenario with "
                "trace_rumors > 0 first"
            )
        return pvn.build_report(
            *(getattr(self.net, f"pv_{f}") for f in pvn.ProvCarry._fields), self.n)

    def set_period(self, period) -> None:
        """Per-node protocol periods (int[N], the gray-failure model):
        node i initiates a probe every ``period[i]``-th tick but answers
        pings and serves as a witness every tick.  ``None`` restores
        lockstep.  A row of P is ``phase_mod = P`` on both backends."""
        if period is None:
            self.net = self.net._replace(period=None)
            return
        period = np.asarray(period, dtype=np.int32)
        if period.shape != (self.n,):
            raise ValueError(f"period must be int[{self.n}]")
        if self.params.phase_mod > 1:
            raise ValueError(
                "per-node periods do not compose with phase_mod > 1 "
                "(a period row of P subsumes it)"
            )
        self.net = self.net._replace(period=self._on_device(period))

    def enable_delay(self, depth: int) -> None:
        """Install the in-flight claim buffer, so that delay rules can
        defer claims up to ``depth - 1`` ticks: the dense backend's
        [D, N, N] claim matrix or the delta backend's claim lanes
        (``swim_delta.install_pending``).  It must come before the first
        delayed tick: its presence widens the per-tick key split."""
        if self.backend == "delta":
            self.state = sdelta.install_pending(self.state, depth, self.dparams.wire_cap)
            return
        if depth < 2:
            raise ValueError(f"delay depth must be >= 2 (got {depth})")
        if self.state.pending is not None:
            if self.state.pending.shape[0] != depth:
                raise ValueError(
                    f"an in-flight buffer of depth "
                    f"{self.state.pending.shape[0]} is already installed"
                )
            return
        self.state = self.state._replace(
            pending=torch.zeros((depth, self.n, self.n), dtype=torch.int32, device=self.device)
        )

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- delta maintenance (no-ops on the dense backend) -------------------------

    def compact(self) -> None:
        """Drop delta slots healed back to the base (``swim_delta.compact``)."""
        if self.backend == "delta":
            self.state = sdelta.compact(self.state)

    def rebase(self, anti_entropy: bool = False) -> None:
        """Fold majority divergence into the base (``swim_delta.rebase``;
        per side in sided mode; ``anti_entropy=True`` folds to the
        lattice max)."""
        if self.backend == "delta":
            self.state = sdelta.rebase(self.state, anti_entropy=anti_entropy)

    def split_sides(self, groups: Sequence[Sequence[int]]) -> None:
        """Enter the delta backend's sided mode for a block netsplit
        (``swim_delta.make_sides``) and partition the network to match:
        each side's consensus then folds into its own base row at each
        ``rebase``, so a 50/50 split stays at O(N * C)."""
        if self.backend != "delta":
            raise ValueError("split_sides is a delta-backend operation")
        gid = groups_to_gid(groups, self.n)
        if (gid < 0).any():
            raise ValueError("split_sides groups must cover every node")
        self.state = sdelta.make_sides(self.state, gid)
        self.net = self.net._replace(adj=torch.as_tensor(gid, device=self.device))

    def fold_sides(self) -> None:
        """Leave sided mode after the remerge converges
        (``swim_delta.fold_to_single``); rebase first to drain residue."""
        if self.backend == "delta" and self.state.side is not None:
            self.state = sdelta.fold_to_single(self.state)
