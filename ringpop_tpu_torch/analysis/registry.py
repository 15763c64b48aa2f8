"""The audited entry points: every program of the port the reference audits.

The port of ``ringpop_tpu/analysis/registry.py``.  Each entry is a named
builder producing a ``Built``: a zero-argument ``call`` that runs the
entry once on a small fixture (the reference's fixtures, on the port's
functions), the box that hands the entry state over to it, and the
contract metadata the checks need: the PRNG key roots, whether the
entry takes its state over (the reference's ``donates``), which of its
outputs ride from tick to tick, and the named dims for the census.

Every builder makes its tensors on ``device``: ``cuda`` unless the
caller names another, raising with no card and none named.  Builders
import the model modules lazily, so ``audit --list`` costs nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ringpop_tpu_torch import resolve_device

@dataclasses.dataclass
class Built:
    """One runnable entry point plus its contract metadata."""

    name: str
    backend: str
    n: int
    ticks: int  # protocol ticks one call runs (1: one step or one kernel call)
    replicas: int  # replicas the call runs (syncs are counted a replica-tick)
    call: Callable[[], Any]  # runs the entry once, taking the state out of ``box``
    box: Any  # ``swim_sim._Handoff`` holding the entry state (None: a kernel)
    carry: Callable[[Any], dict[str, torch.Tensor]]  # tick-to-tick tensors of the output
    key_roots: dict[str, list[torch.Tensor]]  # stream name -> key tensors ([..., 2] rows)
    donates: bool  # the entry takes its state over (the reference's donate_argnums)
    census_min_elems: int  # census threshold (>= [N, C]-class)
    dims: dict[str, int]  # named dims for shape tagging (N, C, ...)
    device: torch.device
    mesh_size: int = 0  # shards of a sharded entry (0 = unsharded)
    p2p_only: bool = False  # any member gather is an error (the ring plane)
    nxn_ok: bool = True  # an [N, N] intermediate is the design (dense), not a fault
    # (make, run): a cluster of the fixture, and the same scenario on it
    # as tick(1) calls
    tick_loop: tuple[Callable[[], Any], Callable[[Any], Any]] | None = None

    @property
    def steps(self) -> int:
        """What a host-sync count is divided by: ticks times replicas."""
        return self.ticks * self.replicas


class EntryUnavailable(RuntimeError):
    """The fixture cannot run in this environment (a sharded entry whose
    n does not divide into its shards, or one that needs several cards).
    The audit records an info finding and moves on."""


@dataclasses.dataclass(frozen=True)
class EntrySpec:
    name: str
    backends: tuple[str, ...]
    build: Callable[..., Built]
    doc: str


# ---------------------------------------------------------------------------
# fixtures and carries
# ---------------------------------------------------------------------------


def _dense_fixture(n: int, device: torch.device):
    from ringpop_tpu_torch.models import swim_sim as sim

    return sim.init_state(n, device=device), sim.make_net(n, device=device), \
        sim.SwimParams(loss=0.01)


# the delta fixture's caps: the reference's wire cap, and a claim grid
# that, like the default capacity, differs from the default n = 64, so
# that the census tells [N, C] and [N, K] planes from [N, N] ones
WIRE_CAP, CLAIM_GRID = 16, 48


def _delta_fixture(n: int, capacity: int, device: torch.device):
    from ringpop_tpu_torch.models import swim_delta as sd
    from ringpop_tpu_torch.models import swim_sim as sim

    params = sd.DeltaParams(swim=sim.SwimParams(loss=0.01), wire_cap=WIRE_CAP,
                            claim_grid=CLAIM_GRID)
    return sd.init_delta(n, capacity=capacity, device=device), sim.make_net(n, device=device), \
        params


def _fixture(backend: str, n: int, capacity: int, device: torch.device):
    if backend == "delta":
        return _delta_fixture(n, capacity, device)
    return _dense_fixture(n, device)


def _dims(backend: str, n: int, capacity: int, **more: int) -> dict[str, int]:
    dims = dict(N=n, **({"C": capacity, "K": CLAIM_GRID, "W": WIRE_CAP}
                        if backend == "delta" else {}))
    dims.update(more)
    return dims


def _min_elems(backend: str, n: int, capacity: int) -> int:
    return n * (capacity if backend == "delta" else n)


def state_fields(state: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """The tensor fields of a state NamedTuple (None fields left out)."""
    return {prefix + f: v for f, v in state._asdict().items() if torch.is_tensor(v)}


# the net planes a scenario carries from tick to tick (the link rules are
# the timeline's, not carried state)
_NET_CARRY = ("up", "responsive", "adj", "period", "ov_cnt", "ov_gray", "po_press", "po_shed",
              "po_quar", "po_sends_w", "po_deliv_w", "po_retry_cap", "pv_slot", "pv_tickv",
              "pv_wits", "pv_first", "pv_parent", "pv_knows")


def _net_carry(net: Any) -> dict[str, torch.Tensor]:
    return {f: getattr(net, f) for f in _NET_CARRY if torch.is_tensor(getattr(net, f))}


def _carry_state(out: Any) -> dict[str, torch.Tensor]:
    """(state, metrics) -> the state's fields."""
    return state_fields(out[0])


def _carry_scenario(out: Any) -> dict[str, torch.Tensor]:
    """(state, net, telemetry) -> the state's fields and the net planes."""
    return {**state_fields(out[0]), **_net_carry(out[1])}


def _carry_sweep(out: Any) -> dict[str, torch.Tensor]:
    """(states, nets, telemetry) -> replica 0's carry (every replica
    carries the same fields)."""
    return {**state_fields(out[0][0]), **_net_carry(out[1][0])}


def _no_carry(out: Any) -> dict[str, torch.Tensor]:
    return {}


def _box(state: Any):
    from ringpop_tpu_torch.models import swim_sim as sim

    return sim._Handoff(state)


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


def _build_run(backend: str, *, n: int, ticks: int, capacity: int,
               device: torch.device, **_ignored: Any) -> Built:
    """swim_run / delta_run: ``ticks`` periods on one key, the state
    handed from tick to tick."""
    from ringpop_tpu_torch import prng
    from ringpop_tpu_torch.models import swim_delta as sd
    from ringpop_tpu_torch.models import swim_sim as sim

    state, net, params = _fixture(backend, n, capacity, device)
    box = _box(state)
    del state
    key = prng.PRNGKey(0)
    if backend == "delta":
        name = "delta_run"

        def call():
            return sd.delta_run_impl(box.take(), net, key, params, ticks)
    else:
        name = "swim_run"

        def call():
            return sim._swim_run_handed(box, net, key, params, ticks)
    return Built(
        name=name, backend=backend, n=n, ticks=ticks, replicas=1, call=call, box=box,
        carry=_carry_state, key_roots={"protocol": [key]}, donates=True,
        census_min_elems=_min_elems(backend, n, capacity), dims=_dims(backend, n, capacity),
        device=device, nxn_ok=backend == "dense",
    )


def _spec(ticks: int, events: list[dict], **more: Any):
    from ringpop_tpu_torch.scenarios.spec import ScenarioSpec

    return ScenarioSpec.from_dict({"ticks": ticks, "events": events, **more})


def _kill_at(ticks: int) -> int:
    return min(max(ticks // 4, 1), ticks - 1)


def _plain_events(ticks: int) -> list[dict]:
    return [{"at": _kill_at(ticks), "op": "kill", "node": 0},
            {"at": min(max(ticks // 2, 1), ticks - 1), "op": "loss", "p": 0.05}]


def _overload_events(ticks: int) -> list[dict]:
    return [{"at": _kill_at(ticks), "op": "kill", "node": 0},
            {"at": 0, "op": "overload", "until": ticks, "capacity": 2, "threshold": 8,
             "recover": 2, "factor": 4}]


# The fixtures' protocol schedule is ``split(PRNGKey(0), T)`` and the
# workload's tick keys ``fold_in(PRNGKey(WORKLOAD_SEED), t)``; in the
# partitionable threefry mode ``fold_in(k, t) == split(k, T)[t]``, so on
# one seed the two streams would share their keys.
WORKLOAD_SEED = 1


def _traffic(n: int, kind: str, latency_buckets: int, device: torch.device):
    """The fixture's workload (``WORKLOAD_SEED``)."""
    from ringpop_tpu_torch.models import checksum as cksum
    from ringpop_tpu_torch.traffic.workloads import compile_traffic

    m = min(4 * n, 128)
    return compile_traffic({"kind": kind, "keys_per_tick": m, "pool": 4 * m,
                            "seed": WORKLOAD_SEED, "latency_buckets": latency_buckets},
                           n, cksum.default_addresses(n), device=device)


def _tick_loop(backend: str, n: int, capacity: int, spec: Any, device: torch.device):
    """The scenario through ``run_host_loop`` on a cluster of the
    fixture's size and seed, each ``tick(k)`` as k ``tick(1)`` calls:
    returns the cluster, whose ``tick`` the caller may wrap first."""
    from ringpop_tpu_torch.models import swim_sim as sim
    from ringpop_tpu_torch.models.cluster import SimCluster

    def make():
        return SimCluster(n, sim.SwimParams(loss=0.01), seed=0, device=device, backend=backend,
                          capacity=capacity, wire_cap=WIRE_CAP, claim_grid=CLAIM_GRID)

    def run(cluster):
        from ringpop_tpu_torch.scenarios.runner import run_host_loop

        real = cluster.tick

        def ticks(k: int = 1):
            out = None
            for _ in range(k):
                out = real(1)
            return out

        cluster.tick = ticks
        run_host_loop(cluster, spec)
        return cluster

    return make, run


def _build_scenario(backend: str, *, n: int, ticks: int, capacity: int, device: torch.device,
                    variant: str = "", **_ignored: Any) -> Built:
    """``runner.run_compiled``, the port's scenario program: the plain
    fault timeline (kill, loss step), or with ``variant`` its traffic
    (uniform workload, 8 SLO latency buckets), incident (zipf workload
    and the overload feedback loop), policy (``combined`` on the
    incident) or provenance (4 traced rumors, a tracked node) shape."""
    from ringpop_tpu_torch import prng
    from ringpop_tpu_torch.scenarios import compile as scompile
    from ringpop_tpu_torch.scenarios import runner

    state, net, params = _fixture(backend, n, capacity, device)
    base_loss = getattr(params, "swim", params).loss
    more: dict[str, Any] = {}
    events = _plain_events(ticks)
    traffic = policy = None
    dims: dict[str, int] = {}
    if variant == "traffic":
        traffic = _traffic(n, "uniform", 8, device)
    elif variant in ("incident", "policy"):
        events = _overload_events(ticks)
        traffic = _traffic(n, "zipf", 8, device)
        if variant == "policy":
            from ringpop_tpu_torch.policies import core as pol

            policy = pol.compile_policy("combined", n=n, m=traffic.static.m)
            dims["W"] = policy.config.amp_window
    elif variant == "provenance":
        events = [{"at": _kill_at(ticks), "op": "kill", "node": 0},
                  {"at": 0, "op": "track", "node": 1}]
        more["trace_rumors"] = 4
        dims["K"] = 4
    spec = _spec(ticks, events, **more)
    compiled = scompile.compile_spec(spec, n, base_loss=base_loss, device=device)
    keys = prng.split(prng.PRNGKey(0), ticks)
    roots = {"protocol": [keys]}
    if traffic is not None:
        roots["workload"] = [traffic.tensors.key]
        dims.update(M=traffic.static.m, B=traffic.static.latency_buckets)
    box = _box(state)
    del state

    def call():
        return runner.run_compiled(box, net, keys, compiled, params, traffic=traffic,
                                   policy=policy)

    return Built(
        name="run_scenario" + (f"+{variant}" if variant else ""), backend=backend, n=n,
        ticks=ticks, replicas=1, call=call, box=box, carry=_carry_scenario, key_roots=roots,
        donates=True, census_min_elems=_min_elems(backend, n, capacity),
        dims=_dims(backend, n, capacity, **dims), device=device, nxn_ok=backend == "dense",
        tick_loop=(_tick_loop(backend, n, capacity, spec, device) if not variant else None),
    )


def _build_sweep(backend: str, *, n: int, ticks: int, capacity: int, replicas: int,
                 device: torch.device, param_axes: bool = False, **_ignored: Any) -> Built:
    """``sweep.run_sweep_compiled``: R replicas of a kill timeline from
    one shared start, each from its own copy; with ``param_axes`` a
    ``suspicion_ticks`` axis (3, 5, ...) over the replicas."""
    from ringpop_tpu_torch import prng
    from ringpop_tpu_torch.scenarios import sweep as ssweep

    state, net, params = _fixture(backend, n, capacity, device)
    base_loss = getattr(params, "swim", params).loss
    spec = _spec(ticks, [{"at": _kill_at(ticks), "op": "kill", "node": 0}])
    cs = ssweep.compile_sweep(spec, n, replicas=replicas, base_loss=base_loss, device=device)
    keys = ssweep.sweep_key_schedule(list(prng.split(prng.PRNGKey(0), replicas)), cs)
    axes = {"suspicion_ticks": [3 + 2 * r for r in range(replicas)]} if param_axes else None
    box = _box(state)
    del state

    def call():
        return ssweep.run_sweep_compiled(box.take(), net, keys, cs, params, param_axes=axes)

    return Built(
        name="run_sweep+param_axes" if param_axes else "run_sweep", backend=backend, n=n,
        ticks=ticks, replicas=replicas, call=call, box=box, carry=_carry_sweep,
        key_roots={"protocol": [keys]}, donates=True,
        census_min_elems=_min_elems(backend, n, capacity),
        dims=_dims(backend, n, capacity, R=replicas), device=device, nxn_ok=backend == "dense",
    )


def _build_recv_merge(backend: str, *, n: int, device: torch.device, **_ignored: Any) -> Built:
    """Kernel 1, the receiver merge, called from the host
    (``ops.recv_merge.recv_merge_pallas``): random receivers, every
    ping delivered, random claim rows."""
    from ringpop_tpu_torch.ops.recv_merge import recv_merge_pallas

    rng = np.random.default_rng(0)
    t_safe = torch.from_numpy(rng.integers(0, n, n)).to(device)
    fwd_ok = torch.ones(n, dtype=torch.bool, device=device)
    claims = torch.from_numpy(rng.integers(0, 1 << 20, (n, n), dtype=np.int32)).to(device)
    return Built(
        name="recv_merge_pallas", backend=backend, n=n, ticks=1, replicas=1,
        call=lambda: recv_merge_pallas(t_safe, fwd_ok, claims), box=None, carry=_no_carry,
        key_roots={}, donates=False, census_min_elems=n * n, dims=dict(N=n), device=device,
    )


def _build_delta_merge(backend: str, *, n: int, capacity: int, device: torch.device,
                       **_ignored: Any) -> Built:
    """Kernel 4, the delta insert-merge (``ops.delta_merge.merge_insert``)
    at the reference's audit shape: [N, C] tables, 17 inserts a row
    (``claim_grid`` 16 plus the self column), each row holding C/2 live
    slots and 8 inserts that fit."""
    from ringpop_tpu_torch.ops.delta_merge import SENTINEL, merge_insert

    ki, live = 17, capacity // 2
    rng = np.random.default_rng(0)
    subj = np.full((n, capacity), SENTINEL, np.int32)
    ins = np.full((n, ki), SENTINEL, np.int32)
    for i in range(n):
        pick = np.sort(rng.choice(n, min(live + 8, n), replace=False).astype(np.int32))
        subj[i, :min(live, n)] = pick[:min(live, n)]
        ins[i, :len(pick) - min(live, n)] = pick[min(live, n):]
    for i in range(n):
        subj[i] = np.sort(subj[i])
        ins[i] = np.sort(ins[i])

    def on(a):
        return torch.from_numpy(a).to(device)

    d_subj, ins_subj = on(subj), on(ins)
    d_key = on(np.where(subj < SENTINEL, 8 * 7 + 1, 0).astype(np.int32))
    d_pb = on(np.where(subj < SENTINEL, 1, -1).astype(np.int8))
    d_sl = on(np.full((n, capacity), -1, np.int8))
    ins_key = on(np.where(ins < SENTINEL, 8 * 9 + 2, 0).astype(np.int32))
    return Built(
        name="delta_merge_pallas", backend=backend, n=n, ticks=1, replicas=1,
        call=lambda: merge_insert(d_subj, d_key, d_pb, d_sl, ins_subj, ins_key, sl_start=10,
                                  suspect=2),
        box=None, carry=_no_carry, key_roots={}, donates=False,
        census_min_elems=n * capacity, dims=dict(N=n, C=capacity), device=device,
        nxn_ok=False,
    )


def _build_sharded(backend: str, *, n: int, capacity: int, device: torch.device,
                   mesh: int = 2, gossip: str = "ring", **_ignored: Any) -> Built:
    """One step of the row-sharded dense or delta step over ``mesh``
    shards on the one device (``parallel.mesh``): under the ring plane
    every cross-shard transfer is a hop (kernel 5) and a member gather is
    an error; ``gossip="gather"`` is the single-device lowering the
    ``+gather`` entry keeps measurable, with its member gathers pinned."""
    from ringpop_tpu_torch import prng
    from ringpop_tpu_torch.parallel import mesh as pmesh

    if n % mesh:
        raise EntryUnavailable(f"a {mesh}-shard step needs n divisible by {mesh} (n = {n})")
    m = pmesh.make_mesh(devices=[device] * mesh)
    state, net, params = _fixture(backend, n, capacity, device)
    box = _box(state)
    del state
    key = prng.PRNGKey(0)
    if backend == "delta":
        step = pmesh.sharded_delta_step(m, gossip=gossip)
        name = "sharded_delta_step"
    else:
        step = pmesh.sharded_step(m, gossip=gossip)
        name = ("sharded_step+gather" if gossip == "gather"
                else "sharded_step" if mesh == 2 else f"sharded_step@{mesh}")
    return Built(
        name=name, backend=backend, n=n, ticks=1, replicas=1,
        call=lambda: step(box.take(), net, key, params), box=box, carry=_carry_state,
        key_roots={"protocol": [key]}, donates=True,
        census_min_elems=_min_elems(backend, n, capacity), dims=_dims(backend, n, capacity),
        device=device, mesh_size=mesh, p2p_only=gossip == "ring", nxn_ok=backend == "dense",
    )


def _build_sharded_sweep(backend: str, **_ignored: Any) -> Built:
    raise EntryUnavailable(
        "run_sweep(shard=True) splits the replica axis over several cards, which is not "
        "ported (ROADMAP.md queue 1 item 11, 'Sharding across cards'); on one card it is the "
        "reference's accepted no-op")


def _variant(variant: str) -> Callable[..., Built]:
    return lambda backend, **kw: _build_scenario(backend, variant=variant, **kw)


ENTRY_POINTS: dict[str, EntrySpec] = {
    "swim_run": EntrySpec(
        "swim_run", ("dense",), _build_run,
        "the dense multi-tick run (models/swim_sim.py, the state handed on)"),
    "delta_run": EntrySpec(
        "delta_run", ("delta",), _build_run,
        "the delta multi-tick run (models/swim_delta.py)"),
    "run_scenario": EntrySpec(
        "run_scenario", ("dense", "delta"), _variant(""),
        "the compiled fault timeline (scenarios/runner.py run_compiled)"),
    "run_scenario+traffic": EntrySpec(
        "run_scenario+traffic", ("dense", "delta"), _variant("traffic"),
        "the scenario serving a key workload with the SLO latency plane "
        "(traffic/engine.py + traffic/latency.py)"),
    "run_scenario+incident": EntrySpec(
        "run_scenario+incident", ("dense", "delta"), _variant("incident"),
        "the scenario in its incident shape: traffic + SLO latency + the "
        "overload feedback carry (scenarios/library.py cascading_overload)"),
    "run_scenario+policy": EntrySpec(
        "run_scenario+policy", ("dense", "delta"), _variant("policy"),
        "the incident shape plus the remediation policy carry (policies/)"),
    "run_scenario+provenance": EntrySpec(
        "run_scenario+provenance", ("dense", "delta"), _variant("provenance"),
        "the scenario with the gossip provenance plane armed (obs/provenance.py)"),
    "run_sweep": EntrySpec(
        "run_sweep", ("dense", "delta"), _build_sweep,
        "the R-replica sweep (scenarios/sweep.py run_sweep_compiled)"),
    "run_sweep+param_axes": EntrySpec(
        "run_sweep+param_axes", ("dense", "delta"),
        lambda backend, **kw: _build_sweep(backend, param_axes=True, **kw),
        "run_sweep with a suspicion_ticks axis over the replicas (swim_sim.SwimKnobs)"),
    "recv_merge_pallas": EntrySpec(
        "recv_merge_pallas", ("dense",), _build_recv_merge,
        "kernel 1, the receiver merge, from the host (ops/recv_merge.py, csrc/recv_merge.cu)"),
    "delta_merge_pallas": EntrySpec(
        "delta_merge_pallas", ("delta",), _build_delta_merge,
        "kernel 4, the delta insert-merge (ops/delta_merge.py, csrc/delta_merge.cu)"),
    "sharded_step": EntrySpec(
        "sharded_step", ("dense",),
        lambda backend, **kw: _build_sharded(backend, **{"mesh": 2, **kw}),
        "the row-sharded dense step over 2 shards on one device, ring plane "
        "(parallel/mesh.py; every cross-shard transfer a hop, csrc/ring_hop.cu)"),
    "sharded_step@4": EntrySpec(
        "sharded_step@4", ("dense",),
        lambda backend, **kw: _build_sharded(backend, **{"mesh": 4, **kw}),
        "the row-sharded dense step over 4 shards on one device"),
    "sharded_step+gather": EntrySpec(
        "sharded_step+gather", ("dense",),
        lambda backend, **kw: _build_sharded(backend, gossip="gather", **{"mesh": 2, **kw}),
        "the sharded dense step in its gather lowering (no hops; its member "
        "gathers pinned as its measured cost, not outlawed)"),
    "sharded_delta_step": EntrySpec(
        "sharded_delta_step", ("delta",),
        lambda backend, **kw: _build_sharded(backend, **{"mesh": 2, **kw}),
        "the row-sharded delta step over 2 shards on one device, ring plane"),
    "run_sweep+shard": EntrySpec(
        "run_sweep+shard", ("dense", "delta"), _build_sharded_sweep,
        "run_sweep(shard=True): the replica axis over several cards (not ported)"),
}


def build_entry(name: str, backend: str, *, n: int = 64, ticks: int = 4, capacity: int = 32,
                replicas: int = 2, device: torch.device | str | None = None,
                **extra: Any) -> Built:
    """Materialize one (entry, backend) fixture at the given shape on
    ``device`` (``cuda`` unless named)."""
    spec = ENTRY_POINTS[name]
    if backend not in spec.backends:
        raise ValueError(f"{name} has no {backend} backend (has {spec.backends})")
    if ticks < 2:
        raise ValueError("the fixtures need ticks >= 2 (a kill after the first tick)")
    return spec.build(backend, n=n, ticks=ticks, capacity=capacity, replicas=replicas,
                      device=resolve_device(device), **extra)


def iter_entries(names=None, backends=None):
    """Yield every requested (entry name, backend) pair."""
    for name, spec in ENTRY_POINTS.items():
        if names is not None and name not in names:
            continue
        for backend in spec.backends:
            if backends is not None and backend not in backends:
                continue
            yield name, backend
