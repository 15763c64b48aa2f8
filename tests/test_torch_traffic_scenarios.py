"""Served fault families against the JAX reference, dense backend, and
the sharded serve.

``benchmarks/bench_faults.py --traffic``'s scorecard: the gray and the
delay families at n = 48 with its zipf workload (256 keys a tick, a
2 048-key pool, 16 latency buckets), streamed in quarter-horizon
segments, with the horizon cut from 80 ticks to 30 (both windows and
the kill stay inside it).  Each side's trace, state, net, key and log
must be equal, and the scorecard numbers computed from them too.  The
delta backend's runs are in ``test_torch_traffic_scenarios_delta.py``.

``parallel.sharded_serve`` at n = 16 over D = 4 shards (on the CPU: the
hop's plain version) equals ``serve_once`` on the same rows, with and
without the latency plane.
"""

from __future__ import annotations

import pytest
import torch

from test_torch_harness import assert_same_scenario, one_thread, run_port, run_reference

from ringpop_tpu_torch import parallel
from ringpop_tpu_torch.models.cluster import SimCluster
from ringpop_tpu_torch.models.swim_sim import SwimParams
from ringpop_tpu_torch.traffic import engine as tengine
from ringpop_tpu_torch.traffic import latency as tlat

N = 48
TICKS = 30
SEED = 7
WL = {"kind": "zipf", "keys_per_tick": 256, "pool": 8 * 256, "latency_buckets": 16}
QUARTER = list(range(N // 4))
HALF = list(range(N // 2, N))
FAMILIES = {
    "gray": {"ticks": TICKS, "events": [
        {"at": 8, "op": "gray", "nodes": QUARTER, "factor": 6, "until": int(TICKS * 0.7)},
        {"at": 12, "op": "kill", "node": N - 1}]},
    "delay": {"ticks": TICKS, "events": [
        {"at": 8, "op": "delay", "src": QUARTER, "dst": HALF, "delay": 2, "jitter": 3,
         "until": int(TICKS * 0.7)},
        {"at": 12, "op": "kill", "node": N - 1}]},
}
STREAM = {"traffic": WL, "segment_ticks": max(TICKS // 4, 1)}


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """The port's runs of this module on one intra-op thread."""


def family_cases(backend: str) -> list[dict]:
    kw = {} if backend == "dense" else {"backend": "delta", "caps": {"capacity": min(2 * N, 1024)}}
    return [{"name": f"{fam}_{backend}", "n": N, "params": {"suspicion_ticks": 12},
             "seed": SEED, **kw, "ops": [["run_streamed", spec, STREAM]]}
            for fam, spec in FAMILIES.items()]


def scorecard(trace: dict) -> dict:
    """bench_faults' row from a recorded trace's arrays."""
    m = {k[2:]: v for k, v in trace.items() if k.startswith("m.")}
    lookups, delivered = int(m["lookups"].sum()), int(m["delivered"].sum())
    agg = tlat.hist_stats(trace["p.lat_hist_ms"].sum(axis=0))
    return {"goodput": delivered / max(lookups, 1),
            "lat_ms": [agg[k] for k in ("median", "p95", "p99")],
            "amplification": tengine.total_sends(m) / max(delivered, 1),
            "gray_timeouts": int(m["gray_timeouts"].sum())}


CASES = family_cases("dense")
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("families_ref")))


@pytest.mark.parametrize("name", sorted(BY_NAME))
def test_family_scorecard_equals_reference(reference, tmp_path, name):
    tries, scen = {}, {}
    run_port(BY_NAME[name], tries=tries, scenarios=scen, tmp_dir=str(tmp_path))
    assert_same_scenario(reference, BY_NAME[name], 0, scen[0])
    row = scorecard(scen[0]["trace"])
    assert 0 < row["goodput"] <= 1 and row["amplification"] >= 1
    if name.startswith("gray"):
        assert row["gray_timeouts"] > 0


@pytest.mark.parametrize("buckets", [0, 16])
def test_sharded_serve_equals_serve_once(buckets):
    """D = 4 shards of a 16-node cluster after a kill: every counter of
    the ring-fetched serve equals the unsharded one, at several ticks."""
    c = SimCluster(16, SwimParams(suspicion_ticks=4), seed=5, device="cpu")
    c.tick(2)
    c.kill(3)
    c.suspend(9)
    c.tick(2)
    ct = c.compile_traffic({"kind": "zipf", "keys_per_tick": 64, "pool": 256,
                            "latency_buckets": buckets, "lookup_n": 2})
    mesh = parallel.make_mesh(devices=[torch.device("cpu")] * 4)
    serve = parallel.sharded_serve(mesh, static=ct.static)
    gather = parallel.sharded_serve(mesh, static=ct.static, gossip="gather")
    for t in (0, 1, 5):
        want = tengine.serve_once(c.state.view_key, c.net.up, c.net.responsive, ct.tensors, t,
                                  static=ct.static)
        for fn in (serve, gather):
            got = fn(c.state.view_key, c.net.up, c.net.responsive, ct.tensors, t)
            assert set(got) == set(want)
            for k in want:
                assert torch.equal(got[k], want[k]), (t, k)
        assert int(want["lookups"]) > 0
    with pytest.raises(ValueError, match="divisible"):
        parallel.sharded_serve(parallel.make_mesh(devices=[torch.device("cpu")] * 3),
                               static=ct.static)(c.state.view_key, c.net.up, c.net.responsive,
                                                 ct.tensors, 0)
