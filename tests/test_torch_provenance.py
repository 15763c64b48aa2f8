"""The port's gossip provenance plane on the dense backend against the JAX
reference.

``SimCluster.run_scenario`` with ``trace_rumors`` runs on both sides (the
reference's in a child process): ``tests/test_provenance.py``'s
scenario (N = 10, ``LEAN``, K = 3, a reserved slot that never fires and
a kill whose rumor auto-arms, seed 11), and a chaos run (N = 16, K = 4:
a reserved slot that fires and one that never does, a kill, 5% loss so
that rumors are refuted, and a delay rule so that nodes hear a rumor
with no in-tick edge to explain it).  After each run every ``pv_*``
plane on the net, the ``pv_heard`` plane and every series of the trace,
the state and the key must be equal; so must ``provenance_report()``,
``summary_block``, the ``write_spans`` file (byte for byte) and the stat
calls of a ``CaptureEmitter`` sink, the replay of the run and of a
``tick`` after it included.  The refusals raise the reference's
exception, type and message, with the reference's key after them: the
sparse step, the planes a finished run left (``clear_provenance``), a
slot count that does not match, and the spec validation of
``tests/test_provenance.py``.

The port is also held against itself: its per-tick host walk
(``swim_step(prov=True)`` folded through ``prov_update``) equals its
``run_scenario``, and a traced run's protocol trajectory equals the
untraced run's.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import pytest
import torch

from test_torch_harness import (
    assert_same_provenance,
    assert_same_scenario,
    assert_same_stats,
    run_port,
    run_reference,
)

from ringpop_tpu_torch.models import swim_sim as tsim
from ringpop_tpu_torch.models.cluster import SimCluster
from ringpop_tpu_torch.models.swim_sim import SwimParams
from ringpop_tpu_torch.obs import provenance as pvn
from ringpop_tpu_torch.scenarios import compile as scompile
from ringpop_tpu_torch.scenarios.spec import ScenarioSpec

N = 10
LEAN = {"suspicion_ticks": 8, "ping_req_size": 1}
K = 3
# tests/test_provenance.py:46
PV_SPEC = {
    "ticks": 18,
    "trace_rumors": K,
    "events": [
        {"at": 0, "op": "track", "node": 1},
        {"at": 3, "op": "kill", "node": 9},
    ],
}
# slot 0 reserved for the killed node (it fires), slot 1 for a node that
# stays healthy (it never does), two free slots; the loss gets rumors
# refuted, the delay rule delivers claims with no in-tick edge
CHAOS = {
    "ticks": 30,
    "trace_rumors": 4,
    "events": [
        {"at": 0, "op": "track", "node": 13},
        {"at": 2, "op": "track", "node": 2},
        {"at": 0, "op": "loss", "p": 0.05},
        {"at": 1, "op": "delay", "src": [0, 1, 2, 3, 4, 5], "dst": [6, 7, 8, 9, 10, 11],
         "delay": 1, "jitter": 1, "until": 24},
        {"at": 5, "op": "kill", "node": 13},
    ],
}
QUIET = {"ticks": 6, "trace_rumors": 2, "events": []}
BAD_SPECS = [
    {**PV_SPEC, "trace_rumors": -1},
    {**PV_SPEC, "trace_rumors": pvn.MAX_RUMORS + 1},
    {**PV_SPEC, "ticks": pvn.MAX_TICKS + 1},
    {"ticks": 8, "events": [{"at": 0, "op": "track", "node": 1}]},
    {**PV_SPEC, "events": [{"at": 0, "op": "track", "node": N}]},
    {**PV_SPEC, "events": [{"at": 0, "op": "track", "node": 1},
                           {"at": 2, "op": "track", "node": 1}]},
    {**PV_SPEC, "trace_rumors": 1, "events": [{"at": 0, "op": "track", "node": 1},
                                              {"at": 0, "op": "track", "node": 2}]},
]

CASES = [
    {"name": "traced", "n": N, "params": LEAN, "seed": 11, "stats": True, "ops": [
        ["run_scenario", PV_SPEC],
        ["provenance"],
        ["stats"],
        ["try", "run_scenario", PV_SPEC],
        ["tick", 1],
        ["stats"],
        ["clear_provenance"],
        ["try", "provenance_report"],
    ]},
    {"name": "chaos", "n": 16, "params": {"suspicion_ticks": 4}, "seed": 5, "stats": True,
     "ops": [["run_scenario", CHAOS], ["provenance"], ["stats"]]},
    {"name": "refusals", "n": N, "params": LEAN, "seed": 3, "ops": [
        ["run_scenario", QUIET],
        ["try", "run_scenario", {**QUIET, "trace_rumors": 3}],
        *[["try", "run_scenario", bad] for bad in BAD_SPECS],
    ]},
    {"name": "sparse", "n": N, "params": {**LEAN, "sparse_cap": 4}, "seed": 2,
     "ops": [["try", "run_scenario", PV_SPEC]]},
]
BY_NAME = {c["name"]: c for c in CASES}


def _ops(kind: str) -> list[tuple[str, int]]:
    return [(c["name"], i) for c in CASES for i, op in enumerate(c["ops"]) if op[0] == kind]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("provenance_ref")))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("provenance_port"))
    out = {}
    for c in CASES:
        tries: dict[int, str] = {}
        scen: dict[int, dict] = {}
        run_port(c, tries=tries, scenarios=scen, tmp_dir=tmp)
        out[c["name"]] = (tries, scen)
    return out


@pytest.mark.parametrize("name,i", _ops("run_scenario"))
def test_traced_run_matches_reference(reference, port_runs, name, i):
    """Every pv_* plane, pv_heard, every series, the state, the net, the
    key, the loss and the log entry equal."""
    assert_same_scenario(reference, BY_NAME[name], i, port_runs[name][1][i])


@pytest.mark.parametrize("name,i", _ops("provenance"))
def test_report_summary_and_spans_match_reference(reference, port_runs, name, i):
    """``provenance_report()``, ``summary_block``, ``emit_provenance`` and
    the spans file equal the reference's."""
    assert_same_provenance(reference, BY_NAME[name], i, port_runs[name][1][i])


@pytest.mark.parametrize("name,i", _ops("stats"))
def test_stats_sink_matches_reference(reference, port_runs, name, i):
    """The stat calls of the run's replay (and of a tick after it) equal
    the reference's, in order."""
    assert_same_stats(reference, BY_NAME[name], i, port_runs[name][1][i])


@pytest.mark.parametrize("name,i", _ops("try"))
def test_refusals_match_reference(reference, port_runs, name, i):
    """The same exception type and message, and the reference's key after
    it."""
    tries, scen = port_runs[name]
    want = str(reference[f"{name}/try{i}"])
    assert want and tries[i] == want
    np.testing.assert_array_equal(scen[i]["key"], reference[f"{name}/key_after_try{i}"])


def test_chaos_run_arms_refutes_and_leaves_unattributed(port_runs):
    """The chaos scenario exercises what it is for: the reserved slot of
    the killed node fires and confirms, the other reserved slot never
    arms, and delayed claims leave nodes heard with no in-tick edge."""
    rep = port_runs["chaos"][1][1]["report"]
    by_slot = {r["slot"]: r for r in rep["rumors"]}
    assert by_slot[0]["subject"] == 13 and by_slot[0]["resolution"] == pvn.RES_CONFIRMED
    assert 1 not in by_slot
    assert sum(r["unattributed"] for r in rep["rumors"]) > 0
    assert any(r["resolution"] == pvn.RES_REFUTED for r in rep["rumors"])


# -- the port against itself ---------------------------------------------------


def _host_walk(spec: dict, seed: int) -> tuple[SimCluster, pvn.ProvCarry, np.ndarray]:
    """``tests/test_provenance.py``'s host oracle on the port: the step
    per tick with the run's key schedule and ``prov=True``, each evidence
    bundle folded through ``prov_update``."""
    spec_obj = ScenarioSpec.from_dict(spec)
    c = SimCluster(N, SwimParams(**LEAN), seed=seed, device="cpu")
    compiled = scompile.compile_spec(spec_obj, c.n, base_loss=c.params.loss, device="cpu")
    keys = scompile.key_schedule(c._split, compiled)
    pvc = pvn.init_carry(c.n, spec_obj.trace_rumors, LEAN["ping_req_size"], device="cpu")
    pv_at, pv_node = pvn.track_tensors(compiled.tracks, spec_obj.trace_rumors)
    by_tick = defaultdict(list)
    for at, op, arg in scompile.expand_events(spec_obj, c.params.loss):
        by_tick[at].append((op, arg))
    heards = []
    for t in range(spec_obj.ticks):
        for op, arg in sorted(by_tick.get(t, ()), key=lambda x: scompile._OP_RANK[x[0]]):
            if op == "kill":
                c.kill(arg)
        c.state, m = tsim.swim_step_impl(c.state, c.net, keys[t], c.params, prov=True)
        ev = {name: m[name] for name in pvn.EVIDENCE_KEYS}
        pvc, heard = pvn.prov_update(
            pvc, ev, t, lambda q: torch.gather(c.state.view_key, 1, q.long()),
            pv_at, pv_node, c.n)
        heards.append(heard.numpy())
    return c, pvc, np.stack(heards)


def test_host_walk_matches_run_scenario():
    """The port's per-tick walk equals its ``run_scenario``: the carry,
    the heard rows, the state and the checksums."""
    a = SimCluster(N, SwimParams(**LEAN), seed=11, device="cpu")
    trace = a.run_scenario(PV_SPEC)
    b, pvc, heards = _host_walk(PV_SPEC, 11)
    np.testing.assert_array_equal(trace.planes["pv_heard"], heards)
    for f in pvn.ProvCarry._fields:
        assert torch.equal(getattr(a.net, f"pv_{f}"), getattr(pvc, f)), f
    for f, x in a.state._asdict().items():
        assert (x is None) == (getattr(b.state, f) is None), f
        if x is not None:
            assert torch.equal(x, getattr(b.state, f)), f
    assert a.checksums() == b.checksums()


def test_untraced_run_is_the_same_trajectory():
    """The plane only observes: the untraced run from the same seed has
    the traced run's series, state, key and checksums, and leaves no
    planes on the net."""
    a = SimCluster(N, SwimParams(**LEAN), seed=11, device="cpu")
    ta = a.run_scenario(PV_SPEC)
    off = {"ticks": PV_SPEC["ticks"],
           "events": [e for e in PV_SPEC["events"] if e["op"] != "track"]}
    b = SimCluster(N, SwimParams(**LEAN), seed=11, device="cpu")
    tb = b.run_scenario(off)
    assert "pv_heard" in ta.planes and "pv_heard" not in tb.planes
    assert set(ta.metrics) == set(tb.metrics)
    for k in tb.metrics:
        np.testing.assert_array_equal(ta.metrics[k], tb.metrics[k], err_msg=k)
    for f, x in a.state._asdict().items():
        if x is not None:
            assert torch.equal(x, getattr(b.state, f)), f
    assert torch.equal(a.key, b.key)
    assert a.checksums() == b.checksums()
    assert b.net.pv_slot is None
    with pytest.raises(ValueError, match="no provenance state"):
        b.provenance_report()
