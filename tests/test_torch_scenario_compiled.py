"""The port's compiled scenario runner on the dense backend against the
JAX reference.

``SimCluster.run_scenario`` runs on both sides (the reference's in a
child process): the acceptance scenario of ``tests/test_scenario.py``
(kill, partition, heal, a loss step and a ramp; N = 12, seed 3), its
revive-in-scan and suspend/resume scenarios, and the static refusals,
each with the reference's exception type and message and the key left
as it was.  After each run the trace (every series, its dtype and its
meta), the state, the net, the key, the loss and the ``metrics_log``
entry must be equal.  The port's ``run_scenario`` is also held against
its own ``run_host_loop`` (``compile_spec`` and ``key_schedule`` are in
``test_torch_scenario_faults.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_faults import MIXED
from test_torch_harness import assert_same_scenario, run_port, run_reference

from ringpop_tpu_torch.models.cluster import SimCluster
from ringpop_tpu_torch.models.swim_sim import SwimParams
from ringpop_tpu_torch.scenarios import runner as trunner
from ringpop_tpu_torch.scenarios.spec import ScenarioSpec

N = 12
FAST = {"suspicion_ticks": 8}
# tests/test_scenario.py:36, the acceptance scenario
SPEC = {"ticks": 40, "events": [
    {"at": 5, "op": "kill", "node": 3},
    {"at": 10, "op": "partition", "groups": [list(range(6)), list(range(6, 12))]},
    {"at": 10, "op": "loss", "p": 0.08},
    {"at": 20, "op": "heal"},
    {"at": 25, "op": "loss_ramp", "until": 30, "to": 0.0},
]}
# tests/test_scenario.py:431 and :454
REVIVE = {"ticks": 30, "events": [{"at": 2, "op": "kill", "node": 5},
                                  {"at": 15, "op": "revive", "node": 5}]}
SUSPEND = {"ticks": 6, "events": [{"at": 1, "op": "suspend", "node": 2},
                                  {"at": 4, "op": "resume", "node": 2}]}
PLAIN = {"ticks": 4, "events": [{"at": 1, "op": "kill", "node": 5}]}
GRAY6 = {"ticks": 6, "events": [{"at": 1, "op": "gray", "node": 0, "factor": 3}]}
DELAY6 = {"ticks": 6, "events": [{"at": 1, "op": "delay", "src": [0], "dst": [1], "delay": 2}]}
OVERLOAD6 = {"ticks": 6, "events": [{"at": 1, "op": "overload", "capacity": 4, "threshold": 9,
                                     "factor": 3}]}
SRC = np.eye(6, dtype=bool)[:1].tolist()

CASES = [
    # the run, two ticks on the net it leaves, and a second run from there
    {"name": "spec", "n": N, "params": FAST, "seed": 3,
     "ops": [["run_scenario", SPEC], ["tick", 2], ["run_scenario", SUSPEND]]},
    {"name": "revive", "n": 10, "params": FAST, "seed": 7, "ops": [["run_scenario", REVIVE]]},
    {"name": "suspend", "n": 6, "params": FAST, "seed": 2, "ops": [["run_scenario", SUSPEND]]},
    # tests/test_scenario.py:368 and tests/test_faults.py:337, :309
    {"name": "refusals", "n": 6, "params": {"suspicion_ticks": 5}, "seed": 1,
     "ops": [
         ["run_scenario", PLAIN],
         ["partition", [[0, 1], [2, 3]]],
         ["try", "run_scenario", {"ticks": 4, "events": []}],
         ["heal_partition"],
         ["run_scenario", PLAIN],
         ["set_link_rules", SRC, SRC, [0.5]],
         ["try", "run_scenario", PLAIN],
         ["set_link_rules", SRC, SRC, [0.0]],
         ["run_scenario", PLAIN],
         ["clear_link_rules"],
         ["set_period", [1, 1, 4, 1, 1, 1]],
         ["try", "run_scenario", GRAY6],
         ["run_scenario", PLAIN],
         ["set_period", [1] * 6],
         ["run_scenario", GRAY6],
         ["enable_delay", 4],
         ["try", "run_scenario", DELAY6],
         ["try", "run_scenario", OVERLOAD6],
     ]},
    {"name": "phase_mod", "n": 6, "params": {"suspicion_ticks": 5, "phase_mod": 2}, "seed": 1,
     "ops": [["run_scenario", PLAIN], ["try", "run_scenario", GRAY6]]},
    {"name": "sparse_delay", "n": 6, "params": {"suspicion_ticks": 5, "sparse_cap": 4}, "seed": 1,
     "ops": [["run_scenario", PLAIN], ["try", "run_scenario", DELAY6]]},
]
BY_NAME = {c["name"]: c for c in CASES}
SCENARIO_OPS = [(c["name"], i) for c in CASES for i, op in enumerate(c["ops"])
                if op[0] == "run_scenario"]
TRY_OPS = [(c["name"], i) for c in CASES for i, op in enumerate(c["ops"]) if op[0] == "try"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("scenario_compiled_ref")))


@pytest.fixture(scope="module")
def port_runs():
    out = {}
    for c in CASES:
        tries: dict[int, str] = {}
        scen: dict[int, dict] = {}
        out[c["name"]] = (run_port(c, tries=tries, scenarios=scen), tries, scen)
    return out


@pytest.mark.parametrize("name,i", SCENARIO_OPS)
def test_run_scenario_matches_reference(reference, port_runs, name, i):
    """Trace, state, net, key, loss and log entry equal after the run."""
    assert_same_scenario(reference, BY_NAME[name], i, port_runs[name][2][i])


@pytest.mark.parametrize("name,i", TRY_OPS)
def test_refusals_match_reference(reference, port_runs, name, i):
    """The same exception type and message, and no key drawn: the key
    after the refusal is the key the run before it left."""
    _, tries, scen = port_runs[name]
    want = str(reference[f"{name}/try{i}"])
    assert want and tries[i] == want
    np.testing.assert_array_equal(scen[i]["key"], reference[f"{name}/key_after_try{i}"])
    before = max(j for j in scen if j < i)
    np.testing.assert_array_equal(scen[i]["key"], scen[before]["key"])


def test_follow_on_ticks_match_reference(reference, port_runs):
    """``tick()`` on the net a run leaves (group-id adjacency, the loss
    mirrored from the schedule) continues the reference's trajectory."""
    recs = port_runs["spec"][0]
    assert len(recs) == 1
    for f in ("view_key", "pb", "suspect_left", "tick"):
        np.testing.assert_array_equal(recs[0][f], reference[f"spec/{f}"][1], err_msg=f)
    want = {k.rsplit("/", 1)[1]: int(v) for k, v in reference.items() if k.startswith("spec/m0/")}
    assert {k: v for k, v in recs[0]["metrics"].items() if k != "ticks"} == {
        k: v for k, v in want.items() if k != "ticks"}


def test_revive_in_scan_outcome(port_runs):
    """The revived node is back and every live view agrees (the
    reference's test_revive_in_scan_matches_host)."""
    rec = port_runs["revive"][2][0]
    live = rec["trace"]["live"]
    assert live[2] == 9 and live[-1] == 10
    assert rec["trace"]["converged"][-1]


# -- the port against its own host loop -----------------------------------------

HOST_LOOP = [("dense", SPEC, {}), ("dense", REVIVE, {}), ("dense", MIXED, {}),
             ("delta", SPEC, {"capacity": N, "wire_cap": N, "claim_grid": 3 * N * N})]


@pytest.mark.parametrize("backend,spec,caps", HOST_LOOP, ids=["spec", "revive", "mixed", "delta"])
def test_run_scenario_matches_own_host_loop(backend, spec, caps):
    """From one seed, ``run_scenario`` and ``run_host_loop`` reach the same
    state, key, loss and checksums; the net's up and responsive bits and
    period row agree."""
    n = 10 if spec in (REVIVE, MIXED) else N
    a = SimCluster(n, SwimParams(**FAST), seed=7, device="cpu", backend=backend, **caps)
    trace = a.run_scenario(spec)
    b = SimCluster(n, SwimParams(**FAST), seed=7, device="cpu", backend=backend, **caps)
    trunner.run_host_loop(b, ScenarioSpec.from_dict(spec))
    for f, x in a.state._asdict().items():
        y = getattr(b.state, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x, y), f
    for f in ("up", "responsive"):
        assert torch.equal(getattr(a.net, f), getattr(b.net, f)), f
    if b.net.period is not None:
        assert a.net.period.tolist() == b.net.period.tolist()
    assert torch.equal(a.key, b.key)
    assert a.params.loss == np.float32(b.params.loss)
    assert a.checksums() == b.checksums()
    assert trace.ticks == spec["ticks"] and a.traces == [trace]
    assert a.metrics_log[-1]["ticks"] == spec["ticks"]


def test_single_call_counts_and_logs():
    """One compiled call per run; the trace carries every tick
    (tests/test_scenario.py's single-dispatch smoke)."""
    before = trunner.dispatch_count()
    c = SimCluster(6, SwimParams(suspicion_ticks=5), seed=1, device="cpu")
    trace = c.run_scenario(PLAIN)
    assert trunner.dispatch_count() - before == 1
    assert trace.live.tolist() == [6, 5, 5, 5]
    assert all(arr.shape == (4,) for arr in trace.metrics.values())
    assert c.metrics_log[-1]["ticks"] == 4
    assert c.traces == [trace]


def test_unported_planes_refused_before_the_key():
    """Tracked rumors on the sparse step and over the planes a finished
    traced run left, a bad workload, a policy without one, the streaming
    options without ``segment_ticks`` and knobs the plane cannot take
    raise the reference's errors; none draws a key."""
    track = {"ticks": 4, "trace_rumors": 1, "events": [{"at": 1, "op": "kill", "node": 2}]}
    sparse = SimCluster(6, SwimParams(suspicion_ticks=5, sparse_cap=4), seed=1, device="cpu")
    before = sparse.key.clone()
    for seg in (None, 2):
        with pytest.raises(NotImplementedError, match="dense delivery evidence"):
            sparse.run_scenario(track, segment_ticks=seg)
        assert torch.equal(sparse.key, before)
    c = SimCluster(6, SwimParams(suspicion_ticks=5), seed=1, device="cpu")
    c.run_scenario({**track, "ticks": 12})
    assert c.provenance_report()["rumors"]
    before = c.key.clone()
    for seg in (None, 2):
        with pytest.raises(ValueError, match="clear_provenance"):
            c.run_scenario(track, segment_ticks=seg)
        assert torch.equal(c.key, before)
    c.clear_provenance()
    for kwargs, exc, match in (
        ({"traffic": {"keys": 8}}, TypeError, "keys"),
        ({"traffic": {"kind": "bogus"}}, ValueError, "unknown workload kind"),
        ({"policy": "admission"}, ValueError, "policies meter"),
        ({"traffic": {"kind": "zipf"}, "policy": "nope"}, ValueError, "unknown policy"),
    ):
        for seg in (None, 2):
            with pytest.raises(exc, match=match):
                c.run_scenario(PLAIN, segment_ticks=seg, **kwargs)
            assert torch.equal(c.key, before)
    with pytest.raises(ValueError, match="streaming options"):
        c.run_scenario(PLAIN, store="unused")
    with pytest.raises(ValueError, match="not wired through the streamed"):
        c.run_scenario(PLAIN, segment_ticks=2, param_knobs={"suspicion_ticks": 9})
    with pytest.raises(ValueError, match="damping=True"):
        c.run_scenario(PLAIN, param_knobs={"damp_reuse": 100.0})
    trunner.validate_param_knobs(6, SwimParams(), {}, backend="dense", period_active=False,
                                 damping=False)
    assert torch.equal(c.key, before)
