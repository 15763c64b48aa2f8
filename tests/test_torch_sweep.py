"""The port's dense scenario sweep (``SimCluster.run_sweep``) against the
JAX reference.

``run_sweep`` runs on both sides (the reference's in a child process)
at n = 16 with R = 3: seed only, then loss scales with kill jitter, and
a flap storm with loss scales, kill and flap jitter (its flaps revive
in the run).  Every replica's series, final state and net, the replica
keys, the cluster key after the sweep and the cluster left as it was
must be equal.  The streamed sweep must equal the whole one, with and
without a segment store.  Refusals raise the reference's exception
(type and message) with the key unchanged: bad axes and jitter, the
delta backend's in-scan revive; bad policy and traffic arguments raise
before any key.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_harness import assert_same_sweep, port_cluster, run_port, run_reference

from ringpop_tpu_torch.scenarios import stream as tstream
from ringpop_tpu_torch.scenarios import sweep as tsweep

N = 16
FAST = {"suspicion_ticks": 4}
# benchmarks/bench_sweep.py's _experiment_spec(16, 20): a kill, 5% loss,
# then a ramp back to 0
SPEC = {"ticks": 20, "events": [
    {"at": 2, "op": "kill", "node": N - 1},
    {"at": 5, "op": "loss", "p": 0.05},
    {"at": 10, "op": "loss_ramp", "until": 20, "to": 0.0},
]}
# the same with a flap storm on three nodes (benchmarks/tune.py's
# arm_boundary window, cut to 20 ticks)
FLAP = {"ticks": 20, "events": [
    *SPEC["events"],
    {"at": 4, "op": "flap", "nodes": [N - 2, N - 3, N - 4], "until": 12, "down": 3, "up": 4,
     "stagger": 2},
]}
JITTER = {"loss_scales": [1.0, 0.5, 2.0], "kill_jitter": [0, 1, 2]}
STORM = {**JITTER, "flap_jitter": [0, 1, 2]}
REVIVE = {"ticks": 10, "events": [{"at": 2, "op": "kill", "node": 5},
                                  {"at": 6, "op": "revive", "node": 5}]}


def _try(spec, replicas, **kwargs):
    return ["try", "run_sweep", spec, replicas, {"kwargs": kwargs}]


CASES = [
    {"name": "seed", "n": N, "params": FAST, "seed": 5, "ops": [
        ["run_sweep", SPEC, 3, {}],
        _try(SPEC, 2, param_axes={"bogus": [1, 2]}),
        _try(SPEC, 2, param_axes={"suspicion_ticks": [1, 2, 3]}),
        _try(SPEC, 2, param_axes={"suspicion_ticks": [4, 127]}),
        _try(SPEC, 2, kill_jitter=[0, 30]),
        _try(SPEC, 2, loss_scales=[1.0]),
        _try(SPEC, 2, loss_scales=[1.0, -0.5]),
        _try(SPEC, 0),
        _try(SPEC, 2, segment_ticks=5, param_axes={"suspicion_ticks": [4, 8]}),
        ["run_sweep", SPEC, 3, JITTER],
    ]},
    {"name": "storm", "n": N, "params": FAST, "seed": 2, "ops": [
        ["run_sweep", FLAP, 3, STORM],
        _try(FLAP, 2, flap_jitter=[0, 9]),
    ]},
    {"name": "delta_revive", "n": N, "params": FAST, "seed": 1, "backend": "delta",
     "caps": {"capacity": 8, "wire_cap": 4, "claim_grid": 16},
     "ops": [_try(REVIVE, 2), _try(REVIVE, 2, segment_ticks=4)]},
]
BY_NAME = {c["name"]: c for c in CASES}
SWEEP_OPS = [(c["name"], i) for c in CASES for i, op in enumerate(c["ops"])
             if op[0] == "run_sweep"]
TRY_OPS = [(c["name"], i) for c in CASES for i, op in enumerate(c["ops"]) if op[0] == "try"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("sweep_ref")))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    out = {}
    for c in CASES:
        tries: dict[int, str] = {}
        recs: dict[int, dict] = {}
        run_port(c, tries=tries, scenarios=recs, tmp_dir=str(tmp_path_factory.mktemp("sw")))
        out[c["name"]] = (tries, recs)
    return out


@pytest.mark.parametrize("name,i", SWEEP_OPS)
def test_run_sweep_matches_reference(reference, port_runs, name, i):
    """Every replica's series (with dtype and meta), final state and net
    fields, the replica keys, the cluster key after the sweep, and the
    cluster's own state and logs left as they were."""
    assert_same_sweep(reference, BY_NAME[name], i, port_runs[name][1][i])


@pytest.mark.parametrize("name,i", TRY_OPS)
def test_refusals_match_reference(reference, port_runs, name, i):
    """The reference's exception type and message, and the key the op
    before it left: no replica key was drawn."""
    tries, recs = port_runs[name]
    want = str(reference[f"{name}/try{i}"])
    assert want and tries[i] == want
    np.testing.assert_array_equal(recs[i]["key"], reference[f"{name}/key_after_try{i}"])
    before = [j for j in recs if j < i]
    np.testing.assert_array_equal(
        recs[i]["key"],
        recs[max(before)]["key"] if before else port_cluster(BY_NAME[name]).key.numpy())


def test_delta_revive_refusal_names_the_backend(port_runs):
    assert "dense-backend-only" in port_runs["delta_revive"][0][0]
    assert port_runs["delta_revive"][0][0].startswith("NotImplementedError")


def _same_sweeps(a, b) -> None:
    ta, tb = a.to_arrays(), b.to_arrays()
    assert ta.keys() == tb.keys()
    for k, v in ta.items():
        assert v.dtype == tb[k].dtype and np.array_equal(v, tb[k]), k
    assert a.meta() == b.meta()
    for sa, sb in zip(a.final_states, b.final_states):
        for f, x in sa._asdict().items():
            y = getattr(sb, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype and torch.equal(x, y), f
    for na, nb in zip(a.final_nets, b.final_nets):
        for f, x in na._asdict().items():
            y = getattr(nb, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert torch.equal(x, y), f


@pytest.fixture(scope="module")
def whole_storm():
    c = port_cluster(BY_NAME["storm"])
    return c, c.run_sweep(FLAP, 3, **STORM)


@pytest.mark.parametrize("store,pipeline", [(False, True), (True, True), (True, False)])
def test_streamed_sweep_equals_whole(whole_storm, tmp_path, store, pipeline):
    """7-tick segments (a ragged tail), with and without a segment store
    and pipelining: the whole sweep's trace, final states and nets, and
    the same cluster key; the store's slabs reassemble to it."""
    a, whole = whole_storm
    b = port_cluster(BY_NAME["storm"])
    before = tsweep.dispatch_count()
    path = str(tmp_path / "sweep-store") if store else None
    got = b.run_sweep(FLAP, 3, **STORM, segment_ticks=7, store=path, pipeline=pipeline)
    assert tsweep.dispatch_count() - before == 3
    _same_sweeps(whole, got)
    assert torch.equal(a.key, b.key)
    if store:
        st = tstream.SegmentStore.open(path)
        assert st.kind == "sweep" and st.segments == 3
        assert [s.ticks for s in st.iter_traces()] == [7, 7, 6]
        ta, tb = st.assemble().to_arrays(), whole.to_arrays()
        assert all(np.array_equal(v, tb[k]) for k, v in ta.items())
        c = port_cluster(BY_NAME["storm"])
        assert c.run_sweep(FLAP, 3, **STORM, segment_ticks=7, store=str(tmp_path / "s2"),
                           assemble=False).kind == "sweep"


def test_replica_equals_standalone_run(whole_storm):
    """Replica r of the storm sweep is ``run_scenario(replica_spec(...))``
    from replica key r on a cluster at the scaled base loss: series,
    state and net bits."""
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.scenarios.spec import ScenarioSpec

    _, whole = whole_storm
    for r in (0, 2):
        c = port_cluster(BY_NAME["storm"])
        c.key = convert.key_from_numpy(whole.replica_keys[r])
        trace = c.run_scenario(tsweep.replica_spec(
            ScenarioSpec.from_dict(FLAP), kill_jitter=STORM["kill_jitter"][r],
            loss_scale=STORM["loss_scales"][r], flap_jitter=STORM["flap_jitter"][r]))
        rep = whole.replica(r)
        for k, v in trace.to_arrays().items():
            assert np.array_equal(v, rep.to_arrays()[k]), (r, k)
        assert rep.spec == trace.spec
        for f, x in c.state._asdict().items():
            y = getattr(whole.final_states[r], f)
            assert (x is None) == (y is None) and (x is None or torch.equal(x, y)), (r, f)
        assert torch.equal(c.net.up, whole.final_nets[r].up)


def test_unported_planes_refused_before_the_key():
    """A policy without a workload, policy axes without a policy or of
    the wrong length, a bad workload, tracked rumors on the sparse step
    and over a finished traced run's planes raise the reference's
    errors, streamed or not; no key is drawn and the cluster logs
    nothing."""
    traced = {**SPEC, "trace_rumors": 2}
    sparse = port_cluster({**BY_NAME["seed"], "params": {**FAST, "sparse_cap": 4}})
    left = port_cluster(BY_NAME["seed"])
    left.run_scenario(traced)
    assert left.provenance_report()["rumors"]
    for d, exc, match in ((sparse, NotImplementedError, "dense delivery evidence"),
                          (left, ValueError, "clear_provenance")):
        key = d.key.clone()
        for seg in (None, 5):
            with pytest.raises(exc, match=match):
                d.run_sweep(traced, 2, segment_ticks=seg)
            assert torch.equal(d.key, key)
    c = port_cluster(BY_NAME["seed"])
    before = c.key.clone()
    for kwargs, exc, match in (
        ({"policy": "admission"}, ValueError, "policies meter"),
        ({"policy": "admission", "policy_axes": {"admit_capacity": [2, 4]}},
         ValueError, "policies meter"),
        ({"policy_axes": {"admit_capacity": [2, 4]}}, ValueError, "requires policy"),
        ({"traffic": {"kind": "zipf"}, "policy": "admission",
          "policy_axes": {"admit_capacity": [2]}}, ValueError, "one value per replica"),
        ({"traffic": {"keys": 8}}, TypeError, "keys"),
        ({"shard": True}, None, None),
    ):
        for seg in (None, 5):
            d = c.key.clone()
            if exc is None:
                tr = c.run_sweep(SPEC, 2, segment_ticks=seg, **kwargs)
                assert tr.replicas == 2
                continue
            with pytest.raises(exc, match=match):
                c.run_sweep(SPEC, 2, segment_ticks=seg, **kwargs)
            assert torch.equal(c.key, d)
    assert not torch.equal(c.key, before)  # the two shard=True sweeps drew keys
    assert c.metrics_log == [] and c.traces == []
    with pytest.raises(ValueError, match="streaming options"):
        c.run_sweep(SPEC, 2, store="unused")
    from ringpop_tpu_torch.policies import core as pol

    cp = pol.compile_policy("admission", n=16, m=24)
    assert tsweep.policy_knob_axes(cp, None, 2) == [cp.knobs, cp.knobs]
    assert tsweep.policy_knob_axes(None, None, 2) is None


def test_shard_refused_on_several_cards(monkeypatch):
    """``shard=True`` with more than one visible card raises, naming the
    queue item, before any key; on one card it is a no-op."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match="item 11"):
        tsweep.precheck_shard(4)
    c = port_cluster(BY_NAME["seed"])
    before = c.key.clone()
    with pytest.raises(NotImplementedError, match="item 11"):
        c.run_sweep(SPEC, 2, shard=True)
    assert torch.equal(c.key, before)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    tsweep.precheck_shard(4)
