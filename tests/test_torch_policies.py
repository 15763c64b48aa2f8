"""The remediation policy plane (``policy=`` with a served workload)
against the JAX reference, dense backend.

``tests/test_policies.py``'s units (parsing, the catalog, compiled
defaults and their round trip, the update's hysteresis and amplification
window on numpy and torch alike), and its ``PO_SPEC``/``PO_WL`` parity
for each of the four policies at the reference's oracle knobs: every
counter and histogram row, the ``ov_*`` and ``policy_*`` series, the
final state and net (``net.po_*``), key and log entry equal.  Also: a
sweep with ``policy_axes`` (replica r equal to a standalone run under
``sweep.replica_policy``), a streamed soak killed and resumed, a soak
the reference leaves interrupted that the port's ``resume`` finishes
from the reference's checkpoint (``po_*`` across packages), a served
policy sweep streamed against the whole one, and ``clear_policy``.  ``combined`` on the delta backend is in
``test_torch_policies_delta.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_harness import (
    assert_same_scenario,
    assert_same_sweep,
    one_thread,
    run_port,
    run_reference,
    run_reference_script,
)

from ringpop_tpu_torch import checkpoint
from ringpop_tpu_torch.models.cluster import SimCluster
from ringpop_tpu_torch.models.swim_sim import SwimParams
from ringpop_tpu_torch.policies import core as pol
from ringpop_tpu_torch.scenarios import runner as trunner
from ringpop_tpu_torch.scenarios import stream as tstream
from ringpop_tpu_torch.scenarios import sweep as tsweep

N = 10
LEAN = {"suspicion_ticks": 8, "ping_req_size": 1}
B = 10
PO_WL = {"kind": "zipf", "keys_per_tick": 24, "pool": 256, "zipf_s": 1.2,
         "window": N * 100, "latency_buckets": B}
PO_SPEC = {
    "ticks": 12,
    "events": [
        {"at": 1, "op": "gray", "nodes": [1, 2], "factor": 4, "until": 10},
        {"at": 3, "op": "kill", "node": 9},
        {"at": 1, "op": "overload", "until": 12, "capacity": 1,
         "threshold": 5, "recover": 1, "factor": 4},
    ],
}
# operating points at which every enabled mechanism fires at N = 10
ORACLE_KNOBS = {
    "admission": dict(admit_capacity=2, shed_hi=3, shed_lo=1),
    "retry_budget": dict(admit_capacity=2, amp_threshold_x16=20),
    "quarantine": dict(admit_capacity=2, quar_hi=3, quar_lo=1),
    "combined": dict(admit_capacity=2, shed_hi=3, shed_lo=1,
                     quar_hi=4, quar_lo=1, amp_threshold_x16=20),
}


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """The port's runs of this module on one intra-op thread."""


def policy_arg(name: str) -> str:
    """The oracle policy as its ``NAME:k=v`` argument (JSON for both sides)."""
    return name + ":" + ",".join(f"{k}={v}" for k, v in ORACLE_KNOBS[name].items())


SWEEP_SPEC = {"ticks": 16, "events": [
    {"at": 1, "op": "overload", "until": 16, "capacity": 1, "threshold": 5,
     "recover": 1, "factor": 4}]}
AXES = {"shed_hi": [3, pol.INF]}
BASE = {"n": N, "params": LEAN, "seed": 11}
SOAK = {"segment_ticks": 5, "traffic": PO_WL, "policy": policy_arg("combined"),
        "checkpoint": True, "interrupt_after": 1}

CASES = [
    *({"name": f"po_{name}", **BASE,
       "ops": [["run_scenario", PO_SPEC, {"traffic": PO_WL, "policy": policy_arg(name)}]]}
      for name in sorted(pol.POLICIES)),
    {"name": "sweep", **BASE, "seed": 9, "ops": [
        ["run_sweep", SWEEP_SPEC, 2, {"traffic": PO_WL, "policy": policy_arg("admission"),
                                      "policy_axes": AXES}]]},
    {"name": "soak", **BASE, "ops": [["run_streamed", PO_SPEC, SOAK]]},
    {"name": "left", **BASE, "ops": [["run_streamed", PO_SPEC, {**SOAK, "resume": False}]]},
    {"name": "refusals", **BASE, "ops": [
        ["try", "run_scenario", {"ticks": 4, "events": []}, {"kwargs": {"policy": "combined"}}],
        ["run_scenario", PO_SPEC, {"traffic": PO_WL, "policy": "combined"}],
        ["clear_overload"],
        ["try", "run_scenario", PO_SPEC, {"kwargs": {"traffic": PO_WL, "policy": "combined"}}],
        ["clear_policy"],
        ["run_scenario", PO_SPEC, {"traffic": PO_WL, "policy": "combined"}],
    ]},
]
BY_NAME = {c["name"]: c for c in CASES}

_UNITS = r"""
import json, sys
import numpy as np
from ringpop_tpu.policies import core as pol
out = {"catalog": pol.format_catalog(10, 24), "list": pol.list_policies()}
for name in pol.list_policies():
    cp = pol.compile_policy(name, n=10, m=24)
    out["default/" + name] = pol.to_dict(cp)
    cp = pol.compile_policy(name + ":admit_capacity=2,amp_window=4", n=64, m=512)
    out["over/" + name] = pol.to_dict(cp)
bad = []
for arg in ("nope", "admission:bogus=1", "admission:shed_hi", "admission:amp_window=0"):
    try:
        pol.compile_policy(arg, n=10, m=24)
        bad.append("")
    except ValueError as e:
        bad.append(str(e))
out["bad"] = bad
cp = pol.compile_policy("combined:admit_capacity=2,amp_window=3", n=10, m=24)
rng = np.random.default_rng(5)
st = (np.zeros(10, np.int32), np.zeros(10, bool), np.zeros(10, bool),
      np.zeros(3, np.int32), np.zeros(3, np.int32))
walk = []
for t in range(30):
    sends = rng.integers(0, 9, 10).astype(np.int32)
    deliv = np.int32(rng.integers(0, 30))
    r = pol.policy_update(cp.config, cp.knobs, *st, sends, np.int32(sends.sum()), deliv, t, 3)
    st = r[:5]
    walk.append([np.asarray(x).tolist() for x in r])
out["walk"] = walk
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("policies_ref")))


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    return run_reference_script(_UNITS, str(tmp_path_factory.mktemp("policies_units")))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("policies_port"))
    out = {}
    for case in CASES:
        tries, scen = {}, {}
        run_port(case, tries=tries, scenarios=scen, tmp_dir=tmp)
        out[case["name"]] = (tries, scen)
    return out


def test_parse_catalog_and_defaults(units):
    """The catalog text, the policy list, the scale-aware defaults, the
    ``NAME:k=v`` overrides and the refusals: the reference's."""
    assert pol.format_catalog(10, 24) == units["catalog"]
    assert pol.list_policies() == units["list"]
    for name in pol.list_policies():
        assert pol.to_dict(pol.compile_policy(name, n=10, m=24)) == units["default/" + name]
        cp = pol.compile_policy(name + ":admit_capacity=2,amp_window=4", n=64, m=512)
        assert pol.to_dict(cp) == units["over/" + name]
        assert pol.from_dict(pol.to_dict(cp)) == cp
        assert pol.compile_policy(pol.to_dict(cp), n=1, m=1) == cp
        assert pol.compile_policy(cp, n=1, m=1) is cp
    got = []
    for arg in ("nope", "admission:bogus=1", "admission:shed_hi", "admission:amp_window=0"):
        try:
            pol.compile_policy(arg, n=10, m=24)
            got.append("")
        except ValueError as e:
            got.append(str(e))
    assert got == units["bad"]


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_policy_update_walk(units, kind):
    """30 ticks of the fold (hysteresis, the amp window wrapping) on
    numpy arrays and on tensors, equal to the reference's numpy walk."""
    cp = pol.compile_policy("combined:admit_capacity=2,amp_window=3", n=10, m=24)
    rng = np.random.default_rng(5)
    st = (np.zeros(10, np.int32), np.zeros(10, bool), np.zeros(10, bool),
          np.zeros(3, np.int32), np.zeros(3, np.int32))
    if kind == "torch":
        st = tuple(torch.from_numpy(x) for x in st)
    for t, want in enumerate(units["walk"]):
        sends = rng.integers(0, 9, 10).astype(np.int32)
        deliv = np.int32(rng.integers(0, 30))
        if kind == "torch":
            r = pol.policy_update(cp.config, cp.knobs, *st, torch.from_numpy(sends),
                                  torch.tensor(int(sends.sum()), dtype=torch.int32),
                                  torch.tensor(int(deliv), dtype=torch.int32), t, 3)
            assert all(x.dtype in (torch.int32, torch.bool) for x in r)
        else:
            r = pol.policy_update(cp.config, cp.knobs, *st, sends, np.int32(sends.sum()),
                                  deliv, t, 3)
        assert [np.asarray(x).tolist() for x in r] == want, t
        st = r[:5]


@pytest.mark.parametrize("name", sorted(pol.POLICIES))
def test_policy_parity_dense(reference, port_runs, name):
    """Each policy at its oracle knobs equals the reference: counters
    (``policy_shed`` included), histogram, overload and policy series,
    final state and net; every enabled mechanism fired and every
    disabled one stayed silent."""
    case = f"po_{name}"
    scen = port_runs[case][1][0]
    assert_same_scenario(reference, BY_NAME[case], 0, scen)
    m = {k[2:]: v for k, v in scen["trace"].items() if k.startswith("m.")}
    mechs = pol.POLICIES[name][1]
    assert (int(m["policy_shed"].sum()) > 0) == ("admission" in mechs)
    assert (int(m["policy_quarantined"].max()) > 0) == ("quarantine" in mechs)
    assert (int(m["policy_retry_cap"].min()) < 3) == ("retry_budget" in mechs)


def test_policy_sweep_axes(reference, port_runs):
    """A sweep over ``shed_hi`` equals the reference's; replica 1 (INF:
    admission off) sheds nothing and equals a standalone run under its
    ``replica_policy``."""
    scen = port_runs["sweep"][1][0]
    assert_same_sweep(reference, BY_NAME["sweep"], 0, scen)
    shed = scen["trace"]["m.policy_shed"]
    assert int(shed[0].sum()) > 0 and int(shed[1].sum()) == 0
    c = SimCluster(N, SwimParams(**LEAN), seed=9, device="cpu")
    ct = c.compile_traffic(PO_WL)
    cp = pol.compile_policy(policy_arg("admission"), n=N, m=24)
    tr = c.run_sweep(SWEEP_SPEC, 2, traffic=ct, policy=cp, policy_axes=AXES)
    d = SimCluster(N, SwimParams(**LEAN), seed=9, device="cpu")
    d.key = torch.from_numpy(tr.replica_keys[1].astype(np.int64))
    td = d.run_scenario(SWEEP_SPEC, traffic=ct, policy=tsweep.replica_policy(cp, AXES, 1))
    rep = tr.replica(1)
    for k, v in td.metrics.items():
        np.testing.assert_array_equal(rep.metrics[k], v, err_msg=k)
    np.testing.assert_array_equal(rep.planes["lat_hist_ms"], td.planes["lat_hist_ms"])
    for f in ("po_press", "po_shed", "po_quar", "po_sends_w", "po_deliv_w", "po_retry_cap"):
        assert torch.equal(getattr(tr.final_nets[1], f), getattr(d.net, f)), f
    rows = tr.serving_summary()
    assert [r["replica"] for r in rows] == [0, 1]
    assert rows[0]["policy_shed"] > 0 and rows[1]["policy_shed"] == 0
    assert tsweep.policy_knob_axes(cp, AXES, 2)[1].shed_hi == pol.INF
    with pytest.raises(ValueError, match="one value per replica"):
        tsweep.policy_knob_axes(cp, {"shed_hi": [1]}, 2)
    with pytest.raises(ValueError, match="unknown policy axes"):
        tsweep.policy_knob_axes(cp, {"nope": [1, 2]}, 2)


def test_policy_streamed_and_resumed(reference, port_runs):
    """A soak killed after its first checkpoint and resumed equals the
    reference's (its policy carry crossing the checkpoint)."""
    assert_same_scenario(reference, BY_NAME["soak"], 0, port_runs["soak"][1][0])


def test_resume_reference_checkpoint(reference, tmp_path):
    """The port finishes a soak the reference left interrupted, from the
    reference's checkpoint (its ``po_*`` and ``ov_*`` arrays and its
    cursor's workload and policy), with the reference's uninterrupted
    result; its checkpoint loads in the port with the policy carry."""
    ck = str(reference["left/ckpt0"])
    c = checkpoint.load(ck, device="cpu")
    assert c.net.po_press is not None and c.net.po_retry_cap.dim() == 0
    assert c.stream_cursor["policy"]["name"] == "combined"
    c, tr = tstream.resume(ck, device="cpu")
    from test_torch_harness import scenario_record

    got = scenario_record(c, BY_NAME["left"], tr)
    assert_same_scenario(reference, BY_NAME["soak"], 0, got)


def test_refusals_and_clear_policy(reference, port_runs):
    """A policy without a workload, and a fresh policy run over the last
    one's carry, raise the reference's ``ValueError`` with the key
    unchanged; after ``clear_overload`` and ``clear_policy`` the run
    equals the reference's."""
    tries, scen = port_runs["refusals"]
    for i in (0, 3):
        assert tries[i] == str(reference[f"refusals/try{i}"]), i
        np.testing.assert_array_equal(scen[i]["key"], reference[f"refusals/key_after_try{i}"])
    assert tries[0].startswith("ValueError: policies meter")
    assert tries[3].startswith("ValueError: the cluster carries policy state")
    for i in (1, 5):
        assert_same_scenario(reference, BY_NAME["refusals"], i, scen[i])
    c = SimCluster(N, SwimParams(**LEAN), seed=11, device="cpu")
    before = c.key.clone()
    for seg in (None, 4):
        with pytest.raises(ValueError, match="policies meter"):
            c.run_scenario({"ticks": 4, "events": []}, policy="combined", segment_ticks=seg)
    assert torch.equal(c.key, before)
    c.run_scenario(PO_SPEC, traffic=PO_WL, policy="combined")
    assert trunner.last_meta() == {"backend": "dense", "n": N, "ticks": 12, "replicas": 1,
                                   "traffic_m": 24, "policy": "combined"}
    assert c.net.po_press is not None
    c.clear_overload()
    before = c.key.clone()
    with pytest.raises(ValueError, match="policy state from a previous run"):
        c.run_scenario(PO_SPEC, traffic=PO_WL, policy="combined", segment_ticks=4)
    assert torch.equal(c.key, before)
    c.clear_policy()
    assert all(getattr(c.net, f) is None for f in c.net._fields if f.startswith("po_"))


def test_policy_sweep_streamed_equals_whole():
    """The served, policy-armed sweep streamed in 5-tick segments equals
    the whole one: every series, histogram plane and final net (the
    overload and policy carries cross the segments)."""
    def sweep(**kw):
        c = SimCluster(N, SwimParams(**LEAN), seed=9, device="cpu")
        return c.run_sweep(PO_SPEC, 2, traffic=PO_WL, policy=policy_arg("combined"),
                           policy_axes=AXES, kill_jitter=[0, 1], **kw)

    whole, seg = sweep(), sweep(segment_ticks=5)
    a, b = whole.to_arrays(), seg.to_arrays()
    assert a.keys() == b.keys() and "p.lat_hist_ms" in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for x, y in zip(whole.final_nets, seg.final_nets):
        for f in x._fields:
            u, v = getattr(x, f), getattr(y, f)
            assert (u is None) == (v is None) and (u is None or torch.equal(u, v)), f
    assert whole.final_nets[0].po_press is not None
