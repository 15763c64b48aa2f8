"""The port's scenario host side against the JAX reference's.

``ringpop_tpu_torch.scenarios`` keeps its own copies of the reference's
``spec.py`` (specs, validation, the flap and rolling-restart expansion),
the host half of ``faults.py`` (link rules, delay depth, period rows,
boundary ticks, the masked rule table, the overload update) and
``compile.expand_events``.  One child process evaluates the reference's
on a set of specs (every family of ``tests/test_faults.py``, its
validation errors, adjacent gray windows, split delay rules, a loss
ramp and an overload window); each result must be equal here.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from test_torch_faults import FAMILIES
from test_torch_harness import run_reference_script

from ringpop_tpu_torch.scenarios import compile as tcompile
from ringpop_tpu_torch.scenarios import faults as tfaults
from ringpop_tpu_torch.scenarios.spec import Event, ScenarioSpec, expand_fault_primitives

N = 10
SPECS = {
    **FAMILIES,
    "adjacent_gray": {"ticks": 40, "events": [
        {"at": 20, "op": "gray", "node": 0, "factor": 6, "until": 30},
        {"at": 10, "op": "gray", "node": 0, "factor": 4, "until": 20}]},
    "split_delay": {"ticks": 20, "events": [
        {"at": 1, "op": "delay", "src": [0], "dst": [1], "delay": 3},
        {"at": 2, "op": "delay", "src": [0], "dst": [1], "delay": 0, "jitter": 2}]},
    "ramp": {"ticks": 20, "events": [
        {"at": 2, "op": "loss", "p": 0.2},
        {"at": 5, "op": "loss_ramp", "until": 9, "to": 0.0},
        {"at": 6, "op": "kill", "node": 3},
        {"at": 6, "op": "revive", "node": 4},
        {"at": 12, "op": "flap", "nodes": [5, 6], "until": 16, "down": 1, "up": 2,
         "stagger": 1}]},
    "overload": {"ticks": 30, "events": [
        {"at": 3, "op": "overload", "until": 20, "capacity": 4, "threshold": 9,
         "recover": 2, "factor": 3},
        {"at": 4, "op": "gray", "nodes": [1, 2], "factor": 2, "until": 12}]},
}
BAD = [
    ([{"at": 1, "op": "link_loss", "src": [0], "dst": [1], "p": 1.0}], 20, 8),
    ([{"at": 1, "op": "link_loss", "src": [], "dst": [1], "p": 0.5}], 20, 8),
    ([{"at": 1, "op": "link_loss", "src": [0], "dst": [9], "p": 0.5}], 20, 8),
    ([{"at": 5, "op": "link_loss", "src": [0], "dst": [1], "p": 0.5, "until": 5}], 20, 8),
    ([{"at": 1, "op": "delay", "src": [0], "dst": [1]}], 20, 8),
    ([{"at": 1, "op": "flap", "node": 2, "until": 10, "down": 0, "up": 3}], 20, 8),
    ([{"at": 1, "op": "flap", "node": 2, "until": 19, "down": 3, "up": 2}], 20, 8),
    ([{"at": 1, "op": "gray", "node": 2, "factor": 0}], 20, 8),
    ([{"at": 1, "op": "gray", "node": 2, "factor": 3, "until": 10},
      {"at": 5, "op": "gray", "node": 2, "factor": 5}], 20, 8),
    ([{"at": 1, "op": "rolling_restart", "nodes": [0, 1], "down": 9, "every": 10}], 20, 8),
    ([{"at": 1, "op": "flap", "node": 2, "until": 10, "down": 2, "up": 3},
      {"at": 3, "op": "kill", "node": 2}], 20, 8),
    ([{"at": 1, "op": "kill", "node": 2}, {"at": 1, "op": "revive", "node": 2}], 5, 4),
    ([{"at": 1, "op": "overload", "capacity": 1, "threshold": 2, "factor": 1}], 20, 8),
    ([{"at": 1, "op": "track", "node": 1}], 20, 8),
]
AT = (0, 2, 5, 10, 19, 21, 24)
OV = {"pressure": [0, 3, 9, 12, 1, 2], "gray": [False, True, True, False, True, False],
      "sends": [1, 9, 2, 0, 8, 3]}

_SCRIPT = r"""
from ringpop_tpu.scenarios import compile as scompile
from ringpop_tpu.scenarios import faults as sfaults
from ringpop_tpu.scenarios.spec import ScenarioSpec

specs, bad, at, n, ov = ARGS
out = {"specs": {}, "bad": []}
for name, d in specs.items():
    spec = ScenarioSpec.from_dict(d)
    spec.validate(n)
    rows = {}
    for t in at:
        src, dst, p, dd, j = sfaults.rules_arrays(sfaults.link_rules(spec), n, at=t)
        rows[str(t)] = [src.tolist(), dst.tolist(), p.tolist(), dd.tolist(), j.tolist()]
    cfg = sfaults.overload_config(spec)
    out["specs"][name] = {
        "dict": spec.to_dict(),
        "rules": [list(r) for r in sfaults.link_rules(spec)],
        "depth": sfaults.delay_depth(spec),
        "switches": [[t, r.tolist()] for t, r in sfaults.period_switches(spec, n)],
        "markers": sfaults.fault_marker_ticks(spec),
        "arrays": rows,
        "events": [[a, op, arg] for a, op, arg in scompile.expand_events(spec, 0.01)],
        "overload": None if cfg is None else list(cfg),
    }
    if cfg is not None:
        for win in (True, False):
            cnt, gray = sfaults.overload_update(
                cfg, win, np.array(ov["pressure"], np.int32), np.array(ov["gray"]),
                np.array(ov["sends"], np.int32))
            out["specs"][name][f"ov_{win}"] = [cnt.tolist(), gray.tolist()]
for events, ticks, nn in bad:
    try:
        ScenarioSpec.from_dict({"ticks": ticks, "events": events}).validate(nn)
        out["bad"].append("")
    except ValueError as e:
        out["bad"].append(str(e))
out["rank"] = scompile._OP_RANK
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    args = json.dumps(json.dumps([SPECS, BAD, AT, N, OV]))
    code = f"\nARGS = json.loads({args})\n" + _SCRIPT
    return run_reference_script(code, str(tmp_path_factory.mktemp("scenarios_ref")))


def _events(ops) -> list:
    """``expand_events``' ops in JSON form (group tuples as lists)."""
    return json.loads(json.dumps([[a, op, arg] for a, op, arg in ops]))


@pytest.mark.parametrize("name", list(SPECS))
def test_fault_lowering(reference, name):
    """Rules, depth, period rows, boundary ticks, the masked rule table
    at several ticks, the expanded timeline and the overload config."""
    want = reference["specs"][name]
    spec = ScenarioSpec.from_dict(SPECS[name])
    spec.validate(N)
    assert spec.to_dict() == want["dict"]
    assert [list(r) for r in json.loads(json.dumps(tfaults.link_rules(spec)))] == want["rules"]
    assert tfaults.delay_depth(spec) == want["depth"]
    assert [[t, r.tolist()] for t, r in tfaults.period_switches(spec, N)] == want["switches"]
    assert tfaults.fault_marker_ticks(spec) == want["markers"]
    for t in AT:
        got = tfaults.rules_arrays(tfaults.link_rules(spec), N, at=t)
        assert [a.tolist() for a in got] == want["arrays"][str(t)], t
    assert _events(tcompile.expand_events(spec, 0.01)) == want["events"]
    cfg = tfaults.overload_config(spec)
    assert (None if cfg is None else list(cfg)) == want["overload"]


def test_overload_update_numpy_and_torch(reference):
    """The feedback update on numpy arrays and on tensors, in and out of
    its window."""
    want = reference["specs"]["overload"]
    cfg = tfaults.overload_config(ScenarioSpec.from_dict(SPECS["overload"]))
    for win in (True, False):
        cnt, gray = tfaults.overload_update(
            cfg, win, np.array(OV["pressure"], np.int32), np.array(OV["gray"]),
            np.array(OV["sends"], np.int32))
        assert [cnt.tolist(), gray.tolist()] == want[f"ov_{win}"]
        tcnt, tgray = tfaults.overload_update(
            cfg, win, torch.tensor(OV["pressure"], dtype=torch.int32),
            torch.tensor(OV["gray"]), torch.tensor(OV["sends"], dtype=torch.int32))
        assert [tcnt.tolist(), tgray.tolist()] == want[f"ov_{win}"]


def test_validation_errors(reference):
    """Every bad spec is refused with the reference's message."""
    got = []
    for events, ticks, n in BAD:
        try:
            ScenarioSpec.from_dict({"ticks": ticks, "events": events}).validate(n)
            got.append("")
        except ValueError as e:
            got.append(str(e))
    assert got == reference["bad"]
    assert all(got)


def test_op_rank_and_round_trip(reference):
    assert tcompile._OP_RANK == reference["rank"]
    for d in SPECS.values():
        spec = ScenarioSpec.from_dict(d)
        assert ScenarioSpec.from_json(spec.to_json()) == spec
        for e in spec.events:
            assert Event.from_dict(e.to_dict()) == e
    flap = Event.from_dict({"at": 2, "op": "flap", "nodes": [5, 6], "until": 12, "down": 2,
                            "up": 3, "stagger": 1})
    assert [(p.at, p.op, p.node) for p in expand_fault_primitives(flap, 20)] == [
        (2, "kill", 5), (4, "revive", 5), (7, "kill", 5), (9, "revive", 5),
        (3, "kill", 6), (5, "revive", 6), (8, "kill", 6), (10, "revive", 6)]


def test_host_loop_refuses_overload():
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.scenarios.runner import run_host_loop

    c = SimCluster(N, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="overload"):
        run_host_loop(c, ScenarioSpec.from_dict(SPECS["overload"]))
