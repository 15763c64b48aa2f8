"""The port's protocol knobs (``swim_sim.SwimKnobs``,
``run_scenario(param_knobs=...)``, ``run_sweep(param_axes=...)``) on the
dense backend against the JAX reference.

- The knob helpers and their guards (``tests/test_param_knobs.py``'s
  fast lane): values and casts, range guards, the int8 digit budgets at
  the axis maximum, the composition guards.
- Per knob (the reference's ``PER_KNOB`` list, plus ``ping_req_size``
  below its capacity and the damp thresholds on a damping cluster), a
  ``run_scenario(param_knobs=...)`` on both sides (the reference's in a
  child process): trace, state, net, key, loss and log equal.  Default
  knobs give the no-knob trajectory on the port.
- The knob refusals of ``run_scenario`` with the reference's exception
  and the reference's key after it.
- A ``param_axes`` sweep equal to the reference's, and each replica
  equal to a standalone ``run_scenario`` with its knobs.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_harness import (
    assert_same_scenario,
    assert_same_sweep,
    port_cluster,
    run_port,
    run_reference,
)

from ringpop_tpu_torch.models import swim_sim as tsim
from ringpop_tpu_torch.scenarios import runner as trunner
from ringpop_tpu_torch.scenarios import sweep as tsweep

N = 12
PARAMS = {"suspicion_ticks": 6}
# tests/test_param_knobs.py:32
SPEC = {"ticks": 20, "events": [
    {"at": 3, "op": "kill", "node": 3},
    {"at": 8, "op": "loss", "p": 0.05},
    {"at": 14, "op": "loss", "p": 0.0},
]}
# a flap storm for the damp thresholds (flaps are what they score)
FLAP = {"ticks": 20, "events": [
    {"at": 2, "op": "flap", "nodes": [9, 10], "until": 16, "down": 2, "up": 3},
    {"at": 4, "op": "loss", "p": 0.1},
]}
GRAY = {"ticks": 6, "events": [{"at": 1, "op": "gray", "node": 0, "factor": 3}]}
# tests/test_param_knobs.py:277 PER_KNOB, with relay_full_sync on, the
# capacity-padded ping_req_size below capacity, and the damp thresholds
PER_KNOB = {
    "suspicion": {"suspicion_ticks": 7},
    "piggyback": {"piggyback_factor": 4},
    "phase_mod": {"phase_mod": 3},
    "rfs_off": {"relay_full_sync": 0},
    "rfs_on": {"relay_full_sync": 1},
    "ping_req": {"ping_req_size": 3},
    "ping_req_below": {"ping_req_size": 2},
    "ping_req_one": {"ping_req_size": 1},
    "combo": {"suspicion_ticks": 9, "piggyback_factor": 6, "phase_mod": 2},
}
DAMP = {"damp_penalty": 300.0, "damp_suppress": 1200.0, "damp_reuse": 400.0}
AXES = {"suspicion_ticks": [4, 8, 12], "ping_req_size": [3, 2, 1]}


def _try(spec, **kwargs):
    return ["try", "run_scenario", spec, {"kwargs": kwargs}]


CASES = [
    *({"name": f"knob_{k}", "n": N, "params": PARAMS, "seed": 4,
       "ops": [["run_scenario", SPEC, {"param_knobs": v}]]} for k, v in PER_KNOB.items()),
    {"name": "knob_damp", "n": N, "params": PARAMS, "seed": 4, "damping": True,
     "ops": [["run_scenario", FLAP, {"param_knobs": DAMP}]]},
    {"name": "sweep", "n": N, "params": {"suspicion_ticks": 8}, "seed": 7,
     "ops": [["run_sweep", SPEC, 3, {"param_axes": AXES}]]},
    {"name": "refusals", "n": N, "params": PARAMS, "seed": 1, "ops": [
        ["run_scenario", SPEC],
        _try(SPEC, param_knobs={"damp_suppress": 900.0}),
        _try(GRAY, param_knobs={"phase_mod": 2}),
        _try(SPEC, param_knobs={"suspicion_ticks": 127}),
        _try(SPEC, param_knobs={"ping_req_size": 4}),
        _try(SPEC, param_knobs={"relay_full_sync": 2}),
        _try(SPEC, param_knobs={"piggyback_factor": 70}),
        _try(SPEC, param_knobs={"suspicion_ticks": 5}, segment_ticks=5),
        ["try", "run_sweep", SPEC, 2, {"kwargs": {"param_axes": {"damp_reuse": [1.0, 2.0]}}}],
        ["try", "run_sweep", SPEC, 2, {"kwargs": {"param_axes": {"piggyback_factor": [2, 90]}}}],
        # an unknown knob passes the guards and raises after the key draw,
        # in the reference as here
        _try(SPEC, param_knobs={"bogus": 1}),
    ]},
]
BY_NAME = {c["name"]: c for c in CASES}
TRY_OPS = [i for i, op in enumerate(BY_NAME["refusals"]["ops"]) if op[0] == "try"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("param_knobs_ref")))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    out = {}
    for c in CASES:
        tries: dict[int, str] = {}
        recs: dict[int, dict] = {}
        run_port(c, tries=tries, scenarios=recs, tmp_dir=str(tmp_path_factory.mktemp("pk")))
        out[c["name"]] = (tries, recs)
    return out


@pytest.mark.parametrize("knob", [*PER_KNOB, "damp"])
def test_per_knob_run_scenario_matches_reference(reference, port_runs, knob):
    """``run_scenario(param_knobs=...)``: trace, state (the damping planes
    too), net, key, loss and log entry equal to the reference's."""
    name = f"knob_{knob}"
    assert_same_scenario(reference, BY_NAME[name], 0, port_runs[name][1][0])


def test_param_axes_sweep_matches_reference(reference, port_runs):
    assert_same_sweep(reference, BY_NAME["sweep"], 0, port_runs["sweep"][1][0])


@pytest.mark.parametrize("i", TRY_OPS)
def test_knob_refusals_match_reference(reference, port_runs, i):
    """The reference's exception and message, and its key after the op."""
    tries, recs = port_runs["refusals"]
    want = str(reference[f"refusals/try{i}"])
    assert want and tries[i] == want
    np.testing.assert_array_equal(recs[i]["key"], reference[f"refusals/key_after_try{i}"])


def test_refusals_draw_no_key(port_runs):
    """Every guard fires before the key draw: the key stays the first
    run's until the unknown knob, which the guards let through."""
    tries, recs = port_runs["refusals"]
    keys = [recs[i]["key"] for i in TRY_OPS]
    for k in keys[:-1]:
        np.testing.assert_array_equal(k, recs[0]["key"])
    assert not np.array_equal(keys[-1], recs[0]["key"])
    assert "unknown traced swim knob" in tries[TRY_OPS[-1]]


def test_default_knobs_give_the_plain_trajectory():
    """``param_knobs`` at ``params``' own values (relay full sync off,
    the capacity k) is the no-knob run: trace, state and key."""
    case = BY_NAME["knob_suspicion"]
    a = port_cluster(case)
    ta = a.run_scenario(SPEC)
    b = port_cluster(case)
    knobs = {k: v for k, v in tsim.swim_knob_values(b.params).items()
             if k not in trunner._DAMP_KNOBS}  # those need the damping planes
    tb = b.run_scenario(SPEC, param_knobs=knobs)
    for k, v in ta.to_arrays().items():
        assert np.array_equal(v, tb.to_arrays()[k]), k
    for f, x in a.state._asdict().items():
        y = getattr(b.state, f)
        assert (x is None and y is None) or torch.equal(x, y), f
    assert torch.equal(a.key, b.key)


def test_knob_equals_param_where_the_paths_agree():
    """A knob with the legacy path's semantics (suspicion, piggyback,
    phase_mod) gives the run of ``params`` with that value; the
    capacity-padded ``ping_req_size`` below capacity does not."""
    case = BY_NAME["knob_combo"]
    for knobs in (PER_KNOB["combo"], PER_KNOB["ping_req_below"]):
        a = port_cluster({**case, "params": {**PARAMS, **knobs}})
        ta = a.run_scenario(SPEC)
        b = port_cluster(case)
        tb = b.run_scenario(SPEC, param_knobs=knobs)
        same = all(np.array_equal(v, tb.to_arrays()[k]) for k, v in ta.to_arrays().items())
        assert same == ("ping_req_size" not in knobs), knobs


def test_sweep_replicas_equal_standalone_runs(port_runs):
    """Replica r of the knob sweep is ``run_scenario(param_knobs=
    replica_param_knobs(axes, r))`` from replica key r."""
    from ringpop_tpu_torch import convert

    c = port_cluster(BY_NAME["sweep"])
    strace = c.run_sweep(SPEC, 3, param_axes=AXES)
    for r in range(3):
        c2 = port_cluster(BY_NAME["sweep"])
        c2.key = convert.key_from_numpy(strace.replica_keys[r])
        trace = c2.run_scenario(SPEC, param_knobs=tsweep.replica_param_knobs(AXES, r))
        for k, v in trace.to_arrays().items():
            assert np.array_equal(v, strace.replica(r).to_arrays()[k]), (r, k)
        assert torch.equal(c2.state.view_key, strace.final_states[r].view_key)
    assert tsweep.replica_param_knobs(AXES, 1) == {"suspicion_ticks": 8, "ping_req_size": 2}
    assert tsweep.replica_param_knobs(None, 0) is None


# -- the knob helpers (tests/test_param_knobs.py's fast lane) ------------------


def test_knob_values_and_arrays_roundtrip():
    p = tsim.SwimParams(suspicion_ticks=7, piggyback_factor=4)
    vals = tsim.swim_knob_values(p)
    assert vals["suspicion_ticks"] == 7 and vals["piggyback_factor"] == 4
    knobs = tsim.swim_knob_arrays(p, {"suspicion_ticks": 11, "damp_suppress": 1000.3,
                                      "damp_penalty": 0.1})
    assert knobs.suspicion_ticks == 11 and isinstance(knobs.suspicion_ticks, int)
    # host numbers of the knob dtypes: float16 and float32 rounding
    assert knobs.damp_suppress == float(np.float16(1000.3)) != 1000.3
    assert knobs.damp_penalty == float(np.float32(0.1)) != 0.1
    with pytest.raises(ValueError, match="unknown traced swim knob"):
        tsim.swim_knob_arrays(p, {"nope": 1})


def test_knob_range_guards():
    p = tsim.SwimParams(ping_req_size=3)
    with pytest.raises(ValueError, match="int8 countdown"):
        tsim.check_knob_value("suspicion_ticks", 127, p)
    with pytest.raises(ValueError, match="compiled capacity"):
        tsim.check_knob_value("ping_req_size", 4, p)
    with pytest.raises(ValueError, match="phase_mod"):
        tsim.check_knob_value("phase_mod", 0, p)
    with pytest.raises(ValueError, match="relay_full_sync"):
        tsim.check_knob_value("relay_full_sync", 2, p)
    with pytest.raises(ValueError, match="piggyback_factor"):
        tsim.check_knob_value("piggyback_factor", -1, p)


def test_validate_params_names_offending_axis_value():
    """The int8 digit budgets hold at the axis maximum, and the error
    names the replica whose value broke them."""
    p = tsim.SwimParams()
    assert tsim._validate_params(1000, p) == p.suspicion_ticks + 1
    with pytest.raises(ValueError, match=r"param_axes replica 2"):
        tsim._validate_params(1000, p, knob_values={"piggyback_factor": [2, 3, 40]})
    with pytest.raises(ValueError, match=r"param_axes replica 1"):
        tsim._validate_params(16, p, knob_values={"suspicion_ticks": [9, 200]})


def test_composition_guards():
    p = tsim.SwimParams()
    ok = dict(backend="dense", period_active=False, damping=True)
    trunner.validate_param_knobs(16, p, {"suspicion_ticks": [3, 9]}, **ok)
    with pytest.raises(ValueError, match="phase_mod"):
        trunner.validate_param_knobs(16, p, {"phase_mod": [1, 2]}, backend="dense",
                                     period_active=True, damping=False)
    with pytest.raises(ValueError, match="full-sync exchange arm"):
        trunner.validate_param_knobs(16, p, {"relay_full_sync": [0, 1]}, backend="delta",
                                     period_active=False, damping=False)
    with pytest.raises(ValueError, match="no damping plane"):
        trunner.validate_param_knobs(16, p, {"damp_penalty": [100.0]}, backend="delta",
                                     period_active=False, damping=False)
    with pytest.raises(ValueError, match="damping=True"):
        trunner.validate_param_knobs(16, p, {"damp_suppress": [900.0]}, backend="dense",
                                     period_active=False, damping=False)


def test_sparse_step_keeps_knobs_refused():
    """The sparse program keeps the reference's ValueError for knobs."""
    from ringpop_tpu_torch import prng

    n = 8
    p = tsim.SwimParams(sparse_cap=4)
    with pytest.raises(ValueError, match="knob"):
        tsim.swim_step_impl(tsim.init_state(n, device="cpu"), tsim.make_net(n, device="cpu"),
                            prng.PRNGKey(0), p, knobs=tsim.swim_knob_arrays(p))
