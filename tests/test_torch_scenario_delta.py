"""The port's compiled scenario runner on the delta backend against the
JAX reference.

``SimCluster.run_scenario`` on both sides (the reference's in one child
process a lowering): the acceptance scenario of ``tests/test_scenario.py``
(N = 12, seed 3) at ample caps (capacity = wire = N, grid = 3N^2: the
delta step is the dense one; the default lowering only, as the Pallas
lowering's interpret mode is slow there) and at tight caps (capacity 4,
wire 2, grid 4: tables overflow; both lowerings), and the delta
backend's refusals: an in-scan revive and a standing in-flight buffer
of another depth, with the reference's type and message and no key
drawn.  After each run the trace, state (the uint32 planes as uint32),
net, key, loss and ``metrics_log`` entry must be equal.
"""

from __future__ import annotations

import numpy as np
import pytest

from test_torch_faults_delta import TIGHT
from test_torch_harness import DELTA_LOWERINGS, assert_same_scenario, run_port, run_references
from test_torch_scenario_compiled import FAST, N, PLAIN, SPEC

DELAY3 = {"ticks": 6, "events": [{"at": 1, "op": "delay", "src": [0], "dst": [1], "delay": 2}]}
REVIVE4 = {"ticks": 4, "events": [{"at": 1, "op": "revive", "node": 0}]}
AMPLE12 = {"capacity": N, "wire_cap": N, "claim_grid": 3 * N * N}

CASES = [
    {"name": "spec_ample", "n": N, "backend": "delta", "params": FAST, "seed": 3,
     "caps": AMPLE12, "ops": [["run_scenario", SPEC]], "lowerings": ["default"]},
    {"name": "spec_tight", "n": N, "backend": "delta", "params": FAST, "seed": 3,
     "caps": TIGHT, "ops": [["run_scenario", SPEC], ["tick", 2]]},
    # tests/test_scenario.py:355 and tests/test_faults.py:309
    {"name": "refusals", "n": 8, "backend": "delta", "params": FAST, "seed": 0,
     "caps": {"capacity": 8, "wire_cap": 4, "claim_grid": 16}, "lowerings": ["default"],
     "ops": [["run_scenario", PLAIN], ["try", "run_scenario", REVIVE4], ["enable_delay", 4],
             ["try", "run_scenario", DELAY3]]},
]
BY_NAME = {c["name"]: c for c in CASES}
PAIRS = [(lw, c["name"], i) for c in CASES for lw in c.get("lowerings", DELTA_LOWERINGS)
         for i, op in enumerate(c["ops"]) if op[0] == "run_scenario"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_references(CASES, str(tmp_path_factory.mktemp("scenario_delta_ref")),
                          DELTA_LOWERINGS)


@pytest.fixture(scope="module")
def port_runs():
    out = {}
    for c in CASES:
        tries: dict[int, str] = {}
        scen: dict[int, dict] = {}
        out[c["name"]] = (run_port(c, tries=tries, scenarios=scen), tries, scen)
    return out


@pytest.mark.parametrize("lowering,name,i", PAIRS)
def test_run_scenario_matches_reference(reference, port_runs, lowering, name, i):
    assert_same_scenario(reference[lowering], BY_NAME[name], i, port_runs[name][2][i])


def test_follow_on_ticks_match_reference(reference, port_runs):
    """``tick(2)`` after the tight run continues each lowering's trajectory."""
    rec = port_runs["spec_tight"][0][0]
    for lowering in DELTA_LOWERINGS:
        ref = reference[lowering]
        for f in ("d_subj", "d_key", "base_key", "tick", "overflow_drops"):
            np.testing.assert_array_equal(rec[f], ref[f"spec_tight/{f}"][1], err_msg=f)


def test_refusals_match_reference(reference, port_runs):
    """An in-scan revive and a mismatched in-flight depth: the reference's
    type and message, and the key the run before left."""
    ref = reference["default"]
    _, tries, scen = port_runs["refusals"]
    for i in (1, 3):
        assert tries[i] == str(ref[f"refusals/try{i}"]) != ""
        np.testing.assert_array_equal(scen[i]["key"], ref[f"refusals/key_after_try{i}"])
        np.testing.assert_array_equal(scen[i]["key"], scen[0]["key"])
    assert tries[1].startswith("NotImplementedError: in-scan revive")
    assert "depth 4" in tries[3]


def test_tight_caps_overflow(port_runs):
    """The tight run does drop claims (the caps bind)."""
    trace = port_runs["spec_tight"][2][0]["trace"]
    assert trace["m.overflow_drops"][-1] > 0 or trace["m.claims_dropped"].sum() > 0
