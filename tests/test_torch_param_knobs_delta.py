"""The port's protocol knobs on the delta backend against the JAX
reference (under its default lowering, which its knob path needs).

Per knob (the reference's ``PER_KNOB`` list, with ``ping_req_size``
below its capacity), a ``run_scenario(param_knobs=...)`` on both sides:
trace, state (the uint32 planes with their dtype), net, key, loss and
log equal.  The delta refusals (relay full sync, damp knobs) with the
reference's exception and key.  The delta ``param_axes`` sweep is in
``test_torch_sweep_delta_knobs.py``: the reference compiles its
vmapped step apart, and one child for both would take over a minute.
"""

from __future__ import annotations

import numpy as np
import pytest

from test_torch_harness import assert_same_scenario, port_cluster, run_port, run_reference
from test_torch_param_knobs import N, PER_KNOB, SPEC

DELTA = {"n": N, "params": {"suspicion_ticks": 8}, "seed": 3, "backend": "delta",
         "caps": {"capacity": N, "wire_cap": N, "claim_grid": 3 * N * N}}
KNOBS = {k: v for k, v in PER_KNOB.items() if k != "rfs_on"}


def _try(**kwargs):
    return ["try", "run_scenario", SPEC, {"kwargs": kwargs}]


CASES = [
    *({**DELTA, "name": f"knob_{k}", "ops": [["run_scenario", SPEC, {"param_knobs": v}]]}
      for k, v in KNOBS.items()),
    {**DELTA, "name": "refusals", "ops": [
        _try(param_knobs={"relay_full_sync": 1}),
        _try(param_knobs={"damp_penalty": 100.0}),
        ["try", "run_sweep", SPEC, 2, {"kwargs": {"param_axes": {"relay_full_sync": [0, 1]}}}],
    ]},
]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("param_knobs_delta_ref")))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    out = {}
    for c in CASES:
        tries: dict[int, str] = {}
        recs: dict[int, dict] = {}
        run_port(c, tries=tries, scenarios=recs, tmp_dir=str(tmp_path_factory.mktemp("pkd")))
        out[c["name"]] = (tries, recs)
    return out


@pytest.mark.parametrize("knob", list(KNOBS))
def test_delta_per_knob_run_scenario_matches_reference(reference, port_runs, knob):
    name = f"knob_{knob}"
    assert_same_scenario(reference, BY_NAME[name], 0, port_runs[name][1][0])


@pytest.mark.parametrize("i", [0, 1, 2])
def test_delta_knob_refusals_match_reference(reference, port_runs, i):
    """The reference's exception and message, and no key drawn."""
    tries, recs = port_runs["refusals"]
    want = str(reference[f"refusals/try{i}"])
    assert want.startswith("ValueError") and tries[i] == want
    np.testing.assert_array_equal(recs[i]["key"], reference[f"refusals/key_after_try{i}"])
    np.testing.assert_array_equal(recs[i]["key"], port_cluster(DELTA).key.numpy())
