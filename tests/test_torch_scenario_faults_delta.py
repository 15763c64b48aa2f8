"""Fault families through the compiled scenario runner on the delta
backend, against the JAX reference.

The delta twin of ``test_torch_scenario_faults.py``: link loss with gray
periods and a kill (``test_torch_faults_delta.LINK_GRAY``) and delay
with jitter and loss (``test_torch_faults.DELAY``) through
``SimCluster.run_scenario`` on both sides, at ample and tight caps,
under the reference's default lowering (``test_torch_scenario_delta.py``
holds the runner under the Pallas lowering too, and
``test_torch_faults_delta*.py`` these families' steps); the families
with revives (flap, rolling restart) are refused on this backend, as in
the reference.  Trace, state (the in-flight lanes included), net, key,
loss and ``metrics_log`` entry must be equal.
"""

from __future__ import annotations

import pytest

from test_torch_faults import DELAY, FLAP
from test_torch_faults_delta import LINK_GRAY, scenario_cases
from test_torch_harness import assert_same_scenario, run_port, run_reference

CASES = []
for fam, spec in (("link_gray", LINK_GRAY), ("delay", DELAY)):
    for case in scenario_cases(fam, spec):
        CASES.append({**case, "ops": [["run_scenario", spec]]})
CASES.append({**CASES[-1], "name": "flap_tight", "ops": [["try", "run_scenario", FLAP]]})
BY_NAME = {c["name"]: c for c in CASES}
NAMES = [c["name"] for c in CASES if c["ops"][0][0] == "run_scenario"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("scenario_faults_delta_ref")))


@pytest.fixture(scope="module")
def port_runs():
    out = {}
    for c in CASES:
        tries: dict[int, str] = {}
        scen: dict[int, dict] = {}
        run_port(c, tries=tries, scenarios=scen)
        out[c["name"]] = (tries, scen)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_family_matches_reference(reference, port_runs, name):
    assert_same_scenario(reference, BY_NAME[name], 0, port_runs[name][1][0])


def test_flap_refused_like_reference(reference, port_runs):
    tries, scen = port_runs["flap_tight"]
    assert tries[0] == str(reference["flap_tight/try0"])
    assert tries[0].startswith("NotImplementedError: in-scan revive")
