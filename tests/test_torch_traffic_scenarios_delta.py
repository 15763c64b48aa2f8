"""``bench_faults.py --traffic``'s gray family on the delta backend (its
capacity ``min(2n, 1024)``) against the JAX reference: the run of
``test_torch_traffic_scenarios.py`` (n = 48, 30 ticks, streamed in
quarter-horizon segments), trace, state, net, key and log equal.  The
serve reads the delta tables (``traffic.engine.DeltaRows``).  The delay
family is in ``test_torch_traffic_scenarios_delta_delay.py``: one
reference child a file keeps each under a minute."""

from __future__ import annotations

import pytest

from test_torch_harness import assert_same_scenario, one_thread, run_port, run_reference
from test_torch_traffic_scenarios import family_cases, scorecard

FAMILY = "gray"
CASES = [c for c in family_cases("delta") if c["name"].startswith(FAMILY)]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """The port's runs of this module on one intra-op thread."""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("families_delta_ref")))


@pytest.mark.parametrize("name", sorted(BY_NAME))
def test_family_scorecard_delta_equals_reference(reference, tmp_path, name):
    tries, scen = {}, {}
    run_port(BY_NAME[name], tries=tries, scenarios=scen, tmp_dir=str(tmp_path))
    assert_same_scenario(reference, BY_NAME[name], 0, scen[0])
    row = scorecard(scen[0]["trace"])
    assert 0 < row["goodput"] <= 1
