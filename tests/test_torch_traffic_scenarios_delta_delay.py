"""``bench_faults.py --traffic``'s delay family on the delta backend
against the JAX reference (see ``test_torch_traffic_scenarios_delta.py``):
the requests' latency reads the link rules whose delays the delta
in-flight lanes carry."""

from __future__ import annotations

import pytest

from test_torch_harness import assert_same_scenario, one_thread, run_port, run_reference
from test_torch_traffic_scenarios import family_cases, scorecard

CASES = [c for c in family_cases("delta") if c["name"].startswith("delay")]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """The port's runs of this module on one intra-op thread."""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("families_delay_ref")))


@pytest.mark.parametrize("name", sorted(BY_NAME))
def test_family_scorecard_delta_delay_equals_reference(reference, tmp_path, name):
    tries, scen = {}, {}
    run_port(BY_NAME[name], tries=tries, scenarios=scen, tmp_dir=str(tmp_path))
    assert_same_scenario(reference, BY_NAME[name], 0, scen[0])
    row = scorecard(scen[0]["trace"])
    assert 0 < row["goodput"] <= 1 and row["lat_ms"][2] > 0
