"""The ``combined`` remediation policy on the delta backend against the
JAX reference (``tests/test_policies.py``'s ``PO_SPEC``/``PO_WL`` at the
oracle knobs, the delta caps of ``test_overload.py``): counters,
histogram, overload and policy series, final state and net (``po_*``),
key and log entry equal, and all three mechanisms fired.  One case: the
reference compiles its delta scan once per program."""

from __future__ import annotations

import pytest

from test_torch_harness import assert_same_scenario, one_thread, run_port, run_reference
from test_torch_overload_delta import DELTA
from test_torch_policies import PO_SPEC, PO_WL, policy_arg

CASE = {"name": "combined_delta", **DELTA, "ops": [
    ["run_scenario", PO_SPEC, {"traffic": PO_WL, "policy": policy_arg("combined")}]]}


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """The port's runs of this module on one intra-op thread."""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference([CASE], str(tmp_path_factory.mktemp("policies_delta_ref")))


def test_combined_delta_equals_reference(reference, tmp_path):
    tries, scen = {}, {}
    run_port(CASE, tries=tries, scenarios=scen, tmp_dir=str(tmp_path))
    assert_same_scenario(reference, CASE, 0, scen[0])
    m = scen[0]["trace"]
    assert int(m["m.policy_shed"].sum()) > 0
    assert int(m["m.policy_quarantined"].max()) > 0
    assert int(m["m.policy_retry_cap"].min()) < 3
