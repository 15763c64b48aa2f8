"""The overload feedback loop on the delta backend against the JAX
reference: ``tests/test_overload.py``'s parity spec with its delta caps
(capacity N, wire cap N, claim grid 3N^2), as a streamed soak killed
after its first checkpoint and resumed (the unsegmented delta run of
the same spec, with a policy on top, is in
``test_torch_policies_delta.py``).  The serve reads the delta tables
directly (``traffic.engine.DeltaRows``): the viewers' rows are built
from them and the ring-divergence and self-in-ring counters counted
from them, so equality here also holds those counts to the reference's
[N, N] ones.  The reference compiles its delta scan once per program,
so this file keeps one case."""

from __future__ import annotations

import pytest

from test_torch_harness import assert_same_scenario, one_thread, run_port, run_reference
from test_torch_overload import N, OV_SPEC, OV_WL, SOAK

DELTA = {"n": N, "params": {"suspicion_ticks": 8, "ping_req_size": 1}, "seed": 11,
         "backend": "delta", "caps": {"capacity": N, "wire_cap": N, "claim_grid": 3 * N * N}}
CASES = [{"name": "ov_delta_soak", **DELTA, "ops": [["run_streamed", OV_SPEC, SOAK]]}]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """The port's runs of this module on one intra-op thread."""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("overload_delta_ref")))


@pytest.mark.parametrize("name", sorted(BY_NAME))
def test_overload_delta_equals_reference(reference, tmp_path, name):
    tries, scen = {}, {}
    run_port(BY_NAME[name], tries=tries, scenarios=scen, tmp_dir=str(tmp_path))
    assert_same_scenario(reference, BY_NAME[name], 0, scen[0])
    assert int(scen[0]["trace"]["m.ov_gray_nodes"].max()) > 0
