"""``tick-cluster --incident`` on the delta layout against the reference's
(see ``test_torch_cli.py``): the control arm and the ``combined`` policy
arm of cascading_overload at n = 16, their summary and A/B lines.  A
delta program takes the reference ~45 s to compile, hence a file of its
own.
"""

from __future__ import annotations

import pytest

from test_torch_cli import TPU_SIM, normalized, run_both
from test_torch_harness import one_thread  # noqa: F401 - a fixture

CASES = [
    ("incident_delta", TPU_SIM + ["-n", "16", "--seed", "3", "--layout", "delta",
                                  "--capacity", "16", "--incident", "cascading_overload",
                                  "--policy", "combined"]),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):  # noqa: F811
    return run_both(CASES, str(tmp_path_factory.mktemp("cli_delta")), "cli_delta")


def test_incident_delta_lines_equal(runs):
    port, ref, port_dir, ref_dir = runs
    got, want = port["incident_delta"], ref["incident_delta"]
    assert got[1] == want[1] == ""
    assert normalized(got[0], port_dir) == normalized(want[0], ref_dir)
    assert "incident cascading_overload:" in got[0] and "policy combined:" in got[0]
