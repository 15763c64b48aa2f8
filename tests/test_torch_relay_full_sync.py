"""The ping-req relay's full rows (``SwimParams.relay_full_sync``) equal
``ringpop_tpu``'s exactly: every state field and metric on every tick,
``relay_full_syncs`` included.

The spec is the reference's ``tests/test_faults.py`` relay case (a kill,
30% loss, a one-way 95% link loss from four nodes to three until tick
40), driven through each side's ``run_host_loop`` with the flag on and
off, and once more on the sparse step with the flag on.
"""

from __future__ import annotations

import pytest

from test_torch_harness import assert_same_trajectory, run_port, run_reference

SPEC = {
    "ticks": 60,
    "events": [
        {"at": 2, "op": "kill", "node": 11},
        {"at": 4, "op": "loss", "p": 0.3},
        {"at": 8, "op": "link_loss", "src": [0, 1, 2, 3], "dst": [8, 9, 10], "p": 0.95,
         "until": 40},
        {"at": 40, "op": "loss", "p": 0.0},
    ],
}
ON = {"suspicion_ticks": 8, "relay_full_sync": True}
CASES = [
    {"name": "on", "n": 12, "params": ON, "seed": 2, "ops": [["run_host_loop", SPEC]]},
    {"name": "off", "n": 12, "params": {"suspicion_ticks": 8}, "seed": 2,
     "ops": [["run_host_loop", SPEC]]},
    {"name": "sparse_on", "n": 12, "params": {**ON, "sparse_cap": 4}, "seed": 2,
     "ops": [["run_host_loop", SPEC]]},
]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("relay_ref")))


@pytest.fixture(scope="module")
def port_runs():
    out = {}
    for case in CASES:
        conv = []
        out[case["name"]] = (run_port(case, on_tick=lambda t, c, conv=conv: conv.append(
            c.converged())), conv)
    return out


@pytest.mark.parametrize("name", list(BY_NAME))
def test_relay_trajectory(reference, port_runs, name):
    recs, _ = port_runs[name]
    assert len(recs) == 5  # one record per host-loop segment
    assert_same_trajectory(reference, BY_NAME[name], recs)


def _relay_total(recs) -> int:
    return sum(r["metrics"]["relay_full_syncs"] for r in recs)


def test_flag_on_fires_and_heals(port_runs):
    """With the flag the relay answers with full rows and the cluster
    still converges; with it off the metric stays 0."""
    recs, conv = port_runs["on"]
    assert _relay_total(recs) > 0 and conv[-1]
    recs, _ = port_runs["off"]
    assert _relay_total(recs) == 0
    recs, conv = port_runs["sparse_on"]
    assert _relay_total(recs) > 0 and conv[-1]
