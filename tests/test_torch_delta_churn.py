"""The port's delta backend against the JAX reference's under churn.

The companion of ``test_torch_delta.py`` (same checks, other cases):
every ``DeltaState`` field and metric after every tick op, through
``SimCluster(backend="delta")`` and through ``delta_step_impl`` stepped
alone from the reference's states, under both reference lowerings.

- ``churn130``: n = 130 at 30% loss with suspicion 5: kills, suspend,
  resume, leave, revive and join, then ``compact`` and ``rebase`` with
  both ``anti_entropy`` values;
- ``prod64``: production-style caps far below the cluster's divergence
  (capacity 8, wire_cap 2, claim_grid 4), so that claims drop at
  routing (``claims_dropped``) and inserts at full tables
  (``overflow_drops``).
"""

from __future__ import annotations

import pytest

from test_torch_harness import (
    DELTA_LOWERINGS,
    assert_same_trajectory,
    assert_steps_from_reference,
    run_port,
    run_references,
)

T1 = ["tick", 1]
CHURN = {"loss": 0.3, "suspicion_ticks": 5}

CASES = [
    {"name": "churn130", "n": 130, "backend": "delta", "params": CHURN, "seed": 3,
     "caps": {"capacity": 64, "wire_cap": 8, "claim_grid": 16},
     "ops": [T1, ["kill", 7], ["kill", 50], T1, T1, ["suspend", 11], T1, T1, ["resume", 11],
             ["leave", 20], T1, T1, ["revive", 7], T1, ["join", 20, 0], T1, T1,
             ["compact"], T1, ["rebase", False], T1, T1, ["rebase", True], T1, T1]},
    {"name": "prod64", "n": 64, "backend": "delta", "params": CHURN, "seed": 2,
     "caps": {"capacity": 8, "wire_cap": 2, "claim_grid": 4},
     "ops": [T1, ["kill", 9]] + [T1] * 10},
]
BY_NAME = {c["name"]: c for c in CASES}
PAIRS = [(lw, c["name"]) for lw in DELTA_LOWERINGS for c in CASES]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_references(CASES, str(tmp_path_factory.mktemp("churn_ref")), DELTA_LOWERINGS)


@pytest.fixture(scope="module")
def port_runs():
    return {c["name"]: run_port(c) for c in CASES}


@pytest.mark.parametrize("lowering,name", PAIRS)
def test_cluster_trajectory(reference, port_runs, lowering, name):
    assert_same_trajectory(reference[lowering], BY_NAME[name], port_runs[name])


@pytest.mark.parametrize("lowering,name", PAIRS)
def test_step_from_reference_states(reference, lowering, name):
    assert assert_steps_from_reference(reference[lowering], BY_NAME[name]) >= 10


def test_cases_exercise_their_paths(reference, port_runs):
    """A rebase moves the base; the production caps drop claims and
    slots and the killed node is declared faulty."""
    base = reference["default"]["churn130/base_key"]
    assert (base[-1] != base[0]).any()  # only a rebase moves the base
    prod = [r["metrics"] for r in port_runs["prod64"]]
    assert sum(m["claims_dropped"] for m in prod) > 0
    assert prod[-1]["overflow_drops"] > 0
    assert sum(m["faulty_declared"] for m in prod) > 0
