"""The port's delta backend against the JAX reference's across a
netsplit and a bootstrap.

The companion of ``test_torch_delta.py`` (same checks, other cases):
every ``DeltaState`` field and metric after every tick op, through
``SimCluster(backend="delta")`` and through ``delta_step_impl`` stepped
alone from the reference's states, under both reference lowerings.

- ``part130``: a group-id netsplit (the only partition form the delta
  backend takes) held for 6 ticks with a kill on one side, then healed;
- ``self16``: the ``init="self"`` bootstrap: every node joins through
  node 0, gossip discovers the rest, and ``rebase`` folds the consensus
  into the base.
"""

from __future__ import annotations

import numpy as np
import pytest

from test_torch_harness import (
    DELTA_LOWERINGS,
    assert_same_trajectory,
    assert_steps_from_reference,
    run_port,
    run_references,
)

T1 = ["tick", 1]
HALVES = [list(range(65)), list(range(65, 130))]

CASES = [
    {"name": "part130", "n": 130, "backend": "delta",
     "params": {"loss": 0.3, "suspicion_ticks": 5}, "seed": 4,
     "caps": {"capacity": 64, "wire_cap": 8, "claim_grid": 16},
     "ops": [["partition", HALVES], ["kill", 100]] + [T1] * 6 + [["heal_partition"]]
            + [T1] * 6},
    {"name": "self16", "n": 16, "backend": "delta", "init": "self",
     "params": {"loss": 0.02, "suspicion_ticks": 6}, "seed": 5,
     "caps": {"capacity": 20, "wire_cap": 16, "claim_grid": 16},
     "ops": [["join", j, 0] for j in range(1, 16)] + [T1] * 10 + [["rebase", False], T1]},
]
BY_NAME = {c["name"]: c for c in CASES}
PAIRS = [(lw, c["name"]) for lw in DELTA_LOWERINGS for c in CASES]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_references(CASES, str(tmp_path_factory.mktemp("netsplit_ref")), DELTA_LOWERINGS)


@pytest.fixture(scope="module")
def port_runs():
    return {c["name"]: run_port(c) for c in CASES}


@pytest.mark.parametrize("lowering,name", PAIRS)
def test_cluster_trajectory(reference, port_runs, lowering, name):
    assert_same_trajectory(reference[lowering], BY_NAME[name], port_runs[name])


@pytest.mark.parametrize("lowering,name", PAIRS)
def test_step_from_reference_states(reference, lowering, name):
    assert assert_steps_from_reference(reference[lowering], BY_NAME[name]) >= 10


def test_cases_exercise_their_paths(reference):
    """The split side declares the killed node faulty; the bootstrap
    fills the tables and the rebase folds the consensus."""
    ref = reference["default"]
    faulty = sum(int(ref[f"part130/m{t}/faulty_declared"]) for t in range(12))
    assert faulty > 0
    assert (ref["part130/adj0"] != 0).any()  # the split was in force
    occ = (ref["self16/d_subj"] < np.iinfo(np.int32).max).sum(axis=2)
    assert occ[-2].max() > 8  # discovery filled the tables
    assert occ[-1].max() < occ[-2].max()  # the rebase folded the consensus
