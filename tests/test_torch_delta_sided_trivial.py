"""Sided mode with one side against the reference, and against the
port's own unsided run.

``trivial24``: every viewer on one side (G = 1 plus the merge row), a
node down, 30 ticks at 5% loss (``tests/test_swim_delta.py``'s trivial
sided case).  Every field and metric equals the reference's after every
tick (both lowerings, through ``SimCluster`` and stepped alone), and
the sided run's views and pb records equal the unsided run's: the
sided machinery moves no view.  See ``test_torch_delta_sided.py``.
"""

from __future__ import annotations

import pytest
import torch

from test_torch_harness import (
    DELTA_LOWERINGS,
    assert_same_trajectory,
    assert_steps_from_reference,
    port_cluster,
    run_port,
    run_references,
)

CASE = {"name": "trivial24", "n": 24, "backend": "delta",
        "params": {"loss": 0.05, "suspicion_ticks": 8}, "seed": 0,
        "caps": {"capacity": 24, "wire_cap": 8, "claim_grid": 64},
        "ops": [["split_sides", [list(range(24))]], ["kill", 3]] + [["tick", 1]] * 30}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_references([CASE], str(tmp_path_factory.mktemp("trivial_ref")), DELTA_LOWERINGS)


@pytest.fixture(scope="module")
def port_run():
    return run_port(CASE)


@pytest.mark.parametrize("lowering", list(DELTA_LOWERINGS))
def test_cluster_trajectory(reference, port_run, lowering):
    assert_same_trajectory(reference[lowering], CASE, port_run)


@pytest.mark.parametrize("lowering", list(DELTA_LOWERINGS))
def test_step_from_reference_states(reference, lowering):
    assert assert_steps_from_reference(reference[lowering], CASE) >= 30


def test_trivial_sides_equal_the_unsided_run():
    """The sided run's views and pb records equal the unsided run's (the
    same ops with the one group as a partition) on every tick."""
    from ringpop_tpu_torch.models import swim_delta as tdelta

    unsided = {**CASE, "ops": [["partition", [list(range(24))]]] + CASE["ops"][1:]}
    c_sided, c_plain = port_cluster(CASE), port_cluster(unsided)
    ticks = 0
    for op_s, op_p in zip(CASE["ops"], unsided["ops"]):
        getattr(c_sided, op_s[0])(*op_s[1:])
        getattr(c_plain, op_p[0])(*op_p[1:])
        if op_s[0] == "tick":
            a, b = tdelta.densify(c_sided.state), tdelta.densify(c_plain.state)
            assert torch.equal(a.view_key, b.view_key), ticks
            assert torch.equal(a.pb, b.pb), ticks
            ticks += 1
    assert ticks == 30 and c_sided.state.side is not None
    assert c_plain.state.side is None
    assert sum(m["suspects_declared"] for m in c_sided.metrics_log) > 0  # node 3 suspected
