"""A sided split bridged by a cross-side join, against the reference.

``bridge32``: the split runs to completion (each side holds the other
faulty, so no cross-side probe is left after the heal), and one
``join`` of a node of side 1 through a node of side 0 bridges the
sides, as BASELINE config 4's bench does when its heal stalls at two
checksum groups: the joiner flips onto the merge row.  Every field and
metric equals the reference's after every tick op (both lowerings,
through ``SimCluster`` and stepped alone).  See
``test_torch_delta_sided.py``.
"""

from __future__ import annotations

import pytest

from test_torch_harness import (
    DELTA_LOWERINGS,
    assert_same_trajectory,
    assert_steps_from_reference,
    run_port,
    run_references,
    split_heal,
)

JOIN_AT = 17  # tick ops before the join
CASE = {"name": "bridge32", "n": 32, "backend": "delta", "checksums": True,
        "params": {"loss": 0.0, "suspicion_ticks": 3}, "seed": 3,
        "caps": {"capacity": 24, "wire_cap": 8, "claim_grid": 64},
        "ops": split_heal(32, 14, 0, split_every=5) + [["tick", 1]] * 3 + [["join", 16, 0]]
               + [["tick", 1]] * 10}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_references([CASE], str(tmp_path_factory.mktemp("bridge_ref")), DELTA_LOWERINGS)


@pytest.fixture(scope="module")
def port_run():
    return run_port(CASE)


@pytest.mark.parametrize("lowering", list(DELTA_LOWERINGS))
def test_cluster_trajectory(reference, port_run, lowering):
    assert_same_trajectory(reference[lowering], CASE, port_run)


@pytest.mark.parametrize("lowering", list(DELTA_LOWERINGS))
def test_step_from_reference_states(reference, lowering):
    assert assert_steps_from_reference(reference[lowering], CASE) >= 25


def test_join_bridges_the_stalled_split(reference, port_run):
    """Two checksum groups, one a side, up to the join; the joiner is the
    first viewer on the merge row after it."""
    ref = reference["default"]
    assert (ref["bridge32/adj13"] != 0).any()  # the split held to its end
    assert len(set(ref[f"bridge32/ck{JOIN_AT - 1}_val"].tolist())) == 2
    before, after = port_run[JOIN_AT - 1]["side"], port_run[JOIN_AT]["side"]
    assert (before < 2).all() and after[16] == 2
