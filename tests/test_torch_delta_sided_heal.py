"""Sided mode at a tight capacity against the reference.

``heal64``: n = 64 at C = 16 and 5% loss, split into halves with
anti-entropy rebases, then healed for 30 ticks, so that table drops,
cross-side flips onto the merge row, the absorb of the merged base and
the post-flip refutation merge all fire.  Every field and metric equals
the reference's after every tick op (both lowerings, through
``SimCluster`` and stepped alone).  See ``test_torch_delta_sided.py``.
"""

from __future__ import annotations

import pytest
import torch

from test_torch_harness import (
    DELTA_LOWERINGS,
    assert_same_trajectory,
    assert_steps_from_reference,
    run_port,
    run_references,
    split_heal,
)

CASE = {"name": "heal64", "n": 64, "backend": "delta",
        "params": {"loss": 0.05, "suspicion_ticks": 6}, "seed": 1,
        "caps": {"capacity": 16, "wire_cap": 8, "claim_grid": 64},
        "ops": split_heal(64, 8, 30)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_references([CASE], str(tmp_path_factory.mktemp("heal_ref")), DELTA_LOWERINGS)


@pytest.fixture(scope="module")
def port_run():
    """The port's run, with the valid rows of each post-flip refutation
    merge (a one-claim merge whose subjects are the viewers themselves)."""
    from ringpop_tpu_torch.models import swim_delta as tdelta

    refutes = []
    real = tdelta._merge_claims

    def spy(state, c_subj, c_key, valid, *args):
        ids = torch.arange(state.n, dtype=torch.int32)
        if c_subj.shape[1] == 1 and torch.equal(c_subj[:, 0], ids):
            refutes.append(int(valid.sum()))
        return real(state, c_subj, c_key, valid, *args)

    tdelta._merge_claims = spy
    try:
        return run_port(CASE), refutes
    finally:
        tdelta._merge_claims = real


@pytest.mark.parametrize("lowering", list(DELTA_LOWERINGS))
def test_cluster_trajectory(reference, port_run, lowering):
    assert_same_trajectory(reference[lowering], CASE, port_run[0])


@pytest.mark.parametrize("lowering", list(DELTA_LOWERINGS))
def test_step_from_reference_states(reference, lowering):
    assert assert_steps_from_reference(reference[lowering], CASE) >= 30


def test_case_exercises_its_paths(port_run):
    """Slots dropped at full tables, full syncs, most viewers flipped onto
    the merge row, and the post-flip refutation merge refuted someone."""
    recs, refutes = port_run
    assert recs[-1]["overflow_drops"] > 0
    assert sum(r["metrics"]["full_syncs"] for r in recs) > 0
    assert (recs[-1]["side"] == 2).sum() > 32
    assert sum(refutes) > 0
