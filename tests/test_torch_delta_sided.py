"""The port's sided delta mode against the JAX reference's, tick for tick.

Sided mode is the structured-netsplit form of the delta backend
(``SimCluster.split_sides`` / ``fold_sides``, ``swim_delta.make_sides``
/ ``fold_to_single``): one base row per side plus a merge row, a
cross-side full sync flips the adopter onto the merge row, and each
``rebase`` folds a side into its own row.  The checks are those of
``test_torch_delta.py``: every ``DeltaState`` field (``side``,
``merge_to`` and the [G, N] bases included) and every metric after
every tick op, through ``SimCluster(backend="delta")`` and through
``delta_step_impl`` stepped alone from the reference's pre-tick states,
under both reference lowerings.

This file holds ``sided32``: a 50/50 split with anti-entropy rebases,
the heal, the remerge to one view, then ``fold_sides`` back to one base
and one checksum group (the form of ``tests/test_swim_delta.py``'s
sided ``SimCluster`` scenario).  The other sided cases, one a file so
that each file's reference run stays under a minute:
``test_torch_delta_sided_trivial.py`` (one side), ``_heal.py`` (drops,
flips and refutations at C = 16), ``_bridge.py`` (a cross-side join),
and ``_units.py`` (the host functions, the readers and the sharded
sided step).
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

CASE = {"name": "sided32", "n": 32, "backend": "delta", "checksums": True,
        "params": {"loss": 0.0, "suspicion_ticks": 5}, "seed": 2,
        "caps": {"capacity": 16, "wire_cap": 8, "claim_grid": 64},
        "ops": split_heal(32, 8, 30) + [["rebase", True], ["fold_sides"], ["tick", 1]]}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_references([CASE], str(tmp_path_factory.mktemp("sided_ref")), DELTA_LOWERINGS)


@pytest.fixture(scope="module")
def checksums_seen(reference):
    """The port's run, its checksums held against the reference's after
    every tick op; returns (records, groups per tick op)."""
    ref = reference["default"]
    seen = []

    def on_tick(t, c):
        want = dict(zip(ref[f"sided32/ck{t}_addr"].tolist(),
                        (int(v) for v in ref[f"sided32/ck{t}_val"])))
        assert c.checksums() == want, t
        seen.append(len(set(want.values())))

    return run_port(CASE, on_tick), seen


@pytest.mark.parametrize("lowering", list(DELTA_LOWERINGS))
def test_cluster_trajectory(reference, checksums_seen, lowering):
    """Every DeltaState field (sided ones included) and metric after
    every tick op."""
    assert_same_trajectory(reference[lowering], CASE, checksums_seen[0])


@pytest.mark.parametrize("lowering", list(DELTA_LOWERINGS))
def test_step_from_reference_states(reference, lowering):
    """``delta_step_impl`` alone from the reference's sided states."""
    assert assert_steps_from_reference(reference[lowering], CASE) >= 30


def test_heal_remerges_and_folds_to_one_group(checksums_seen):
    """The checksums equal the reference's after every tick op (checked
    as the port ran); the heal remerges every view onto the merge row,
    ``fold_sides`` leaves sided mode, and the last checksums form one
    group."""
    recs, seen = checksums_seen
    assert recs[-2]["side"] is not None and (recs[-2]["side"] == 2).all()
    assert recs[-1]["side"] is None and recs[-1]["base_key"].ndim == 1
    assert max(seen) > 2 and seen[-1] == 1 and len(seen) == len(recs)
