"""The delta backend's carried slot-base planes (``d_bpmask``/``d_bprank``)
equal ``ringpop_tpu``'s exactly.

Both sides build their states under ``RINGPOP_CARRY_SLOTBASE=1`` (the
reference's switch, read when a state is built): the reference in its
child processes, the port here through ``monkeypatch``.  Held: the
oracles ``compute_slot_base`` and ``refresh_carried`` (with the switch
on and off), a carried trajectory under the reference's default lowering
(a kill, ``compact``, both ``rebase`` forms), one at tight caps under
both lowerings (claims and inserts dropped), a sided split and heal (the
full-sync flips recompute the planes in the step), and that carrying the
planes changes no other field.
"""

from __future__ import annotations

import numpy as np
import pytest

from test_torch_harness import (
    DELTA_FIELDS,
    DELTA_LOWERINGS,
    assert_same_trajectory,
    assert_steps_from_reference,
    flatten_outputs,
    run_port,
    run_reference_calls,
    run_references,
    split_heal,
)

from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models import swim_delta as tdelta

CARRY = {"RINGPOP_CARRY_SLOTBASE": "1"}
ENVS = {"default": CARRY, "pallas": {**DELTA_LOWERINGS["pallas"], **CARRY}}
T1 = ["tick", 1]
CHURN = {"loss": 0.3, "suspicion_ticks": 5}

CASES = [
    {"name": "carry32", "n": 32, "backend": "delta", "params": {"loss": 0.05, "suspicion_ticks": 5},
     "seed": 1, "caps": {"capacity": 32, "wire_cap": 8, "claim_grid": 16},
     "lowerings": ["default"],
     "ops": [T1, ["kill", 5]] + [T1] * 8 + [["compact"], T1, ["rebase", False], T1, T1,
                                              ["rebase", True], T1, ["tick", 5]]},
    {"name": "tight32", "n": 32, "backend": "delta", "params": CHURN, "seed": 2,
     "caps": {"capacity": 8, "wire_cap": 2, "claim_grid": 4},
     "ops": [T1, ["kill", 9]] + [T1] * 10},
    {"name": "sided32", "n": 32, "backend": "delta", "params": {"loss": 0.01}, "seed": 4,
     "caps": {"capacity": 32, "wire_cap": 8, "claim_grid": 16}, "lowerings": ["default"],
     "ops": split_heal(32, 4, 12)},
]
BY_NAME = {c["name"]: c for c in CASES}
PAIRS = [(lw, c["name"]) for lw in ENVS for c in CASES if lw in c.get("lowerings", ENVS)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_references(CASES, str(tmp_path_factory.mktemp("carry_ref")), ENVS)


def _run(case: dict, carried: bool) -> list[dict]:
    with pytest.MonkeyPatch.context() as mp:
        if carried:
            mp.setenv("RINGPOP_CARRY_SLOTBASE", "1")
        else:
            mp.delenv("RINGPOP_CARRY_SLOTBASE", raising=False)
        return run_port(case)


@pytest.fixture(scope="module")
def port_runs():
    return {c["name"]: _run(c, True) for c in CASES}


@pytest.mark.parametrize("lowering,name", PAIRS)
def test_carried_trajectory(reference, port_runs, lowering, name):
    recs = port_runs[name]
    assert recs[0]["d_bpmask"] is not None and recs[-1]["d_bprank"] is not None
    assert_same_trajectory(reference[lowering], BY_NAME[name], recs)


@pytest.mark.parametrize("lowering,name", PAIRS)
def test_carried_step_from_reference_states(reference, lowering, name):
    """``delta_step_impl`` alone from each carried reference state."""
    assert assert_steps_from_reference(reference[lowering], BY_NAME[name]) >= 10


@pytest.mark.parametrize("name", list(BY_NAME))
def test_carry_changes_no_other_field(port_runs, name):
    plain = _run(BY_NAME[name], False)
    for t, (a, b) in enumerate(zip(port_runs[name], plain)):
        assert b["d_bpmask"] is None and b["d_bprank"] is None
        for f in DELTA_FIELDS:
            if f in ("d_bpmask", "d_bprank"):
                continue
            if a[f] is None:
                assert b[f] is None
            else:
                np.testing.assert_array_equal(a[f], b[f], err_msg=f"{name} {f} at {t}")
        assert a["metrics"] == b["metrics"]


def test_oracles_match_reference(tmp_path):
    """``compute_slot_base`` of a stepped state, and ``refresh_carried``
    of it with the planes dropped, under the switch and without it."""
    from ringpop_tpu_torch.models.cluster import SimCluster

    c = SimCluster(32, seed=1, backend="delta", capacity=32, device="cpu")
    c.kill(5)
    c.tick(6)
    st = convert.delta_state_to_numpy(c.state)
    assert st["d_bpmask"] is None
    arrays = {f"s_{k}": v for k, v in st.items() if v is not None}
    arg = ["delta_state", {k: f"s_{k}" for k, v in st.items() if v is not None}]
    calls = [
        {"name": "slot", "module": "swim_delta", "fn": "compute_slot_base", "args": [arg]},
        {"name": "refresh", "module": "swim_delta", "fn": "refresh_carried", "args": [arg]},
    ]
    (tmp_path / "on").mkdir()
    (tmp_path / "off").mkdir()
    on = run_reference_calls(calls, arrays, str(tmp_path / "on"), env=CARRY)
    off = run_reference_calls(calls[1:], arrays, str(tmp_path / "off"))
    state = convert.delta_state_from_numpy(st, device="cpu")
    got = flatten_outputs(tdelta.compute_slot_base(state), "slot", {})
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RINGPOP_CARRY_SLOTBASE", "1")
        got_on = convert.delta_state_to_numpy(tdelta.refresh_carried(state))
    got_off = convert.delta_state_to_numpy(tdelta.refresh_carried(state))
    for k, v in got.items():
        np.testing.assert_array_equal(v, on[k], err_msg=k)
    assert got["slot/0"].any() and got["slot/1"].any()
    for want, have in ((on, got_on), (off, got_off)):
        keys = {k.split("/", 1)[1] for k in want if k.startswith("refresh/")}
        assert keys == {k for k, v in have.items() if v is not None}
        for k in keys:
            np.testing.assert_array_equal(have[k], want[f"refresh/{k}"], err_msg=k)
            assert have[k].dtype == want[f"refresh/{k}"].dtype, k
    assert got_off["d_bpmask"] is None
    # a state that carries the planes keeps them with the switch off
    kept = tdelta.refresh_carried(convert.delta_state_from_numpy(got_on, device="cpu"))
    assert kept.d_bpmask is not None
