"""The port's flap damping equals ``ringpop_tpu``'s exactly: the
``damp``/``damped`` planes, every other state field and metric, on every
tick, and the quarantine of damped members from ``ring_for`` and
``lookup_batch``.

Cases: the reference's ``tests/test_sim_core.py`` damping test (n = 12,
eight suspend/resume cycles of node 4, then 250 quiet ticks), a revive
of a damped node (its damping rows clear), damping beside the in-flight
buffer (claims that mature flap too), and one step from hand-set scores
that land exactly on the float16 thresholds.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_harness import (
    assert_same_trajectory,
    flatten_outputs,
    run_port,
    run_reference,
    run_reference_calls,
)

from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models import swim_sim as tsim

DAMP = {"damp_penalty": 1000.0, "damp_suppress": 2000.0, "damp_reuse": 400.0,
        "damp_decay_per_tick": 0.98}
FLAPPY = 4
CYCLES = [["suspend", FLAPPY], ["tick", 4], ["resume", FLAPPY], ["tick", 4]] * 8
KEYS = [f"key-{i}" for i in range(48)]
VIEWERS = [v for v in range(12) if v != FLAPPY]
LOOKUPS = {"keys": KEYS, "viewers": VIEWERS}
EVERY = np.ones((1, 12), dtype=bool)

CASES = [
    {"name": "flap", "n": 12, "params": DAMP, "seed": 3, "damping": True, "ops": CYCLES,
     "lookups": LOOKUPS},
    {"name": "decay", "n": 12, "params": DAMP, "seed": 3, "damping": True,
     "ops": CYCLES + [["tick", 250]], "lookups": LOOKUPS},
    {"name": "revive", "n": 12, "params": {**DAMP, "suspicion_ticks": 3, "loss": 0.1}, "seed": 1,
     "damping": True,
     "ops": CYCLES[:8] + [["kill", FLAPPY], ["tick", 6], ["revive", FLAPPY]] + [["tick", 1]] * 6},
    {"name": "delay", "n": 12, "params": DAMP, "seed": 2, "damping": True,
     "ops": [["enable_delay", 3],
             ["set_link_rules", EVERY.tolist(), EVERY.tolist(), [0.0], [1], [1]]]
     + CYCLES[:12]},
]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("damping_ref")))


@pytest.fixture(scope="module")
def port_runs():
    out = {}
    for case in CASES:
        rings = {}

        def on_end(t, c, case=case, rings=rings):
            if t == sum(1 for op in case["ops"] if op[0] == "tick") - 1 and "lookups" in case:
                for v in VIEWERS:
                    rings[v] = (c.ring_for(v), c.lookup_batch(KEYS, viewer=v))
                rings["pairs"] = c.damped_pairs()

        out[case["name"]] = (run_port(case, on_tick=on_end), rings)
    return out


@pytest.mark.parametrize("name", list(BY_NAME))
def test_damping_trajectory(reference, port_runs, name):
    case = BY_NAME[name]
    recs, _ = port_runs[name]
    assert_same_trajectory(reference, case, recs)
    assert recs[-1]["damp"].dtype == np.float16


@pytest.mark.parametrize("name", ["flap", "decay"])
def test_quarantine_in_rings(reference, port_runs, name):
    """``ring_for`` and ``lookup_batch`` of every viewer equal the
    reference's; after the flapping some viewer has node 4 out of its
    ring, and after the quiet ticks nobody does."""
    recs, rings = port_runs[name]
    damped = recs[-1]["damped"]
    for v in VIEWERS:
        ring, batch = rings[v]
        np.testing.assert_array_equal(
            np.array([h for h, _ in ring._entries], np.int64), reference[f"{name}/ring{v}/hash"]
        )
        np.testing.assert_array_equal(
            np.array([s for _, s in ring._entries], dtype=str), reference[f"{name}/ring{v}/server"]
        )
        assert [o or "" for o in batch] == reference[f"{name}/batch{v}"].tolist()
        assert [o or "" for o in batch] == reference[f"{name}/lookup{v}"].tolist()
    flappy_out = [v for v in VIEWERS if damped[v, FLAPPY]]
    if name == "flap":
        assert rings["pairs"] > 0 and flappy_out
    else:
        assert rings["pairs"] == 0 and not flappy_out


def test_revive_clears_damping_rows(port_runs):
    """The revived process starts with no damp memory: one tick after
    the revive its row holds at most one penalty and nothing damped."""
    recs, _ = port_runs["revive"]
    assert recs[4]["damp"].any()  # the last tick before the revive
    after = recs[5]
    assert not after["damped"][FLAPPY].any()
    assert (after["damp"][FLAPPY] <= np.float16(DAMP["damp_penalty"])).all()


# one step from scores that land on the float16 thresholds: 2041 * 0.98
# rounds onto 2000 (not above suppress), 408.25 * 0.98 onto 400 (not
# below reuse), 408 * 0.98 below it
_SCORES = [2041.0, 408.25, 408.0, 2040.5, 2500.0, 0.0, 1020.5, 2049.0, 399.75, 409.0]


def _threshold_state(n: int = 8) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(7)
    st = convert.state_to_numpy(tsim.init_state(n, damping=True, device="cpu"))
    st["damp"] = np.resize(np.array(_SCORES, np.float16), (n, n))
    st["damped"] = rng.random((n, n)) < 0.5
    return st


def test_float16_thresholds_match_reference(tmp_path):
    st = _threshold_state()
    arrays = {f"st_{k}": v for k, v in st.items() if v is not None}
    arrays["net_up"] = np.ones(8, bool)
    arrays["net_responsive"] = np.ones(8, bool)
    arrays["key"] = np.array([0, 11], np.uint32)
    calls = [{"name": "step", "module": "swim_sim", "fn": "swim_step_impl",
              "args": [["cluster_state", {k: f"st_{k}" for k, v in st.items() if v is not None}],
                       ["net", {"up": "net_up", "responsive": "net_responsive"}],
                       ["array", "key"], ["swim_params", DAMP]]}]
    want = run_reference_calls(calls, arrays, str(tmp_path))
    state = convert.state_from_numpy(st, device="cpu")
    net = tsim.make_net(8, device="cpu")
    got = flatten_outputs(
        tsim.swim_step_impl(state, net, convert.key_from_numpy(arrays["key"]),
                            tsim.SwimParams(**DAMP)),
        "step", {},
    )
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    damp = got["step/0/damp"]
    assert (damp == np.float16(2000.0)).any() and (damp == np.float16(400.0)).any()


def test_damped_pairs_and_delta_refusal():
    """``damped_pairs`` without and with the planes, the delta backend's
    refusal, and a refused tick (sparse with damping) that leaves the
    cluster's state in place although the step takes it over."""
    c = tsim.init_state(4, damping=True, device="cpu")
    assert c.damp.shape == (4, 4)
    from ringpop_tpu_torch.models.cluster import SimCluster

    assert SimCluster(4, device="cpu", damping=True).damped_pairs() == 0
    assert SimCluster(4, device="cpu").damped_pairs() == 0
    with pytest.raises(ValueError, match="delta"):
        SimCluster(4, device="cpu", damping=True, backend="delta")
    torch.testing.assert_close(c.damped.sum(), torch.tensor(0))
    refused = SimCluster(4, tsim.SwimParams(sparse_cap=2), device="cpu", damping=True)
    for ticks in (1, 3):
        with pytest.raises(NotImplementedError, match="damping"):
            refused.tick(ticks)
        assert refused.state.damp is not None and int(refused.state.tick) == 0
