"""The overload feedback loop (``overload`` events with a served
workload) against the JAX reference, dense backend.

``tests/test_overload.py``'s parity spec: two gray nodes seed duty
timeouts, a kill at tick 3, and the overload meter whose hysteresis bit
degrades a pressured node's period the next tick.  Each side runs it
through ``run_scenario(spec, traffic=...)`` and as a streamed soak
killed after its first checkpoint and resumed; every counter and
histogram row, the ``ov_*`` telemetry, the final state and net (the
feedback carry on ``net.ov_*``), the key and the log entry must be
equal.  The refusals (overload without a workload, leftover feedback
state, the host loop) come before any key is drawn, as the reference's.
The delta backend's cases are in ``test_torch_overload_delta.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_harness import (
    assert_same_scenario,
    one_thread,
    run_port,
    run_reference,
)

from ringpop_tpu_torch.models.cluster import SimCluster
from ringpop_tpu_torch.models.swim_sim import SwimParams
from ringpop_tpu_torch.scenarios import faults as tfaults
from ringpop_tpu_torch.scenarios.spec import ScenarioSpec

N = 10
LEAN = {"suspicion_ticks": 8, "ping_req_size": 1}
B = 10
# exact window: the masked walk settles every key
OV_WL = {"kind": "zipf", "keys_per_tick": 24, "pool": 256, "zipf_s": 1.2,
         "window": N * 100, "latency_buckets": B}
OV_SPEC = {
    "ticks": 12,
    "events": [
        {"at": 1, "op": "gray", "nodes": [1, 2], "factor": 4, "until": 10},
        {"at": 3, "op": "kill", "node": 9},
        {"at": 1, "op": "overload", "until": 12, "capacity": 1,
         "threshold": 5, "recover": 1, "factor": 4},
    ],
}
# the same incident without the feedback loop: the control arm
CONTROL = {"ticks": 12, "events": OV_SPEC["events"][:2]}
BASE = {"n": N, "params": LEAN, "seed": 11}
SOAK = {"segment_ticks": 5, "traffic": OV_WL, "checkpoint": True, "interrupt_after": 1}

CASES = [
    {"name": "ov", **BASE, "ops": [["run_scenario", OV_SPEC, {"traffic": OV_WL}]]},
    {"name": "ov_soak", **BASE, "ops": [["run_streamed", OV_SPEC, SOAK]]},
    {"name": "control", **BASE, "ops": [["run_scenario", CONTROL, {"traffic": OV_WL}]]},
    # the refusals, each with the key after it; then a second overload
    # run after clear_overload
    {"name": "refusals", **BASE, "ops": [
        ["try", "run_scenario", OV_SPEC],
        ["try", "run_host_loop", OV_SPEC],
        ["run_scenario", OV_SPEC, {"traffic": OV_WL}],
        ["try", "run_scenario", OV_SPEC, {"kwargs": {"traffic": OV_WL}}],
        ["clear_overload"],
        ["run_scenario", OV_SPEC, {"traffic": OV_WL}],
    ]},
]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """The port's runs of this module on one intra-op thread."""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("overload_ref")))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("overload_port"))
    out = {}
    for case in CASES:
        tries, scen = {}, {}
        run_port(case, tries=tries, scenarios=scen, tmp_dir=tmp)
        out[case["name"]] = (tries, scen)
    return out


@pytest.mark.parametrize("name,i", [("ov", 0), ("ov_soak", 0), ("control", 0)])
def test_overload_run_equals_reference(reference, port_runs, name, i):
    """Counters, the latency histogram, the ``ov_*`` series, the final
    state and net (``ov_cnt``/``ov_gray``), key and log: all equal."""
    _, scen = port_runs[name]
    assert_same_scenario(reference, BY_NAME[name], i, scen[i])


def test_the_storm_fired(port_runs):
    """The feedback loop engaged (pressure crossed the threshold, gray
    timeouts followed) and the control arm has no feedback series."""
    tr = port_runs["ov"][1][0]["trace"]
    assert int(tr["m.ov_gray_nodes"].max()) > 0
    assert int(tr["m.gray_timeouts"].sum()) > 0
    ctl = port_runs["control"][1][0]["trace"]
    assert "m.ov_gray_nodes" not in ctl and "m.lookups" in ctl
    assert "ov_cnt" not in port_runs["control"][1][0]["net"]


def test_refusals_equal_reference(reference, port_runs):
    """Overload without a workload, and a fresh overload run over the
    feedback state of the last, raise the reference's ``ValueError``;
    the host loop refuses overload; the key is unchanged after each, and
    the run after ``clear_overload`` equals the reference's."""
    tries, scen = port_runs["refusals"]
    for i in (0, 1, 3):
        want = str(reference[f"refusals/try{i}"])
        got = tries[i]
        assert got.split(":")[0] == want.split(":")[0], (i, got, want)
        if i != 1:
            assert got == want, (i, got, want)
        np.testing.assert_array_equal(scen[i]["key"], reference[f"refusals/key_after_try{i}"])
    assert tries[0].startswith("ValueError: overload events meter")
    assert tries[1].startswith("NotImplementedError")
    assert tries[3].startswith("ValueError: the cluster carries overload feedback")
    for i in (2, 5):
        assert_same_scenario(reference, BY_NAME["refusals"], i, scen[i])


def test_refusal_draws_no_key():
    c = SimCluster(N, SwimParams(**LEAN), seed=11, device="cpu")
    before = c.key.clone()
    with pytest.raises(ValueError, match="overload events meter"):
        c.run_scenario(OV_SPEC)
    with pytest.raises(ValueError, match="overload events meter"):
        c.run_scenario(OV_SPEC, segment_ticks=4)
    assert torch.equal(c.key, before)


def test_overload_config_and_update_in_window():
    """The update with a host window flag equals the one with a bool
    array, in and out of the window."""
    cfg = tfaults.overload_config(ScenarioSpec.from_dict(OV_SPEC))
    rng = np.random.default_rng(0)
    press = rng.integers(0, 9, N).astype(np.int32)
    gray = rng.integers(0, 2, N).astype(bool)
    sends = rng.integers(0, 6, N).astype(np.int32)
    for win in (True, False):
        a = tfaults.overload_update(cfg, win, torch.from_numpy(press), torch.from_numpy(gray),
                                    torch.from_numpy(sends))
        b = tfaults.overload_update(cfg, np.array(win), press, gray, sends)
        assert np.array_equal(a[0].numpy(), b[0]) and np.array_equal(a[1].numpy(), b[1])
