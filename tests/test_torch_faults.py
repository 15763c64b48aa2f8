"""The port's fault model on the dense backend against the JAX reference.

Every family of the reference's failure model (``tests/test_faults.py``'s
parity cases, at its N = 10 and ``SwimParams(suspicion_ticks=8)``) runs
through the scenario host loop on both sides: the reference's
``scenarios.runner.run_host_loop`` in a child process, the port's
``ringpop_tpu_torch.scenarios.runner.run_host_loop`` here.  After every
segment the loop ticks, every ``ClusterState`` field (the in-flight
buffer ``pending`` included), the net's fault fields the segment ran
under and every metric must be equal, and the membership checksums at
the end.

- directed link loss with asymmetry, gray periods, a flap storm, a
  rolling restart, delay with jitter and loss, and ``MIXED`` (every
  family and a partition at once);
- a period row of P against ``phase_mod = P``;
- the guards of ``SimCluster``'s fault surface, with the reference's
  exception types and messages.
"""

from __future__ import annotations

import numpy as np
import pytest

from test_torch_harness import (
    assert_same_trajectory,
    run_port,
    run_reference,
    snapshot,
)

N = 10
FAST = {"suspicion_ticks": 8}

LINK_LOSS = {
    "ticks": 25,
    "events": [
        {"at": 2, "op": "link_loss", "src": [0, 1, 2], "dst": [5, 6, 7], "p": 0.8,
         "until": 18},
        {"at": 4, "op": "link_loss", "src": [5], "dst": [0], "p": 0.5},
    ],
}
GRAY = {
    "ticks": 25,
    "events": [
        {"at": 2, "op": "gray", "node": 3, "factor": 5, "until": 20},
        {"at": 5, "op": "gray", "nodes": [6, 7], "factor": 3},
    ],
}
FLAP = {
    "ticks": 24,
    "events": [
        {"at": 2, "op": "flap", "nodes": [8, 9], "until": 15, "down": 2, "up": 3,
         "stagger": 1},
    ],
}
ROLLING = {
    "ticks": 24,
    "events": [
        {"at": 2, "op": "rolling_restart", "nodes": [5, 6, 7], "down": 2, "every": 3},
    ],
}
DELAY = {
    "ticks": 25,
    "events": [
        {"at": 2, "op": "delay", "src": [0, 1, 2, 3], "dst": [4, 5, 6, 7], "delay": 2,
         "jitter": 2, "until": 20},
        {"at": 3, "op": "loss", "p": 0.05},
    ],
}
MIXED = {
    "ticks": 30,
    "events": [
        {"at": 2, "op": "link_loss", "src": [0, 1], "dst": [4, 5], "p": 0.9, "until": 20},
        {"at": 3, "op": "gray", "node": 2, "factor": 4, "until": 25},
        {"at": 4, "op": "flap", "node": 7, "until": 16, "down": 2, "up": 3},
        {"at": 5, "op": "rolling_restart", "nodes": [8, 9], "down": 2, "every": 4},
        {"at": 6, "op": "delay", "src": [3], "dst": [6], "delay": 2, "jitter": 1,
         "until": 22},
        {"at": 10, "op": "partition", "groups": [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]]},
        {"at": 18, "op": "heal"},
    ],
}
# Every link delayed, a kill, and a loss event (of the value in force)
# at every tick: each segment of the host loop is then one tick, so the
# metrics of every tick are recorded (a segment of k ticks reports its
# last tick's), and the kill's rumors travel mostly in the buffer, so
# matured claims apply
DELAY_EACH_TICK = {
    "ticks": 25,
    "events": [
        {"at": 2, "op": "delay", "src": list(range(N)), "dst": list(range(N)), "delay": 1,
         "jitter": 2, "until": 20},
        {"at": 3, "op": "kill", "node": 5},
    ] + [{"at": t, "op": "loss", "p": 0.05} for t in range(3, 25)],
}
FAMILIES = {"link_loss": LINK_LOSS, "gray": GRAY, "flap": FLAP, "rolling": ROLLING,
            "delay": DELAY, "mixed": MIXED, "delay_each_tick": DELAY_EACH_TICK}

P = 4
ONES = np.ones((1, 4), bool).tolist()

CASES = [
    {"name": name, "n": N, "params": FAST, "seed": 7, "checksums": True,
     "ops": [["run_host_loop", spec]]}
    for name, spec in FAMILIES.items()
] + [
    # a period row of P reproduces phase_mod = P value for value
    {"name": "phase_mod", "n": N, "params": {"suspicion_ticks": 32, "phase_mod": P},
     "seed": 5, "checksums": True, "ops": [["tick", 1]] * 20},
    {"name": "period_row", "n": N, "params": {"suspicion_ticks": 32}, "seed": 5,
     "checksums": True, "ops": [["set_period", [P] * N]] + [["tick", 1]] * 20},
    # the fault surface's guards (the reference's test_cluster_fault_surface_guards)
    {"name": "guards", "n": 4, "params": FAST, "seed": 0,
     "ops": [
         ["try", "set_link_rules", ONES, ONES, [0.0], [2], [0]],
         ["try", "enable_delay", 1],
         ["try", "set_link_rules", [True] * 4, ONES, [0.5]],
         ["try", "set_link_rules", np.ones((1, 3), bool).tolist(),
          np.ones((1, 3), bool).tolist(), [0.5]],
         ["try", "set_period", [1, 2, 3]],
         ["enable_delay", 3],
         ["try", "enable_delay", 4],
         ["try", "set_link_rules", ONES, ONES, [0.0], [2], [1]],
         ["set_link_rules", ONES, ONES, [0.25], [1], [1]],
         ["tick", 1],
         ["set_period", [1, 2, 3, 1]],
         ["tick", 2],
         ["clear_link_rules"],
         ["clear_overload"],
         ["set_period", None],
         ["tick", 1],
     ]},
    {"name": "guards_phase_mod", "n": 4, "params": {**FAST, "phase_mod": 2}, "seed": 0,
     "ops": [["try", "set_period", [1, 1, 1, 1]]]},
]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("faults_ref")))


@pytest.fixture(scope="module")
def port_runs():
    """(records, tries, checksums after every tick) per case."""
    out = {}
    for c in CASES:
        tries: dict[int, str] = {}
        sums: list[dict[str, int]] = []
        hook = (lambda t, cl: sums.append(cl.checksums())) if c.get("checksums") else None
        out[c["name"]] = (run_port(c, on_tick=hook, tries=tries), tries, sums)
    return out


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_trajectory(reference, port_runs, name):
    """Every state field, net fault field and metric after every segment."""
    assert_same_trajectory(reference, BY_NAME[name], port_runs[name][0])


@pytest.mark.parametrize("name", [*FAMILIES, "phase_mod", "period_row"])
def test_checksums(reference, port_runs, name):
    """The membership checksums after every segment, the last included."""
    _, _, sums = port_runs[name]
    assert sums
    for t, got in enumerate(sums):
        want = dict(zip(reference[f"{name}/ck{t}_addr"].tolist(),
                        (int(v) for v in reference[f"{name}/ck{t}_val"])))
        assert got == want, (name, t)


def test_guard_errors(reference, port_runs):
    """Each guarded call raises the reference's exception type and
    message, or nothing where the reference raises nothing."""
    for name in ("guards", "guards_phase_mod"):
        _, tries, _ = port_runs[name]
        want = {int(k.rsplit("try", 1)[1]): str(v) for k, v in reference.items()
                if k.startswith(f"{name}/try")}
        assert tries == want, name
        assert all(want.values()), want  # every guarded call raised


def test_period_row_is_phase_mod(port_runs):
    """A row of P and ``phase_mod = P`` give the same state on every tick."""
    a = port_runs["phase_mod"][0]
    b = port_runs["period_row"][0]
    for t, (ra, rb) in enumerate(zip(a, b)):
        for f in ("view_key", "pb", "suspect_left", "tick"):
            np.testing.assert_array_equal(ra[f], rb[f], err_msg=f"{f} at {t}")
        assert ra["metrics"] == rb["metrics"], t


def test_cases_exercise_their_arms(reference):
    """The families do what they are for: loss rules installed and
    zeroed after their window, gray nodes probing less, the buffer
    delaying and maturing claims, the flap and restarts killing nodes."""
    ref = reference

    def metric(name, key):
        return [int(v) for k, v in sorted(ref.items()) if k.startswith(f"{name}/m")
                and k.endswith(f"/{key}")]

    assert "link_loss/net1/link_p" in ref
    assert ref["link_loss/net1/link_p"].max() > 0
    assert min(metric("gray", "pings_sent")) < N
    assert len(metric("delay_each_tick", "acks")) == 24  # a record a tick after tick 1
    assert sum(metric("delay_each_tick", "delayed_claims")) > 0
    assert sum(metric("delay_each_tick", "matured_applied")) > 0
    ends = len(metric("delay_each_tick", "acks"))
    pend = [snapshot(ref, "delay_each_tick", "pending", k) for k in range(1, ends + 1)]
    assert any(p is not None and p.any() for p in pend)
    ups = [ref[k] for k in sorted(ref) if k.startswith("flap/up")]
    assert any(not u.all() for u in ups)
