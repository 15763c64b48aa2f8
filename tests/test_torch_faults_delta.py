"""The port's fault model on the delta backend against the JAX reference.

The delta twin of ``test_torch_faults.py``, over four files (one
reference child process a lowering each, side by side): this one holds
link loss with gray periods and a kill, and the guards of the delta
fault surface; ``_delay.py`` delay with jitter; ``_mixed.py`` every
family and a partition at once; ``_period.py`` a period row of P
against ``phase_mod = P``.  Each scenario runs through each side's
``run_host_loop`` at ample caps (capacity = wire = N, grid = 3N^2,
where the delta step is the dense one) and at tight caps (capacity 4,
wire 2, grid 4, where tables overflow and matured lanes are cut at the
claim grid).  After every segment every ``DeltaState`` field (the
in-flight lanes ``pend_*`` included), the net's fault fields and every
metric must be equal, and the checksums.

The tight cases run under both reference lowerings (the XLA default
and the Pallas kernels that kernels 3 and 4 replace); the ample cases
under the default lowering only: the Pallas lowering runs in interpret
mode on the CPU, where one 25-tick ample case takes over six minutes.
"""

from __future__ import annotations

import numpy as np
import pytest

from test_torch_faults import FAST, N
from test_torch_harness import (
    DELTA_LOWERINGS,
    assert_same_trajectory,
    run_port,
    run_references,
    snapshot,
)

AMPLE = {"capacity": N, "wire_cap": N, "claim_grid": 3 * N * N}
TIGHT = {"capacity": 4, "wire_cap": 2, "claim_grid": 4}
LINK_GRAY = {
    "ticks": 25,
    "events": [
        {"at": 2, "op": "link_loss", "src": [0, 1, 2], "dst": [5, 6, 7], "p": 0.8,
         "until": 18},
        {"at": 3, "op": "gray", "node": 3, "factor": 5, "until": 20},
        {"at": 5, "op": "kill", "node": 9},
    ],
}


def scenario_cases(name: str, spec: dict) -> list[dict]:
    """The scenario at ample caps (default lowering) and tight caps (both)."""
    return [
        {"name": f"{name}_ample", "n": N, "backend": "delta", "params": FAST, "seed": 7,
         "caps": AMPLE, "checksums": True, "ops": [["run_host_loop", spec]],
         "lowerings": ["default"]},
        {"name": f"{name}_tight", "n": N, "backend": "delta", "params": FAST, "seed": 7,
         "caps": TIGHT, "checksums": True, "ops": [["run_host_loop", spec]]},
    ]


def parity_checks(cases: list[dict], tag: str) -> dict:
    """The fixtures and parity tests of a file of delta fault cases: the
    references (one child a lowering), the port's runs, and per (lowering,
    case) the trajectory and the checksums after every segment."""
    by_name = {c["name"]: c for c in cases}
    pairs = [(lw, c["name"]) for c in cases for lw in c.get("lowerings", DELTA_LOWERINGS)]

    @pytest.fixture(scope="module")
    def reference(tmp_path_factory):
        return run_references(cases, str(tmp_path_factory.mktemp(tag)), DELTA_LOWERINGS)

    @pytest.fixture(scope="module")
    def port_runs():
        """(records, tries, checksums after every segment) per case."""
        out = {}
        for c in cases:
            tries: dict[int, str] = {}
            sums: list[dict[str, int]] = []
            hook = (lambda t, cl, s=sums: s.append(cl.checksums())) if c.get("checksums") else None
            out[c["name"]] = (run_port(c, on_tick=hook, tries=tries), tries, sums)
        return out

    @pytest.mark.parametrize("lowering,name", pairs)
    def test_trajectory(reference, port_runs, lowering, name):
        """Every state field, net fault field and metric after every segment."""
        assert_same_trajectory(reference[lowering], by_name[name], port_runs[name][0])

    @pytest.mark.parametrize("lowering,name", [p for p in pairs if by_name[p[1]].get("checksums")])
    def test_checksums(reference, port_runs, lowering, name):
        """The membership checksums after every segment, the last included."""
        ref = reference[lowering]
        sums = port_runs[name][2]
        assert sums
        for t, got in enumerate(sums):
            want = dict(zip(ref[f"{name}/ck{t}_addr"].tolist(),
                            (int(v) for v in ref[f"{name}/ck{t}_val"])))
            assert got == want, (name, t)

    return {"reference": reference, "port_runs": port_runs,
            "test_trajectory": test_trajectory, "test_checksums": test_checksums,
            "BY_NAME": by_name}


def metric(ref: dict, name: str, key: str) -> list[int]:
    return [int(v) for k, v in ref.items() if k.startswith(f"{name}/m") and k.endswith(f"/{key}")]


CASES = scenario_cases("link_gray", LINK_GRAY) + [
    # the delta half of the reference's test_cluster_fault_surface_guards:
    # a standing depth that the spec's does not match is refused before
    # any key is drawn
    {"name": "guards", "n": 4, "backend": "delta", "params": FAST, "seed": 0,
     "caps": {"capacity": 4, "wire_cap": 16, "claim_grid": 64},
     "ops": [
         ["try", "enable_delay", 1],
         ["enable_delay", 4],
         ["try", "enable_delay", 5],
         ["try", "run_host_loop", {"ticks": 6, "events": [
             {"at": 1, "op": "delay", "src": [0], "dst": [1], "delay": 2}]}],
         ["try", "set_link_rules", np.ones((1, 4), bool).tolist(),
          np.ones((1, 4), bool).tolist(), [0.0], [3], [1]],
         ["set_link_rules", np.ones((1, 4), bool).tolist(),
          np.ones((1, 4), bool).tolist(), [0.5], [2], [1]],
         ["tick", 1],
     ]},
]
globals().update(parity_checks(CASES, "faults_delta_ref"))


def test_guard_errors(reference, port_runs):
    """Each guarded call raises the reference's exception type and
    message; the refused host loop drew no key; the lanes have the
    reference's shape (D slots of 2(D - 1) lanes)."""
    for lowering in DELTA_LOWERINGS:
        ref = reference[lowering]
        want = {int(k.rsplit("try", 1)[1]): str(v) for k, v in ref.items()
                if k.startswith("guards/try")}
        assert port_runs["guards"][1] == want
        assert all(want.values()), want
        # the first tick drew the cluster's first key: nothing drew before it
        np.testing.assert_array_equal(ref["guards/key0"], np.array([0, 0], np.uint32))
        assert snapshot(ref, "guards", "pend_subj", 1).shape[:2] == (4, 6)


def test_gray_probes_less(reference):
    for name in ("link_gray_ample", "link_gray_tight"):
        assert min(metric(reference["default"], name, "pings_sent")) < N, name
