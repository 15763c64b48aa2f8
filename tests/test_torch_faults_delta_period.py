"""The delta fault model against the reference: periods and phase_mod.

Companion of ``test_torch_faults_delta.py`` (its checks, this file's
cases): a period row of P set through ``SimCluster.set_period``, and
``SwimParams.phase_mod = P``, each for 20 ticks at ample caps, against
the reference, and against each other.
"""

from __future__ import annotations

import numpy as np

from test_torch_faults import N
from test_torch_faults_delta import AMPLE, parity_checks

P = 4
CASES = [
    {"name": "phase_mod", "n": N, "backend": "delta",
     "params": {"suspicion_ticks": 32, "phase_mod": P}, "seed": 5, "caps": AMPLE,
     "checksums": True, "ops": [["tick", 1]] * 20, "lowerings": ["default"]},
    {"name": "period_row", "n": N, "backend": "delta", "params": {"suspicion_ticks": 32},
     "seed": 5, "caps": AMPLE, "checksums": True,
     "ops": [["set_period", [P] * N]] + [["tick", 1]] * 20, "lowerings": ["default"]},
]
globals().update(parity_checks(CASES, "faults_delta_period_ref"))


def test_period_row_is_phase_mod(port_runs):
    a = port_runs["phase_mod"][0]
    b = port_runs["period_row"][0]
    for t, (ra, rb) in enumerate(zip(a, b)):
        for f in ("d_subj", "d_key", "d_pb", "d_sl", "digest", "tick"):
            np.testing.assert_array_equal(ra[f], rb[f], err_msg=f"{f} at {t}")
        assert ra["metrics"] == rb["metrics"], t
