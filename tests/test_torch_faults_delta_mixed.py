"""The delta fault model against the reference: every family at once.

Companion of ``test_torch_faults_delta.py`` (its checks, this file's
cases): ``MIXED`` (one-way link loss, a gray node, a flap, a rolling
restart, delay with jitter and a partition with its heal) at ample and
at tight caps.
"""

from __future__ import annotations

from test_torch_faults import MIXED, N
from test_torch_faults_delta import parity_checks, scenario_cases
from test_torch_harness import snapshot

CASES = scenario_cases("mixed", MIXED)
globals().update(parity_checks(CASES, "faults_delta_mixed_ref"))


def test_mixed_parks_claims(reference):
    """Some segment of each run ends with claims parked in the lanes."""
    for name in ("mixed_ample", "mixed_tight"):
        ref = reference["default"]
        ends = len([k for k in ref if k.startswith(f"{name}/key")])
        parked = [snapshot(ref, name, "pend_recv", k) for k in range(1, ends + 1)]
        assert any((p < N).any() for p in parked), name
