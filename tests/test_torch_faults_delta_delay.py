"""The delta fault model against the reference: delay with jitter.

Companion of ``test_torch_faults_delta.py`` (its checks, this file's
cases): the reference's delay scenario at ample caps, and, at tight
caps under both lowerings, every link delayed around a kill with a
boundary at every tick (``DELAY_EACH_TICK`` of ``test_torch_faults.py``),
so that each tick's metrics are recorded and each tick is also stepped
alone from the reference's own state, net and key.
"""

from __future__ import annotations

import pytest

from test_torch_faults import DELAY, DELAY_EACH_TICK, FAST, N
from test_torch_faults_delta import TIGHT, metric, parity_checks, scenario_cases
from test_torch_harness import DELTA_LOWERINGS, assert_steps_from_reference, run_port

CASES = scenario_cases("delay", DELAY)[:1] + [
    # a claim grid of 2 (two sender rows a receiver): matured lanes overflow it
    {"name": "delay_each_tick", "n": N, "backend": "delta", "params": FAST, "seed": 7,
     "caps": {**TIGHT, "claim_grid": 2}, "checksums": True,
     "ops": [["run_host_loop", DELAY_EACH_TICK]]},
]
globals().update(parity_checks(CASES, "faults_delta_delay_ref"))


@pytest.mark.parametrize("lowering", list(DELTA_LOWERINGS))
def test_each_tick_from_reference_states(reference, lowering):
    """``delta_step_impl`` stepped alone from the reference's state, net
    and key before every one-tick segment."""
    assert assert_steps_from_reference(reference[lowering], BY_NAME["delay_each_tick"]) >= 20


def test_claims_delayed_matured_and_cut(reference, monkeypatch):
    """Claims park and mature on every lowering; at tight caps the
    matured lanes overflow the claim grid (``mat_late``), which the
    port counts in ``claims_dropped`` as the reference does."""
    for lowering in DELTA_LOWERINGS:
        ref = reference[lowering]
        assert sum(metric(ref, "delay_each_tick", "delayed_claims")) > 0
        assert sum(metric(ref, "delay_each_tick", "matured_applied")) > 0
    from ringpop_tpu_torch.models import swim_delta as tdelta

    late = []
    real = tdelta._mature_lanes

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        late.append(int(out[2]))
        return out

    monkeypatch.setattr(tdelta, "_mature_lanes", spy)
    run_port(BY_NAME["delay_each_tick"])
    assert sum(late) > 0
