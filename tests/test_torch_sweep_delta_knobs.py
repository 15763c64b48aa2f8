"""The port's delta-backend knob sweep against the JAX reference.

A ``param_axes`` sweep over ``suspicion_ticks`` and
``piggyback_factor`` at n = 12 with R = 2 (the reference's
``test_delta_sweep_param_axes_replica_parity``) runs on both sides (the
reference's in a child process, under its default lowering): every
replica's series, final state and net, the replica keys and the
cluster key after it equal.  Each replica equals its standalone
``run_scenario(param_knobs=replica_param_knobs(axes, r))`` on the port.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_harness import assert_same_sweep, port_cluster, run_port, run_reference
from test_torch_param_knobs import SPEC
from test_torch_param_knobs_delta import DELTA

from ringpop_tpu_torch.scenarios import sweep as tsweep

AXES = {"suspicion_ticks": [5, 10], "piggyback_factor": [3, 5]}
CASE = {**DELTA, "name": "sweep", "ops": [["run_sweep", SPEC, 2, {"param_axes": AXES}]]}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference([CASE], str(tmp_path_factory.mktemp("sweep_delta_knobs_ref")))


def test_delta_param_axes_sweep_matches_reference(reference, tmp_path):
    recs: dict[int, dict] = {}
    run_port(CASE, scenarios=recs, tmp_dir=str(tmp_path))
    assert_same_sweep(reference, CASE, 0, recs[0])


def test_delta_sweep_replicas_equal_standalone_runs():
    from ringpop_tpu_torch import convert

    strace = port_cluster(DELTA).run_sweep(SPEC, 2, param_axes=AXES)
    for r in range(2):
        c = port_cluster(DELTA)
        c.key = convert.key_from_numpy(strace.replica_keys[r])
        trace = c.run_scenario(SPEC, param_knobs=tsweep.replica_param_knobs(AXES, r))
        for k, v in trace.to_arrays().items():
            assert np.array_equal(v, strace.replica(r).to_arrays()[k]), (r, k)
        for f, x in c.state._asdict().items():
            y = getattr(strace.final_states[r], f)
            assert (x is None and y is None) or torch.equal(x, y), (r, f)
