"""The port's delta-backend scenario sweep against the JAX reference.

One delta sweep at n = 16 with R = 2 (loss scales and kill jitter) runs
on both sides (the reference's in a child process, under its default
lowering): every replica's series, final state fields (the uint32
planes with their dtype) and net, the replica keys and the cluster key
after it must be equal.  The port's streamed sweep (7-tick segments,
with and without a store) must equal its unsegmented one.  The
reference compiles each segment length anew, so its streamed delta
sweep is left to the port's own comparison.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_harness import assert_same_sweep, port_cluster, run_port, run_reference
from test_torch_sweep import SPEC, _same_sweeps

N = 16
CAPS = {"capacity": 8, "wire_cap": 4, "claim_grid": 16}
AXES = {"loss_scales": [1.0, 2.0], "kill_jitter": [0, 3]}
CASE = {"name": "delta", "n": N, "params": {"suspicion_ticks": 4, "loss": 0.02}, "seed": 9,
        "backend": "delta", "caps": CAPS, "ops": [["run_sweep", SPEC, 2, AXES]]}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference([CASE], str(tmp_path_factory.mktemp("sweep_delta_ref")))


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    recs: dict[int, dict] = {}
    run_port(CASE, scenarios=recs, tmp_dir=str(tmp_path_factory.mktemp("swd")))
    return recs


def test_delta_sweep_matches_reference(reference, port_run):
    assert_same_sweep(reference, CASE, 0, port_run[0])


@pytest.mark.parametrize("store", [False, True])
def test_delta_streamed_sweep_equals_whole(tmp_path, store):
    a = port_cluster(CASE)
    whole = a.run_sweep(SPEC, 2, **AXES)
    b = port_cluster(CASE)
    got = b.run_sweep(SPEC, 2, **AXES, segment_ticks=7,
                      store=str(tmp_path / "store") if store else None)
    _same_sweeps(whole, got)
    assert torch.equal(a.key, b.key)
    # the base loss is scaled per replica
    assert np.float32(got.loss[1, 0]) == np.float32(0.02 * 2.0)
