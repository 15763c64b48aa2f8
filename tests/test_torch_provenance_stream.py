"""The port's provenance plane streamed, resumed and swept, against the
JAX reference.

``tests/test_provenance.py``'s traced scenario (N = 10, ``LEAN``, K = 3)
runs on both sides (the reference's in a child process) whole, streamed
in 7-tick segments, and killed right after its first checkpoint and
resumed; every run's planes, trace, state, net and key must equal the
reference's whole run, and a streamed run's stat calls (replayed slab by
slab into a ``CaptureEmitter`` sink, closing with the checksum gauge)
the whole run's.  The checkpoint carries the planes between the
packages: the port finishes the reference's killed run, and the
reference finishes the port's.  A traced ``run_sweep`` of two replicas
gives each replica its own planes (``final_nets[r].pv_*``, ``pv_heard``
[R, T, K]); each equals the standalone run from its replica key.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from test_torch_harness import (
    assert_same_provenance,
    assert_same_scenario,
    assert_same_stats,
    assert_same_sweep,
    port_cluster,
    run_port,
    run_reference,
    scenario_record,
)
from test_torch_provenance import LEAN, N, PV_SPEC

from ringpop_tpu_torch.scenarios import stream as tstream

SEG = {"segment_ticks": 7}
SOAK = {**SEG, "checkpoint": True, "interrupt_after": 1}
BASE = {"n": N, "params": LEAN, "seed": 7}
PORT_LEFT = {"name": "port_left", **BASE,
             "ops": [["run_streamed", PV_SPEC, {**SOAK, "resume": False}]]}
CASES = [
    {"name": "whole", **BASE, "stats": True,
     "ops": [["run_scenario", PV_SPEC], ["provenance"], ["stats"]]},
    {"name": "streamed", **BASE, "stats": True,
     "ops": [["run_streamed", PV_SPEC, SEG], ["provenance"], ["stats"]]},
    {"name": "soak", **BASE, "ops": [["run_streamed", PV_SPEC, SOAK], ["provenance"]]},
    {"name": "left", **BASE, "ops": [["run_streamed", PV_SPEC, {**SOAK, "resume": False}]]},
    {"name": "sweep", **BASE, "ops": [["run_sweep", PV_SPEC, 2, {}]]},
]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's runs, then the reference's, which also finishes the
    checkpoint the port's killed run left (``finish``)."""
    tmp = str(tmp_path_factory.mktemp("provenance_stream"))
    port = {}
    for c in [*CASES, PORT_LEFT]:
        scen: dict[int, dict] = {}
        run_port(c, scenarios=scen, tmp_dir=tmp)
        port[c["name"]] = scen
    finish = {"name": "finish", **BASE, "ops": [["resume_checkpoint", port["port_left"][0]["ckpt"]]]}
    ref_dir = os.path.join(tmp, "reference")
    os.makedirs(ref_dir)
    return run_reference([*CASES, finish], ref_dir), port, finish


def test_whole_run_matches_reference(runs):
    reference, port, _ = runs
    assert_same_scenario(reference, BY_NAME["whole"], 0, port["whole"][0])


@pytest.mark.parametrize("name", ["streamed", "soak"])
def test_streamed_and_resumed_equal_the_whole_run(runs, name):
    """Streamed in segments (and killed and resumed): the reference's
    whole run, planes, trace, state, net and key; and its report."""
    reference, port, _ = runs
    assert_same_scenario(reference, BY_NAME[name], 0, port[name][0])
    assert_same_scenario(reference, BY_NAME["whole"], 0, port[name][0])
    assert_same_provenance(reference, BY_NAME["whole"], 1, port[name][1])


def test_streamed_stats_equal_the_whole_runs(runs):
    """Slab by slab, the sink gets the whole run's stat calls."""
    reference, port, _ = runs
    assert_same_stats(reference, BY_NAME["streamed"], 2, port["streamed"][2])
    assert_same_stats(reference, BY_NAME["whole"], 2, port["streamed"][2])


def test_port_finishes_reference_checkpoint(runs):
    """The port resumes the planes the reference's killed run
    checkpointed and reaches the reference's whole run."""
    reference, _, _ = runs
    cluster, trace = tstream.resume(str(reference["left/ckpt0"]), device="cpu")
    assert cluster.net.pv_knows.dtype == torch.int64
    assert_same_scenario(reference, BY_NAME["whole"], 0,
                         scenario_record(cluster, BY_NAME["whole"], trace))


def test_reference_finishes_port_checkpoint(runs):
    """The reference resumes the port's checkpoint (its planes, knows
    words as uint32) and reaches its own whole run."""
    reference, port, finish = runs
    got = {k[len("finish/sc0/"):]: v for k, v in reference.items()
           if k.startswith("finish/sc0/")}
    want = {k[len("whole/sc0/"):]: v for k, v in reference.items()
            if k.startswith("whole/sc0/")}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_sweep_matches_reference(runs):
    reference, port, _ = runs
    assert_same_sweep(reference, BY_NAME["sweep"], 0, port["sweep"][0])
    assert port["sweep"][0]["trace"]["p.pv_heard"].shape == (2, PV_SPEC["ticks"], 3)


def test_sweep_replicas_equal_standalone_runs():
    """Replica r of a traced sweep equals ``run_scenario`` from its replica
    key (pv_heard and every plane); the cluster itself carries no planes
    after it, and the streamed sweep is the same sweep."""
    c = port_cluster(BY_NAME["sweep"])
    sw = c.run_sweep(PV_SPEC, 2)
    assert c.net.pv_slot is None
    sw.summary()  # the pv planes are left out of the summary
    streamed = port_cluster(BY_NAME["sweep"]).run_sweep(PV_SPEC, 2, segment_ticks=5)
    np.testing.assert_array_equal(streamed.planes["pv_heard"], sw.planes["pv_heard"])
    for r in range(2):
        d = port_cluster(BY_NAME["sweep"])
        d.key = torch.as_tensor(sw.replica_keys[r].astype(np.int64))
        td = d.run_scenario(PV_SPEC)
        np.testing.assert_array_equal(sw.planes["pv_heard"][r], td.planes["pv_heard"])
        for f in ("pv_slot", "pv_tickv", "pv_wits", "pv_first", "pv_parent", "pv_knows"):
            assert torch.equal(getattr(sw.final_nets[r], f), getattr(d.net, f)), f
            assert torch.equal(getattr(streamed.final_nets[r], f), getattr(d.net, f)), f
