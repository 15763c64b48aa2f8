"""The port's gossip provenance plane on the delta backend against the JAX
reference.

``SimCluster(backend="delta").run_scenario`` with ``trace_rumors`` runs
on both sides (the reference's in a child process, its default
lowering): ``tests/test_provenance.py``'s scenario at ample caps (its
delta twin), and the chaos scenario of ``test_torch_provenance.py`` at
tight caps (claims dropped at the wire and the table) with its delay
rule (a full sync's flip lands in-tick over a delayed link, so the delta
bundle's ack edges include it).  After each
run every ``pv_*`` plane, ``pv_heard``, every series, the state, the net
and the key must be equal, and so must the report, its summary block and
the spans file.  The fold's post-tick views come from ``view_lookup``,
which runs the row-searchsorted kernel on the card.  The port's per-tick
host walk over ``delta_step_impl(prov=True)`` equals its
``run_scenario``.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import pytest
import torch

from test_torch_harness import (
    assert_same_provenance,
    assert_same_scenario,
    run_port,
    run_reference,
)
from test_torch_provenance import CHAOS, LEAN, N, PV_SPEC

from ringpop_tpu_torch.models import swim_delta as tdelta
from ringpop_tpu_torch.models.cluster import SimCluster
from ringpop_tpu_torch.models.swim_sim import SwimParams
from ringpop_tpu_torch.obs import provenance as pvn
from ringpop_tpu_torch.scenarios import compile as scompile
from ringpop_tpu_torch.scenarios.spec import ScenarioSpec

AMPLE = {"capacity": N, "wire_cap": N, "claim_grid": 3 * N * N}
TIGHT = {"capacity": 4, "wire_cap": 2, "claim_grid": 8}

CASES = [
    {"name": "ample", "n": N, "params": LEAN, "seed": 11, "backend": "delta", "caps": AMPLE,
     "ops": [["run_scenario", PV_SPEC], ["provenance"]]},
    {"name": "tight", "n": 16, "params": {"suspicion_ticks": 4}, "seed": 5, "backend": "delta",
     "caps": TIGHT, "ops": [["run_scenario", CHAOS], ["provenance"]]},
]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("provenance_delta_ref")))


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("provenance_delta_port"))
    out = {}
    for c in CASES:
        scen: dict[int, dict] = {}
        run_port(c, scenarios=scen, tmp_dir=tmp)
        out[c["name"]] = scen
    return out


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_traced_delta_run_matches_reference(reference, port_runs, name):
    """Every pv_* plane, pv_heard, every series, the state, the net, the
    key, the loss and the log entry equal."""
    assert_same_scenario(reference, BY_NAME[name], 0, port_runs[name][0])


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_delta_report_and_spans_match_reference(reference, port_runs, name):
    """The report, the summary block, ``emit_provenance`` and the spans
    file equal the reference's; the killed node's rumor confirmed."""
    assert_same_provenance(reference, BY_NAME[name], 1, port_runs[name][1])
    rumors = port_runs[name][1]["report"]["rumors"]
    assert any(r["resolution"] == pvn.RES_CONFIRMED for r in rumors)


def test_delta_host_walk_matches_run_scenario():
    """The port's per-tick walk over ``delta_step_impl(prov=True)``, each
    bundle folded with ``view_lookup`` post-views, equals its
    ``run_scenario``."""
    a = SimCluster(N, SwimParams(**LEAN), seed=11, device="cpu", backend="delta", **AMPLE)
    trace = a.run_scenario(PV_SPEC)
    spec = ScenarioSpec.from_dict(PV_SPEC)
    b = SimCluster(N, SwimParams(**LEAN), seed=11, device="cpu", backend="delta", **AMPLE)
    compiled = scompile.compile_spec(spec, b.n, base_loss=b.params.loss, device="cpu")
    keys = scompile.key_schedule(b._split, compiled)
    pvc = pvn.init_carry(b.n, spec.trace_rumors, LEAN["ping_req_size"], device="cpu")
    pv_at, pv_node = pvn.track_tensors(compiled.tracks, spec.trace_rumors)
    by_tick = defaultdict(list)
    for at, op, arg in scompile.expand_events(spec, b.params.loss):
        by_tick[at].append((op, arg))
    heards = []
    for t in range(spec.ticks):
        for op, arg in by_tick.get(t, ()):
            if op == "kill":
                b.kill(arg)
        b.state, m = tdelta.delta_step_impl(b.state, b.net, keys[t], b.dparams, prov=True)
        ev = {k: m[k] for k in pvn.EVIDENCE_KEYS}
        pvc, heard = pvn.prov_update(pvc, ev, t, lambda q: tdelta.view_lookup(b.state, q),
                                     pv_at, pv_node, b.n)
        heards.append(heard.numpy())
    np.testing.assert_array_equal(trace.planes["pv_heard"], np.stack(heards))
    for f in pvn.ProvCarry._fields:
        assert torch.equal(getattr(a.net, f"pv_{f}"), getattr(pvc, f)), f
    assert a.checksums() == b.checksums()


def test_prov_needs_the_full_step():
    """``prov`` with a truncated step raises the reference's error."""
    c = SimCluster(N, SwimParams(**LEAN), seed=1, device="cpu", backend="delta", **AMPLE)
    with pytest.raises(ValueError, match="upto=7"):
        tdelta.delta_step_impl(c.state, c.net, c._split(), c.dparams, upto=5, prov=True)
