"""The port's streamed scenario runner (``scenarios/stream.py``) and its
segment store, against its own unsegmented run and against the JAX
reference.

- A streamed run at segment sizes 1, 7 and the whole horizon equals the
  unsegmented ``run_scenario`` (trace, state, net, key, log entry), on
  both backends, with and without pipelining.
- A run killed right after its first checkpoint and resumed equals the
  uninterrupted run, on both backends.
- On both sides (the reference's in a child process) the same
  interrupted soak is resumed by each side's ``resume``: the records
  must be equal.  A reference soak interrupted in the child and finished
  by the port's ``resume`` gives the reference's uninterrupted trace.
- The segment store and ``Trace`` on their own: round trips, lazy
  reading, truncation, refusals (``tests/test_stream.py``,
  ``tests/test_scenario.py``).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from test_torch_faults_delta import TIGHT
from test_torch_harness import (
    assert_same_scenario,
    port_cluster,
    run_port,
    run_reference,
    scenario_record,
)
from test_torch_scenario_compiled import FAST, N, SPEC

from ringpop_tpu_torch import checkpoint
from ringpop_tpu_torch.scenarios import runner as trunner
from ringpop_tpu_torch.scenarios import stream as tstream
from ringpop_tpu_torch.scenarios.trace import Trace
from ringpop_tpu_torch.stats import Histogram

DENSE = {"n": N, "params": FAST, "seed": 3}
DELTA = {**DENSE, "backend": "delta", "caps": TIGHT}
SOAK = {"segment_ticks": 7, "checkpoint": True, "interrupt_after": 1}

CASES = [
    # each side's streamed run, killed after its first checkpoint and resumed
    {"name": "soak", **DENSE, "ops": [["run_streamed", SPEC, SOAK]]},
    {"name": "soak_delta", **DELTA, "ops": [["run_streamed", SPEC, SOAK]]},
    # a soak the reference leaves interrupted, and its uninterrupted twin
    {"name": "left", **DENSE, "ops": [["run_streamed", SPEC, {**SOAK, "resume": False}]]},
    {"name": "whole", **DENSE, "ops": [["run_scenario", SPEC]]},
]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("stream_ref")))


def _same_clusters(a, b) -> None:
    for what in ("state", "net"):
        for f, x in getattr(a, what)._asdict().items():
            y = getattr(getattr(b, what), f)
            assert (x is None) == (y is None), (what, f)
            if x is not None:
                assert x.dtype == y.dtype and torch.equal(x, y), (what, f)
    assert torch.equal(a.key, b.key)
    assert a.params.loss == b.params.loss


def _same_traces(a: Trace, b: Trace) -> None:
    assert a.to_arrays().keys() == b.to_arrays().keys()
    for k, v in a.to_arrays().items():
        w = b.to_arrays()[k]
        assert v.dtype == w.dtype and np.array_equal(v, w), k
    assert a.meta() == b.meta()


@pytest.fixture(scope="module")
def whole():
    """The unsegmented run on each backend."""
    out = {}
    for name, case in (("dense", DENSE), ("delta", DELTA)):
        c = port_cluster(case)
        out[name] = (c, c.run_scenario(SPEC))
    return out


@pytest.mark.parametrize("backend", ["dense", "delta"])
@pytest.mark.parametrize("segment_ticks", [1, 7, SPEC["ticks"]])
def test_streamed_equals_whole(whole, backend, segment_ticks):
    """Any segment size gives the unsegmented run: trace, state, net, key,
    loss, ``traces`` and ``metrics_log``."""
    a, trace = whole[backend]
    b = port_cluster(DENSE if backend == "dense" else DELTA)
    before = trunner.dispatch_count()
    streamed = b.run_scenario(SPEC, segment_ticks=segment_ticks, pipeline=segment_ticks != 7)
    assert trunner.dispatch_count() - before == -(-SPEC["ticks"] // segment_ticks)
    _same_traces(trace, streamed)
    _same_clusters(a, b)
    assert b.traces == [streamed]
    assert b.metrics_log[-1] == a.metrics_log[-1]


@pytest.mark.parametrize("backend", ["dense", "delta"])
def test_interrupted_and_resumed_equals_whole(whole, backend, tmp_path):
    """Killed right after the first checkpoint, resumed from it: the
    uninterrupted run's trace, state, net and key; the completed prefix
    persisted; the finished checkpoint's cursor complete."""
    a, trace = whole[backend]
    b = port_cluster(DENSE if backend == "dense" else DELTA)
    ck = str(tmp_path / "soak.npz")
    with pytest.raises(tstream.StreamInterrupted):
        tstream.run_streamed(b, SPEC, segment_ticks=7, checkpoint_path=ck, interrupt_after=1)
    assert tstream.SegmentStore.open(ck + ".segments").ticks_stored >= 7
    mid = checkpoint.load(ck, device="cpu").stream_cursor
    assert mid["ticks_done"] == 7
    for field in ("run_id", "spec", "segment_ticks", "start_key", "base_loss", "store",
                  "checkpoint_every"):
        assert field in mid, field
    b2, resumed = tstream.resume(ck, device="cpu")
    _same_traces(trace, resumed)
    _same_clusters(a, b2)
    assert b2.metrics_log[-1] == a.metrics_log[-1]
    assert checkpoint.load(ck, device="cpu").stream_cursor["ticks_done"] == SPEC["ticks"]
    _, again = tstream.resume(ck, device="cpu")  # complete: reassembles from the store
    _same_traces(trace, again)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    out = {}
    for c in CASES[:2]:
        scen: dict[int, dict] = {}
        run_port(c, scenarios=scen, tmp_dir=str(tmp_path_factory.mktemp("stream_port")))
        out[c["name"]] = scen[0]
    return out


@pytest.mark.parametrize("name", ["soak", "soak_delta"])
def test_resumed_soak_matches_reference(reference, port_runs, name):
    """Each side's interrupted and resumed soak: equal records."""
    assert_same_scenario(reference, BY_NAME[name], 0, port_runs[name])


def test_port_finishes_reference_soak(reference):
    """The port resumes the checkpoint the reference's killed soak left
    (its state, cursor and segment store) and reaches the trace, state,
    net and key of the reference's uninterrupted run."""
    cluster, trace = tstream.resume(str(reference["left/ckpt0"]), device="cpu")
    assert_same_scenario(reference, BY_NAME["whole"], 0, scenario_record(cluster, DENSE, trace))


def test_pipelined_telemetry_off_and_on(whole):
    """``pipeline=False`` drains each segment before the next; same run."""
    a, trace = whole["dense"]
    b = port_cluster(DENSE)
    _same_traces(trace, b.run_scenario(SPEC, segment_ticks=9, pipeline=False))
    _same_clusters(a, b)


def test_store_memory_contract(tmp_path):
    """``assemble=False`` returns the store: every slab within a segment,
    the log entry from the last one."""
    c = port_cluster(DENSE)
    store = c.run_scenario(SPEC, segment_ticks=16, store=str(tmp_path / "st"), assemble=False)
    assert isinstance(store, tstream.SegmentStore)
    assert [s.ticks for s in store.iter_traces()] == [16, 16, 8]
    assert c.metrics_log[-1]["ticks"] == SPEC["ticks"] and c.traces == []


def test_stream_refusals_keep_the_key(tmp_path):
    """Refusals come before the key draw (tests/test_stream.py)."""
    store = str(tmp_path / "st")
    port_cluster(DENSE).run_scenario(SPEC, segment_ticks=20, store=store)
    c = port_cluster({**DENSE, "seed": 4})
    before = c.key.clone()
    with pytest.raises(ValueError, match="refusing to mix runs"):
        c.run_scenario(SPEC, segment_ticks=20, store=store)
    with pytest.raises(ValueError, match="segment store"):
        c.run_scenario(SPEC, segment_ticks=4, assemble=False)
    with pytest.raises(ValueError, match="checkpoint_every"):
        tstream.run_streamed(c, SPEC, segment_ticks=4, checkpoint_every=0)
    with pytest.raises(ValueError, match="segment_ticks"):
        c.run_scenario(SPEC, segment_ticks=0)
    assert torch.equal(c.key, before)


# -- the segment store and the trace, on their own ------------------------------


def _slab(start_tick: int, ticks: int, base: int = 0) -> Trace:
    rng = np.arange(ticks, dtype=np.int32) + base
    return Trace(metrics={"pings_sent": rng, "acks": rng * 2}, converged=(rng % 2 == 0),
                 live=np.full(ticks, 5, np.int32), loss=np.zeros(ticks, np.float32), n=6,
                 backend="dense", start_tick=start_tick)


def test_segment_store_roundtrip_and_truncate(tmp_path):
    path = str(tmp_path / "store")
    meta = {"kind": "trace", "run_id": "r1", "n": 6, "backend": "dense", "segment_ticks": 4,
            "ticks": 10, "start_tick": 0, "spec": {"ticks": 10, "events": []}}
    store = tstream.SegmentStore.create(path, meta)
    for seg, (a, t) in enumerate(((0, 4), (4, 4), (8, 2))):
        store.append(_slab(a, t, a), segment=seg, tick0=a)
    back = tstream.SegmentStore.open(path)
    assert back.segments == 3 and back.ticks_stored == 10
    assert all(s.ticks <= 4 for s in back.iter_traces())
    full = back.assemble()
    np.testing.assert_array_equal(full.metrics["pings_sent"], np.arange(10, dtype=np.int32))
    assert full.spec == meta["spec"]
    back.truncate(8)
    assert tstream.SegmentStore.open(path).ticks_stored == 8
    with open(f"{path}/manifest.jsonl", "a") as f:
        f.write('{"segment": 9, "tick0"')  # a torn last line is dropped
    assert tstream.SegmentStore.open(path).ticks_stored == 8
    with pytest.raises(ValueError, match="refusing to mix runs"):
        tstream.SegmentStore.create(path, {**meta, "run_id": "r2"})
    with pytest.raises(ValueError, match="segment_ticks"):
        tstream.segment_bounds(8, 0)
    assert tstream.segment_bounds(10, 4) == [(0, 4), (4, 8), (8, 10)]


def test_trace_concat_validate_summary_and_npz(tmp_path):
    with pytest.raises(ValueError, match="not contiguous"):
        Trace.concat([_slab(0, 4), _slab(6, 4)])
    odd = _slab(4, 4)
    odd.metrics["extra"] = np.zeros(4, np.int32)
    with pytest.raises(ValueError, match="metric series"):
        Trace.concat([_slab(0, 4), odd])
    with pytest.raises(ValueError, match="no slabs"):
        Trace.concat([])
    t = Trace(metrics={"pings_sent": np.arange(5, dtype=np.int32)},
              converged=np.array([False] * 4 + [True]), live=np.full(5, 7, np.int32),
              loss=np.zeros(5, np.float32), n=8, backend="dense", start_tick=3,
              spec={"ticks": 5, "events": []})
    summary = t.summary()
    keys = set(Histogram().print_obj())
    for name in ("pings_sent", "live", "loss"):
        assert set(summary[name]) == keys, name
    assert summary["pings_sent"]["sum"] == 10 and summary["live"]["min"] == 7.0
    assert summary["converged"] == {"count": 5, "sum": 1, "final": True, "first_tick": 4}
    path = str(tmp_path / "t.npz")
    t.save(path)
    back = Trace.load(path).validate()
    assert back.meta() == t.meta()
    assert json.dumps(back.summary()) == json.dumps(summary)
    t.metrics["pings_sent"] = np.zeros(3, np.int32)
    with pytest.raises(ValueError, match="not .*-shaped"):
        t.validate()
