"""The dispatch ledger and the profiler scopes (``obs/ledger.py``,
``obs/annotate.py``) against the reference's.

``summarize``, ``summarize_runs``, ``_sig_diff`` and the summarizer's
printed lines run in process on both sides (the reference's ``obs``
modules import under jax 0.9 unpatched).  The rows of real runs (a
streamed scenario twice, an unsegmented one, a tagged sweep and a
streamed sweep) come from the reference in a child process, with its
ledger on in memory, and are compared field by field with the port's:
the same programs, the same meta, the same cold rows (one per program
and segment shape) and the same pattern of equal signatures.  The same
child records ``SimCluster.tick`` (``tick()``, ``tick(3)`` and both
again, dense and delta, n = 8) and a host-level receiver merge.
"""

from __future__ import annotations

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from test_torch_harness import ReferenceScript, one_thread  # noqa: F401 - a fixture

from ringpop_tpu_torch.models import swim_sim as tsim
from ringpop_tpu_torch.models.cluster import SimCluster
from ringpop_tpu_torch.obs import annotate, ledger
from ringpop_tpu_torch.ops.recv_merge import recv_merge_pallas
from ringpop_tpu_torch.scenarios.spec import Event, ScenarioSpec

SPEC = dict(ticks=20, events=[dict(at=4, op="kill", node=3)])

_CHILD = r"""
from ringpop_tpu.models.cluster import SimCluster
from ringpop_tpu.models.swim_sim import SwimParams
from ringpop_tpu.obs.ledger import default_ledger
from ringpop_tpu.scenarios.spec import ScenarioSpec
led = default_ledger().enable(None)
c = SimCluster(16, SwimParams(), seed=3)
spec = ScenarioSpec.from_dict(SPEC)
c.run_scenario(spec, segment_ticks=8)
c.run_scenario(spec, segment_ticks=8)
c.run_scenario(spec)
c.run_sweep(spec, 2, program_tag="grid")
c.run_sweep(spec, 2, segment_ticks=8)
json.dump(led.rows, open(sys.argv[1], "w"))
"""

# a second child, run beside the first: SimCluster.tick and host-level
# receiver merges with the ledger on
_TICK_CHILD = r"""
from ringpop_tpu.models.cluster import SimCluster
from ringpop_tpu.models.swim_sim import SwimParams
from ringpop_tpu.obs.ledger import default_ledger
led = default_ledger().enable(None)
for backend in ("dense", "delta"):
    c = SimCluster(8, SwimParams(), seed=3, backend=backend)
    for k in TICKS:
        c.tick(k)
import jax.numpy as jnp
from ringpop_tpu.ops import recv_merge_pallas as rmp
for n in (8, 8, 16):
    rmp.recv_merge_pallas(jnp.zeros(n, jnp.int32), jnp.ones(n, bool),
                          jnp.zeros((n, n), jnp.int32), interpret=True)
json.dump(led.rows, open(sys.argv[1], "w"))
"""

TICKS = (1, 3, 1, 3)

# the row fields both packages fill alike (times, digests, run ids,
# memory and recompile texts differ by construction)
COMPARED = ("program", "platform", "cold", "backend", "n", "ticks", "replicas", "segment",
            "tick0", "segment_ticks", "total_ticks", "traffic_m", "policy")


@contextlib.contextmanager
def in_memory_ledger():
    """The process-global ledger on, in memory, for the block; its state
    before comes back after."""
    led = ledger.default_ledger()
    saved = (led._path, led._explicit, led._enabled)
    led.clear()
    led.enable(None)
    try:
        yield led
    finally:
        led.clear()
        led._path, led._explicit, led._enabled = saved


def port_tick_rows() -> list[dict]:
    """The rows of ``SimCluster.tick`` and of host-level receiver merges,
    as the child makes them."""
    with in_memory_ledger() as led:
        for backend in ("dense", "delta"):
            c = SimCluster(8, tsim.SwimParams(), seed=3, backend=backend, device="cpu")
            for k in TICKS:
                c.tick(k)
        for n in (8, 8, 16):
            recv_merge_pallas(torch.zeros(n, dtype=torch.int64), torch.ones(n, dtype=torch.bool),
                              torch.zeros((n, n), dtype=torch.int32))
        return [dict(r) for r in led.rows]


def port_rows() -> list[dict]:
    with in_memory_ledger() as led:
        c = SimCluster(16, tsim.SwimParams(), seed=3, device="cpu")
        spec = ScenarioSpec.from_dict(SPEC)
        c.run_scenario(spec, segment_ticks=8)
        c.run_scenario(spec, segment_ticks=8)
        c.run_scenario(spec)
        c.run_sweep(spec, 2, program_tag="grid")
        c.run_sweep(spec, 2, segment_ticks=8)
        return [dict(r) for r in led.rows]


@pytest.fixture(scope="module")
def rows(tmp_path_factory, one_thread):  # noqa: F811
    tmp = str(tmp_path_factory.mktemp("ledger"))
    children = [ReferenceScript(f"SPEC = {json.dumps(SPEC)}\n" + _CHILD, tmp, "ledger"),
                ReferenceScript(f"TICKS = {TICKS}\n" + _TICK_CHILD, tmp, "ticks")]
    try:
        got = port_rows(), port_tick_rows()
        return got, tuple(child.result() for child in children)
    finally:
        for child in children:
            child.close()


def test_rows_match_reference(rows):
    (got, _), (want, _) = rows
    assert len(got) == len(want) == 3 + 3 + 1 + 1 + 3
    for g, w in zip(got, want):
        assert {k: g.get(k) for k in COMPARED} == {k: w.get(k) for k in COMPARED}
        assert ("recompile_cause" in g) == ("recompile_cause" in w)
        assert set(w) - {"ts"} <= set(g), set(w) - set(g)
    # one cold row per (program, signature): the same signatures repeat
    for i in range(len(got)):
        for j in range(len(got)):
            same = got[i]["sig"] == got[j]["sig"] and got[i]["program"] == got[j]["program"]
            assert same == (want[i]["sig"] == want[j]["sig"]
                            and want[i]["program"] == want[j]["program"]), (i, j)


def test_tick_rows_match_reference(rows):
    (_, got), (_, want) = rows
    assert [r["program"] for r in got] == (
        ["swim_step", "swim_run"] * 2 + ["delta_step", "delta_run"] * 2 + ["recv_merge_pallas"] * 3)
    assert [r["cold"] for r in got] == [True, True, False, False] * 2 + [True, False, True]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: g.get(k) for k in COMPARED} == {k: w.get(k) for k in COMPARED}
        assert ("recompile_cause" in g) == ("recompile_cause" in w)
    assert [r["ticks"] for r in got[:8]] == list(TICKS) * 2
    assert got[-1]["n"] == 16 and got[-1]["backend"] == "dense"


def test_obs_exports_the_ledger():
    import ringpop_tpu.obs as robs

    import ringpop_tpu_torch.obs as tobs

    assert tobs.DispatchLedger is ledger.DispatchLedger
    assert tobs.default_ledger is ledger.default_ledger
    assert {"DispatchLedger", "default_ledger"} <= set(tobs.__all__)
    assert set(tobs.__all__) == set(robs.__all__) - {"memory_row"}


def test_streamed_rows_and_tag(rows):
    (got, _), _ = rows
    seg = [r for r in got if r.get("run_id") and r["program"] == "run_scenario"]
    assert [r["cold"] for r in seg] == [True, False, True, False, False, False]
    assert all(r["trace_s"] == r["compile_s"] == 0.0 for r in got)
    assert all(r["drain_overlap_s"] <= r["drain_s"] for r in seg)
    assert "arg leaf" in " ".join(seg[2]["recompile_cause"])
    assert [r["program"] for r in got if "run_id" not in r] == ["run_scenario", "run_sweep:grid"]
    runs = ledger.summarize_runs(got)
    assert [(g["program"], g["segments"], g["cold"], g["ticks"]) for g in runs
            if g["program"] == "run_scenario"] in (
        [("run_scenario", 3, 2, 20), ("run_scenario", 3, 0, 20)],
        [("run_scenario", 3, 0, 20), ("run_scenario", 3, 2, 20)])


def _rows_for_summaries() -> list[dict]:
    rng = np.random.default_rng(7)
    rows = []
    for i in range(40):
        row = {"program": ["run_scenario", "run_sweep", "run_sweep:grid"][i % 3],
               "backend": ["dense", "delta"][i % 2], "platform": ["gpu", "cpu"][i % 4 // 3],
               "n": [16, 64][i % 5 // 4], "ticks": [8, 4, 20][i % 3], "replicas": 1 + i % 2,
               "cold": bool(rng.random() < 0.3), "compile_s": float(rng.random()),
               "peak_bytes": int(rng.integers(0, 5_000_000))}
        if i % 7:
            row["execute_s"] = float(np.round(rng.random(), 6))
        if i % 2:
            row.update(run_id=f"r{i % 3}", segment_ticks=8, dispatch_s=float(rng.random()),
                       drain_s=float(rng.random()), drain_overlap_s=float(rng.random() / 2))
        rows.append(row)
    rows.append({"program": "probe"})
    rows.append({"program": "run_scenario", "run_id": "z", "drain_s": 0.0})
    return rows


def test_summaries_equal_reference(tmp_path):
    from ringpop_tpu.obs import ledger as rledger

    rows = _rows_for_summaries()
    assert ledger.summarize(rows) == rledger.summarize(rows)
    assert ledger.summarize_runs(rows) == rledger.summarize_runs(rows)
    path = str(tmp_path / "ledger.jsonl")
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    assert ledger.DispatchLedger.load_rows(path) == rows
    for argv in ([path], [path, "--json"]):
        outs = []
        for main in (ledger.main, rledger.main):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main(argv)
            outs.append(buf.getvalue())
        assert outs[0] == outs[1]


def test_sig_diff_names_the_same_component():
    import jax.numpy as jnp

    from ringpop_tpu.obs import ledger as rledger

    def both(args_np, statics):
        mine = ledger._signature(tuple(torch.from_numpy(a) for a in args_np), statics)
        theirs = rledger._signature(tuple(jnp.asarray(a) for a in args_np), statics)
        return mine, theirs

    base = ([np.zeros(4, np.int32), np.zeros((3, 2), np.float32)], {"params": 3, "mode": "a"})
    drifts = [
        ([np.zeros(5, np.int32), np.zeros((3, 2), np.float32)], {"params": 3, "mode": "a"}),
        ([np.zeros(4, np.int32), np.zeros((3, 2), np.int32)], {"params": 3, "mode": "a"}),
        ([np.zeros(4, np.int32), np.zeros((3, 2), np.float32)], {"params": 4, "mode": "a"}),
        ([np.zeros(4, np.int32), np.zeros((3, 2), np.float32)], {"params": 3}),
        ([np.zeros(4, np.int32)], {"params": 3, "mode": "b"}),
    ]
    m0, t0 = both(*base)
    for args, statics in drifts:
        m1, t1 = both(args, statics)
        mine, theirs = ledger._sig_diff(m0, m1), rledger._sig_diff(t0, t1)
        assert mine == theirs, (mine, theirs)
        assert ledger._sig_hash(m1) != ledger._sig_hash(m0)


def test_disabled_is_a_call_through(one_thread):  # noqa: F811
    spec = ScenarioSpec(ticks=12, events=(Event(at=3, op="kill", node=2),))
    led = ledger.default_ledger()
    assert not led.enabled
    off = SimCluster(8, seed=5, device="cpu").run_scenario(spec, segment_ticks=5)
    assert led.rows == []
    with in_memory_ledger() as on_led:
        on = SimCluster(8, seed=5, device="cpu").run_scenario(spec, segment_ticks=5)
        assert len(on_led.rows) == 3
    for k, v in off.metrics.items():
        assert np.array_equal(v, on.metrics[k]), k
    assert np.array_equal(off.converged, on.converged)
    assert led.dispatch("p", lambda x, k=1: x + k, 1, k=2) == 3 and led.rows == []


def test_env_switch_file_and_cap(tmp_path, monkeypatch):
    path = str(tmp_path / "env.jsonl")
    monkeypatch.setenv(ledger.ENV_VAR, path)
    led = ledger.DispatchLedger()
    assert led.enabled and led.path == path
    monkeypatch.setattr(ledger, "MAX_ROWS_IN_MEMORY", 3)
    for i in range(5):
        led.dispatch("p", lambda x: x * 2, torch.arange(i % 2 + 1), _meta={"n": i})
    assert [r["n"] for r in led.rows] == [2, 3, 4]
    on_disk = ledger.DispatchLedger.load_rows(path)
    assert [r["cold"] for r in on_disk] == [True, True, False, False, False]
    assert on_disk[1]["recompile_cause"] == ["arg leaf 0 shape changed: (1,) -> (2,)"]
    assert all(r["platform"] == "cpu" and r["peak_bytes"] == 0 for r in on_disk)
    led.disable()
    led.dispatch("p", lambda x: x, 1)
    assert len(ledger.DispatchLedger.load_rows(path)) == 5


def test_profile_trace_writes_and_stops_on_exception(tmp_path, one_thread):  # noqa: F811
    d1 = str(tmp_path / "ok")
    c = SimCluster(8, seed=1, device="cpu")
    with annotate.profile_trace(d1) as got:
        assert got == d1
        c.tick()
    (name,) = os.listdir(d1)
    with open(os.path.join(d1, name)) as f:
        text = f.read()
    for scope in ("swim.phase01_select", "swim.recv_merge", "swim.pingreq"):
        assert scope in text, scope
    d2 = str(tmp_path / "raises")
    with pytest.raises(ZeroDivisionError):
        with annotate.profile_trace(d2):
            with annotate.scope("obs.test"):
                1 / 0
    assert os.listdir(d2) and not torch.autograd.profiler._is_profiler_enabled

    @annotate.scoped("obs.scoped")
    def f(x):
        return x + 1

    assert f(1) == 2 and f.__name__ == "f"
