"""The port's sweep pieces (``scenarios/sweep.py``) against the JAX
reference, on the same inputs, in one child process.

- ``replica_spec`` (kill and flap jitter, loss scales) and
  ``compile_sweep`` (the seed-only path, jittered and scaled replicas,
  and the refusals: jitter out of range, axes of the wrong length,
  negative scales, no replicas), event rows, loss rows and boundaries.
- ``sweep_key_schedule`` for shared and per-replica boundaries.
- ``SweepTrace`` on the same arrays: ``validate``, ``replica``,
  ``concat_ticks``, ``detect_ticks``/``heal_ticks``, ``summary``.
- ``.npz`` files written by the port loaded by the reference, and the
  other way round.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from test_torch_harness import run_reference_script
from test_torch_sweep import FLAP, SPEC

from ringpop_tpu_torch import convert
from ringpop_tpu_torch.scenarios import sweep as tsweep
from ringpop_tpu_torch.scenarios.spec import ScenarioSpec

N = 16
REPLICA_SPECS = [
    (SPEC, {"kill_jitter": 3}),
    (SPEC, {"loss_scale": 0.3}),
    (FLAP, {"flap_jitter": 2, "kill_jitter": -1, "loss_scale": 1.7}),
    (FLAP, {"flap_jitter": -4}),
    (SPEC, {"kill_jitter": 25}),
    (FLAP, {"flap_jitter": 9}),
]
COMPILES = [
    {"spec": SPEC, "replicas": 3, "base_loss": 0.01},
    {"spec": SPEC, "replicas": 3, "base_loss": 0.1, "loss_scales": [1.0, 0.3, 2.5],
     "kill_jitter": [0, 2, 5]},
    {"spec": FLAP, "replicas": 2, "flap_jitter": [0, 3], "kill_jitter": [1, 0]},
    {"spec": SPEC, "replicas": 2, "kill_jitter": [0, 40]},
    {"spec": SPEC, "replicas": 2, "kill_jitter": [0]},
    {"spec": SPEC, "replicas": 2, "loss_scales": [1.0, -1.0]},
    {"spec": SPEC, "replicas": 0},
    {"spec": FLAP, "replicas": 2, "flap_jitter": [0, 1, 2]},
]
R, T = 3, 12


def _trace_arrays() -> dict:
    rng = np.random.default_rng(11)
    conv = rng.random((R, T)) < 0.6
    conv[0, 5:] = True
    conv[1] = False
    conv[2, -1] = False
    fd = (rng.random((R, T)) < 0.2).astype(np.int32)
    fd[1] = 0
    return {
        "converged": conv,
        "live": rng.integers(0, N + 1, (R, T)).astype(np.int32),
        "loss": rng.random((R, T)).astype(np.float32),
        "m.faulty_declared": fd,
        "m.pings_sent": rng.integers(0, 50, (R, T)).astype(np.int32),
        "p.hist": rng.integers(0, 9, (R, T, 4)).astype(np.int32),
        "replica_keys": rng.integers(0, 2**32, (R, 2), dtype=np.uint64).astype(np.uint32),
    }


META = {"n": N, "backend": "dense", "start_tick": 4, "loss_scales": [1.0, 0.5, 2.0],
        "kill_jitter": [0, 1, 2], "flap_jitter": [0, 2, 1], "spec": FLAP}
BAD = [("live", lambda a: a["live"].__setitem__((0, 0), N + 1)),
       ("shape", lambda a: a.__setitem__("m.pings_sent", a["m.pings_sent"][:, :-1])),
       ("plane", lambda a: a.__setitem__("p.hist", a["p.hist"][:, :, 0])),
       ("keys", lambda a: a.__setitem__("replica_keys", a["replica_keys"][:2]))]

_SCRIPT = r"""
import jax, jax.numpy as jnp
from ringpop_tpu.scenarios import sweep
from ringpop_tpu.scenarios.spec import ScenarioSpec
inp = json.load(open(INPUT))
arrays = dict(np.load(inp["arrays"]))
out = {}

def err(fn):
    try:
        return fn()
    except Exception as e:
        return f"{type(e).__name__}: {e}"

out["replica_spec"] = [
    err(lambda s=s, kw=kw: sweep.replica_spec(ScenarioSpec.from_dict(s), **kw).to_dict())
    for s, kw in inp["replica_specs"]]

def compiled(c):
    kw = {k: v for k, v in c.items() if k != "spec"}
    cs = sweep.compile_sweep(ScenarioSpec.from_dict(c["spec"]), inp["n"], **kw)
    return {"ev_tick": np.asarray(cs.ev_tick).tolist(), "ev_kind": np.asarray(cs.ev_kind).tolist(),
            "ev_node": np.asarray(cs.ev_node).tolist(),
            "loss": np.asarray(cs.loss).view(np.uint32).tolist(),
            "boundaries": [list(b) for b in cs.boundaries], "loss_scales": list(cs.loss_scales),
            "kill_jitter": list(cs.kill_jitter), "flap_jitter": list(cs.flap_jitter)}

out["compile"] = [err(lambda c=c: compiled(c)) for c in inp["compiles"]]
keys = [jnp.asarray(np.array(k, np.uint32)) for k in inp["replica_keys"]]
out["schedules"] = []
for i in inp["schedule_compiles"]:
    c = inp["compiles"][i]
    kw = {k: v for k, v in c.items() if k != "spec"}
    cs = sweep.compile_sweep(ScenarioSpec.from_dict(c["spec"]), inp["n"], **kw)
    out["schedules"].append(np.asarray(sweep.sweep_key_schedule(keys[:cs.replicas], cs)).tolist())

def make(arrs, meta):
    return sweep.SweepTrace.from_arrays(arrs, meta)

meta = inp["meta"]
tr = make(arrays, meta)
out["validate"] = err(lambda: (tr.validate(), "")[1])
bad = dict(np.load(inp["bad"]))
out["bad"] = {}
for name in inp["bad_names"]:
    sub = {k[len(name) + 1:]: v for k, v in bad.items() if k.startswith(name + "/")}
    out["bad"][name] = err(lambda sub=sub: (make(sub, meta).validate(), "")[1])

def arrs(t):
    return {k: np.asarray(v).tolist() for k, v in t.to_arrays().items()}

out["replica"] = [{"arrays": arrs(tr.replica(r)), "meta": tr.replica(r).meta()}
                  for r in range(tr.replicas)]
slabs = []
for a, b in ((0, 5), (5, 9), (9, 12)):
    s = make({k: (v[:, a:b] if k != "replica_keys" else v) for k, v in arrays.items()},
             dict(meta, start_tick=meta["start_tick"] + a))
    slabs.append(s)
joined = sweep.SweepTrace.concat_ticks(slabs)
out["concat"] = {"arrays": arrs(joined), "meta": joined.meta()}
out["concat_gap"] = err(lambda: sweep.SweepTrace.concat_ticks([slabs[0], slabs[2]]))
out["detect"] = tr.detect_ticks().tolist()
out["detect_pings"] = tr.detect_ticks("pings_sent").tolist()
out["heal"] = tr.heal_ticks().tolist()
out["summary"] = tr.summary()
port = sweep.SweepTrace.load(inp["port_file"])
out["port_file"] = {"arrays": arrs(port), "meta": port.meta()}
tr.save(inp["ref_file"])
out["not_sweep"] = err(lambda: sweep.SweepTrace.load(inp["trace_file"]))
json.dump(out, open(sys.argv[1], "w"))
"""


def _port_trace(arrays: dict, meta: dict) -> tsweep.SweepTrace:
    return tsweep.SweepTrace.from_arrays(arrays, meta)


def _err(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - the type and message are compared
        return f"{type(e).__name__}: {e}"


def _compiled(c: dict):
    kw = {k: v for k, v in c.items() if k != "spec"}
    cs = tsweep.compile_sweep(ScenarioSpec.from_dict(c["spec"]), N, device="cpu", **kw)
    return {"ev_tick": cs.ev_tick.tolist(), "ev_kind": cs.ev_kind.tolist(),
            "ev_node": cs.ev_node.tolist(),
            "loss": cs.loss.numpy().view(np.uint32).tolist(),
            "boundaries": [list(b) for b in cs.boundaries], "loss_scales": list(cs.loss_scales),
            "kill_jitter": list(cs.kill_jitter), "flap_jitter": list(cs.flap_jitter)}


def _arrs(t) -> dict:
    return {k: np.asarray(v).tolist() for k, v in t.to_arrays().items()}


RKEYS = [[0, 7], [12345, 4294967295], [2718281828, 31415]]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("sweep_units")
    arrays = _trace_arrays()
    np.savez(d / "arrays.npz", **arrays)
    bad = {}
    for name, edit in BAD:
        a = {k: v.copy() for k, v in arrays.items()}
        edit(a)
        bad.update({f"{name}/{k}": v for k, v in a.items()})
    np.savez(d / "bad.npz", **bad)
    port = _port_trace(arrays, META)
    port.save(str(d / "port.npz"))
    from ringpop_tpu_torch.scenarios.trace import Trace
    port.replica(0).save(str(d / "trace.npz"))
    inp = {"arrays": str(d / "arrays.npz"), "bad": str(d / "bad.npz"),
           "bad_names": [b for b, _ in BAD], "meta": META, "n": N,
           "replica_specs": REPLICA_SPECS, "compiles": COMPILES, "replica_keys": RKEYS,
           "schedule_compiles": [0, 1, 2], "port_file": str(d / "port.npz"),
           "ref_file": str(d / "ref.npz"), "trace_file": str(d / "trace.npz")}
    with open(d / "input.json", "w") as f:
        json.dump(inp, f)
    ref = run_reference_script(f"INPUT = {str(d / 'input.json')!r}\n" + _SCRIPT, str(d))
    assert isinstance(Trace.load(str(d / "trace.npz")), Trace)
    return ref, inp, arrays, bad


@pytest.mark.parametrize("i", range(len(REPLICA_SPECS)))
def test_replica_spec_matches_reference(both, i):
    ref = both[0]["replica_spec"][i]
    spec, kw = REPLICA_SPECS[i]
    got = _err(lambda: tsweep.replica_spec(ScenarioSpec.from_dict(spec), **kw).to_dict())
    assert json.loads(json.dumps(got)) == ref


@pytest.mark.parametrize("i", range(len(COMPILES)))
def test_compile_sweep_matches_reference(both, i):
    """Event rows, loss rows (bit for bit), boundaries and axes, or the
    reference's refusal and message."""
    got = _err(lambda: _compiled(COMPILES[i]))
    assert isinstance(got, dict) == (i < 3)
    assert json.loads(json.dumps(got)) == both[0]["compile"][i]


@pytest.mark.parametrize("i", [0, 1, 2])
def test_sweep_key_schedule_matches_reference(both, i):
    """Shared boundaries (seed only), per-replica boundaries (kill and
    flap jitter): each replica's schedule from its own key."""
    c = COMPILES[i]
    kw = {k: v for k, v in c.items() if k != "spec"}
    cs = tsweep.compile_sweep(ScenarioSpec.from_dict(c["spec"]), N, device="cpu", **kw)
    keys = [convert.key_from_numpy(np.array(k, np.uint32)) for k in RKEYS[:cs.replicas]]
    got = tsweep.sweep_key_schedule(keys, cs)
    assert got.dtype == torch.int64
    assert got.tolist() == both[0]["schedules"][i]
    if i:
        assert len(set(cs.boundaries)) > 1  # the per-replica path
    with pytest.raises(ValueError, match="replica keys"):
        tsweep.sweep_key_schedule(keys[:1], cs)


def test_sweep_trace_validate_matches_reference(both):
    ref, _, arrays, bad = both
    assert _err(lambda: (_port_trace(arrays, META).validate(), "")[1]) == ref["validate"] == ""
    for name, _ in BAD:
        sub = {k[len(name) + 1:]: v for k, v in bad.items() if k.startswith(name + "/")}
        got = _err(lambda sub=sub: (_port_trace(sub, META).validate(), "")[1])
        assert got == ref["bad"][name] and got.startswith("ValueError"), name


def test_sweep_trace_replica_matches_reference(both):
    """Replica r as a ``Trace``: its series and meta, the spec made
    replica r's (jitter and scale applied)."""
    ref, _, arrays, _ = both
    tr = _port_trace(arrays, META)
    for r in range(R):
        rep = tr.replica(r)
        assert _arrs(rep) == ref["replica"][r]["arrays"]
        assert json.loads(json.dumps(rep.meta())) == ref["replica"][r]["meta"]


def test_sweep_trace_concat_matches_reference(both):
    ref, _, arrays, _ = both
    slabs = [_port_trace({k: (v[:, a:b] if k != "replica_keys" else v)
                          for k, v in arrays.items()},
                         dict(META, start_tick=META["start_tick"] + a))
             for a, b in ((0, 5), (5, 9), (9, 12))]
    joined = tsweep.SweepTrace.concat_ticks(slabs)
    assert _arrs(joined) == ref["concat"]["arrays"]
    assert json.loads(json.dumps(joined.meta())) == ref["concat"]["meta"]
    assert _err(lambda: tsweep.SweepTrace.concat_ticks([slabs[0], slabs[2]])) == ref["concat_gap"]
    with pytest.raises(ValueError, match="replica axis"):
        other = _port_trace({**{k: v[:, 5:9] for k, v in arrays.items() if k != "replica_keys"},
                             "replica_keys": arrays["replica_keys"] + 1},
                            dict(META, start_tick=META["start_tick"] + 5))
        tsweep.SweepTrace.concat_ticks([slabs[0], other])


def test_sweep_trace_outcomes_match_reference(both):
    """Detection and heal ticks per replica (undetected and unhealed
    replicas -1), and the summary's distributions and counts."""
    ref, _, arrays, _ = both
    tr = _port_trace(arrays, META)
    assert tr.detect_ticks().tolist() == ref["detect"]
    assert tr.detect_ticks("pings_sent").tolist() == ref["detect_pings"]
    assert tr.heal_ticks().tolist() == ref["heal"]
    assert -1 in ref["detect"] and -1 in ref["heal"]
    assert json.loads(json.dumps(tr.summary())) == ref["summary"]
    assert tr.serving_summary() is None


def test_npz_files_cross_both_ways(both):
    """The reference loads the port's file to the same arrays and meta;
    the port loads the reference's; a plain trace file is refused."""
    ref, inp, arrays, _ = both
    port = _port_trace(arrays, META)
    assert ref["port_file"]["arrays"] == _arrs(port)
    assert ref["port_file"]["meta"] == json.loads(json.dumps(port.meta()))
    got = tsweep.SweepTrace.load(inp["ref_file"])
    for k, v in port.to_arrays().items():
        w = got.to_arrays()[k]
        assert v.dtype == w.dtype and np.array_equal(v, w), k
    assert got.meta() == port.meta()
    assert _err(lambda: tsweep.SweepTrace.load(inp["trace_file"])) == ref["not_sweep"]


def test_serving_series_refused(tmp_path):
    """A loaded trace with serving series has a scorecard per replica
    (a trace without them has none): goodput, amplification and the
    latency percentiles from its histogram plane."""
    arrays = _trace_arrays()
    assert _port_trace(arrays, META).serving_summary() is None
    for name in ("lookups", "delivered", "handled_local", "proxy_sends", "proxy_retries",
                 "misroutes", "gray_timeouts"):
        arrays[f"m.{name}"] = np.ones((R, T), np.int32)
    arrays["m.lookups"] = np.full((R, T), 4, np.int32)
    arrays["p.lat_hist_ms"] = np.zeros((R, T, 4), np.int32)
    arrays["p.lat_hist_ms"][:, :, 2] = 1
    tr = _port_trace(arrays, META)
    path = str(tmp_path / "serving.npz")
    tr.save(path)
    rows = tsweep.SweepTrace.load(path).serving_summary()
    assert os.path.exists(path)
    assert [r["replica"] for r in rows] == list(range(R))
    for r in rows:
        assert r["lookups"] == 4 * T and r["delivered"] == T
        assert r["goodput"] == 0.25 and r["amplification"] == 3.0
        assert r["gray_timeouts"] == T and r["lat_p99_ms"] == 2.0
