"""The serving plane's pieces against the JAX reference: workload specs,
the key pool, the sampler, and ``serve_once`` on snapshot rows.

- ``WorkloadSpec`` parsing (``kind:M[:pool]``, dicts, viewers) and every
  validation message; ``compile_traffic``'s statics and tensors (the
  pool hashed on the device equal to the host FarmHash).
- ``sample_tick`` for 200 ticks of a uniform, a zipf and a tenant
  workload (the Gumbel argmax and the viewer ``randint``), equal to the
  reference's batches.
- ``serve_once`` on the views of a reference cluster after a kill and a
  suspend (one reference child computes every case): the plain chain;
  the SLO latency chain under delay rules and a gray period row with
  ``lookup_n``; ``every`` off and on cadence; damped rows; the policy
  planes (shed, quarantine, a retry cap, ``node_sends``); and a delta
  state, served from its tables (``DeltaRows``) and from its
  materialized [N, N] table.  Every counter, histogram row and send
  vector equal.
- The latency helpers (``backoff_*``, ``bucket_*``, ``hist_stats``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_harness import one_thread, run_reference_script

from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models import checksum as cksum
from ringpop_tpu_torch.models import swim_sim as tsim
from ringpop_tpu_torch.ops.farmhash import farmhash32
from ringpop_tpu_torch.traffic import engine as tengine
from ringpop_tpu_torch.traffic import latency as tlat
from ringpop_tpu_torch.traffic.workloads import WorkloadSpec, compile_traffic

N = 32
ADDRS = [f"10.0.0.{i}:3000" for i in range(N)]
WORKLOADS = {
    "uniform": {"kind": "uniform", "keys_per_tick": 64, "pool": 512, "seed": 3},
    "zipf": {"kind": "zipf", "keys_per_tick": 64, "pool": 512, "zipf_s": 1.2, "seed": 4},
    "tenant": {"kind": "tenant", "keys_per_tick": 64, "pool": 500, "tenants": 7,
               "zipf_s": 1.5, "seed": 5, "viewers": [1, 4, 9, 30]},
}
SAMPLE_TICKS = 200
BAD_SPECS = [
    "bogus:8", {"viewers": [99]}, {"viewers": []}, {"every": 0}, {"keys_per_tick": 0},
    {"pool": 0}, {"kind": "tenant", "tenants": 0}, {"lookup_n": -1}, {"window": 0},
    {"latency_buckets": 1}, {"latency_buckets": 33}, {"period_ms": 0},
]
# (name, workload, static overrides, serve kwargs): the serve_once cases
LAT_WL = {"kind": "zipf", "keys_per_tick": 96, "pool": 300, "zipf_s": 1.1, "seed": 8,
          "latency_buckets": 16, "lookup_n": 3, "max_retries": 4}
SERVES = [
    ("plain", {"kind": "uniform", "keys_per_tick": 96, "pool": 300, "seed": 2}, {}, {}),
    ("narrow", {"kind": "zipf", "keys_per_tick": 96, "pool": 300, "seed": 6, "window": 3,
                "max_retries": 1}, {}, {}),
    ("latency", LAT_WL, {}, {"net": True, "period": True}),
    ("every_off", {**LAT_WL, "every": 2}, {}, {"net": True, "period": True, "t": 3}),
    ("every_on", {**LAT_WL, "every": 2}, {}, {"net": True, "period": True, "t": 4}),
    ("damped", {"kind": "zipf", "keys_per_tick": 96, "pool": 300, "seed": 9}, {},
     {"damped": True}),
    ("policy", LAT_WL, {"track_load": 1, "track_policy": 1},
     {"net": True, "period": True, "policy": True}),
    ("policy_plain", {"kind": "uniform", "keys_per_tick": 96, "pool": 300, "seed": 10},
     {"track_load": 1, "track_policy": 1}, {"policy": True}),
]
DELTA_SERVES = [s for s in SERVES if s[0] in ("plain", "latency", "policy")]

_REFERENCE = r"""
import json, sys
import numpy as np
import jax
import jax.numpy as jnp
from ringpop_tpu.models import swim_delta as sdelta, swim_sim as sim
from ringpop_tpu.models.cluster import SimCluster
from ringpop_tpu.traffic import engine, workloads

cfg = json.loads(sys.argv[2])
n, addrs = cfg["n"], cfg["addrs"]
out = {"bad": []}
for bad in cfg["bad"]:
    try:
        workloads.WorkloadSpec.from_spec(bad).validate(n)
        out["bad"].append("")
    except (ValueError, TypeError) as e:
        out["bad"].append(f"{type(e).__name__}: {e}")
out["parsed"] = [workloads.WorkloadSpec.from_spec(s).to_dict()
                 for s in ("zipf:512:2048", "tenant:16", {"kind": "tenant", "viewers": [0, 2]})]
for name, wl in cfg["workloads"].items():
    ct = workloads.compile_traffic(wl, n, addrs)
    out[f"{name}/pool"] = np.asarray(ct.tensors.pool).tolist()
    out[f"{name}/logits"] = np.asarray(ct.tensors.logits).view(np.int32).tolist()
    out[f"{name}/static"] = list(ct.static)
    idx, view = [], []
    sample = jax.jit(engine.sample_tick, static_argnums=2)
    for t in range(cfg["sample_ticks"]):
        i, v = sample(ct.tensors, jnp.int32(t), ct.static.m)
        idx.append(np.asarray(i).tolist())
        view.append(np.asarray(v).tolist())
    out[f"{name}/idx"], out[f"{name}/view"] = idx, view

rng = np.random.default_rng(17)
damped = rng.random((n, n)) < 0.2
shed = rng.random(n) < 0.25
quar = rng.random(n) < 0.2
out["damped"], out["shed"], out["quar"] = damped.tolist(), shed.tolist(), quar.tolist()
period = np.ones(n, np.int32)
period[[1, 2, 5, 20]] = [3, 4, 2, 5]
out["period"] = period.tolist()
src = np.zeros((2, n), bool); dst = np.zeros((2, n), bool)
src[0, :8] = True; dst[0, 16:] = True; src[1, 20:] = True; dst[1, :] = True
rules = dict(link_src=src, link_dst=dst, link_p=np.array([0.0, 0.1], np.float32),
             link_d=np.array([2, 1], np.int32), link_j=np.array([3, 0], np.int32))
out["rules"] = {k: v.tolist() for k, v in rules.items()}

def serve_all(c, rows, prefix, cases):
    out[f"{prefix}/up"] = np.asarray(c.net.up).tolist()
    out[f"{prefix}/resp"] = np.asarray(c.net.responsive).tolist()
    for name, wl, over, kw in cases:
        ct = c.compile_traffic(wl)
        st = ct.static._replace(**over)
        net = c.net._replace(**{k: jnp.asarray(v) for k, v in rules.items()}) if kw.get("net") else None
        res = engine.serve_once(
            rows, c.net.up, c.net.responsive, ct.tensors, jnp.int32(kw.get("t", 7)), static=st,
            damped=jnp.asarray(damped) if kw.get("damped") else None, net=net,
            period=jnp.asarray(period) if kw.get("period") else None,
            policy=(jnp.asarray(shed), jnp.asarray(quar), jnp.int32(2)) if kw.get("policy") else None)
        out[f"{prefix}/{name}"] = {k: np.asarray(v).tolist() for k, v in res.items()}

def churn(c):
    # one-tick steps: one compiled program each backend
    for t in range(5):
        if t == 2:
            c.kill(6); c.suspend(11)
        c.tick(1)

c = SimCluster(n, sim.SwimParams(suspicion_ticks=5), seed=3)
churn(c)
out["dense/view_key"] = np.asarray(c.state.view_key).tolist()
serve_all(c, c.state.view_key, "dense", cfg["serves"])

d = SimCluster(n, sim.SwimParams(suspicion_ticks=5), seed=3, backend="delta", capacity=16,
               wire_cap=8, claim_grid=64)
churn(d)
out["delta/state"] = {f: None if v is None else np.asarray(v).tolist()
                      for f, v in d.state._asdict().items()}
out["delta/state_dtypes"] = {f: None if v is None else str(np.asarray(v).dtype)
                             for f, v in d.state._asdict().items()}
serve_all(d, sdelta.materialize_rows(d.state, jnp.arange(n)), "delta", cfg["delta_serves"])
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module", autouse=True)
def _threads(one_thread):
    """The port's runs of this module on one intra-op thread."""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    import json

    cfg = {"n": N, "addrs": ADDRS, "bad": BAD_SPECS, "workloads": WORKLOADS,
           "sample_ticks": SAMPLE_TICKS, "serves": SERVES, "delta_serves": DELTA_SERVES}
    code = _REFERENCE.replace("json.loads(sys.argv[2])", repr(json.dumps(cfg)).join(
        ("json.loads(", ")")))
    return run_reference_script(code, str(tmp_path_factory.mktemp("traffic_ref")))


def test_spec_parsing_and_validation(reference):
    got = []
    for bad in BAD_SPECS:
        try:
            WorkloadSpec.from_spec(bad).validate(N)
            got.append("")
        except (ValueError, TypeError) as e:
            got.append(f"{type(e).__name__}: {e}")
    assert got == reference["bad"]
    assert all(got)
    parsed = [WorkloadSpec.from_spec(s).to_dict()
              for s in ("zipf:512:2048", "tenant:16", {"kind": "tenant", "viewers": [0, 2]})]
    assert parsed == reference["parsed"]
    ws = WorkloadSpec.from_spec({"kind": "tenant", "viewers": [0, 2]})
    assert ws.viewers == (0, 2) and WorkloadSpec.from_spec(ws) is ws


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_compiled_workload_and_sampler(reference, name):
    """The pool (and the host FarmHash), the logits' bits, the statics,
    and 200 ticks of sampled keys and viewers."""
    ct = compile_traffic(WORKLOADS[name], N, ADDRS, device="cpu")
    pool = ct.tensors.pool.numpy()
    assert pool.tolist() == reference[f"{name}/pool"]
    assert [farmhash32(k) for k in ct.spec.pool_keys()] == pool.tolist()
    assert ct.tensors.logits.numpy().view(np.int32).tolist() == reference[f"{name}/logits"]
    assert list(ct.static) == reference[f"{name}/static"]
    for t in range(SAMPLE_TICKS):
        idx, view = tengine.sample_tick(ct.tensors, t, ct.static.m)
        assert idx.dtype == view.dtype == torch.int32
        assert idx.tolist() == reference[f"{name}/idx"][t], t
        assert view.tolist() == reference[f"{name}/view"][t], t


def _serve_inputs(reference, prefix):
    up = torch.tensor(reference[f"{prefix}/up"])
    resp = torch.tensor(reference[f"{prefix}/resp"])
    rules = {k: torch.tensor(np.asarray(v, dtype=np.float32 if k == "link_p" else None))
             for k, v in reference["rules"].items()}
    return up, resp, rules


def _serve(rows, up, resp, rules, reference, wl, over, kw):
    # the cluster's own address book, as its compile_traffic lowers against
    spec = WorkloadSpec.from_spec(wl)
    if spec.latency_buckets:
        spec = spec._replace(period_ms=tsim.SwimParams().period_ms)
    ct = compile_traffic(spec, N, cksum.default_addresses(N), device="cpu")
    st = ct.static._replace(**over)
    net = tsim.make_net(N, device="cpu")._replace(up=up, responsive=resp, **rules) \
        if kw.get("net") else None
    policy = None
    if kw.get("policy"):
        policy = (torch.tensor(reference["shed"]), torch.tensor(reference["quar"]),
                  torch.tensor(2, dtype=torch.int32))
    return tengine.serve_once(
        rows, up, resp, ct.tensors, kw.get("t", 7), static=st,
        damped=torch.tensor(reference["damped"]) if kw.get("damped") else None, net=net,
        period=torch.tensor(reference["period"], dtype=torch.int32) if kw.get("period") else None,
        policy=policy)


def _assert_same(got, want, name):
    assert set(got) == set(want), (name, sorted(got), sorted(want))
    for k, v in got.items():
        assert v.dtype == torch.int32, (name, k, v.dtype)
        assert v.tolist() == want[k], (name, k, v.tolist(), want[k])


@pytest.mark.parametrize("case", SERVES, ids=[s[0] for s in SERVES])
def test_serve_once_dense(reference, case):
    name, wl, over, kw = case
    rows = torch.tensor(reference["dense/view_key"], dtype=torch.int32)
    up, resp, rules = _serve_inputs(reference, "dense")
    got = _serve(rows, up, resp, rules, reference, wl, over, kw)
    _assert_same(got, reference[f"dense/{name}"], name)
    if name in ("plain", "latency"):
        assert int(got["delivered"]) > 0 and int(got["dropped"]) > 0
    if name == "latency":
        assert int(got["gray_timeouts"]) > 0 and int(got["lat_sum_ms"]) > 0
    if name == "every_off":
        assert all(int(v.sum()) == 0 for v in got.values())


@pytest.mark.parametrize("case", DELTA_SERVES, ids=[s[0] for s in DELTA_SERVES])
def test_serve_once_delta(reference, case):
    """A delta state served from its tables (``DeltaRows``: no [N, N]
    table) and from its materialized table, both the reference's."""
    name, wl, over, kw = case
    dtypes = reference["delta/state_dtypes"]
    fields = {f: None if v is None else np.asarray(v, dtype=dtypes[f])
              for f, v in reference["delta/state"].items()}
    state = convert.delta_state_from_numpy(fields, device="cpu")
    up, resp, rules = _serve_inputs(reference, "delta")
    from ringpop_tpu_torch.models import swim_delta as tdelta

    table = tdelta.materialize_rows(state, torch.arange(N))
    for rows in (tengine.DeltaRows(state), table):
        got = _serve(rows, up, resp, rules, reference, wl, over, kw)
        _assert_same(got, reference[f"delta/{name}"], name)


def test_delta_divergence_counts_sided_rows():
    """The table-free ring-divergence count equals the [N, N] count on a
    sided state (per-side base rows) and with a quarantine mask."""
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.models.cluster import SimCluster

    c = SimCluster(16, tsim.SwimParams(suspicion_ticks=4), seed=2, device="cpu",
                   backend="delta", capacity=8, wire_cap=4, claim_grid=32)
    c.tick(2)
    c.split_sides([list(range(8)), list(range(8, 16))])
    c.kill(3)
    c.tick(3)
    st = c.state
    assert st.side is not None
    rng = np.random.default_rng(1)
    for trial in range(4):
        gossip = torch.from_numpy(rng.random(16) < 0.8)
        quar = None if trial == 0 else torch.from_numpy(rng.random(16) < 0.3)
        full = tengine._DenseViews(tdelta.materialize_rows(st, torch.arange(16)), None, quar)
        lean = tengine._DeltaViews(st, quar)
        assert int(lean.divergence(gossip)) == int(full.divergence(gossip))
        assert torch.equal(lean.self_in, tengine.in_ring_from_rows(
            tdelta.materialize_rows(st, torch.arange(16))).diagonal())
        idx = torch.tensor([0, 5, 9, 15, 5], dtype=torch.int32)
        assert torch.equal(lean.rows(idx), full.rows(idx))


def test_latency_helpers():
    assert tlat.backoff_ms_schedule(5).tolist() == [0, 1000, 3500, 3500, 3500]
    assert tlat.backoff_ms_schedule(0).tolist() == [0]
    assert tlat.backoff_tick_offsets(3, 200).tolist() == [0, 0, 5, 22]
    assert tlat.bucket_edges_ms(5).tolist() == [1, 2, 4, 8]
    ms = np.array([-3, 0, 1, 2, 3, 4, 7, 8, 1000, 2**31 - 1])
    want = tlat.bucket_index(ms, 8)
    got = tlat.bucket_index(torch.tensor(ms, dtype=torch.int32), 8)
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    assert want.tolist() == [0, 0, 1, 2, 2, 3, 3, 4, 7, 7]
    counts = tlat.bucket_counts(torch.tensor(ms, dtype=torch.int32),
                                torch.tensor([True] * 9 + [False]), 8)
    assert counts.tolist() == [2, 1, 2, 2, 1, 0, 0, 1]
    stats = tlat.hist_stats(np.array([2, 1, 2, 2, 1, 0, 0, 1]))
    assert stats["count"] == 9 and stats["median"] == 2.0 and stats["max"] == 64.0
    assert tlat.hist_stats(np.zeros(4))["count"] == 0
