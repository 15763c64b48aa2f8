"""The port's observability modules against the JAX reference's, in
process.

``ringpop_tpu.obs.provenance``, ``.bridge``, ``.emitters`` and ``.spans``
import under this host's jax without the reference child's patches, so
they run here beside the port's copies on the same inputs, made from a
numpy seed: the provenance fold (``_attribute`` over K rumors at once,
``prov_update`` over several ticks of random evidence with delayed lanes
and duplicate declarations, reserved and free slots), ``build_report``,
``summary_block``, ``trace_events`` and the ``write_spans`` file; the
statsd line protocol (over a localhost socket), the JSON-lines round
trip and ``make_emitter``'s specs; ``emit_counters``, ``replay_trace``
(traffic counters, the latency plane's timing samples, continuation
slabs) and ``emit_provenance``.  Every result must be equal.  Last, a
``SimCluster(stats_emitter=)`` run: every key it emits is in the
bridge's tables or carries the ``sim.`` prefix, and each increment's
total is the trace series it replays.
"""

from __future__ import annotations

import io
import json
import socket
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.obs import bridge as rbridge
from ringpop_tpu.obs import emitters as remit
from ringpop_tpu.obs import provenance as rpvn
from ringpop_tpu.obs import spans as rspans
from ringpop_tpu_torch.models.cluster import SimCluster
from ringpop_tpu_torch.models.swim_sim import SwimParams
from ringpop_tpu_torch.obs import bridge as tbridge
from ringpop_tpu_torch.obs import emitters as temit
from ringpop_tpu_torch.obs import provenance as tpvn
from ringpop_tpu_torch.obs import spans as tspans
from ringpop_tpu_torch.scenarios.trace import Trace

N, K, KK, TICKS = 24, 5, 2, 8


def _evidence(rng: np.random.Generator, n: int, kk: int) -> dict[str, np.ndarray]:
    """A random evidence bundle: targets and witnesses in range, hop
    masks nested as the step's are, a third of the declarations aimed at
    nodes 0-3 (so simultaneous declarers collide)."""
    tgt = rng.integers(0, n, n).astype(np.int32)
    tgt[: n // 3] = rng.integers(0, 4, n // 3)
    wit = rng.integers(0, n, (n, kk)).astype(np.int32)
    send = rng.random(n) < 0.9
    ping = send & (rng.random(n) < 0.8)
    req = (rng.random((n, kk)) < 0.5) & ~ping[:, None]
    rping = req & (rng.random((n, kk)) < 0.7)
    return {
        "pv_tgt": tgt, "pv_send": send, "pv_ping": ping,
        "pv_ack": ping & (rng.random(n) < 0.8),
        "pv_wit": wit, "pv_witv": rng.random((n, kk)) < 0.8,
        "pv_req": req, "pv_rping": rping, "pv_rack": rping & (rng.random((n, kk)) < 0.7),
        "pv_resp": req & (rng.random((n, kk)) < 0.7),
        "pv_decl": rng.random(n) < 0.3,
    }


def _views(rng: np.random.Generator, n: int, t: int) -> np.ndarray:
    """Post-tick view keys: incarnations rising with the tick, statuses
    alive, suspect, faulty and leave, so rumors arm, spread and resolve
    both ways."""
    inc = rng.integers(0, 2, (n, n)) + t // 3
    status = rng.choice([1, 2, 2, 3, 4], (n, n))
    return (inc * 8 + status).astype(np.int32)


def _fold_both():
    """TICKS ticks of random evidence folded by both sides; returns the
    per-tick (carry, heard) pairs of each."""
    rng = np.random.default_rng(12)
    pv_at = np.array([0, 3, 0, 0, 0], np.int32)
    pv_node = np.array([2, 3, -1, -1, -1], np.int32)
    rc = rpvn.init_carry(N, K, KK)
    tc = tpvn.init_carry(N, K, KK, device="cpu")
    r_at, r_node = jnp.asarray(pv_at), jnp.asarray(pv_node)
    t_at, t_node = torch.from_numpy(pv_at), torch.from_numpy(pv_node)
    out = []
    for t in range(TICKS):
        ev = _evidence(rng, N, KK)
        views = _views(rng, N, t)
        rev = {k: jnp.asarray(v) for k, v in ev.items()}
        tev = {k: torch.from_numpy(v) for k, v in ev.items()}
        rc, rh = rpvn.prov_update(
            rc, rev, t, lambda q: jnp.take_along_axis(jnp.asarray(views), q, axis=1),
            r_at, r_node, N)
        tc, th = tpvn.prov_update(
            tc, tev, t, lambda q: torch.gather(torch.from_numpy(views), 1, q.long()),
            t_at, t_node, N)
        out.append(((rc, rh), (tc, th)))
    return out


@pytest.fixture(scope="module")
def folded():
    return _fold_both()


def test_attribute_matches_reference():
    """The batched attribution over K rumors equals the reference's per
    rumor, row for row."""
    rng = np.random.default_rng(3)
    ev = _evidence(rng, N, 3)
    ks = rng.random((K, N)) < 0.4
    got = tpvn._attribute(torch.from_numpy(ks), {k: torch.from_numpy(v) for k, v in ev.items()}, N)
    rev = {k: jnp.asarray(v) for k, v in ev.items()}
    for j in range(K):
        want = np.asarray(rpvn._attribute(jnp.asarray(ks[j]), rev, N))
        np.testing.assert_array_equal(got[j].numpy(), want, err_msg=str(j))


def test_prov_update_matches_reference(folded):
    """Every carry plane (dtypes as the reference's, the knows words as
    the same 32 bits) and the heard counts, tick by tick."""
    armed = 0
    for t, ((rc, rh), (tc, th)) in enumerate(folded):
        np.testing.assert_array_equal(th.numpy(), np.asarray(rh), err_msg=f"heard {t}")
        for f in rpvn.ProvCarry._fields:
            want = np.asarray(getattr(rc, f))
            got = getattr(tc, f).numpy()
            if f == "knows":
                got = got.astype(np.uint32)
            assert got.dtype == want.dtype, (f, t)
            np.testing.assert_array_equal(got, want, err_msg=f"{f} {t}")
        armed = int((np.asarray(rc.slot)[:, 0] >= 0).sum())
    assert armed == K  # the random evidence armed every slot


def test_report_summary_and_spans_match_reference(folded, tmp_path):
    """``build_report``, ``summary_block``, ``trace_events`` and the
    ``write_spans`` file (byte for byte) equal the reference's."""
    (rc, _), (tc, _) = folded[-1]
    want = rpvn.build_report(*rc, N)
    got = tpvn.build_report(*tc, N)
    assert got == want
    res = {r["resolution"] for r in got["rumors"]}
    assert {tpvn.RES_REFUTED, tpvn.RES_CONFIRMED} <= res
    assert tpvn.summary_block(got) == rpvn.summary_block(want)
    assert tpvn.summary_block({"rumors": []}) == rpvn.summary_block({"rumors": []})
    assert tspans.trace_events(got, tick_us=250) == rspans.trace_events(want, tick_us=250)
    a, b = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    assert tspans.write_spans(got, a) == rspans.write_spans(want, b)
    assert open(a).read() == open(b).read()
    cap_t, cap_r = temit.CaptureEmitter(), remit.CaptureEmitter()
    assert tbridge.emit_provenance(got, cap_t) == rbridge.emit_provenance(want, cap_r)
    assert cap_t.calls == cap_r.calls


def test_statsd_line_protocol_matches_reference():
    """The same datagrams, byte for byte, for counts, gauges, timings,
    integral and fractional values and ``None``."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(5)
    port = sock.getsockname()[1]
    calls = [("increment", "a.b", None), ("increment", "a.b", 3), ("gauge", "g", 2.5),
             ("gauge", "g", None), ("timing", "t", 7.0), ("timing", "t", 0.125)]
    lines = {}
    try:
        for name, mod in (("port", temit), ("ref", remit)):
            e = mod.StatsdEmitter("127.0.0.1", port)
            for method, key, value in calls:
                getattr(e, method)(key, value)
            assert (e.sent, e.dropped) == (len(calls), 0)
            e.close()
            lines[name] = [sock.recv(256) for _ in calls]
    finally:
        sock.close()
    assert lines["port"] == lines["ref"]
    assert lines["port"][0] == b"a.b:1|c" and lines["port"][2] == b"g:2.5|g"


def test_jsonl_and_capture_emitters_match_reference(tmp_path):
    """JSON-lines rows (but their time stamps) and a capture's aggregates
    equal the reference's; ``MultiEmitter`` fans out to both."""
    rows = {}
    caps = {}
    for name, mod in (("port", temit), ("ref", remit)):
        buf = io.StringIO()
        cap = mod.CaptureEmitter()
        e = mod.MultiEmitter(mod.JsonlEmitter(buf), cap)
        e.increment("x", 2)
        e.gauge("y", 1.5)
        e.timing("z", 4)
        e.increment("x")
        e.close()
        rows[name] = [{k: v for k, v in json.loads(ln).items() if k != "ts"}
                      for ln in buf.getvalue().splitlines()]
        caps[name] = (cap.calls, dict(cap.counters), cap.gauges, cap.timings,
                      cap.suffixes("x"))
    assert rows["port"] == rows["ref"] and len(rows["port"]) == 4
    assert caps["port"] == caps["ref"]
    path = str(tmp_path / "stats.jsonl")
    e = temit.make_emitter(path)
    e.gauge("k", 3)
    e.close()
    assert json.loads(open(path).read())["value"] == 3


@pytest.mark.parametrize("spec", ["capture", "-", "statsd://127.0.0.1:9", "udp://localhost:8125",
                                  "statsd://nohost", "udp://:9"])
def test_make_emitter_matches_reference(spec):
    """The same emitter type (or the same error) for each string form."""
    def build(mod):
        try:
            e = mod.make_emitter(spec)
        except ValueError as err:
            return f"ValueError: {err}"
        kind = type(e).__name__
        if kind == "StatsdEmitter":
            kind += f" {e.host}:{e.port}"
            e.close()
        return kind

    assert build(temit) == build(remit)


def _trace_arrays(rng: np.random.Generator, ticks: int) -> dict:
    """A served run's telemetry: protocol and traffic counters, the
    changes-applied trio, sim-only series and a latency plane."""
    names = ["pings_sent", "acks", "ping_reqs", "full_syncs", "suspects_declared",
             "faulty_declared", "ping_changes_applied", "ack_changes_applied",
             "pingreq_changes_applied", "claims_dropped", "lookups", "lookupns",
             "proxy_sends", "proxy_retries", "proxy_failed", "send_errors",
             "retry_succeeded", "misroutes"]
    metrics = {k: rng.integers(0, 4, ticks).astype(np.int32) for k in names}
    live = np.array([10, 9, 9, 10, 10, 8, 9, 9][:ticks], np.int32)
    return {
        "metrics": metrics,
        "planes": {"lat_hist_ms": rng.integers(0, 12, (ticks, 6)).astype(np.int32)},
        "converged": rng.random(ticks) < 0.5,
        "live": live,
        "loss": np.full(ticks, 0.05, np.float32),
    }


@pytest.fixture
def reference_latency(monkeypatch):
    """The reference bridge's timing replay imports
    ``ringpop_tpu.traffic.latency``, whose package imports the step
    modules that need the child's patches: for this test the package is
    a bare module holding the file itself (``sys.modules`` is restored
    after it)."""
    import importlib.util
    import sys
    import types

    path = rbridge.__file__.replace("obs/bridge.py", "traffic/latency.py")
    spec = importlib.util.spec_from_file_location("ringpop_tpu.traffic.latency", path)
    latency = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "ringpop_tpu.traffic", types.ModuleType("ringpop_tpu.traffic"))
    monkeypatch.setitem(sys.modules, "ringpop_tpu.traffic.latency", latency)
    spec.loader.exec_module(latency)


@pytest.mark.parametrize("mode", ["whole", "slab", "pending", "bare"])
def test_replay_trace_matches_reference(mode, reference_latency):
    """``replay_trace`` of the same telemetry into both bridges: the same
    calls and call counts, whole, as a continuation slab, with the
    checksum pending, and without the namespace declaration."""
    arr = _trace_arrays(np.random.default_rng(5), 8)
    kw = {"whole": {"checksum": 123},
          "slab": {"declare_namespace": False, "prev_live": 12, "checksum_pending": True},
          "pending": {"checksum_pending": True},
          "bare": {"declare_namespace": False}}[mode]
    port_trace = Trace(n=12, backend="dense", **arr).validate()
    ref_trace = SimpleNamespace(ticks=8, **arr)
    cap_t, cap_r = temit.CaptureEmitter(), remit.CaptureEmitter()
    got = tbridge.replay_trace(port_trace, cap_t, prefix="p", **kw)
    want = rbridge.replay_trace(ref_trace, cap_r, prefix="p", **kw)
    assert got == want == len(cap_t.calls)
    assert cap_t.calls == cap_r.calls
    # emit_counters of one tick, and of a multi-tick entry (gauges only)
    for ticks in (1, 4):
        m = {k: int(v[0]) for k, v in arr["metrics"].items()}
        m["ticks"] = ticks
        sink_t = tbridge.StatSink(cap_t, "q")
        sink_r = rbridge.StatSink(cap_r, "q")
        assert tbridge.emit_counters(m, sink_t, live=7) == rbridge.emit_counters(m, sink_r, live=7)
    assert cap_t.calls == cap_r.calls
    assert tbridge.REFERENCE_KEYS == rbridge.REFERENCE_KEYS
    assert tbridge.TRAFFIC_KEYS == rbridge.TRAFFIC_KEYS


def test_cluster_stats_bridge_totals():
    """A ``SimCluster(stats_emitter=)``: tick loop, run_scenario and the
    same run streamed.  Every key is in the bridge's tables or ``sim.``;
    each increment total is its trace series' sum (plus the bootstrap
    alive count); the streamed run emits the whole run's calls."""
    spec = {"ticks": 14, "events": [{"at": 2, "op": "kill", "node": 7},
                                    {"at": 4, "op": "loss", "p": 0.1}]}
    known = set(tbridge.REFERENCE_KEYS) | set(tbridge.TRAFFIC_COUNTER_KEYS.values())
    caps = []
    for seg in (None, 4):
        cap = temit.CaptureEmitter()
        c = SimCluster(12, SwimParams(suspicion_ticks=3), seed=9, device="cpu",
                       stats_emitter=cap)
        trace = c.run_scenario(spec, segment_ticks=seg)
        caps.append(cap)
        suffixes = cap.suffixes(tbridge.DEFAULT_PREFIX)
        assert all(k in known or k.startswith("sim.") for k in suffixes), suffixes - known
        pre = tbridge.DEFAULT_PREFIX + "."
        for series, key in tbridge.PROTOCOL_COUNTER_KEYS.items():
            assert cap.counters[pre + key] == int(trace.metrics[series].sum()), key
        ups = np.diff(trace.live.astype(np.int64), prepend=0)
        assert cap.counters[pre + "membership-update.alive"] == int(ups[ups > 0].sum())
        assert cap.gauges[pre + "checksum"] == c.first_live_checksum()
    assert caps[0].calls == caps[1].calls
    cap = temit.CaptureEmitter()
    c = SimCluster(12, SwimParams(suspicion_ticks=3), seed=9, device="cpu", stats_emitter=cap)
    for _ in range(3):
        m = c.tick()
    assert cap.counters["ringpop.sim.ping.send"] > 0
    assert cap.gauges["ringpop.sim.num-members"] == 12
    assert cap.calls[-1] == ("gauge", "ringpop.sim.num-members", 12)
    assert m["ticks"] == 1
