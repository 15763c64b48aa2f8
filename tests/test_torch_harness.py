"""Shared harness for the port's parity tests, plus its own checks.

The JAX reference's ``swim_sim`` and ``SimCluster`` do not import in a
process with jax 0.9 unless two runtime patches are applied (an alias
for ``pltpu.TPUMemorySpace`` and a ``__contains__`` on the batching
proxy).  Those patches are process-global, so they are applied only in
a child process: ``run_reference`` runs a list of cluster cases there
and returns each case's trajectory (per-tick state, metrics, keys, net
and checksums; ``pre{t}`` is the state a tick op starts from) as
numpy arrays.  A field is stacked over the snapshots where its shape
holds (``{name}/{field}``), else recorded per snapshot
(``{name}/s{k}/{field}``, left out where it is None), as the sided
fields are: ``base_key`` turns from [N] to [G, N] and back, and
``side``/``merge_to`` come and go; ``snapshot`` reads either form.
``run_port`` drives the port through the same ops, and
``assert_same_trajectory`` compares the two exactly.

A case is ``{"name", "n", "params", "seed", "init", "checksums",
"ops"}``, plus for the delta backend ``"backend": "delta"`` and its
caps under ``"caps"`` (``capacity``, ``wire_cap``, ``claim_grid``),
``"damping": True`` for the damping planes, and ``"sparse_small_n": m``
to run the reference with ``swim_sim._SPARSE_SMALL_N = m`` (the forced
block-prefix lowerings; the port's test patches its own module alike);
each op is ``["tick", k]`` or a ``SimCluster`` method name with its
arguments (``["kill", 3]``, ``["partition", [[0, 1], [2]]]``,
``["heal_partition"]``, ``["rebase", True]``, ...), the same on both
sides; ``["run_host_loop", spec_dict]`` runs a scenario through each
side's ``scenarios.runner.run_host_loop``, every segment it ticks
recorded as a tick op; ``["try", op...]`` runs an op and records the
exception it raises as ``"Type: message"`` under ``{name}/try{i}`` (i
the op's index; "" for none) and the key after it
(``{name}/key_after_try{i}``).  ``["run_scenario", spec, kwargs]`` runs
``SimCluster.run_scenario`` on each side; ``["run_streamed", spec,
kwargs]`` runs ``scenarios.stream.run_streamed``, with a checkpoint in
the case's ``tmp_dir`` where ``kwargs`` has ``"checkpoint": True``, and
after an ``interrupt_after`` kill finishes through ``stream.resume``
(the resumed cluster carries on) unless ``"resume": False`` (the
checkpoint's path is then recorded under ``{name}/ckpt{i}``);
``["resume_checkpoint", path]`` finishes the streamed run a checkpoint at ``path``
left (``stream.resume``; the resumed cluster carries on).  Each
records, under ``{name}/sc{i}/``, the trace's arrays (``trace/...``) and
meta (``trace_meta``), the state, net, key, loss and last
``metrics_log`` entry after it.  ``["run_sweep", spec, replicas,
kwargs]`` runs ``SimCluster.run_sweep`` (``"store": True`` streams into
a store in the case's ``tmp_dir``) and records under ``{name}/sw{i}/``
the sweep trace's arrays and meta, each replica's final state and net
stacked on a leading replica axis (``states/...``, ``nets/...``), and
the cluster's state, key and log length after it (``sweep_record``,
``assert_same_sweep``).  In a ``try`` op a trailing ``{"kwargs": {...}}``
passes keyword arguments.  A case with ``"stats": True`` gives the
cluster a ``CaptureEmitter`` stats sink; a ``["stats"]`` op records its
calls so far (``{name}/stats{i}``, JSON), and a ``["provenance"]`` op
the cluster's ``provenance_report()``, its ``summary_block``, the
``write_spans`` file and the ``emit_provenance`` calls
(``{name}/pv{i}``, JSON; ``assert_same_provenance``,
``assert_same_stats``).  Before every tick the net's fault
fields (``NET_FAULT_FIELDS``) and the loss are recorded
(``{name}/net{t}/{field}``, ``{name}/loss{t}``).  A case with
``"lookups": {"keys": [...], "viewers": [...]}``
also records, after its ops, the global ``traffic_ring()`` tables
(``{name}/traffic/hashes``, ``/owners``), and per viewer v the host
ring ``ring_for(v)`` (``{name}/ring{v}/hash``, ``/server``,
``/checksum``), ``lookup`` of every key (``{name}/lookup{v}``) and
``lookup_batch`` of them all (``{name}/batch{v}``), None as "".
``run_references`` runs the cases once per reference lowering
(``DELTA_LOWERINGS``: environment variables that the reference reads
when it is imported), one child process each, side by side.

``run_reference_calls`` evaluates single reference functions on given
arrays in one child process, for the unit tests of single port
functions; ``flatten_outputs`` lays the port's results out the same
way.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

# The port's CPU runs in the tests are small: one torch thread a worker,
# so that the suite's workers and their reference children do not
# oversubscribe the host (``one_thread`` still pins a module that
# changes it).
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STATE_FIELDS = ("view_key", "pb", "suspect_left", "tick")
# the fields a cluster case compares: with the in-flight buffer and the
# damping planes, which are None unless a case installs them
CLUSTER_FIELDS = STATE_FIELDS + ("pending", "damp", "damped")
DELTA_FIELDS = (
    "base_key", "bp_mask", "bp_rank", "bp_list", "d_subj", "d_key", "d_pb", "d_sl",
    "tick", "overflow_drops", "side", "merge_to", "digest",
    "pend_subj", "pend_key", "pend_recv", "d_bpmask", "d_bprank",
)
# NetState's fault-model fields, recorded before every tick op
NET_FAULT_FIELDS = (
    "link_src", "link_dst", "link_p", "link_d", "link_j", "period", "ov_cnt", "ov_gray",
)


def child_env(**extra: str) -> dict[str, str]:
    """The environment of a reference child: the CPU platform, the repo on
    the path, and XLA:CPU on one thread.  The suite runs six workers on
    the host, each with its reference children, so an intra-op pool a
    child per core only oversubscribes the cores (its small programs gain
    nothing from it)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **extra)
    env["XLA_FLAGS"] = " ".join(filter(None, (
        env.get("XLA_FLAGS", ""),
        "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")))
    return env


def case_fields(case: dict) -> tuple[str, ...]:
    return DELTA_FIELDS if case.get("backend") == "delta" else CLUSTER_FIELDS


# The two runtime patches for jax 0.9, applied only in child processes.
_PATCHES = r"""
import json, sys
import numpy as np
from jax.experimental.pallas import tpu as pltpu
if not hasattr(pltpu, "TPUMemorySpace"):
    pltpu.TPUMemorySpace = pltpu.MemorySpace
from jax._src.interpreters import batching
type(batching.primitive_batchers).__contains__ = lambda self, key: True
"""

_REFERENCE = _PATCHES + r"""
import os
from ringpop_tpu.models import swim_sim as sim
from ringpop_tpu.models.cluster import SimCluster
from ringpop_tpu.scenarios import stream

with open(sys.argv[1]) as f:
    cases = json.load(f)
out = {}
small_n = sim._SPARSE_SMALL_N
for case in cases:
    name = case["name"]
    fields = case["fields"]
    want_small_n = case.get("sparse_small_n", small_n)
    if want_small_n != sim._SPARSE_SMALL_N:
        # a traced constant: programs compiled under the other value go
        import jax
        jax.clear_caches()
        sim._SPARSE_SMALL_N = want_small_n
    from ringpop_tpu.obs.emitters import CaptureEmitter
    c = SimCluster(case["n"], sim.SwimParams(**case.get("params", {})),
                   seed=case.get("seed", 0), init=case.get("init", "converged"),
                   backend=case.get("backend", "dense"), damping=case.get("damping", False),
                   stats_emitter=CaptureEmitter() if case.get("stats") else None,
                   **case.get("caps", {}))
    snaps = []
    def snap():
        # host copies now: a scenario run donates the state's buffers
        snaps.append({f: None if getattr(c.state, f) is None else np.asarray(getattr(c.state, f))
                      for f in fields})
    snap()
    t = 0
    real_tick = c.tick
    def tick(k=1):
        global t
        for f in fields:
            if getattr(c.state, f) is not None:
                out[f"{name}/pre{t}/{f}"] = np.asarray(getattr(c.state, f))
        out[f"{name}/key{t}"] = np.asarray(c.key)
        out[f"{name}/k{t}"] = np.array(k)
        out[f"{name}/loss{t}"] = np.array(c.params.loss)
        out[f"{name}/up{t}"] = np.asarray(c.net.up)
        out[f"{name}/responsive{t}"] = np.asarray(c.net.responsive)
        if c.net.adj is not None:
            out[f"{name}/adj{t}"] = np.asarray(c.net.adj)
        for f in case["net_fields"]:
            if getattr(c.net, f) is not None:
                out[f"{name}/net{t}/{f}"] = np.asarray(getattr(c.net, f))
        m = real_tick(k)
        for key, v in m.items():
            out[f"{name}/m{t}/{key}"] = np.asarray(v)
        snap()
        if case.get("checksums"):
            ck = c.checksums()
            out[f"{name}/ck{t}_addr"] = np.array(list(ck), dtype=object).astype(str)
            out[f"{name}/ck{t}_val"] = np.array(list(ck.values()), dtype=np.int64)
        t += 1
        return m
    def call(op):
        if op[0] == "run_host_loop":
            from ringpop_tpu.scenarios import runner
            from ringpop_tpu.scenarios.spec import ScenarioSpec
            runner.run_host_loop(c, ScenarioSpec.from_dict(op[1]))
        elif isinstance(op[-1], dict) and set(op[-1]) == {"kwargs"}:
            getattr(c, op[0])(*op[1:-1], **op[-1]["kwargs"])
        else:
            getattr(c, op[0])(*op[1:])
    def record_sweep(key, tr):
        for k, v in tr.to_arrays().items():
            out[f"{key}/trace/{k}"] = np.asarray(v)
        out[f"{key}/trace_meta"] = np.array(json.dumps(tr.meta()))
        for f in fields:
            if getattr(tr.final_states, f) is not None:
                out[f"{key}/states/{f}"] = np.asarray(getattr(tr.final_states, f))
        for f, v in tr.final_nets._asdict().items():
            if v is not None:
                out[f"{key}/nets/{f}"] = np.asarray(v)
        for f in fields:
            if getattr(c.state, f) is not None:
                out[f"{key}/state/{f}"] = np.asarray(getattr(c.state, f))
        out[f"{key}/key"] = np.asarray(c.key)
        out[f"{key}/log_len"] = np.array([len(c.metrics_log), len(c.traces)])
    def record_scenario(key, tr):
        for k, v in tr.to_arrays().items():
            out[f"{key}/trace/{k}"] = np.asarray(v)
        out[f"{key}/trace_meta"] = np.array(json.dumps(tr.meta()))
        for f in fields:
            if getattr(c.state, f) is not None:
                out[f"{key}/state/{f}"] = np.asarray(getattr(c.state, f))
        for f, v in c.net._asdict().items():
            if v is not None:
                out[f"{key}/net/{f}"] = np.asarray(v)
        out[f"{key}/key"] = np.asarray(c.key)
        out[f"{key}/loss"] = np.array(c.params.loss)
        out[f"{key}/log"] = np.array(json.dumps(c.metrics_log[-1]))
    c.tick = tick
    for i, op in enumerate(case["ops"]):
        if op[0] == "tick":
            tick(op[1])
        elif op[0] == "run_scenario":
            record_scenario(f"{name}/sc{i}", c.run_scenario(op[1], **(op[2] if len(op) > 2 else {})))
        elif op[0] == "run_streamed":
            kw = dict(op[2])
            ck = os.path.join(case["tmp_dir"], f"{name}-{i}.npz")
            if kw.pop("checkpoint", False):
                kw["checkpoint_path"] = ck
            finish = kw.pop("resume", True)
            try:
                tr = stream.run_streamed(c, op[1], **kw)
            except stream.StreamInterrupted:
                out[f"{name}/ckpt{i}"] = np.array(ck)
                if not finish:
                    continue
                c, tr = stream.resume(ck)
                real_tick = c.tick
                c.tick = tick
            record_scenario(f"{name}/sc{i}", tr)
        elif op[0] == "resume_checkpoint":
            c, tr = stream.resume(op[1])
            real_tick = c.tick
            c.tick = tick
            record_scenario(f"{name}/sc{i}", tr)
        elif op[0] == "run_sweep":
            kw = dict(op[3])
            if kw.pop("store", False):
                kw["store"] = os.path.join(case["tmp_dir"], f"{name}-sweep-{i}")
            record_sweep(f"{name}/sw{i}", c.run_sweep(op[1], op[2], **kw))
        elif op[0] == "provenance":
            from ringpop_tpu.obs import bridge, provenance, spans
            rep = c.provenance_report()
            path = os.path.join(case["tmp_dir"], f"{name}-spans-{i}.json")
            spans.write_spans(rep, path)
            cap = CaptureEmitter()
            bridge.emit_provenance(rep, cap)
            with open(path) as f:
                out[f"{name}/pv{i}"] = np.array(json.dumps({
                    "report": rep, "summary": provenance.summary_block(rep),
                    "spans": f.read(), "emit": cap.calls}))
        elif op[0] == "stats":
            out[f"{name}/stats{i}"] = np.array(json.dumps(c.stats_sink.emitter.calls))
        elif op[0] == "try":
            try:
                call(op[1:])
                out[f"{name}/try{i}"] = np.array("")
            except Exception as e:
                out[f"{name}/try{i}"] = np.array(f"{type(e).__name__}: {e}")
            out[f"{name}/key_after_try{i}"] = np.asarray(c.key)
        else:
            call(op)
    look = case.get("lookups")
    if look:
        keys = look["keys"]
        ring = c.traffic_ring()
        out[f"{name}/traffic/hashes"] = np.asarray(ring.hashes)
        out[f"{name}/traffic/owners"] = np.asarray(ring.owners)
        for v in look["viewers"]:
            hr = c.ring_for(v)
            out[f"{name}/ring{v}/hash"] = np.array([h for h, _ in hr._entries], np.int64)
            out[f"{name}/ring{v}/server"] = np.array([s for _, s in hr._entries], dtype=str)
            out[f"{name}/ring{v}/checksum"] = np.array(hr.checksum, np.int64)
            out[f"{name}/lookup{v}"] = np.array(
                [c.lookup(k, viewer=v) or "" for k in keys], dtype=str)
            out[f"{name}/batch{v}"] = np.array(
                [o or "" for o in c.lookup_batch(keys, viewer=v)], dtype=str)
    for f in fields:
        vals = [None if s[f] is None else np.asarray(s[f]) for s in snaps]
        if all(v is not None for v in vals) and len({v.shape for v in vals}) == 1:
            out[f"{name}/{f}"] = np.stack(vals)
            continue
        for k, v in enumerate(vals):
            if v is not None:
                out[f"{name}/s{k}/{f}"] = v
np.savez_compressed(sys.argv[2], **out)
"""


# The delta reference's two lowerings of its kernel sites: the XLA
# defaults, and the Pallas kernels (interpret mode on the CPU) that the
# port's CUDA kernels replace.  The switches are read when the reference
# module is imported, so each lowering runs in its own child process.
DELTA_LOWERINGS = {
    "default": {},
    "pallas": {"RINGPOP_WIDE_METHOD": "pallas", "RINGPOP_DELTA_MERGE": "pallas"},
}


def run_reference(cases: list[dict], tmp_dir: str) -> dict[str, np.ndarray]:
    """Run ``cases`` through the JAX reference in a child process."""
    return run_references(cases, tmp_dir, {"default": {}})["default"]


def run_references(
    cases: list[dict], tmp_dir: str, envs: dict[str, dict[str, str]]
) -> dict[str, dict[str, np.ndarray]]:
    """Run ``cases`` through the JAX reference once per entry of
    ``envs`` (name -> extra environment), one child process each, all
    at once; returns each run's trajectories under its name.  A case
    with ``"lowerings": [names]`` runs only in those children."""
    procs = {}
    for name, extra in envs.items():
        spec = os.path.join(tmp_dir, f"cases-{name}.json")
        with open(spec, "w") as f:
            json.dump([{**c, "fields": list(case_fields(c)),
                        "net_fields": list(NET_FAULT_FIELDS), "tmp_dir": tmp_dir}
                       for c in cases if name in c.get("lowerings", envs)], f)
        out = os.path.join(tmp_dir, f"reference-{name}.npz")
        env = child_env(**extra)
        procs[name] = (out, subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, spec, out],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    results = {}
    try:
        for name, (out, proc) in procs.items():
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"reference run {name!r} failed:\n{err[-4000:]}")
            with np.load(out) as z:
                results[name] = {k: z[k] for k in z.files}
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


# Calls of single reference functions: each call names a module of
# ``ringpop_tpu.models`` (or ``gossip_remote_copy`` or ``bitpack`` of
# ``ringpop_tpu.ops``, or ``engine`` of ``ringpop_tpu.traffic``) and a
# function in it, and its arguments, each ``["array", key]`` (an array
# of the npz handed over), ``["delta_state", {field: key}]`` (a
# ``DeltaState`` of such arrays), ``["net", {field: key}]`` (a
# ``NetState``), ``["tuple", [...]]`` or ``["py", value]``.  A call with
# ``"ring": d`` runs jitted inside ``ring_mesh(parallel.make_mesh(d))``
# (the ring primitives need the context); a call with ``"raises": true``
# records the name of the exception it raises under ``{name}/raises``; a
# call with ``"sparse_small_n": m`` runs with ``swim_sim._SPARSE_SMALL_N``
# set to m in the child (the forced large-row lowerings), as a cluster
# case with that key does.  ``["cluster_state", {field: key}]``,
# ``["swim_params", {...}]`` and ``["delta_params", {"swim", "wire_cap",
# "claim_grid"}]`` build those arguments; a dict result (metrics) is
# flattened by key.
_CALLS = _PATCHES + r"""
import functools
import jax
import jax.numpy as jnp
from ringpop_tpu.models import swim_delta, swim_sim
from ringpop_tpu.ops import bitpack, gossip_remote_copy
from ringpop_tpu.traffic import engine

with open(sys.argv[1]) as f:
    calls = json.load(f)
z = np.load(sys.argv[2])
mods = {"swim_delta": swim_delta, "swim_sim": swim_sim,
        "gossip_remote_copy": gossip_remote_copy, "bitpack": bitpack,
        "engine": engine}

def arg(a):
    kind, v = a
    if kind == "array":
        return jnp.asarray(z[v])
    if kind == "delta_state":
        return swim_delta.DeltaState(**{f: jnp.asarray(z[k]) for f, k in v.items()})
    if kind == "net":
        return swim_sim.NetState(**{f: jnp.asarray(z[k]) for f, k in v.items()})
    if kind == "cluster_state":
        return swim_sim.ClusterState(**{f: jnp.asarray(z[k]) for f, k in v.items()})
    if kind == "swim_params":
        return swim_sim.SwimParams(**v)
    if kind == "delta_params":
        return swim_delta.DeltaParams(swim=swim_sim.SwimParams(**v["swim"]),
                                      wire_cap=v["wire_cap"], claim_grid=v["claim_grid"])
    if kind == "tuple":
        return tuple(v)
    return v

out = {}
def flat(x, key):
    if x is None:
        return
    if hasattr(x, "_asdict"):
        for f, v in x._asdict().items():
            flat(v, f"{key}/{f}")
    elif isinstance(x, dict):
        for f, v in x.items():
            flat(v, f"{key}/{f}")
    elif isinstance(x, tuple):
        for i, v in enumerate(x):
            flat(v, f"{key}/{i}")
    else:
        out[key] = np.asarray(x)

small_n = swim_sim._SPARSE_SMALL_N
for c in calls:
    swim_sim._SPARSE_SMALL_N = c.get("sparse_small_n", small_n)
    fn = getattr(mods[c["module"]], c["fn"])
    args = [arg(a) for a in c["args"]]
    if "ring" in c:
        from ringpop_tpu import parallel
        with gossip_remote_copy.ring_mesh(parallel.make_mesh(c["ring"])):
            res = jax.jit(functools.partial(fn, **c.get("kwargs", {})))(*args)
    elif c.get("raises"):
        try:
            fn(*args, **c.get("kwargs", {}))
            res = np.array("")
        except Exception as e:
            res = np.array(type(e).__name__)
        out[c["name"] + "/raises"] = res
        continue
    else:
        res = fn(*args, **c.get("kwargs", {}))
    flat(res, c["name"])
np.savez_compressed(sys.argv[3], **out)
"""


def run_reference_script(code: str, tmp_dir: str) -> object:
    """Run ``code`` in a child process after the jax 0.9 patches; it
    writes a JSON value to the path in ``sys.argv[1]``, which is
    returned."""
    out = os.path.join(tmp_dir, "script-output.json")
    proc = subprocess.run(
        [sys.executable, "-c", _PATCHES + code, out],
        cwd=REPO, env=child_env(), capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"reference script failed:\n{proc.stderr[-4000:]}")
    with open(out) as f:
        return json.load(f)


class ReferenceScript:
    """A ``run_reference_script`` child started without waiting: the
    caller runs the port meanwhile and reads ``result()`` after (or
    ``close()`` it, which kills a child still running)."""

    def __init__(self, code: str, tmp_dir: str, name: str = "script"):
        self.out = os.path.join(tmp_dir, f"{name}-output.json")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _PATCHES + code, self.out],
            cwd=REPO, env=child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        self._value = None

    def result(self, timeout: float = 900) -> object:
        if self._value is None:
            _, err = self.proc.communicate(timeout=timeout)
            if self.proc.returncode != 0:
                raise RuntimeError(f"reference script failed:\n{err[-4000:]}")
            with open(self.out) as f:
                self._value = json.load(f)
        return self._value

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def flatten_outputs(x, key: str, out: dict) -> dict:
    """Numpy leaves of a (nested) result under ``key/field`` or
    ``key/index`` names, None leaves left out: the child's layout."""
    if x is None:
        return out
    if hasattr(x, "_asdict"):
        for f, v in x._asdict().items():
            flatten_outputs(v, f"{key}/{f}", out)
    elif isinstance(x, dict):
        for f, v in x.items():
            flatten_outputs(v, f"{key}/{f}", out)
    elif isinstance(x, tuple):
        for i, v in enumerate(x):
            flatten_outputs(v, f"{key}/{i}", out)
    else:
        out[key] = x.numpy() if torch.is_tensor(x) else np.asarray(x)
    return out


def run_reference_calls(
    calls: list[dict], arrays: dict[str, np.ndarray], tmp_dir: str,
    env: dict[str, str] | None = None,
) -> dict[str, np.ndarray]:
    """Evaluate single reference functions in one child process (the
    default lowering, plus ``env``); returns the flattened outputs of
    every call."""
    spec = os.path.join(tmp_dir, "calls.json")
    inputs = os.path.join(tmp_dir, "call-inputs.npz")
    out = os.path.join(tmp_dir, "call-outputs.npz")
    with open(spec, "w") as f:
        json.dump(calls, f)
    np.savez(inputs, **arrays)
    proc = subprocess.run(
        [sys.executable, "-c", _CALLS, spec, inputs, out],
        cwd=REPO, env=child_env(**(env or {})),
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"reference calls failed:\n{proc.stderr[-4000:]}")
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


# Sharded runs of the reference (``ringpop_tpu.parallel``) on the child's
# virtual CPU mesh.  A case is ``{"name", "backend": "dense"|"delta",
# "entry": "step"|"run", "n", "d", "params", "seed", "ticks"}`` plus
# ``"caps"`` (delta: capacity, wire_cap, claim_grid), ``"init"``,
# ``"joins"`` (dense: every node joins through node 0 first),
# ``"down"`` (nodes killed before the first tick), ``"damping"`` (dense:
# the damping planes), and for the delta
# backend ``"sides"`` (sided mode: halves split by ``make_sides`` and the
# group-id adjacency) with ``"heal_at"`` (the step from which the
# adjacency is all one group) and ``"rebase_at"`` (the steps before which
# the state is rebased, ``anti_entropy=True``).  A dense case may give
# ``"adj"`` (``{"groups": [N]}`` or ``{"mask": [[N] x N]}``, installed on
# the net before the start, the step built for its layout), and a case of
# either backend ``"events"`` (``{"t": [["kill", i] | ["revive", i, inc],
# ...]}``, applied before step t, after a rebase there: a kill clears
# ``up[i]``, a revive is ``sim.revive`` (``sd.revive`` on the delta
# backend) and sets it again).  It records the start
# state and net, the keys, and the state and metrics after every step
# (``{name}/{t}/...``, ``{name}/m{t}/...``) or after the run
# (``{name}/run/...``, ``{name}/mrun/...``).  A case with ``"faults":
# {"rules": {"src", "dst", "p", "d", "j"}, "depth", "period"}`` installs
# those link rules and that period row on the net (recorded under
# ``{name}/net/...``) and the in-flight buffer of that depth in the
# state before its start is recorded.  The layout maps of
# ``parallel.mesh`` come back as JSON under ``maps/{NAME}``.
_SHARDED = _PATCHES + r"""
import jax
from ringpop_tpu import parallel
from ringpop_tpu.models import swim_delta as sd, swim_sim as sim
from ringpop_tpu.parallel import mesh as pmesh

with open(sys.argv[1]) as f:
    cases = json.load(f)
out = {f"maps/{m}": np.array(json.dumps(getattr(pmesh, m)))
       for m in ("CLUSTER_FIELD_SPECS", "NET_FIELD_SPECS", "DELTA_FIELD_SPECS")}

def record(key, values):
    for f, v in values.items():
        if v is not None:
            out[f"{key}/{f}"] = np.array(v)

for case in cases:
    name, n, d = case["name"], case["n"], case["d"]
    mesh = parallel.make_mesh(d)
    net = sim.make_net(n)
    for i in case.get("down", []):
        net = net._replace(up=net.up.at[i].set(False))
    out[f"{name}/up"] = np.array(net.up)
    out[f"{name}/responsive"] = np.array(net.responsive)
    swim = sim.SwimParams(**case.get("params", {}))
    faults = case.get("faults")
    if faults:
        jnp = jax.numpy
        r = faults["rules"]
        net = net._replace(
            link_src=jnp.asarray(np.array(r["src"], bool)),
            link_dst=jnp.asarray(np.array(r["dst"], bool)),
            link_p=jnp.asarray(np.array(r["p"], np.float32)),
            link_d=jnp.asarray(np.array(r["d"], np.int32)),
            link_j=jnp.asarray(np.array(r["j"], np.int32)),
            period=jnp.asarray(np.array(faults["period"], np.int32)),
        )
        record(f"{name}/net", {f: getattr(net, f) for f in
                               ("link_src", "link_dst", "link_p", "link_d", "link_j", "period")})
    if case["backend"] == "delta":
        params = sd.DeltaParams(swim=swim, wire_cap=case["caps"]["wire_cap"],
                                claim_grid=case["caps"]["claim_grid"])
        state = sd.init_delta(n, capacity=case["caps"]["capacity"])
        if case.get("sides"):
            gid = (np.arange(n) >= n // 2).astype(np.int32)
            state = sd.make_sides(state, gid)
            net = net._replace(adj=jax.numpy.asarray(gid))
        if faults:
            state = sd.install_pending(state, faults["depth"], case["caps"]["wire_cap"])
        record(f"{name}/init", state._asdict())
        like = (dict(net_like=net, state_like=state)
                if case.get("sides") or faults else {})
        state = parallel.shard_delta(state, mesh)
        build = parallel.sharded_delta_step if case["entry"] == "step" else parallel.sharded_delta_run
        fn = build(mesh, gossip=case.get("gossip"), **like)
    else:
        params = swim
        adj = case.get("adj")
        if adj is not None:
            net = net._replace(adj=jax.numpy.asarray(
                np.array(adj["groups"], np.int32) if "groups" in adj
                else np.array(adj["mask"], bool)))
        state = sim.init_state(n, mode=case.get("init", "converged"),
                               damping=case.get("damping", False))
        if case.get("joins"):
            for j in range(1, n):
                state = sim.admin_join(state, j, 0)
        if faults:
            d = faults["depth"]
            state = state._replace(pending=jax.numpy.zeros((d, n, n), jax.numpy.int32))
        record(f"{name}/init", state._asdict())
        like = dict(like=state, net_like=net) if faults or adj is not None else {}
        state, net = parallel.shard_cluster(state, net, mesh)
        build = parallel.sharded_step if case["entry"] == "step" else parallel.sharded_run
        fn = build(mesh, gossip=case.get("gossip"), **like)
    key = jax.random.PRNGKey(case["seed"])
    if case["entry"] == "step":
        keys = jax.random.split(key, case["ticks"])
        out[f"{name}/keys"] = np.array(keys)
        for t, k in enumerate(keys):
            if t == case.get("heal_at"):
                net = net._replace(adj=jax.numpy.zeros(n, jax.numpy.int32))
            if t in case.get("rebase_at", []):
                state = parallel.shard_delta(sd.rebase(state, anti_entropy=True), mesh)
            for ev in case.get("events", {}).get(str(t), []):
                delta = case["backend"] == "delta"
                if ev[0] == "revive":
                    state = (sd if delta else sim).revive(state, ev[1], ev[2])
                net = net._replace(up=net.up.at[ev[1]].set(ev[0] == "revive"))
                if delta:
                    state = parallel.shard_delta(state, mesh)
                else:
                    state, net = parallel.shard_cluster(state, net, mesh)
            state, m = fn(state, net, k, params)
            record(f"{name}/{t}", state._asdict())
            record(f"{name}/m{t}", m)
    else:
        out[f"{name}/key"] = np.array(key)
        state, m = fn(state, net, key, params, case["ticks"])
        record(f"{name}/run", state._asdict())
        record(f"{name}/mrun", m)
np.savez_compressed(sys.argv[2], **out)
"""


def run_sharded_references(cases: list[dict], tmp_dir: str) -> dict[str, np.ndarray]:
    """Run each sharded case through the reference in its own child
    process, all at once; returns every case's records in one mapping."""
    procs = []
    for case in cases:
        spec = os.path.join(tmp_dir, f"sharded-{case['name']}.json")
        out = os.path.join(tmp_dir, f"sharded-{case['name']}.npz")
        with open(spec, "w") as f:
            json.dump([case], f)
        env = child_env()
        procs.append((case["name"], out, subprocess.Popen(
            [sys.executable, "-c", _SHARDED, spec, out],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    results: dict[str, np.ndarray] = {}
    try:
        for name, out, proc in procs:
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"sharded reference {name!r} failed:\n{err[-4000:]}")
            with np.load(out) as z:
                results.update({k: z[k] for k in z.files})
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return results


@pytest.fixture(scope="module")
def one_thread():
    """One torch intra-op thread for a module's port runs: under the
    suite's parallel workers (and their reference children) the default
    pool of one thread a core oversubscribes the host and a CPU run of
    the serving plane's draws slows many times over.  The count in force
    before comes back after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def port_cluster(case: dict):
    from ringpop_tpu_torch.models import swim_sim as tsim
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.obs.emitters import CaptureEmitter

    return SimCluster(
        case["n"], tsim.SwimParams(**case.get("params", {})),
        seed=case.get("seed", 0), init=case.get("init", "converged"), device="cpu",
        backend=case.get("backend", "dense"), damping=case.get("damping", False),
        stats_emitter=CaptureEmitter() if case.get("stats") else None,
        **case.get("caps", {}),
    )


def provenance_record(c, path: str) -> dict:
    """What a ``["provenance"]`` op leaves: the cluster's
    ``provenance_report()``, its ``summary_block``, the ``write_spans``
    file (written to ``path``) and the ``emit_provenance`` stat calls."""
    from ringpop_tpu_torch.obs import bridge, provenance, spans
    from ringpop_tpu_torch.obs.emitters import CaptureEmitter

    rep = c.provenance_report()
    spans.write_spans(rep, path)
    cap = CaptureEmitter()
    bridge.emit_provenance(rep, cap)
    with open(path) as f:
        return {"report": rep, "summary": provenance.summary_block(rep), "spans": f.read(),
                "emit": [list(x) for x in cap.calls]}


def run_port(case: dict, on_tick=None, tries: dict | None = None,
             scenarios: dict | None = None, tmp_dir: str | None = None) -> list[dict]:
    """Drive the port's ``SimCluster`` on the CPU through ``case["ops"]``;
    returns one record per tick (a tick op, or a segment of the host
    loop of a ``["run_host_loop", spec]`` op): the state after it, its
    metrics, and the net's fault fields it ran under.  ``on_tick(t,
    cluster)`` runs after each tick.  A ``["try", op...]`` op runs the
    op and records, in ``tries`` under the op's index, the exception it
    raised as ``"Type: message"`` ("" for none), as the reference
    child records ``{name}/try{i}``.  ``run_scenario`` and
    ``run_streamed`` ops (checkpoints in ``tmp_dir``) record in
    ``scenarios`` under the op's index what ``scenario_record`` gives
    (``{"ckpt": path}`` for an interrupted run left unfinished), and a
    ``try`` op its key after (``{"key": ...}``)."""
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.scenarios import runner, stream
    from ringpop_tpu_torch.scenarios.spec import ScenarioSpec

    c = port_cluster(case)
    recs = []
    real_tick = c.tick

    def tick(k=1):
        net = {f: _np_or_none(getattr(c.net, f)) for f in NET_FAULT_FIELDS}
        m = real_tick(k)
        recs.append({"metrics": m, "net": net, **{f: _np_or_none(getattr(c.state, f))
                                                  for f in case_fields(case)}})
        if on_tick is not None:
            on_tick(len(recs) - 1, c)
        return m

    def call(op):
        if op[0] == "run_host_loop":
            runner.run_host_loop(c, ScenarioSpec.from_dict(op[1]))
        elif isinstance(op[-1], dict) and set(op[-1]) == {"kwargs"}:
            getattr(c, op[0])(*op[1:-1], **op[-1]["kwargs"])
        else:
            getattr(c, op[0])(*op[1:])

    c.tick = tick
    for i, op in enumerate(case["ops"]):
        if op[0] == "tick":
            tick(op[1])
        elif op[0] == "run_scenario":
            scenarios[i] = scenario_record(c, case, c.run_scenario(
                op[1], **(op[2] if len(op) > 2 else {})))
        elif op[0] == "run_streamed":
            kw = dict(op[2])
            ck = os.path.join(tmp_dir, f"{case['name']}-{i}.npz")
            if kw.pop("checkpoint", False):
                kw["checkpoint_path"] = ck
            finish = kw.pop("resume", True)
            try:
                tr = stream.run_streamed(c, op[1], **kw)
            except stream.StreamInterrupted:
                if not finish:
                    scenarios[i] = {"ckpt": ck}
                    continue
                c, tr = stream.resume(ck, device="cpu")
                real_tick = c.tick
                c.tick = tick
            scenarios[i] = scenario_record(c, case, tr)
        elif op[0] == "resume_checkpoint":
            c, tr = stream.resume(op[1], device="cpu")
            real_tick = c.tick
            c.tick = tick
            scenarios[i] = scenario_record(c, case, tr)
        elif op[0] == "run_sweep":
            kw = dict(op[3])
            if kw.pop("store", False):
                kw["store"] = os.path.join(tmp_dir, f"{case['name']}-sweep-{i}")
            scenarios[i] = sweep_record(c, case, c.run_sweep(op[1], op[2], **kw))
        elif op[0] == "provenance":
            scenarios[i] = provenance_record(
                c, os.path.join(tmp_dir, f"{case['name']}-port-spans-{i}.json"))
        elif op[0] == "stats":
            scenarios[i] = {"stats": [list(x) for x in c.stats_sink.emitter.calls]}
        elif op[0] == "try":
            try:
                call(op[1:])
                tries[i] = ""
            except Exception as e:  # noqa: BLE001 - the type is what is compared
                tries[i] = f"{type(e).__name__}: {e}"
            if scenarios is not None:
                scenarios[i] = {"key": convert.key_to_numpy(c.key)}
        else:
            call(op)
    return recs


def scenario_record(c, case: dict, trace) -> dict:
    """What a scenario op leaves, as numpy under the reference's names and
    dtypes: the trace's arrays and meta, the state, net, key, loss and
    last ``metrics_log`` entry."""
    from ringpop_tpu_torch import convert

    state = (convert.delta_state_to_numpy(c.state) if case.get("backend") == "delta"
             else convert.state_to_numpy(c.state))
    return {
        "trace": trace.to_arrays(),
        "meta": json.loads(json.dumps(trace.meta())),
        "state": {f: state[f] for f in case_fields(case)},
        "net": {f: v for f, v in convert.net_to_numpy(c.net).items() if v is not None},
        "key": convert.key_to_numpy(c.key),
        "loss": c.params.loss,
        "log": c.metrics_log[-1],
    }


def sweep_record(c, case: dict, trace) -> dict:
    """What a sweep op leaves, as numpy under the reference's names and
    dtypes: the sweep trace's arrays and meta, each replica's final
    state and net stacked on a leading replica axis, and the cluster's
    state, key and log length after it."""
    from ringpop_tpu_torch import convert

    to_np = (convert.delta_state_to_numpy if case.get("backend") == "delta"
             else convert.state_to_numpy)
    per = [to_np(st) for st in trace.final_states]
    nets = [convert.net_to_numpy(nt) for nt in trace.final_nets]
    state = to_np(c.state)
    return {
        "trace": trace.to_arrays(),
        "meta": json.loads(json.dumps(trace.meta())),
        "states": {f: np.stack([p[f] for p in per]) for f in case_fields(case)
                   if per[0][f] is not None},
        "nets": {f: np.stack([p[f] for p in nets]) for f in nets[0] if nets[0][f] is not None},
        "state": {f: state[f] for f in case_fields(case) if state[f] is not None},
        "key": convert.key_to_numpy(c.key),
        "log_len": np.array([len(c.metrics_log), len(c.traces)]),
    }


def assert_same_sweep(ref: dict[str, np.ndarray], case: dict, i: int, got: dict) -> None:
    """The port's record of sweep op ``i`` equal to the reference's,
    every array with its dtype."""
    key = f"{case['name']}/sw{i}"
    for part, width in (("trace", 7), ("states", 8), ("nets", 6), ("state", 7)):
        want = {k[len(key) + width:]: v for k, v in ref.items()
                if k.startswith(f"{key}/{part}/")}
        assert set(got[part]) == set(want), (key, part, sorted(got[part]), sorted(want))
        for k, v in want.items():
            assert_same_field(np.asarray(got[part][k]), v, f"{key}: {part} {k}")
    assert got["meta"] == json.loads(str(ref[key + "/trace_meta"])), key
    assert_same_field(got["key"], ref[key + "/key"], f"{key}: key")
    np.testing.assert_array_equal(got["log_len"], ref[key + "/log_len"], err_msg=key)


def assert_same_scenario(ref: dict[str, np.ndarray], case: dict, i: int, got: dict) -> None:
    """The port's record of scenario op ``i`` equal to the reference's,
    every array with its dtype."""
    key = f"{case['name']}/sc{i}"
    want_trace = {k[len(key) + 7:]: v for k, v in ref.items() if k.startswith(key + "/trace/")}
    assert set(got["trace"]) == set(want_trace), (key, sorted(got["trace"]), sorted(want_trace))
    for k, v in want_trace.items():
        assert_same_field(np.asarray(got["trace"][k]), v, f"{key}: trace {k}")
    assert got["meta"] == json.loads(str(ref[key + "/trace_meta"])), key
    for f in case_fields(case):
        assert_same_field(got["state"][f], ref.get(f"{key}/state/{f}"), f"{key}: state {f}")
    want_net = {k[len(key) + 5:]: v for k, v in ref.items() if k.startswith(key + "/net/")}
    assert set(got["net"]) == set(want_net), (key, sorted(got["net"]), sorted(want_net))
    for f, v in want_net.items():
        assert_same_field(got["net"][f], v, f"{key}: net {f}")
    assert_same_field(got["key"], ref[key + "/key"], f"{key}: key")
    assert got["loss"] == float(ref[key + "/loss"]), key
    assert got["log"] == json.loads(str(ref[key + "/log"])), key


def assert_same_provenance(ref: dict[str, np.ndarray], case: dict, i: int, got: dict) -> None:
    """The port's record of provenance op ``i`` equal to the reference's:
    the report, the summary block, the stat calls and the spans file,
    byte for byte."""
    want = json.loads(str(ref[f"{case['name']}/pv{i}"]))
    assert got["spans"] == want["spans"], case["name"]
    assert json.loads(json.dumps(got)) == want, case["name"]


def assert_same_stats(ref: dict[str, np.ndarray], case: dict, i: int, got: dict) -> None:
    """The stat calls the port's sink captured up to op ``i`` equal to
    the reference's, in order, keys, types and values."""
    want = json.loads(str(ref[f"{case['name']}/stats{i}"]))
    assert got["stats"] == want, case["name"]


def split_heal(n: int, split: int, heal: int, split_every: int = 4) -> list:
    """Sided ops: ``split_sides`` into halves, ``split`` one-tick ops with
    an anti-entropy rebase after every ``split_every``, the heal, then
    ``heal`` one-tick ops with a rebase after every 10."""
    t1 = ["tick", 1]
    ops = [["split_sides", [list(range(n // 2)), list(range(n // 2, n))]]]
    for t in range(split):
        ops += [t1] + ([["rebase", True]] if t % split_every == split_every - 1 else [])
    ops.append(["heal_partition"])
    for t in range(heal):
        ops += [t1] + ([["rebase", True]] if t % 10 == 9 else [])
    return ops


def _np_or_none(x):
    return None if x is None else x.numpy()


def snapshot(ref: dict[str, np.ndarray], name: str, f: str, k: int) -> np.ndarray | None:
    """Field ``f`` of case ``name`` at snapshot ``k`` (0 is the start,
    k the state after the k-th tick op); None where the reference's
    field was None."""
    stacked = ref.get(f"{name}/{f}")
    return stacked[k] if stacked is not None else ref.get(f"{name}/s{k}/{f}")


def assert_same_field(got, want, msg: str, dtype: bool = True) -> None:
    """Equal arrays (of one dtype, with ``dtype``), or both None."""
    if want is None or got is None:
        assert got is None and want is None, msg
        return
    assert not dtype or got.dtype == want.dtype, msg
    np.testing.assert_array_equal(got, want, err_msg=msg)


def assert_same_trajectory(ref: dict[str, np.ndarray], case: dict, recs: list[dict]) -> None:
    """Every state field and metric equal on every tick op."""
    name = case["name"]
    for t, rec in enumerate(recs):
        for f in case_fields(case):
            assert_same_field(rec[f], snapshot(ref, name, f, t + 1),
                              f"{name}: {f} at tick op {t}", dtype=False)
        for f in NET_FAULT_FIELDS:
            if "net" in rec:
                assert_same_field(rec["net"][f], ref.get(f"{name}/net{t}/{f}"),
                                  f"{name}: net {f} at tick op {t}")
        want_m = {
            k.rsplit("/", 1)[1]: int(v) for k, v in ref.items()
            if k.startswith(f"{name}/m{t}/")
        }
        got_m = {k: v for k, v in rec["metrics"].items() if k != "ticks"}
        assert got_m == {k: v for k, v in want_m.items() if k != "ticks"}, (name, t)


def step_from_reference(ref: dict, case: dict, t: int):
    """The port's ``delta_step_impl`` from the reference's state, net and
    key before tick op ``t`` (a one-tick op): (state, metrics)."""
    from ringpop_tpu_torch import convert, prng
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.models import swim_sim as tsim

    name = case["name"]
    state = convert.delta_state_from_numpy(
        {f: ref.get(f"{name}/pre{t}/{f}") for f in DELTA_FIELDS}, device="cpu"
    )
    net = tsim.make_net(case["n"], device="cpu")._replace(
        up=torch.as_tensor(ref[f"{name}/up{t}"]),
        responsive=torch.as_tensor(ref[f"{name}/responsive{t}"]),
        adj=torch.as_tensor(ref[f"{name}/adj{t}"]) if f"{name}/adj{t}" in ref else None,
        **{f: torch.as_tensor(ref[f"{name}/net{t}/{f}"]) for f in NET_FAULT_FIELDS
           if f"{name}/net{t}/{f}" in ref},
    )
    _, sub = prng.split(convert.key_from_numpy(ref[f"{name}/key{t}"]))
    swim = tsim.SwimParams(**case.get("params", {}))
    if f"{name}/loss{t}" in ref:
        swim = swim._replace(loss=float(ref[f"{name}/loss{t}"]))
    params = tdelta.DeltaParams(swim=swim,
                                **{k: v for k, v in case["caps"].items() if k != "capacity"})
    return tdelta.delta_step_impl(state, net, sub, params)


def assert_steps_from_reference(ref: dict, case: dict) -> int:
    """Every one-tick tick of ``case`` (a tick op, or a segment of a host
    loop), stepped from the reference's own pre-tick state, net and key:
    every field (with its reference dtype) and metric; returns how many
    were checked."""
    from ringpop_tpu_torch import convert

    name = case["name"]
    ticks = 0
    while f"{name}/key{ticks}" in ref:
        ticks += 1
    checked = 0
    for t in range(ticks):
        if int(ref[f"{name}/k{t}"]) != 1:
            continue
        state, metrics = step_from_reference(ref, case, t)
        got = convert.delta_state_to_numpy(state)
        for f in DELTA_FIELDS:
            assert_same_field(got[f], snapshot(ref, case["name"], f, t + 1),
                              f"{case['name']}: {f} at {t}")
        want_m = {k.rsplit("/", 1)[1]: int(v) for k, v in ref.items()
                  if k.startswith(f"{case['name']}/m{t}/")}
        assert {k: int(v) for k, v in metrics.items()} == {
            k: v for k, v in want_m.items() if k != "ticks"
        }, (case["name"], t)
        checked += 1
    return checked


# ---------------------------------------------------------------------------
# checks of the port's boundary
# ---------------------------------------------------------------------------

_PORT_MODULES = (
    "ringpop_tpu_torch",
    "ringpop_tpu_torch.prng",
    "ringpop_tpu_torch._build",
    "ringpop_tpu_torch.convert",
    "ringpop_tpu_torch.ops.recv_merge",
    "ringpop_tpu_torch.ops.farmhash",
    "ringpop_tpu_torch.ops.checksum_device",
    "ringpop_tpu_torch.ops.bitpack",
    "ringpop_tpu_torch.ops.searchsorted",
    "ringpop_tpu_torch.ops.delta_merge",
    "ringpop_tpu_torch.ops.gossip_remote_copy",
    "ringpop_tpu_torch.parallel",
    "ringpop_tpu_torch.parallel.mesh",
    "ringpop_tpu_torch.models.swim_sim",
    "ringpop_tpu_torch.models.swim_delta",
    "ringpop_tpu_torch.models.checksum",
    "ringpop_tpu_torch.models.cluster",
    "ringpop_tpu_torch.profile_tick",
    "ringpop_tpu_torch.utils",
    "ringpop_tpu_torch.utils.events",
    "ringpop_tpu_torch.hashring",
    "ringpop_tpu_torch.ops.ring_ops",
    "ringpop_tpu_torch.traffic",
    "ringpop_tpu_torch.traffic.workloads",
    "ringpop_tpu_torch.traffic.engine",
    "ringpop_tpu_torch.traffic.latency",
    "ringpop_tpu_torch.policies",
    "ringpop_tpu_torch.policies.core",
    "ringpop_tpu_torch.ring_rebalance",
    "ringpop_tpu_torch.scenarios",
    "ringpop_tpu_torch.scenarios.spec",
    "ringpop_tpu_torch.scenarios.faults",
    "ringpop_tpu_torch.scenarios.compile",
    "ringpop_tpu_torch.scenarios.runner",
    "ringpop_tpu_torch.scenarios.trace",
    "ringpop_tpu_torch.scenarios.stream",
    "ringpop_tpu_torch.scenarios.sweep",
    "ringpop_tpu_torch.stats",
    "ringpop_tpu_torch.checkpoint",
    "ringpop_tpu_torch.obs",
    "ringpop_tpu_torch.obs.emitters",
    "ringpop_tpu_torch.obs.bridge",
    "ringpop_tpu_torch.obs.provenance",
    "ringpop_tpu_torch.obs.spans",
    "ringpop_tpu_torch.obs.ledger",
    "ringpop_tpu_torch.obs.annotate",
    "ringpop_tpu_torch.scenarios.library",
    "ringpop_tpu_torch.cli",
    "ringpop_tpu_torch.cli.tick_cluster",
    "ringpop_tpu_torch.__main__",
)


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_PORT_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ringpop_tpu' or m.startswith('ringpop_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    assert "import jax" not in src and "from jax" not in src
    assert "ringpop_tpu." not in src.replace("ringpop_tpu_torch", "")


def test_no_cuda_raises(monkeypatch):
    from ringpop_tpu_torch.models import swim_sim as tsim
    from ringpop_tpu_torch.models.cluster import SimCluster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimCluster(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsim.init_state(8)


def test_kernels_refuse_without_their_build(monkeypatch):
    """A CUDA tensor never reaches a plain version: with no nvcc the
    wrapper raises instead of falling back."""
    from ringpop_tpu_torch import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", os.path.join(REPO, "no-such-toolkit"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("recv_merge")


def test_convert_round_trip():
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models import swim_sim as tsim

    st = tsim.init_state(6, [0, 1, 2, 3, 4, 5], device="cpu")
    back = convert.state_from_numpy(convert.state_to_numpy(st), device="cpu")
    for f in STATE_FIELDS:
        assert torch.equal(getattr(st, f), getattr(back, f))
        assert getattr(st, f).dtype == getattr(back, f).dtype
    net = tsim.make_net(6, partitioned=True, device="cpu")
    net2 = convert.net_from_numpy(convert.net_to_numpy(net), device="cpu")
    assert torch.equal(net.adj, net2.adj)
    key = np.array([1, 4294967295], dtype=np.uint32)
    assert (convert.key_to_numpy(convert.key_from_numpy(key)) == key).all()
    # the policy carry and the provenance planes cross both ways, the
    # packed knows words as the reference's uint32 (all 32 bits); a field
    # no NetState has is refused
    po = {"po_press": np.arange(6, dtype=np.int32), "po_shed": np.ones(6, bool),
          "po_quar": np.zeros(6, bool), "po_sends_w": np.arange(8, dtype=np.int32),
          "po_deliv_w": np.ones(8, np.int32), "po_retry_cap": np.array(2, np.int32),
          "pv_slot": np.array([[3, 10, 1, 0], [-1, -1, -1, 0]], np.int32),
          "pv_tickv": np.array([[2, -1], [-1, -1]], np.int16),
          "pv_wits": np.array([[4], [-1]], np.int32),
          "pv_first": np.arange(12, dtype=np.int16).reshape(2, 6) - 1,
          "pv_parent": np.arange(12, dtype=np.int32).reshape(2, 6) - 3,
          "pv_knows": np.array([[0xFFFFFFFF], [5]], np.uint32)}
    net3 = convert.net_from_numpy({**convert.net_to_numpy(net), **po}, "cpu")
    assert net3.pv_knows.dtype == torch.int64 and int(net3.pv_knows[0, 0]) == 0xFFFFFFFF
    back = convert.net_to_numpy(net3)
    for f, v in po.items():
        assert back[f].dtype == v.dtype and (back[f] == v).all(), f
    with pytest.raises(NotImplementedError):
        convert.net_from_numpy({**convert.net_to_numpy(net), "pv_bogus": np.zeros((1, 4))}, "cpu")
