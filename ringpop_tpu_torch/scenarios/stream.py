"""The streamed scenario runner: S-tick segments, a segment store, and
checkpointed soaks that resume.

The port of ``ringpop_tpu/scenarios/stream.py``.  A T-tick run becomes
``ceil(T / S)`` segments of ``runner._scenario_scan_impl``, each taking
over the state the one before left:

* **The same run as unsegmented.**  The key schedule is drawn once for
  the whole horizon by ``compile.key_schedule`` and sliced per segment,
  and the segment loop numbers its ticks from the segment's start, so
  any segment size gives ``run_scenario``'s trajectory and trace.
* **Pipelined.**  Segment k + 1's work is issued before segment k's
  telemetry is copied to pinned host memory (on a side stream, after
  segment k's last tick), so the copy and the store writes overlap the
  card's work; ``pipeline=False`` drains each segment first.
* **O(segment) host memory.**  Each segment's telemetry is a ``Trace``
  slab appended to a ``SegmentStore`` (a ``.npz`` a segment and a JSONL
  manifest), which reads back one slab at a time.
* **Checkpoints that resume.**  ``checkpoint.py`` v5 records the cursor
  (spec, segment size, ticks done, the key the schedule derives from)
  beside the state at the boundary, so ``resume`` finishes a killed soak
  with the uninterrupted run's trace and state.
* **Streamed sweeps.**  ``run_sweep_streamed`` runs R replicas
  (``sweep.Replicas``) segment by segment, replica by replica within a
  segment, and drains [R, S] ``SweepTrace`` slabs (store kind
  ``"sweep"``); the same replicas as the unsegmented ``run_sweep``.
  Sweeps do not checkpoint.

A served run (``traffic``, ``policy``) records its workload and policy
in the cursor, and carries the overload and policy state from segment
to segment (and through checkpoints, on the net's ``ov_*``/``po_*``);
a traced run (``trace_rumors``) carries its provenance planes the same
way (``pv_*``).  With a stats sink on the cluster
(``SimCluster(stats_emitter=)``) each segment's slab is replayed
through the Trace->stats bridge as it drains, and the run closes with
the checksum gauge: the stat stream of the unsegmented run.  Each
segment goes through the dispatch ledger (``obs/ledger.py``,
``launch``): with the ledger on, a row a segment records its dispatch,
drain and overlapped drain seconds under the run's ``run_id``, the
first segment of each shape cold.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Iterator

import numpy as np
import torch

from ringpop_tpu_torch import prng
from ringpop_tpu_torch.models import swim_sim as sim
from ringpop_tpu_torch.models.swim_sim import NetState
from ringpop_tpu_torch.obs import bridge as obs_bridge
from ringpop_tpu_torch.obs.ledger import default_ledger
from ringpop_tpu_torch.policies import core as pol
from ringpop_tpu_torch.scenarios import compile as scompile
from ringpop_tpu_torch.scenarios import runner as srunner
from ringpop_tpu_torch.scenarios import sweep as ssweep
from ringpop_tpu_torch.scenarios.spec import ScenarioSpec
from ringpop_tpu_torch.scenarios.trace import Trace

STORE_VERSION = 1
CURSOR_VERSION = 1


class StreamInterrupted(RuntimeError):
    """Raised by the ``interrupt_after`` hook: the run stops as a kill at
    that segment boundary would, the checkpoint and the segment store
    left on disk as a crash leaves them.  The cluster is not reusable
    (its state was handed to the abandoned segment); resume from the
    checkpoint."""


def segment_bounds(ticks: int, segment_ticks: int) -> list[tuple[int, int]]:
    """[(a, b)) tick ranges of each segment; the tail may be ragged."""
    if segment_ticks < 1:
        raise ValueError(f"segment_ticks must be >= 1 (got {segment_ticks})")
    return [(a, min(a + segment_ticks, ticks)) for a in range(0, ticks, segment_ticks)]


class SegmentStore:
    """Appendable on-disk store of per-segment telemetry slabs::

        store.json       # run meta: kind, n, backend, spec, run_id, ...
        manifest.jsonl   # one line per slab: {segment, tick0, ticks, file}
        seg-00000.npz    # a Trace slab (written atomically)

    Slab writes are atomic and the manifest append-only, so a crash
    leaves a readable prefix; ``truncate`` drops slabs past a resume
    cursor.  ``iter_traces`` holds one slab in memory at a time;
    ``assemble`` builds the whole series."""

    MANIFEST = "manifest.jsonl"
    METAFILE = "store.json"

    def __init__(self, path: str, meta: dict[str, Any], rows: list[dict[str, Any]]):
        self.path = path
        self.meta = meta
        self.rows = list(rows)

    @classmethod
    def create(cls, path: str, meta: dict[str, Any]) -> "SegmentStore":
        os.makedirs(path, exist_ok=True)
        meta_path = os.path.join(path, cls.METAFILE)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                old = json.load(f)
            if old.get("run_id") != meta.get("run_id"):
                raise ValueError(
                    f"segment store {path} already holds run "
                    f"{old.get('run_id')!r}; refusing to mix runs — pick a "
                    f"fresh directory or resume from that run's checkpoint"
                )
        meta = {"version": STORE_VERSION, **meta}
        tmp = meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=2)
        os.replace(tmp, meta_path)
        with open(os.path.join(path, cls.MANIFEST), "w"):
            pass  # a fresh manifest: tick 0 of a new run
        return cls(path, meta, [])

    @classmethod
    def open(cls, path: str) -> "SegmentStore":
        with open(os.path.join(path, cls.METAFILE)) as f:
            meta = json.load(f)
        if meta.get("version") != STORE_VERSION:
            raise ValueError(f"unsupported segment store version {meta.get('version')}")
        rows = []
        manifest = os.path.join(path, cls.MANIFEST)
        if os.path.exists(manifest):
            with open(manifest) as f:
                lines = [ln.strip() for ln in f if ln.strip()]
            for i, line in enumerate(lines):
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    if i == len(lines) - 1:
                        # a torn last line: its slab was never checkpointed
                        break
                    raise
        rows.sort(key=lambda r: r["tick0"])
        return cls(path, meta, rows)

    @property
    def kind(self) -> str:
        return self.meta.get("kind", "trace")

    @property
    def segments(self) -> int:
        return len(self.rows)

    @property
    def ticks_stored(self) -> int:
        return sum(int(r["ticks"]) for r in self.rows)

    def append(self, slab: Any, *, segment: int, tick0: int) -> dict[str, Any]:
        """Write one slab (a ``Trace``, or a ``SweepTrace`` in a store of
        kind ``"sweep"``; atomically) and its manifest line."""
        fname = f"seg-{segment:05d}.npz"
        slab.save(os.path.join(self.path, fname))
        row = {"segment": int(segment), "tick0": int(tick0), "ticks": int(slab.ticks),
               "file": fname}
        with open(os.path.join(self.path, self.MANIFEST), "a") as f:
            f.write(json.dumps(row) + "\n")
        self.rows.append(row)
        return row

    def truncate(self, ticks_done: int) -> None:
        """Drop the slabs past ``ticks_done`` (a resume's cursor): a crash
        between a slab's append and its checkpoint leaves one, which the
        resumed run writes again."""
        keep = [r for r in self.rows if r["tick0"] + r["ticks"] <= ticks_done]
        if len(keep) == len(self.rows):
            return
        manifest = os.path.join(self.path, self.MANIFEST)
        tmp = manifest + ".tmp"
        with open(tmp, "w") as f:
            for row in keep:
                f.write(json.dumps(row) + "\n")
        os.replace(tmp, manifest)
        self.rows = keep

    def load_segment(self, i: int) -> Any:
        path = os.path.join(self.path, self.rows[i]["file"])
        if self.kind == "sweep":
            return ssweep.SweepTrace.load(path)
        return Trace.load(path)

    def iter_traces(self) -> Iterator[Any]:
        """One slab resident at a time."""
        for i in range(len(self.rows)):
            yield self.load_segment(i)

    def assemble(self) -> Any:
        """The whole series (O(total ticks))."""
        if self.kind == "sweep":
            return ssweep.SweepTrace.concat_ticks(
                self.iter_traces(), spec=self.meta.get("spec")).validate()
        return Trace.concat(self.iter_traces(), spec=self.meta.get("spec")).validate()


def _schedule_from_start_key(start_key: Any, compiled: scompile.CompiledScenario) -> torch.Tensor:
    """The full key schedule again from the cluster key as it was at the
    run's start: the chain of splits ``SimCluster._split`` made."""
    # audit: allow=RPL005 keys are host metadata on the CPU
    kstate = {"key": torch.tensor([int(w) for w in start_key], dtype=torch.int64)}

    def split() -> torch.Tensor:
        kstate["key"], sub = prng.split(kstate["key"])
        return sub

    return scompile.key_schedule(split, compiled)


# audit: allow=RPL001 a checkpoint's host copy, by design
def _to_host(tup: Any) -> Any:
    """A NamedTuple of tensors copied to the CPU."""
    return type(tup)(*(None if v is None else v.cpu() for v in tup))


def run_streamed(
    cluster: Any,
    spec: Any,
    *,
    segment_ticks: int,
    traffic: Any | None = None,
    store: str | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    assemble: bool = True,
    pipeline: bool = True,
    interrupt_after: int | None = None,
    policy: Any | None = None,
) -> Any:
    """Run a scenario as S-tick segments: ``cluster.run_scenario(spec)``'s
    trajectory and trace, the telemetry streamed out a segment at a time.
    Returns the assembled ``Trace`` (with ``run_scenario``'s bookkeeping:
    ``cluster.traces``, ``metrics_log``), or the ``SegmentStore`` with
    ``assemble=False`` (which needs a store).

    ``checkpoint_path`` writes a v5 checkpoint every ``checkpoint_every``
    segments and at the end; the slabs then persist too (by default in
    ``checkpoint_path + ".segments"``) so that ``resume`` can finish the
    trace.  ``interrupt_after=k`` stops the run as a kill right after
    the k-th checkpoint would (``StreamInterrupted``).  ``traffic`` and
    ``policy`` are ``run_scenario``'s."""
    spec = srunner.as_spec(spec)
    spec.validate(cluster.n)
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1 (got {checkpoint_every})")
    if traffic is not None:
        traffic = cluster.compile_traffic(traffic)
    compiled = scompile.compile_spec(spec, cluster.n, base_loss=cluster.params.loss,
                                     device=cluster.device)
    params = cluster.dparams if cluster.backend == "delta" else cluster.params
    adj = srunner.precheck(cluster.state, cluster.net, compiled, params)
    srunner.precheck_overload(compiled, traffic, cluster.net)
    policy = cluster._compile_policy(policy, traffic)
    srunner.precheck_policy(policy, traffic, cluster.net)
    srunner.precheck_prov(compiled, cluster.net, params)
    if checkpoint_path and store is None:
        # a resume reassembles the whole trace from the slabs
        store = checkpoint_path + ".segments"
    if not assemble and store is None:
        raise ValueError(
            "assemble=False discards nothing only with a segment store "
            "(pass store=... or checkpoint_path=...)"
        )
    spec_dict = spec.to_dict()
    if traffic is not None:
        spec_dict["traffic"] = traffic.spec.to_dict()
    # everything that can raise comes before the key draw
    segment_bounds(compiled.ticks, int(segment_ticks))
    cursor = {
        "version": CURSOR_VERSION,
        "run_id": uuid.uuid4().hex[:12],
        "spec": spec.to_dict(),
        "traffic": traffic.spec.to_dict() if traffic is not None else None,
        "policy": pol.to_dict(policy) if policy is not None else None,
        "segment_ticks": int(segment_ticks),
        "ticks": compiled.ticks,
        "ticks_done": 0,
        # audit: allow=RPL001 the key is a CPU tensor: no sync
        "start_key": [int(x) for x in cluster.key.tolist()],
        "start_tick": int(cluster.state.tick),
        "base_loss": float(cluster.params.loss),
        "store": store,
        "checkpoint_every": int(checkpoint_every),
        "prev_live": None,
        "backend": cluster.backend,
    }
    store_obj = None
    if store is not None:
        store_obj = SegmentStore.create(store, {
            "kind": "trace", "run_id": cursor["run_id"], "n": cluster.n,
            "backend": cluster.backend, "segment_ticks": int(segment_ticks),
            "ticks": compiled.ticks, "start_tick": cursor["start_tick"], "spec": spec_dict,
        })
    keys = scompile.key_schedule(cluster._split, compiled)
    return _drive(cluster, compiled, keys, traffic, adj, cursor, store_obj, spec_dict,
                  checkpoint_path=checkpoint_path, assemble=assemble, pipeline=pipeline,
                  interrupt_after=interrupt_after, policy=policy)


def resume(
    checkpoint_path: str,
    *,
    device: torch.device | str | None = None,
    assemble: bool = True,
    pipeline: bool = True,
    interrupt_after: int | None = None,
) -> tuple[Any, Any]:
    """Finish a killed streamed run from its last checkpoint, on
    ``device`` (``cuda`` unless named): the key schedule again from the
    recorded start key, the segment store cut to the cursor, the rest of
    the segments run.  Returns ``(cluster, result)``, the result the
    whole ``Trace`` (the uninterrupted run's) or, with
    ``assemble=False``, the ``SegmentStore``.  A checkpoint whose cursor
    is complete only reopens the store."""
    from ringpop_tpu_torch import checkpoint as ckpt

    cluster = ckpt.load(checkpoint_path, device=device)
    cur = cluster.stream_cursor
    if cur is None:
        raise ValueError(
            f"{checkpoint_path} has no stream cursor (not a streamed-run "
            "checkpoint; plain checkpoints resume via checkpoint.load)"
        )
    if cur.get("store") is None:
        raise ValueError("stream cursor has no segment store to resume into")
    store_obj = SegmentStore.open(cur["store"])
    spec = ScenarioSpec.from_dict(cur["spec"])
    if cur["ticks_done"] >= cur["ticks"]:
        return cluster, (store_obj.assemble() if assemble else store_obj)
    store_obj.truncate(cur["ticks_done"])
    traffic = (cluster.compile_traffic(cur["traffic"]) if cur.get("traffic") is not None
               else None)
    compiled = scompile.compile_spec(spec, cluster.n, base_loss=cur["base_loss"],
                                     device=cluster.device)
    params = cluster.dparams if cluster.backend == "delta" else cluster.params
    # the checkpointed net carries this spec's own mirrored rules,
    # mid-window period row, overload and policy carries: the refusals of
    # standing state are for fresh runs
    adj = srunner.precheck(cluster.state, cluster.net, compiled, params, standing_ok=True)
    srunner.precheck_overload(compiled, traffic, cluster.net, standing_ok=True)
    # the cursor's exact knobs (never derived again from scale)
    policy = pol.from_dict(cur["policy"]) if cur.get("policy") is not None else None
    srunner.precheck_policy(policy, traffic, cluster.net, standing_ok=True)
    srunner.precheck_prov(compiled, cluster.net, params, standing_ok=True)
    # cluster.key is already past the whole schedule; derive it again
    # from the start key without touching it
    keys = _schedule_from_start_key(cur["start_key"], compiled)
    spec_dict = dict(store_obj.meta.get("spec") or spec.to_dict())
    result = _drive(cluster, compiled, keys, traffic, adj, dict(cur), store_obj, spec_dict,
                    checkpoint_path=checkpoint_path, assemble=assemble, pipeline=pipeline,
                    interrupt_after=interrupt_after, policy=policy)
    return cluster, result


class _Pending:
    """A launched segment's telemetry, on its way to the host, with its
    dispatch-ledger row (None with the ledger off)."""

    def __init__(self, seg: int, a: int, ys: dict[str, torch.Tensor],
                 row: dict[str, Any] | None = None):
        self.seg, self.a, self.ys, self.row = seg, a, ys, row
        self.block = srunner.stack_telemetry(ys)
        self.done = None
        if self.block.is_cuda:
            self.done = torch.cuda.Event()
            self.done.record()

    # audit: allow=RPL001,RPL005 the segment's one telemetry drain, into pinned host memory
    def host(self) -> dict[str, np.ndarray]:
        """The telemetry on the host: on the card, copied to pinned memory
        on a side stream that waits for the segment's last tick only."""
        if self.done is None:
            return srunner.unstack_telemetry(self.ys, self.block.numpy())
        side = torch.cuda.Stream(device=self.block.device)
        side.wait_event(self.done)
        with torch.cuda.stream(side):
            pinned = torch.empty(self.block.shape, dtype=self.block.dtype, pin_memory=True)
            pinned.copy_(self.block, non_blocking=True)
            self.block.record_stream(side)
        side.synchronize()
        return srunner.unstack_telemetry(self.ys, pinned.numpy())


def _launch_segment(program: str, fn: Any, args: tuple, kwargs: dict[str, Any],
                    meta: dict[str, Any], sig: tuple[tuple, dict[str, Any]]
                    ) -> tuple[Any, dict[str, Any] | None]:
    """``fn(*args, **kwargs)``, one segment, through the dispatch ledger
    (a plain call with the ledger off), its row describing ``sig``'s
    tensors and statics: its outputs and its unrecorded row, timed to
    the end of the launch (``dispatch_s``)."""
    t0 = time.perf_counter()
    out, row = default_ledger().launch(program, fn, *args, _meta=meta, _sig=sig, **kwargs)
    if row is not None:
        row["dispatch_s"] = round(time.perf_counter() - t0, 6)
    return out, row


def _drained(p: _Pending, t0: float, *, overlapped: bool) -> None:
    """Close a segment's ledger row: the drain's seconds (from ``t0``),
    counted as overlapped when the next segment was already launched."""
    if p.row is not None:
        drain_s = time.perf_counter() - t0
        p.row["drain_s"] = round(drain_s, 6)
        p.row["drain_overlap_s"] = round(drain_s if overlapped else 0.0, 6)
        default_ledger().record(p.row)


# audit: allow=RPL001 the streamed driver drains a segment and copies checkpoints, by design
def _drive(
    cluster: Any,
    compiled: scompile.CompiledScenario,
    keys: torch.Tensor,
    traffic: Any | None,
    adj: torch.Tensor,
    cursor: dict[str, Any],
    store_obj: SegmentStore | None,
    spec_dict: dict[str, Any],
    *,
    checkpoint_path: str | None,
    assemble: bool,
    pipeline: bool,
    interrupt_after: int | None,
    policy: Any | None = None,
) -> Any:
    """The segment loop shared by fresh runs and resumes."""
    from ringpop_tpu_torch import checkpoint as ckpt

    S = int(cursor["segment_ticks"])
    T = compiled.ticks
    bounds = segment_bounds(T, S)
    if cursor["ticks_done"] % S and cursor["ticks_done"] != T:
        raise ValueError(
            f"cursor ticks_done={cursor['ticks_done']} is not a segment boundary of S={S}"
        )
    start_seg = cursor["ticks_done"] // S
    params = cluster.dparams if cluster.backend == "delta" else cluster.params
    traffic = srunner.policy_traffic(srunner.overload_traffic(traffic, compiled), policy)
    f_state, period, ov = srunner.prepare_faults(cluster.state, cluster.net, compiled, params)
    po = (srunner.prepare_policy(policy, cluster.net, cluster.n, traffic.static.max_retries)
          if policy is not None else None)
    pv, pv_at, pv_node = srunner.prepare_prov(compiled, cluster.net, params)
    sink = cluster.stats_sink
    # the segments take the state over: the cluster keeps no reference
    # (a kill mid-run leaves it without one, as StreamInterrupted says)
    hand = sim._Handoff(f_state)
    cluster.state = f_state = None
    up, resp = cluster.net.up, cluster.net.responsive
    loss = compiled.loss.cpu().numpy()
    slabs: list[Trace] = []  # only without a store
    last = {"slab": None, "prev_live": cursor.get("prev_live"), "ckpts": 0}
    pending: _Pending | None = None

    def drain(p: _Pending, *, overlapped: bool) -> None:
        t0 = time.perf_counter()
        stacks = p.host()
        slab = srunner.make_trace(stacks, cluster, cursor["start_tick"] + p.a, None)
        if store_obj is not None:
            store_obj.append(slab, segment=p.seg, tick0=p.a)
        else:
            slabs.append(slab)
        if sink is not None:
            # the slab continues the stream: the namespace is declared by
            # the first segment this call runs, the checksum comes at the
            # end
            obs_bridge.replay_trace(
                slab, sink.emitter, prefix=sink.prefix, checksum=None,
                declare_namespace=(p.seg == start_seg), prev_live=last["prev_live"],
                checksum_pending=True,
            )
        last["slab"], last["prev_live"] = slab, int(stacks["live"][-1])
        _drained(p, t0, overlapped=overlapped)

    for seg in range(start_seg, len(bounds)):
        a, b = bounds[seg]
        due_prev = (checkpoint_path is not None and seg > start_seg
                    and seg % cursor["checkpoint_every"] == 0)
        snap = None
        if due_prev:
            # the state at the boundary, copied before the segment takes it
            carries = {k: v.cpu() for k, v in srunner.carry_fields(ov, po, pv).items()}
            snap = (_to_host(hand.state),
                    NetState(up=up.cpu(), responsive=resp.cpu(), adj=adj.cpu(),
                             period=None if period is None else period.cpu(), **carries))
        srunner._dispatches += 1
        meta = {"backend": cluster.backend, "n": cluster.n, "ticks": b - a, "replicas": 1,
                "run_id": cursor["run_id"], "segment": seg, "tick0": a,
                "segment_ticks": S, "total_ticks": T}
        if traffic is not None:
            meta["traffic_m"] = traffic.static.m
        if policy is not None:
            meta["policy"] = policy.name
        args = (hand, up, resp, adj, period, compiled, keys[a:b], loss[a:b], a)
        traced = dict(knobs=None, traffic=traffic, ov=ov, po=po, pv=pv, pv_at=pv_at,
                      pv_node=pv_node)
        statics = dict(params=params, policy=policy)
        out, row = _launch_segment(
            "run_scenario", srunner._scenario_scan_impl, args, {**traced, **statics}, meta,
            ((*args, *traced.values()), statics))
        del args, traced
        st, up, resp, adj, period, ov, po, pv, ys = out
        hand = sim._Handoff(st)
        del st, out
        launched = _Pending(seg, a, ys, row)
        if pending is not None:
            drain(pending, overlapped=True)
            pending = None
        if due_prev:
            ckpt.save(cluster, checkpoint_path, state=snap[0], net=snap[1],
                      stream=dict(cursor, ticks_done=int(bounds[seg - 1][1]),
                                  prev_live=last["prev_live"]))
            last["ckpts"] += 1
            if interrupt_after is not None and last["ckpts"] >= interrupt_after:
                raise StreamInterrupted(
                    f"simulated kill after checkpoint {last['ckpts']} "
                    f"(ticks_done={bounds[seg - 1][1]})"
                )
        pending = launched
        if not pipeline:
            drain(pending, overlapped=False)
            pending = None
    if pending is not None:
        drain(pending, overlapped=False)

    cluster.state = hand.take()
    cluster.net = srunner.final_net(up, resp, adj, period, compiled, ov=ov, po=po, pv=pv)
    cluster.set_loss(float(loss[-1]))
    if checkpoint_path is not None:
        # the final checkpoint: the cursor complete, written before the
        # whole trace is attached (the trace lives in the store)
        ckpt.save(cluster, checkpoint_path,
                  stream=dict(cursor, ticks_done=T, prev_live=last["prev_live"]))
    result: Any = store_obj
    if assemble:
        result = (store_obj.assemble() if store_obj is not None
                  else Trace.concat(slabs, spec=spec_dict)).validate()
        cluster.traces.append(result)
        cluster.log_run(result, T)
    else:
        cluster.log_run(last["slab"], T)
    if sink is not None:
        # the slabs streamed the series; close with the checksum gauge
        # as run_scenario does (0 with every node dead)
        sink.gauge("checksum", cluster.first_live_checksum() or 0)
    return result


# ---------------------------------------------------------------------------
# the streamed sweep (R replicas x S-tick segments)
# ---------------------------------------------------------------------------


def run_sweep_streamed(
    cluster: Any,
    spec: Any,
    replicas: int,
    *,
    segment_ticks: int,
    loss_scales: Any | None = None,
    kill_jitter: Any | None = None,
    flap_jitter: Any | None = None,
    traffic: Any | None = None,
    store: str | None = None,
    assemble: bool = True,
    pipeline: bool = True,
    shard: bool = False,
    policy: Any | None = None,
    policy_axes: dict[str, Any] | None = None,
) -> Any:
    """R replicas of a scenario, streamed segment by segment: the [R, S]
    telemetry slabs go to ``store`` (kind ``"sweep"``) or are joined at
    the end, so host telemetry is O(R x segment), and every replica
    equals the unsegmented ``run_sweep``'s (the same replica keys, the
    schedules sliced per segment).  Segment k + 1 is issued for every
    replica before segment k's slab is copied to pinned host memory;
    ``pipeline=False`` drains each segment first.  As with ``run_sweep``
    the cluster does not advance (only its key moves), and sweeps do not
    checkpoint.  ``traffic``, ``policy`` and ``policy_axes`` are
    ``run_sweep``'s."""
    spec = srunner.as_spec(spec)
    spec.validate(cluster.n)
    if not assemble and store is None:
        raise ValueError("assemble=False discards nothing only with a segment store")
    if traffic is not None:
        traffic = cluster.compile_traffic(traffic)
    cs = ssweep.compile_sweep(
        spec, cluster.n, replicas=replicas, base_loss=cluster.params.loss,
        loss_scales=loss_scales, kill_jitter=kill_jitter, flap_jitter=flap_jitter,
        device=cluster.device,
    )
    params = cluster.dparams if cluster.backend == "delta" else cluster.params
    policy = cluster._compile_policy(policy, traffic)
    adj, _ = ssweep.prepare(cluster.state, cluster.net, cs, params, shard=shard,
                            traffic=traffic, policy=policy, policy_axes=policy_axes)
    # everything that can raise comes before the replica keys are drawn
    S = int(segment_ticks)
    T = cs.base.ticks
    bounds = segment_bounds(T, S)
    run_id = uuid.uuid4().hex[:12]
    start_tick = int(cluster.state.tick)
    store_obj = None
    if store is not None:
        store_obj = SegmentStore.create(store, {
            "kind": "sweep", "run_id": run_id, "n": cluster.n, "backend": cluster.backend,
            "segment_ticks": S, "ticks": T, "start_tick": start_tick, "spec": spec.to_dict(),
        })
    replica_keys = [cluster._split() for _ in range(replicas)]
    keys = ssweep.sweep_key_schedule(replica_keys, cs)
    # audit: allow=RPL001 replica keys are CPU tensors: no sync
    rkeys_np = np.stack([k.numpy().astype(np.uint32) for k in replica_keys])
    reps = ssweep.Replicas(cluster.state, cluster.net, adj, cs, keys, params, None,
                           traffic=traffic, policy=policy, policy_axes=policy_axes)
    slabs: list[Any] = []
    pending: _Pending | None = None

    def drain(p: _Pending, *, overlapped: bool) -> None:
        t0 = time.perf_counter()
        slab = ssweep.sweep_trace(p.host(), cluster, rkeys_np, cs, start_tick + p.a, None)
        if store_obj is not None:
            store_obj.append(slab, segment=p.seg, tick0=p.a)
        else:
            slabs.append(slab)
        _drained(p, t0, overlapped=overlapped)

    for seg, (a, b) in enumerate(bounds):
        meta = {"backend": cluster.backend, "n": cs.base.n, "ticks": b - a,
                "replicas": cs.replicas, "run_id": run_id, "segment": seg, "tick0": a,
                "segment_ticks": S, "total_ticks": T}
        if policy is not None:
            meta["policy"] = policy.name
        ys, row = _launch_segment("run_sweep", reps.segment, (a, b), {}, meta,
                                  (reps.program_args(a, b), reps.program_statics()))
        launched = _Pending(seg, a, ys, row)
        if pending is not None:
            drain(pending, overlapped=True)
        pending = launched
        if not pipeline:
            drain(pending, overlapped=False)
            pending = None
    if pending is not None:
        drain(pending, overlapped=False)
    states, nets = reps.finish()
    if not assemble:
        return store_obj
    trace = (store_obj.assemble() if store_obj is not None
             else ssweep.SweepTrace.concat_ticks(slabs, spec=spec.to_dict())).validate()
    trace.final_states = states
    trace.final_nets = nets
    return trace
