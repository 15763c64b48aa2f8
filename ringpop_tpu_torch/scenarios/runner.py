"""Drive a scenario through ``SimCluster``: the host loop.

The port of ``run_host_loop`` of ``ringpop_tpu/scenarios/runner.py``.
The one-dispatch compiled runner (``run_compiled``) is not ported yet.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any

from ringpop_tpu_torch.scenarios import faults as sfaults
from ringpop_tpu_torch.scenarios.compile import _OP_RANK, expand_events
from ringpop_tpu_torch.scenarios.spec import ScenarioSpec


def run_host_loop(cluster, spec: ScenarioSpec):
    """Apply each boundary tick's events through the public ``SimCluster``
    surface, then ``tick()`` the segment to the next boundary.  It draws
    the cluster key once a segment, as the reference's host loop and its
    compiled scan's key schedule do, so from equal state and key the
    trajectory is the reference's.

    Ops of one tick apply in the canonical order (``_OP_RANK``): node bit
    edits, then revives, then partitions, loss and the fault
    configuration (``faults.HostPlan``)."""
    spec.validate(cluster.n)
    if any(e.op == "overload" for e in spec.events):
        raise NotImplementedError(
            "run_host_loop does not serve traffic, so it cannot drive "
            "the overload feedback loop"
        )
    plan = sfaults.HostPlan(spec, cluster.n)
    plan.prepare(cluster)
    by_tick: dict[int, list[tuple[str, Any]]] = defaultdict(list)
    for at, op, arg in expand_events(spec, cluster.params.loss):
        by_tick[at].append((op, arg))
    boundaries = sorted(t for t in by_tick if 0 < t < spec.ticks)
    pts = [0, *boundaries, spec.ticks]
    for a, b in zip(pts, pts[1:]):
        ops = sorted(by_tick.get(a, ()), key=lambda x: _OP_RANK[x[0]])
        cfg_done = False
        for op, arg in ops:
            if op == "kill":
                cluster.kill(arg)
            elif op == "suspend":
                cluster.suspend(arg)
            elif op == "resume":
                cluster.resume(arg)
            elif op == "revive":
                cluster.revive(arg)
            elif op == "partition":
                cluster.partition([list(g) for g in arg])
            elif op == "heal":
                cluster.heal_partition()
            elif op == "loss":
                cluster.set_loss(arg)
            elif op == "faultcfg" and not cfg_done:
                plan.apply(cluster, a)
                cfg_done = True
        cluster.tick(b - a)
    return cluster
