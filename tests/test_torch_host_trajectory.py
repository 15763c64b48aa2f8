"""The host library's cluster, the reference against the port, step by step.

The reference's ``harness.Cluster`` and the port's ``Cluster(device=
"cpu")`` run side by side in this process (the reference's host modules
import no JAX) at n = 5 and n = 25 on two seeds, through bootstrap, a
kill, a suspend and its resume, a partition and its heal, a revive, and
a leave and a rejoin.  After every step both hold the same state: the
virtual time, the pending timers and the message count, and for every
node its member list in its own order (address, status, incarnation),
its membership checksum, its ring (checksum, servers, entries), its
dissemination buffer and piggyback limit, its suspicion timers, its
gossip and iterator counters, its rollup buffer, its random generator's
state, and ``get_stats()``.

Only fields that differ by nature are set aside: the update ids
(``uuid4``, in the dissemination and rollup buffers) and
``get_stats()["process"]["pid"]``.  Time is virtual on both sides, so
no wall-clock field remains.
"""

from __future__ import annotations

import pytest

import ringpop_tpu.harness as ref_harness
from ringpop_tpu_torch import harness as port_harness


def no_id(change: dict) -> dict:
    return {k: v for k, v in change.items() if k != "id"}


def stats(rp) -> dict:
    out = rp.get_stats()
    assert set(out["process"]) == {"pid"}
    del out["process"]
    return out


def node_state(rp) -> dict:
    rollup = rp.membership_update_rollup
    gossip = rp.gossip
    return {
        "host": rp.host_port,
        "flags": (rp.is_ready, rp.destroyed, rp.is_pinging, rp._protocol_period_count),
        "members": [(m.address, m.status, m.incarnation_number) for m in rp.membership.members],
        "local": (None if rp.membership.local_member is None else
                  (rp.membership.local_member.status,
                   rp.membership.local_member.incarnation_number)),
        "checksum": rp.membership.checksum,
        "ring": (rp.ring.checksum, list(rp.ring.servers), list(rp.ring._entries)),
        "changes": {a: no_id(c) for a, c in rp.dissemination.changes.items()},
        "max_pb": rp.dissemination.max_piggyback_count,
        "suspects": list(rp.suspicion.timers),
        "gossip": (gossip.is_stopped, gossip.last_protocol_period, gossip.last_protocol_rate,
                   gossip.num_protocol_periods),
        "iterator": (rp.member_iterator.current_index, rp.member_iterator.current_round),
        "rollup": ({a: [no_id(e) for e in es] for a, es in rollup.buffer.items()},
                   rollup.first_update_time, rollup.last_update_time, rollup.last_flush_time),
        "rng": rp.rng.getstate(),
        "stats": stats(rp),
    }


def cluster_state(c) -> dict:
    return {
        "now": c.scheduler.now(),
        "pending": c.scheduler.pending(),
        "messages": c.network.message_count,
        "killed": sorted(c.network.killed),
        "paused": sorted(c.network.paused),
        "checksums": c.checksums(),
        "groups": {k: sorted(v) for k, v in c.checksum_groups().items()},
        "nodes": [node_state(n) for n in c.nodes],
    }


def _admin(c, index: int, endpoint: str) -> list:
    """Call one node's admin endpoint in process, as the server's table
    holds it; returns what it answered."""
    out = []
    c.network.endpoints[c.host_ports[index]][endpoint](
        None, None, "test", lambda err, r1=None, r2=None: out.append((repr(err), r1, r2)))
    return out


def steps(n: int):
    """The trajectory: (label, fn(cluster) -> result) pairs."""
    half = [list(range(n // 2)), list(range(n // 2, n))]
    victim, sleeper, leaver = n - 1, 1, 2
    return [
        ("bootstrap", lambda c: c.bootstrap_all()),
        ("converge", lambda c: c.run_until_converged()),
        ("tick_all", lambda c: c.tick_all()),
        ("kill", lambda c: (c.kill(victim), c.run(8000))),
        ("kill_converge", lambda c: c.run_until_converged()),
        ("suspend", lambda c: (c.suspend(sleeper), c.run(3000))),
        ("resume", lambda c: (c.resume(sleeper), c.run_until_converged())),
        ("partition", lambda c: (c.partition(half), c.run(12000))),
        ("heal", lambda c: (c.heal_partition(), c.run_until_converged(max_ms=60000))),
        ("revive", lambda c: (c.revive(victim), c.run_until_converged())),
        ("leave", lambda c: (_admin(c, leaver, "/admin/leave"), c.run(2000))),
        ("rejoin", lambda c: (_admin(c, leaver, "/admin/join"), c.run_until_converged())),
        ("tick_all_end", lambda c: c.tick_all()),
    ]


@pytest.mark.parametrize("n,seed", [(5, 1), (5, 7), (25, 1), (25, 2)])
def test_cluster_trajectory_equals_reference(n, seed):
    ref = ref_harness.Cluster(size=n, seed=seed)
    port = port_harness.Cluster(size=n, seed=seed, device="cpu")
    assert cluster_state(port) == cluster_state(ref)
    for label, step in steps(n):
        got, want = step(port), step(ref)
        assert got == want, label
        assert cluster_state(port) == cluster_state(ref), label
    # the run reached every state the steps meant to reach
    assert ref.is_converged() and len(ref.live_nodes()) == n
    assert ref.nodes[2].membership.local_member.status == "alive"
    port.destroy_all()
    ref.destroy_all()
