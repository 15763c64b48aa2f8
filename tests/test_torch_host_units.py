"""The host library's units, the reference against the port in process.

Every case of the reference's host unit tests (``test_membership.py``,
``test_update_rules.py``, ``test_dissemination.py``, ``test_rollup.py``,
``test_swim_units.py``, ``test_join_merge.py``, ``test_damping.py``)
runs through both packages: ``ringpop_tpu``'s host modules import no JAX,
so both sides run in this process, the port with ``device="cpu"`` (its
rings hash a batch with the plain FarmHash).  Each case keeps the
reference test's own assertions, which both sides must pass, and returns
what it observed (member lists, checksums, rings, buffers); the two
observations must be equal.  The update ids (``uuid4``) are random on
both sides and are left out of every observation.
"""

from __future__ import annotations

import random
import types

import pytest

import ringpop_tpu.changeset_merge as ref_merge
import ringpop_tpu.harness as ref_harness
import ringpop_tpu.member as ref_member
import ringpop_tpu.update_rules as ref_rules
from ringpop_tpu.ops.farmhash import farmhash32 as ref_farmhash32
from ringpop_tpu.swim import join_response_merge as ref_join_merge
from ringpop_tpu.swim import join_sender as ref_join_sender
from ringpop_tpu_torch import changeset_merge as port_merge
from ringpop_tpu_torch import harness as port_harness
from ringpop_tpu_torch import member as port_member
from ringpop_tpu_torch import update_rules as port_rules
from ringpop_tpu_torch.swim import join_response_merge as port_join_merge
from ringpop_tpu_torch.ops.farmhash import farmhash32
from ringpop_tpu_torch.swim import join_sender as port_join_sender

REF = types.SimpleNamespace(
    name="ref", harness=ref_harness, Status=ref_member.Status, Member=ref_member.Member,
    rules=ref_rules, merge=ref_merge.merge_membership_changesets,
    merge_join=ref_join_merge.merge_join_responses, JoinCluster=ref_join_sender.JoinCluster,
    farmhash32=ref_farmhash32, kw={},
)
PORT = types.SimpleNamespace(
    name="port", harness=port_harness, Status=port_member.Status, Member=port_member.Member,
    rules=port_rules, merge=port_merge.merge_membership_changesets,
    merge_join=port_join_merge.merge_join_responses, JoinCluster=port_join_sender.JoinCluster,
    farmhash32=farmhash32, kw={"device": "cpu"},
)


def make(pkg, **kw):
    """The harness's ``test_ringpop`` of ``pkg`` (the port's on the CPU)."""
    return pkg.harness.test_ringpop(**kw, **pkg.kw)


def no_id(change: dict) -> dict:
    return {k: v for k, v in change.items() if k != "id"}


def view(rp) -> dict:
    """What a node holds, the update ids left out."""
    return {
        "members": [(m.address, m.status, m.incarnation_number) for m in rp.membership.members],
        "checksum": rp.membership.checksum,
        "ring": (rp.ring.checksum, list(rp.ring.servers), list(rp.ring._entries)),
        "changes": {a: no_id(c) for a, c in rp.dissemination.changes.items()},
        "max_pb": rp.dissemination.max_piggyback_count,
        "suspects": list(rp.suspicion.timers),
        "now": rp.clock.now(),
        "rng": rp.rng.getstate(),
    }


# -- membership (test_membership.py) -------------------------------------


def checksum_format_parity(pkg):
    rp = make(pkg, host_port="10.0.0.1:3000")
    rp.membership.make_alive("10.0.0.2:3000", 1414142122275)
    expected_str = rp.membership.generate_checksum_string()
    assert pkg.farmhash32(expected_str) == rp.membership.checksum
    assert ";" in expected_str and "alive" in expected_str
    return expected_str, view(rp)


def checksum_changes_on_update(pkg):
    rp = make(pkg)
    before = rp.membership.checksum
    rp.membership.make_alive("127.0.0.1:3001", 1)
    after = rp.membership.checksum
    assert before != after
    rp.membership.make_alive("127.0.0.1:3001", 1)
    assert rp.membership.checksum == after
    return before, view(rp)


def checksum_order_independent(pkg):
    rp1 = make(pkg, host_port="127.0.0.1:3000", seed=1)
    rp2 = make(pkg, host_port="127.0.0.1:3000", seed=99)
    for rp, order in ((rp1, [1, 2, 3]), (rp2, [3, 1, 2])):
        for i in order:
            rp.membership.make_alive(f"127.0.0.1:300{i}", 1000 + i)
    assert rp1.membership.checksum == rp2.membership.checksum
    return view(rp1), view(rp2)


def update_precedence(pkg):
    rp = make(pkg, host_port="10.0.0.1:3000")
    addr = "10.0.0.2:3000"
    rp.membership.make_alive(addr, 10)
    member = rp.membership.find_member_by_address(addr)
    seen = []
    for status, inc, want in ((pkg.Status.suspect, 10, pkg.Status.suspect),
                              (pkg.Status.alive, 10, pkg.Status.suspect),
                              (pkg.Status.alive, 11, pkg.Status.alive)):
        applied = rp.membership.update({"address": addr, "status": status, "incarnationNumber": inc})
        assert member.status == want
        seen.append([no_id(u) for u in applied])
    return seen, view(rp)


def local_suspect_refutation(pkg):
    rp = make(pkg, host_port="10.0.0.1:3000")
    local = rp.membership.local_member
    original_inc = local.incarnation_number
    applied = rp.membership.update(
        {"address": "10.0.0.1:3000", "status": pkg.Status.suspect,
         "incarnationNumber": original_inc}
    )
    assert local.status == pkg.Status.alive
    assert local.incarnation_number > original_inc
    assert applied and applied[0]["status"] == pkg.Status.alive
    return [no_id(u) for u in applied], view(rp)


def stash_until_ready(pkg):
    rp = make(pkg, make_alive=False)
    rp.is_ready = False
    rp.membership.update(
        [{"address": "127.0.0.1:3001", "status": pkg.Status.alive, "incarnationNumber": 1}]
    )
    rp.membership.update(
        [{"address": "127.0.0.1:3001", "status": pkg.Status.alive, "incarnationNumber": 5},
         {"address": "127.0.0.1:3002", "status": pkg.Status.alive, "incarnationNumber": 2}]
    )
    assert rp.membership.get_member_count() == 0
    rp.membership.set()
    assert rp.membership.get_member_count() == 2
    assert rp.membership.find_member_by_address("127.0.0.1:3001").incarnation_number == 5
    assert rp.membership.checksum is not None
    rp.membership.set()
    assert rp.membership.get_member_count() == 2
    return view(rp)


def pingable_excludes(pkg):
    rp = make(pkg, host_port="10.0.0.1:3000")
    rp.membership.make_alive("10.0.0.2:3000", 1)
    rp.membership.make_suspect("10.0.0.2:3000", 1)
    rp.membership.make_alive("10.0.0.3:3000", 1)
    rp.membership.make_faulty("10.0.0.3:3000", 1)
    rp.membership.make_alive("10.0.0.4:3000", 1)
    pingable = [m.address for m in rp.membership.members if rp.membership.is_pingable(m)]
    assert "10.0.0.1:3000" not in pingable
    assert "10.0.0.2:3000" in pingable
    assert "10.0.0.3:3000" not in pingable
    assert "10.0.0.4:3000" in pingable
    return pingable, view(rp)


def random_pingable_excludes(pkg):
    rp = make(pkg, host_port="10.0.0.1:3000")
    for i in range(2, 8):
        rp.membership.make_alive(f"10.0.0.{i}:3000", 1)
    sample = rp.membership.get_random_pingable_members(3, ["10.0.0.2:3000"])
    assert len(sample) == 3
    assert all(m.address != "10.0.0.2:3000" for m in sample)
    return [m.address for m in sample], view(rp)


# -- update rules (test_update_rules.py) ---------------------------------


def _rule_table(pkg):
    """Every rule over every (member status, change status) pair and
    incarnation relation, local and not."""
    rules = pkg.rules
    out = []
    for m_status in pkg.Status.ALL:
        for c_status in pkg.Status.ALL + ("bogus",):
            for inc in (9, 10, 11):
                m = pkg.Member("10.0.0.1:3000", m_status, 10)
                c = {"status": c_status, "incarnationNumber": inc}
                out.append((
                    rules.is_alive_override(m, c), rules.is_faulty_override(m, c),
                    rules.is_leave_override(m, c), rules.is_suspect_override(m, c),
                    rules.is_local_faulty_override("10.0.0.1:3000", m, c),
                    rules.is_local_suspect_override("10.0.0.1:3000", m, c),
                    rules.is_local_faulty_override("10.0.0.9:3000", m, c),
                    rules.is_local_suspect_override("10.0.0.9:3000", m, c),
                ))
    return out


def update_rules(pkg):
    rules, S = pkg.rules, pkg.Status

    def member(status, inc=10):
        return pkg.Member("10.0.0.1:3000", status, inc)

    def change(status, inc):
        return {"status": status, "incarnationNumber": inc}

    for status in S.ALL:
        assert rules.is_alive_override(member(status), change(S.alive, 11))
        assert not rules.is_alive_override(member(status), change(S.alive, 10))
    assert rules.is_suspect_override(member(S.alive), change(S.suspect, 10))
    assert not rules.is_suspect_override(member(S.suspect), change(S.suspect, 10))
    assert rules.is_suspect_override(member(S.faulty), change(S.suspect, 11))
    assert not rules.is_suspect_override(member(S.leave), change(S.suspect, 99))
    assert rules.is_faulty_override(member(S.alive), change(S.faulty, 10))
    assert not rules.is_faulty_override(member(S.faulty), change(S.faulty, 10))
    assert not rules.is_faulty_override(member(S.leave), change(S.faulty, 99))
    for status in (S.alive, S.suspect, S.faulty):
        assert rules.is_leave_override(member(status), change(S.leave, 10))
        assert not rules.is_leave_override(member(status), change(S.leave, 9))
    assert not rules.is_leave_override(member(S.leave), change(S.leave, 99))
    m = member(S.alive)
    assert rules.is_local_suspect_override("10.0.0.1:3000", m, change(S.suspect, 1))
    assert not rules.is_local_suspect_override("10.0.0.1:3000", m, change(S.faulty, 1))
    return _rule_table(pkg)


# -- dissemination (test_dissemination.py) -------------------------------


def _dis_rp(pkg, n_members=3):
    rp = make(pkg, host_port="10.0.0.1:3000")
    for i in range(2, 2 + n_members):
        rp.membership.make_alive(f"10.0.0.{i}:3000", 1000 + i)
    return rp


def issue_as_sender(pkg):
    rp = _dis_rp(pkg)
    issued = rp.dissemination.issue_as_sender()
    assert "10.0.0.2:3000" in {c["address"] for c in issued}
    for change in issued:
        assert set(change) == {"id", "source", "sourceIncarnationNumber", "address", "status",
                               "incarnationNumber"}
    return [no_id(c) for c in issued], view(rp)


def piggyback_eviction(pkg):
    rp = _dis_rp(pkg)
    max_pb = rp.dissemination.max_piggyback_count
    assert max_pb == 15
    rounds = []
    for _ in range(max_pb):
        issued = rp.dissemination.issue_as_sender()
        assert issued
        rounds.append([no_id(c) for c in issued])
    assert rp.dissemination.issue_as_sender() == []
    assert rp.dissemination.changes == {}
    return rounds, view(rp)


def receiver_filters_own(pkg):
    rp = _dis_rp(pkg)
    rp.dissemination.clear_changes()
    rp.dissemination.record_change({
        "address": "10.0.0.9:3000", "status": pkg.Status.alive, "incarnationNumber": 1,
        "source": "10.0.0.2:3000", "sourceIncarnationNumber": 42,
    })
    assert rp.dissemination.issue_as_receiver("10.0.0.2:3000", 42, rp.membership.checksum) == []
    issued = rp.dissemination.issue_as_receiver("10.0.0.2:3000", 43, rp.membership.checksum)
    assert len(issued) == 1
    return [no_id(c) for c in issued], view(rp)


def full_sync_on_mismatch(pkg):
    rp = _dis_rp(pkg)
    rp.dissemination.clear_changes()
    issued = rp.dissemination.issue_as_receiver("10.0.0.2:3000", 42, 12345)
    assert len(issued) == rp.membership.get_member_count()
    assert all(c["source"] == rp.whoami() for c in issued)
    assert rp.dissemination.issue_as_receiver(
        "10.0.0.2:3000", 42, rp.membership.checksum) == []
    return issued, view(rp)


def adjust_max_piggyback(pkg):
    rp = _dis_rp(pkg)
    assert rp.dissemination.max_piggyback_count == 15
    for i in range(10, 20):
        rp.membership.make_alive(f"10.0.0.{i}:3000", 1)
    assert rp.dissemination.max_piggyback_count == 30
    return view(rp)


# -- rollup (test_rollup.py) ---------------------------------------------


def _rollup(pkg):
    rp = make(pkg, host_port="10.0.0.1:3000", make_alive=False)
    return rp, rp.membership_update_rollup


def _upd(addr, status="alive", inc=1):
    return {"address": addr, "status": status, "incarnationNumber": inc}


def _rollup_view(rollup) -> dict:
    return {
        "buffer": {a: [no_id(e) for e in es] for a, es in rollup.buffer.items()},
        "times": (rollup.first_update_time, rollup.last_update_time, rollup.last_flush_time),
        "n": rollup.get_num_updates(),
    }


def rollup_buffers_by_address(pkg):
    rp, rollup = _rollup(pkg)
    rollup.track_updates([_upd("a:1"), _upd("b:1"), _upd("a:1", "suspect")])
    assert rollup.get_num_updates() == 3
    assert len(rollup.buffer["a:1"]) == 2
    assert all("ts" in e for e in rollup.buffer["a:1"])
    return _rollup_view(rollup)


def rollup_flushes_after_quiet(pkg):
    rp, rollup = _rollup(pkg)
    flushed = []
    rollup.on("flushed", lambda *a: flushed.append(rp.clock.now()))
    rollup.track_updates([_upd("a:1")])
    rp.clock.advance(rollup.flush_interval - 1)
    assert not flushed
    rp.clock.advance(2)
    assert len(flushed) == 1 and rollup.get_num_updates() == 0
    return flushed, _rollup_view(rollup)


def rollup_activity_renews(pkg):
    rp, rollup = _rollup(pkg)
    flushed = []
    rollup.on("flushed", lambda *a: flushed.append(rp.clock.now()))
    for _ in range(3):
        rollup.track_updates([_upd("a:1")])
        rp.clock.advance(rollup.flush_interval / 2)
    assert not flushed
    rp.clock.advance(rollup.flush_interval)
    assert len(flushed) == 1
    return flushed, _rollup_view(rollup)


def rollup_stale_flushed_first(pkg):
    rp, rollup = _rollup(pkg)
    rollup.track_updates([_upd("a:1")])
    rp.clock.cancel(rollup.flush_timer)
    rp.clock.advance(rollup.flush_interval + 1)
    flushed = []
    rollup.on("flushed", lambda *a: flushed.append(rp.clock.now()))
    rollup.track_updates([_upd("b:1")])
    assert len(flushed) == 1 and "a:1" not in rollup.buffer
    assert rollup.get_num_updates() == 1
    return flushed, _rollup_view(rollup)


def rollup_empty_and_destroy(pkg):
    rp, rollup = _rollup(pkg)
    rollup.track_updates([])
    assert rollup.flush_timer is None
    rollup.track_updates([_upd("a:1")])
    rollup.destroy()
    flushed = []
    rollup.on("flushed", lambda *a: flushed.append(1))
    rp.clock.advance(rollup.flush_interval * 2)
    assert not flushed
    return _rollup_view(rollup)


# -- gossip, suspicion, iterator (test_swim_units.py) ---------------------


def gossip_start_stop(pkg):
    rp = make(pkg)
    states = [rp.gossip.is_stopped]
    for op in ("start", "start", "stop", "stop", "start"):
        getattr(rp.gossip, op)()
        states.append(rp.gossip.is_stopped)
    assert states == [True, False, False, True, True, False]
    return states, rp.clock.pending(), view(rp)


def suspicion_timeout_faulty(pkg):
    rp = make(pkg, host_port="10.0.0.1:3000")
    rp.membership.make_alive("10.0.0.2:3000", 7)
    rp.membership.make_suspect("10.0.0.2:3000", 7)
    member = rp.membership.find_member_by_address("10.0.0.2:3000")
    assert member.status == pkg.Status.suspect
    assert "10.0.0.2:3000" in rp.suspicion.timers
    rp.clock.advance(4999)
    assert member.status == pkg.Status.suspect
    rp.clock.advance(2)
    assert member.status == pkg.Status.faulty
    return view(rp)


def suspicion_cancelled_by_alive(pkg):
    rp = make(pkg, host_port="10.0.0.1:3000")
    rp.membership.make_alive("10.0.0.2:3000", 7)
    rp.membership.make_suspect("10.0.0.2:3000", 7)
    rp.membership.update(
        {"address": "10.0.0.2:3000", "status": pkg.Status.alive, "incarnationNumber": 8})
    assert "10.0.0.2:3000" not in rp.suspicion.timers
    rp.clock.advance(10000)
    assert rp.membership.find_member_by_address("10.0.0.2:3000").status == pkg.Status.alive
    return view(rp)


def suspicion_never_local(pkg):
    rp = make(pkg, host_port="10.0.0.1:3000")
    rp.suspicion.start(rp.membership.local_member)
    assert "10.0.0.1:3000" not in rp.suspicion.timers
    return view(rp)


def suspicion_stop_all_reenable(pkg):
    rp = make(pkg, host_port="10.0.0.1:3000")
    rp.membership.make_alive("10.0.0.2:3000", 7)
    rp.suspicion.stop_all()
    rp.membership.make_suspect("10.0.0.2:3000", 7)
    assert "10.0.0.2:3000" not in rp.suspicion.timers
    rp.suspicion.reenable()
    rp.membership.make_suspect("10.0.0.2:3000", 8)
    assert "10.0.0.2:3000" in rp.suspicion.timers
    return view(rp)


def iterator_visits_all(pkg):
    rp = make(pkg, host_port="10.0.0.1:3000")
    for i in range(2, 6):
        rp.membership.make_alive(f"10.0.0.{i}:3000", 1)
    picks = [rp.member_iterator.next().address for _ in range(9)]
    assert set(picks[:4]) == {f"10.0.0.{i}:3000" for i in range(2, 6)}
    return picks, (rp.member_iterator.current_index, rp.member_iterator.current_round), view(rp)


def iterator_none_when_alone(pkg):
    rp = make(pkg, host_port="10.0.0.1:3000")
    assert rp.member_iterator.next() is None
    return view(rp)


# -- changeset and join merges, join groups (test_join_merge.py) ----------


def _ch(addr, inc, status="alive"):
    return {"address": addr, "status": status, "incarnationNumber": inc}


def changeset_merges(pkg):
    merged = pkg.merge(
        "me:1", [[_ch("a:1", 5), _ch("b:2", 3)], [_ch("a:1", 9)], [_ch("a:1", 7), _ch("c:3", 1)]])
    by_addr = {c["address"]: c for c in merged}
    assert by_addr["a:1"]["incarnationNumber"] == 9
    assert set(by_addr) == {"a:1", "b:2", "c:3"}
    excluded = pkg.merge("me:1", [[_ch("me:1", 5), _ch("a:1", 1)]])
    assert [c["address"] for c in excluded] == ["a:1"]
    return merged, excluded


def join_response_merges(pkg):
    members = [_ch("a:1", 1), _ch("b:2", 2)]
    same = [{"checksum": 42, "members": members}, {"checksum": 42, "members": [_ch("a:1", 99)]}]
    assert pkg.merge_join("me:1", same) is members
    mixed = [{"checksum": 42, "members": [_ch("a:1", 1)]},
             {"checksum": 43, "members": [_ch("a:1", 9), _ch("b:2", 2)]}]
    merged = pkg.merge_join("me:1", mixed)
    assert {c["address"]: c for c in merged}["a:1"]["incarnationNumber"] == 9
    assert pkg.merge_join("me:1", []) == []
    # a response with no checksum falls back to the merge
    unchecked = pkg.merge_join("me:1", [{"checksum": None, "members": members}])
    return merged, unchecked


def _joiner(pkg, bootstrap, host_port="10.0.0.1:3000", **opts):
    rp = make(pkg, host_port=host_port)
    rp.bootstrap_hosts = bootstrap
    rp.rng = random.Random(7)
    return pkg.JoinCluster(rp, **opts)


def join_group_selection(pkg):
    bootstrap = ["10.0.0.1:3000", "10.0.0.1:3001", "10.0.0.2:3000", "10.0.0.3:3000"]
    joiner = _joiner(pkg, bootstrap)
    joiner.init([])
    assert set(joiner.preferred_nodes) == {"10.0.0.2:3000", "10.0.0.3:3000"}
    assert set(joiner.non_preferred_nodes) == {"10.0.0.1:3001"}
    group = joiner.select_group([])
    assert len(group) == 3
    assert set(group[:2]) == set(joiner.preferred_nodes)
    return group, joiner.preferred_nodes, joiner.non_preferred_nodes


def join_group_excludes(pkg):
    bootstrap = ["10.0.0.1:3000", "10.0.0.2:3000", "10.0.0.3:3000"]
    joiner = _joiner(pkg, bootstrap)
    assert "10.0.0.1:3000" not in joiner.potential_nodes
    rest = joiner.collect_potential_nodes(["10.0.0.2:3000"])
    assert set(rest) == {"10.0.0.3:3000"}
    capped = _joiner(pkg, ["10.0.0.1:3000", "10.0.0.2:3000"], join_size=10)
    assert capped.join_size == 1
    return joiner.potential_nodes, rest, capped.join_size


# -- flap damping (test_damping.py) --------------------------------------


def _damp_rp(pkg, **damping_options):
    return make(pkg, host_port="10.0.0.1:3000", damping_enabled=True,
                damping_options=damping_options)


def _flap(pkg, rp, addr, times, inc=1):
    for _ in range(times):
        rp.membership.update({"address": addr, "status": pkg.Status.suspect,
                              "incarnationNumber": inc})
        inc += 1
        rp.membership.update({"address": addr, "status": pkg.Status.alive,
                              "incarnationNumber": inc})
        inc += 1
    return inc


def damping_damps_flapper(pkg):
    rp = _damp_rp(pkg)
    addr = "10.0.0.2:3000"
    rp.membership.make_alive(addr, 1)
    assert rp.ring.has_server(addr)
    events = []
    rp.on("memberDamped", lambda a: events.append(a))
    _flap(pkg, rp, addr, times=4)
    assert rp.damping.is_damped(addr) and events == [addr]
    assert not rp.ring.has_server(addr)
    assert rp.membership.find_member_by_address(addr) is not None
    return rp.damping.get_stats(), view(rp)


def damping_stable_never(pkg):
    rp = _damp_rp(pkg)
    addr = "10.0.0.3:3000"
    rp.membership.make_alive(addr, 1)
    for inc in range(2, 20):
        rp.membership.update({"address": addr, "status": pkg.Status.alive,
                              "incarnationNumber": inc})
    assert rp.damping.score_of(addr) == 0.0
    assert rp.ring.has_server(addr)
    return view(rp)


def damping_decays_reinstates(pkg):
    rp = _damp_rp(pkg, decay_half_life_ms=1000.0)
    addr = "10.0.0.4:3000"
    rp.membership.make_alive(addr, 1)
    inc = _flap(pkg, rp, addr, times=4)
    assert rp.damping.is_damped(addr)
    rp.clock.advance(5000)
    undamped = []
    rp.on("memberUndamped", lambda a: undamped.append(a))
    rp.membership.update({"address": addr, "status": pkg.Status.alive,
                          "incarnationNumber": inc + 1})
    assert not rp.damping.is_damped(addr) and undamped == [addr]
    assert rp.ring.has_server(addr)
    return rp.damping.get_stats(), view(rp)


def damping_off_by_default(pkg):
    rp = make(pkg, host_port="10.0.0.1:3000")
    assert rp.damping is None
    addr = "10.0.0.5:3000"
    rp.membership.make_alive(addr, 1)
    _flap(pkg, rp, addr, times=10)
    assert rp.ring.has_server(addr)
    return view(rp)


def damping_stats(pkg):
    rp = _damp_rp(pkg)
    addr = "10.0.0.6:3000"
    rp.membership.make_alive(addr, 1)
    _flap(pkg, rp, addr, times=4)
    stats = rp.get_stats()["damping"]
    assert stats["damped"] == [addr] and stats["scores"][addr] > 0
    return stats


def damping_quiet_reinstates(pkg):
    rp = _damp_rp(pkg, decay_half_life_ms=1000.0)

    class DroppingChannel:  # the fixture has no transport; pings just fail
        destroyed = False

        def request(self, host, endpoint, head, body, timeout_ms, cb):
            rp.clock.call_soon(lambda: cb(Exception("no transport")))

    rp.channel = DroppingChannel()
    addr = "10.0.0.7:3000"
    rp.membership.make_alive(addr, 1)
    _flap(pkg, rp, addr, times=4)
    assert rp.damping.is_damped(addr)
    rp.clock.advance(6000)
    rp.ping_member_now()
    assert not rp.damping.is_damped(addr)
    assert rp.ring.has_server(addr)
    return view(rp)


def damping_emits_ring_changed(pkg):
    rp = _damp_rp(pkg, decay_half_life_ms=1000.0)
    addr = "10.0.0.8:3000"
    rp.membership.make_alive(addr, 1)
    ring_events = []
    rp.on("ringChanged", lambda *a: ring_events.append(rp.ring.checksum))
    _flap(pkg, rp, addr, times=4)
    assert rp.damping.is_damped(addr) and ring_events
    return ring_events, view(rp)


CASES = [
    checksum_format_parity, checksum_changes_on_update, checksum_order_independent,
    update_precedence, local_suspect_refutation, stash_until_ready, pingable_excludes,
    random_pingable_excludes, update_rules, issue_as_sender, piggyback_eviction,
    receiver_filters_own, full_sync_on_mismatch, adjust_max_piggyback,
    rollup_buffers_by_address, rollup_flushes_after_quiet, rollup_activity_renews,
    rollup_stale_flushed_first, rollup_empty_and_destroy, gossip_start_stop,
    suspicion_timeout_faulty, suspicion_cancelled_by_alive, suspicion_never_local,
    suspicion_stop_all_reenable, iterator_visits_all, iterator_none_when_alone,
    changeset_merges, join_response_merges, join_group_selection, join_group_excludes,
    damping_damps_flapper, damping_stable_never, damping_decays_reinstates,
    damping_off_by_default, damping_stats, damping_quiet_reinstates,
    damping_emits_ring_changed,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_unit_case_equals_reference(case):
    assert case(PORT) == case(REF)


# -- the checksum's packing, over the format's edge cases -----------------

PACKED = [
    (b"", 0), (b"", 3), (b"a\x00alive\x001\x00", 1), (b"a\x00alive\x001\x00", 3),
    (b"a\x00alive\x001\x00b\x00suspect\x002\x00", 1), (b"a\x00b", 1), (b"a\x00b", 2),
    (b"a\x00b\x00c\x00d", 2), (b"a\x00b\x00c\x00d\x00", 5), (b"\x00\x00\x00\x00", 2),
    (b"\x00", 1), (b"x", 0), (b"x", -1), ("é:1\x00alive\x001.5\x00".encode(), 1),
]


@pytest.mark.parametrize("packed,n", PACKED, ids=range(len(PACKED)))
def test_membership_checksum_packed_equals_reference(packed, n):
    from ringpop_tpu.ops.farmhash import membership_checksum_packed as ref
    from ringpop_tpu_torch.membership import membership_checksum_packed as port

    assert port(packed, n) == ref(packed, n)


@pytest.mark.parametrize("inc", [0, 7, 1414142122275, 12.0, 12.5, -3, 2 ** 53 + 1.0])
def test_checksum_of_odd_incarnations_equals_reference(inc):
    """The incarnation's decimal form (integral floats as ints) and the
    packed members' hash, through ``membership.update``."""
    out = []
    for pkg in (REF, PORT):
        rp = make(pkg, host_port="10.0.0.1:3000")
        rp.membership.update({"address": "10.0.0.2:3000", "status": "alive",
                              "incarnationNumber": inc})
        out.append((rp.membership.generate_checksum_string(), rp.membership.checksum))
    assert out[1] == out[0]
