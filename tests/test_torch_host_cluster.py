"""The host library end to end: ``tick-cluster --backend host-sim``,
BASELINE config 2, the north-star parity and the refusals.

* **CLI.** The port of ``tests/test_cli.py::test_sim_tick_cluster_script_
  converges_and_survives_faults``: the port's ``SimCluster`` (and
  ``tick_cluster.main`` with ``--backend host-sim`` and ``--sim``, on
  ``--device cpu``) prints the reference's lines, the elapsed ms of each
  ``tick:`` line set aside (wall time).
* **Config 2** (``BASELINE.json`` ``configs[1]``): one
  ``membership.update()`` of the reference's 1 332-member changeset on a
  ``test_ringpop`` gives the reference's member list, membership
  checksum, ring checksum and ring entries.
* **North-star parity.** The port of ``tests/test_sim_parity.py``: the
  port's host ``Cluster`` and the port's tensor ``SimCluster`` (both on
  the CPU) give the same membership checksums for one cluster history,
  and those equal the reference's host ``Cluster``'s.
* **Refusals.** With no card and no ``device`` the host library's entry
  points raise; ``--backend proc`` (the TCP half, ported since) is wired
  to ``ProcCluster`` with the CLI's options.
"""

from __future__ import annotations

import contextlib
import io
import re
import sys

import pytest
import torch

import ringpop_tpu.cli.tick_cluster as ref_tc
import ringpop_tpu.harness as ref_harness
from ringpop_tpu_torch import harness as port_harness
from ringpop_tpu_torch.cli import tick_cluster as port_tc
from ringpop_tpu_torch.models.cluster import SimCluster as TensorCluster
from ringpop_tpu_torch.models.swim_sim import SwimParams

SCRIPT = "j,w3000,t,s,k,w1000,t,K,w10000,t,l,w1000,L,q"


def capture(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def no_elapsed(text: str) -> str:
    """The printed lines with each ``tick:`` line's wall-clock ms set aside."""
    return re.sub(r"(?m)^(tick: .*) in \d+ms$", r"\1 in <ms>", text)


def test_sim_tick_cluster_script_equals_reference():
    outs = []
    for tc, driver in ((port_tc, port_tc.SimCluster(size=5, base_port=24400, seed=7,
                                                    device="cpu")),
                       (ref_tc, ref_tc.SimCluster(size=5, base_port=24400, seed=7))):
        outs.append(capture(lambda: tc.run_script(driver, SCRIPT)))
        driver.shutdown()
    out = outs[0]
    lines = [line for line in out.splitlines() if line.startswith("tick:")]
    assert lines[0].startswith("tick: CONVERGED [5]")
    assert lines[1].startswith("tick: CONVERGED [4]")  # after kill
    assert lines[2].startswith("tick: CONVERGED [5]")  # after revive
    assert "suspended" in out and "resumed" in out
    assert no_elapsed(outs[0]) == no_elapsed(outs[1])


@pytest.mark.parametrize("backend", [["--backend", "host-sim"], ["--sim"]])
def test_tick_cluster_main_host_sim_equals_reference(backend):
    script = SCRIPT.replace(",q", ",p,d,D,g,x,q")  # every command, one unknown
    argv = ["--size", "5", "--seed", "7", "--script", script]
    port = capture(lambda: port_tc.main(backend + ["--device", "cpu"] + argv))
    ref = capture(lambda: ref_tc.main(backend + argv))
    assert "tick: CONVERGED [5]" in port and "p50=" in port
    assert no_elapsed(port) == no_elapsed(ref)


# -- BASELINE config 2 ------------------------------------------------------


def large_membership(n: int = 1332) -> list[dict]:
    """The reference's 1 332-member changeset (a copy of the generator of
    ``benchmarks/fixtures.py``: realistic 10.x addresses, status alive,
    wall-clock incarnation numbers)."""
    members = []
    for i in range(n):
        address = f"10.{30 + i // 2500}.{(i // 25) % 100}.{i % 25 + 1}:{31000 + i % 1000}"
        members.append(
            {"address": address, "status": "alive", "incarnationNumber": 1414143508000 + i}
        )
    return members


def test_config2_membership_update_equals_reference():
    changes = large_membership()
    ref = ref_harness.test_ringpop(host_port="10.30.0.1:30000")
    port = port_harness.test_ringpop(host_port="10.30.0.1:30000", device="cpu")
    applied = [[{k: v for k, v in u.items() if k != "id"} for u in rp.membership.update(changes)]
               for rp in (port, ref)]
    assert applied[0] == applied[1] and len(applied[0]) == 1332
    assert port.membership.get_member_count() == 1333
    assert port.membership.checksum == ref.membership.checksum
    assert port.ring.checksum == ref.ring.checksum
    assert port.ring._entries == ref.ring._entries and len(port.ring._entries) == 133_300
    assert ([(m.address, m.status, m.incarnation_number) for m in port.membership.members]
            == [(m.address, m.status, m.incarnation_number) for m in ref.membership.members])


# -- the north-star parity (test_sim_parity.py) -----------------------------


def _host_clusters_converged(size: int):
    """The port's host cluster on the CPU and the reference's, converged;
    their checksums agree node for node."""
    port = port_harness.Cluster(size=size, device="cpu")
    ref = ref_harness.Cluster(size=size)
    for c in (port, ref):
        c.bootstrap_all()
        assert c.run_until_converged(), "host cluster failed to converge"
    assert port.checksums() == ref.checksums()
    return port, ref


def _adopt(members, n, **kw):
    return TensorCluster(
        n,
        addresses=[m["address"] for m in members],
        base_inc=min(m["incarnationNumber"] for m in members),
        inc=[m["incarnationNumber"] for m in members],
        device="cpu",
        **kw,
    )


def test_bootstrap_checksum_parity_5_nodes():
    host, ref = _host_clusters_converged(5)
    host_sums = set(host.checksums().values())
    assert len(host_sums) == 1
    members = host.nodes[0].membership.get_stats()["members"]
    assert members == ref.nodes[0].membership.get_stats()["members"]
    simc = _adopt(members, 5, init="converged")
    assert set(simc.checksums().values()) == host_sums
    host.destroy_all()
    ref.destroy_all()


def test_faulty_transition_checksum_parity():
    host, ref = _host_clusters_converged(4)
    members = host.nodes[0].membership.get_stats()["members"]
    victim_addr = host.host_ports[2]
    simc = _adopt(members, 4, params=SwimParams(suspicion_ticks=25), init="converged")
    assert set(simc.checksums().values()) == set(host.checksums().values())
    for c in (host, ref):
        c.kill(2)
        c.run(60000)
        assert c.run_until_converged(), "host did not reconverge after kill"
    host_sums = set(host.checksums().values())
    assert len(host_sums) == 1 and host.checksums() == ref.checksums()
    simc.kill(simc.book.index[victim_addr])
    simc.tick(3 * 25)
    assert simc.run_until_converged(600) > 0
    assert set(simc.checksums().values()) == host_sums
    host.destroy_all()
    ref.destroy_all()


def test_member_list_shape_matches_host():
    host, ref = _host_clusters_converged(3)
    members = host.nodes[0].membership.get_stats()["members"]
    simc = _adopt(members, 3)
    assert simc.members(0) == members == ref.nodes[0].membership.get_stats()["members"]
    host.destroy_all()
    ref.destroy_all()


def test_trajectory_parity_bootstrap_from_scratch():
    """Both of the port's backends bootstrap from zero knowledge through
    their own join paths and converge to the same checksums, which are
    the reference host library's."""
    host, ref = _host_clusters_converged(5)
    host_sums = set(host.checksums().values())
    members = host.nodes[0].membership.get_stats()["members"]
    by_addr = {m["address"]: m for m in members}
    assert all(m["status"] == "alive" for m in members)
    simc = TensorCluster(
        5,
        addresses=host.host_ports,
        base_inc=min(m["incarnationNumber"] for m in members),
        inc=[by_addr[a]["incarnationNumber"] for a in host.host_ports],
        init="self",
        device="cpu",
    )
    assert not simc.converged()
    for j in range(1, 5):
        simc.join(j, 0)
    assert simc.run_until_converged(200) > 0
    assert set(simc.checksums().values()) == host_sums == set(ref.checksums().values())
    assert simc.members(0) == members
    host.destroy_all()
    ref.destroy_all()


# -- refusals ----------------------------------------------------------------


def test_host_library_needs_a_card_or_the_cpu(monkeypatch):
    from ringpop_tpu_torch.ringpop import RingPop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: RingPop(app="a", host_port="127.0.0.1:3000"),
                 lambda: port_harness.test_ringpop(),
                 lambda: port_harness.Cluster(size=2),
                 lambda: port_tc.main(["--sim", "--script", "t"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    # the options are checked first, as the reference checks them
    from ringpop_tpu_torch import errors

    with pytest.raises(errors.AppRequiredError):
        RingPop(host_port="127.0.0.1:3000")
    with pytest.raises(errors.HostPortRequiredError):
        RingPop(app="a", host_port="127.0.0.1")
    # with the CPU named, the ring hashes there
    rp = RingPop(app="a", host_port="127.0.0.1:3000", device="cpu")
    assert rp.device == torch.device("cpu") == rp.ring.device


def test_tcp_half_raises_naming_item_12b(monkeypatch):
    """The TCP half is ported (ROADMAP item 12 (b) is done): ``--backend
    proc``, the default, builds a ``ProcCluster`` from ``--size``,
    ``--base-port``, ``--log-level`` and ``--device``, waits
    ``--startup-timeout-s`` for it, runs the script and shuts it down;
    ``--stats-out`` and ``--profile-dir`` still refuse it.  The real
    processes run in ``tests/test_torch_proc_cluster.py``."""
    from ringpop_tpu_torch import __main__ as entry

    seen = []

    class FakeProc(port_tc.ClusterCommands):
        def __init__(self, size, base_port, log_level="warn", device=None):
            seen.append(("init", size, base_port, log_level, device))

        def wait_healthy(self, timeout_s=60.0):
            seen.append(("healthy", timeout_s))

        def tick_all(self):
            seen.append(("tick",))

        def shutdown(self):
            seen.append(("shutdown",))

    monkeypatch.setattr(port_tc, "ProcCluster", FakeProc)
    for backend in ([], ["--backend", "proc"]):
        seen.clear()
        port_tc.main(backend + ["-n", "3", "--base-port", "4100", "--device", "cpu",
                                "--log-level", "error", "--startup-timeout-s", "7",
                                "--script", "t"])
        assert seen == [("init", 3, 4100, "error", "cpu"), ("healthy", 7.0), ("tick",),
                        ("shutdown",)]
    for flag in ("--stats-out", "--profile-dir"):
        with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
            port_tc.main([flag, "x", "--device", "cpu", "--script", "t"])
    assert not hasattr(port_tc, "HOST_LIBRARY_ITEM") and not hasattr(entry, "_NOT_PORTED")


def test_ring_on_card_never_hashes_on_host(monkeypatch):
    """On the card a node's ring hashes each batch with the short-row
    kernel (one launch a batch of uncached servers) and never with the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from ringpop_tpu_torch.ops import farmhash

    def refuse(*a, **k):
        raise AssertionError("the plain FarmHash ran for a ring on the card")

    monkeypatch.setattr(farmhash, "farmhash32_plain", refuse)
    before = farmhash.farmhash32_batch.short_launches
    rp = port_harness.test_ringpop(host_port="10.30.0.1:30000", device="cuda")
    rp.membership.update(large_membership(64))
    assert farmhash.farmhash32_batch.short_launches == before + 2
    ref = ref_harness.test_ringpop(host_port="10.30.0.1:30000")
    ref.membership.update(large_membership(64))
    assert rp.ring._entries == ref.ring._entries
    assert rp.membership.checksum == ref.membership.checksum
