"""The port's host ``HashRing`` against the reference's
(``ringpop_tpu/hashring.py``, which imports no JAX): the same entries,
checksum, events, ``lookup`` and ``lookup_n`` over 1 000 keys after every
change (add, remove, batch, duplicate, conflicting and transient
changes, the empty ring).  The port hashes a batch's replica names with
``farmhash32_batch`` (its plain version on the CPU here); the
comparison is exact."""

from __future__ import annotations

import random

import pytest
import torch

from ringpop_tpu.hashring import HashRing as RefRing
from ringpop_tpu.ops.farmhash import farmhash32 as ref_farmhash32
from ringpop_tpu_torch.hashring import DEFAULT_REPLICA_POINTS, HashRing

_rng = random.Random(3)
KEYS = [f"key-{_rng.randrange(10 ** 12)}" for _ in range(1000)]
SERVERS = [f"10.0.{i // 256}.{i % 256}:{3000 + i}" for i in range(40)]


def _pair(**kw):
    """A reference ring and a port ring, each logging its events."""
    ref, port = RefRing(**kw), HashRing(device="cpu", **kw)
    logs = ([], [])
    for ring, log in ((ref, logs[0]), (port, logs[1])):
        for ev in ("added", "removed", "checksumComputed"):
            ring.on(ev, lambda *a, ev=ev, log=log: log.append((ev, *a)))
    return ref, port, logs


def _same(ref, port, logs, what: str, lookup_n: bool = True) -> None:
    assert port._entries == ref._entries, what
    assert port.servers == ref.servers, what
    assert port.checksum == ref.checksum, what
    assert logs[0] == logs[1], what
    assert [port.lookup(k) for k in KEYS] == [ref.lookup(k) for k in KEYS], what
    if lookup_n:
        for n in (0, 1, 3, 5):
            assert ([port.lookup_n(k, n) for k in KEYS[:200]]
                    == [ref.lookup_n(k, n) for k in KEYS[:200]]), (what, n)


# each step is (method, args); the same steps run on both rings
STEPS = {
    "add_remove_one": [("add_server", ["a:1"]), ("add_server", ["b:2"]),
                       ("add_server", ["a:1"]), ("remove_server", ["a:1"]),
                       ("remove_server", ["zz:9"]), ("remove_server", ["b:2"])],
    "batch": [("add_remove_servers", [SERVERS[:30], []]),
              ("add_remove_servers", [SERVERS[30:], SERVERS[:5]]),
              ("add_remove_servers", [SERVERS[:5], SERVERS[10:20]]),
              ("add_remove_servers", [[], []])],
    "duplicates": [("add_remove_servers", [["a:1", "a:1", "b:1", "b:1"], []]),
                   ("remove_server", ["a:1"]),
                   ("add_remove_servers", [["c:1", "c:1"], ["b:1", "b:1"]])],
    "conflicting": [("add_remove_servers", [SERVERS[:10], []]),
                    ("add_remove_servers", [["c:1", SERVERS[12]], ["c:1", SERVERS[3]]]),
                    ("add_remove_servers", [[SERVERS[3]], [SERVERS[3]]])],
    "transient": [("add_server", ["a:1"]), ("add_remove_servers", [["b:2"], ["b:2"]]),
                  ("add_remove_servers", [["b:2", "c:3"], ["b:2", "c:3"]]),
                  ("add_remove_servers", [[], ["nobody:1"]])],
    "one_by_one_then_batch": [("add_server", [s]) for s in SERVERS[:6]]
    + [("add_remove_servers", [SERVERS[6:12], SERVERS[:3]])]
    + [("remove_server", [s]) for s in SERVERS[3:9]],
}


@pytest.mark.parametrize("name", list(STEPS))
def test_hashring_matches_reference(name):
    ref, port, logs = _pair()
    _same(ref, port, logs, f"{name}: empty")
    for k, (method, args) in enumerate(STEPS[name]):
        got = getattr(port, method)(*args)
        want = getattr(ref, method)(*args)
        assert got == want, (name, k)
        _same(ref, port, logs, f"{name}: step {k} {method}")


def test_empty_ring():
    ref, port, logs = _pair()
    assert port.lookup("k") is None and port.lookup_n("k", 3) == []
    port.compute_checksum()
    ref.compute_checksum()
    assert port.checksum == ref.checksum == ref_farmhash32("")
    _same(ref, port, logs, "empty")


@pytest.mark.parametrize("replica_points", [1, 7, DEFAULT_REPLICA_POINTS, 150])
def test_replica_points_and_removal(replica_points):
    """Replica counts with one- to three-digit suffixes; removing a
    server moves only its keys."""
    ref, port, logs = _pair(replica_points=replica_points)
    for ring in (ref, port):
        ring.add_remove_servers(SERVERS[:12], [])
    assert len(port._entries) == 12 * replica_points
    _same(ref, port, logs, "built", lookup_n=False)
    before = [port.lookup(k) for k in KEYS]
    for ring in (ref, port):
        ring.remove_server(SERVERS[4])
    after = [port.lookup(k) for k in KEYS]
    assert all(b == a or b == SERVERS[4] for b, a in zip(before, after))
    _same(ref, port, logs, "removed", lookup_n=False)


def test_own_hash_func_stays_on_host():
    """A caller's own hash function hashes every replica name on the host,
    and needs no device."""
    calls = []

    def h(s: str) -> int:
        calls.append(s)
        return ref_farmhash32(s[::-1])

    ref, port = RefRing(hash_func=h), HashRing(hash_func=h)
    assert port.device is None
    ref.add_remove_servers(SERVERS[:5], [])
    n_ref = len(calls)
    port.add_remove_servers(SERVERS[:5], [])
    assert len(calls) == 2 * n_ref
    assert port._entries == ref._entries and port.checksum == ref.checksum
    assert [port.lookup(k) for k in KEYS] == [ref.lookup(k) for k in KEYS]


def test_replica_cache_reuse_and_bound(monkeypatch):
    """Removal re-uses the hashes that adding computed (no second batch),
    and the cache is cleared when it outgrows 4x the ring (at least
    1000 servers), as the reference's is."""
    from ringpop_tpu_torch import hashring

    port = HashRing(device="cpu")
    batches = []
    real = hashring.hash_replicas

    def counting(servers, p, device):
        batches.append(list(servers))
        return real(servers, p, device)

    monkeypatch.setattr(hashring, "hash_replicas", counting)
    port.add_remove_servers(SERVERS[:8], [])
    port.add_remove_servers([], SERVERS[:4])
    port.add_remove_servers(SERVERS[:4], [])
    assert batches == [SERVERS[:8]]
    port._replica_cache.update({f"x{i}": (0,) for i in range(4001)})
    port.add_server("new:1")
    assert batches[-1] == ["new:1"]
    assert list(port._replica_cache) == ["new:1"]


def test_ring_needs_a_card_or_the_cpu(monkeypatch):
    from ringpop_tpu_torch import ring_rebalance
    from ringpop_tpu_torch.ops import ring_ops

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HashRing()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ring_ops.build_ring(SERVERS[:2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ring_rebalance.run(n=20, ticks=1, n_keys=5)
    assert HashRing(device="cpu").device == torch.device("cpu")
