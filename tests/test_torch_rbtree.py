"""The port's red-black tree and tree-backed ring (``ringpop_tpu_torch/
rbtree.py``) against the reference's.

* Every case of ``tests/test_rbtree.py`` on the port's ``RBTree``, with the
  port's ``RBRing`` held against the port's ``HashRing(device="cpu")``.
* A seeded random sequence of inserts, removes, ``find``, ``lower_bound``/
  ``upper_bound`` walks, ``min`` and full iteration through both packages'
  trees, equal at every step, with ``check_invariants`` equal (the black
  height) after each batch.
* The port's ``RBRing`` (hashing with the port's ``farmhash32``) equal to
  the reference's ``RBRing`` and to the port's ``HashRing(device="cpu")``
  on ``lookup`` and ``lookup_n`` through adds and removes.
"""

from __future__ import annotations

import random

import pytest

import ringpop_tpu.rbtree as ref_rbtree
from ringpop_tpu.ops.farmhash import farmhash32 as ref_farmhash32
from ringpop_tpu_torch.hashring import HashRing
from ringpop_tpu_torch.ops.farmhash import farmhash32
from ringpop_tpu_torch.rbtree import RBRing, RBTree


def build(vals):
    tree = RBTree()
    for v in vals:
        tree.insert(v, f"s{v}")
    return tree


def test_insert_iterate_sorted():
    vals = random.Random(1).sample(range(10 ** 6), 500)
    tree = build(vals)
    assert tree.size == 500
    assert [n.val for n in tree] == sorted(vals)
    tree.check_invariants()


def test_duplicate_insert_rejected():
    tree = RBTree()
    assert tree.insert(5, "a") is True
    assert tree.insert(5, "b") is False
    assert tree.size == 1
    assert tree.find(5).name == "a"


def test_remove_with_oracle_and_invariants():
    rng = random.Random(7)
    vals = rng.sample(range(10 ** 6), 400)
    tree = build(vals)
    alive = set(vals)
    for v in rng.sample(vals, 300):
        assert tree.remove(v) is True
        alive.discard(v)
        assert tree.remove(v) is False  # already gone
    assert tree.size == len(alive)
    assert [n.val for n in tree] == sorted(alive)
    tree.check_invariants()


def test_payload_copy_on_two_child_removal():
    """Removing a node with two children replaces it with its successor's
    val AND name together — the reference's payload-copy regression."""
    tree = build([50, 25, 75, 10, 30, 60, 90])
    tree.remove(50)
    for node in tree:
        assert node.name == f"s{node.val}", (node.val, node.name)
    tree.check_invariants()


def test_min_and_empty():
    tree = RBTree()
    assert tree.min() is None
    assert tree.find(1) is None
    assert tree.remove(1) is False
    it = tree.iterator()
    assert it.next() is None and it.val() is None
    tree.insert(42, "x")
    assert tree.min().val == 42


def test_bounds_semantics():
    tree = build([10, 20, 30, 40])
    # Exact hit: equality-inclusive (ring.js lookup depends on this).
    assert tree.upper_bound(20).val() == 20
    assert tree.lower_bound(20).val() == 20
    # Between nodes: first greater.
    assert tree.upper_bound(21).val() == 30
    assert tree.lower_bound(5).val() == 10
    # Past the end: cursor is None (ring wraps to min).
    assert tree.upper_bound(41).val() is None
    # Iterator continues in order from a bound.
    it2 = tree.lower_bound(15)
    seen = [it2.val()]
    while it2.next() is not None:
        seen.append(it2.val())
    assert seen == [20, 30, 40]


def test_bounds_against_oracle():
    rng = random.Random(3)
    vals = sorted(rng.sample(range(100000), 200))
    tree = build(vals)
    for probe in rng.sample(range(100001), 300):
        expect = next((v for v in vals if v >= probe), None)
        assert tree.lower_bound(probe).val() == expect
        assert tree.upper_bound(probe).val() == expect


def test_rbring_matches_hashring():
    """The tree-backed ring and the sorted-array ring implement the same
    lookup/lookupN contract (ring.js:138-182)."""
    array_ring = HashRing(device="cpu")
    tree_ring = RBRing(farmhash32)
    servers = [f"10.0.0.{i}:3000" for i in range(12)]
    for server in servers:
        array_ring.add_server(server)
        tree_ring.add_server(server)

    rng = random.Random(11)
    keys = [f"key-{rng.randrange(10 ** 9)}" for _ in range(500)]
    for key in keys:
        assert array_ring.lookup(key) == tree_ring.lookup(key), key
        assert array_ring.lookup_n(key, 4) == tree_ring.lookup_n(key, 4), key

    # ... and still after churn.
    for server in servers[::3]:
        array_ring.remove_server(server)
        tree_ring.remove_server(server)
    for key in keys[:200]:
        assert array_ring.lookup(key) == tree_ring.lookup(key), key
        assert array_ring.lookup_n(key, 3) == tree_ring.lookup_n(key, 3), key


def walk(it, steps: int) -> list:
    """An iterator's (val, name) at its position and ``steps`` moves on."""
    out = [(it.val(), it.name())]
    for _ in range(steps):
        it.next()
        out.append((it.val(), it.name()))
    return out


def observe(tree, rng: random.Random) -> tuple:
    """Everything a tree shows: size, in-order (val, name), min, finds and
    bound walks at probes drawn from ``rng``."""
    nodes = [(n.val, n.name) for n in tree]
    probes = [rng.randrange(-5, 5005) for _ in range(12)] + [v for v, _ in nodes[:3]]
    low = tree.min()
    return (
        tree.size, nodes, (low.val, low.name) if low else None,
        [(n.val, n.name) if (n := tree.find(p)) else None for p in probes],
        [walk(tree.lower_bound(p), 3) for p in probes],
        [walk(tree.upper_bound(p), 2) for p in probes],
        walk(tree.iterator(), 4),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_sequence_equals_reference(seed):
    """Inserts (duplicates included), removes (absent ones included) and
    every query, step by step through both packages' trees."""
    rng = random.Random(seed)
    port, ref = RBTree(), ref_rbtree.RBTree()
    for step in range(1500):
        op = rng.random()
        val = rng.randrange(5000)
        if op < 0.55:
            name = f"n{rng.randrange(100)}"
            assert port.insert(val, name) == ref.insert(val, name), step
        elif op < 0.9:
            assert port.remove(val) == ref.remove(val), step
        else:
            probe_seed = rng.randrange(2 ** 32)
            assert observe(port, random.Random(probe_seed)) == \
                observe(ref, random.Random(probe_seed)), step
        if step % 100 == 99:
            assert port.check_invariants() == ref.check_invariants(), step
    assert [(n.val, n.name) for n in port] == [(n.val, n.name) for n in ref]
    assert port.size == ref.size > 0


def test_rbring_equals_reference_and_hashring():
    """Lookups and ``lookup_n`` through adds and removes: the port's
    ``RBRing`` on the port's FarmHash, the reference's on its own, and the
    port's ``HashRing(device="cpu")`` agree."""
    rng = random.Random(5)
    port, ref = RBRing(farmhash32), ref_rbtree.RBRing(ref_farmhash32)
    array = HashRing(device="cpu")
    servers = [f"10.{rng.randrange(256)}.{rng.randrange(256)}.{i}:{3000 + i}" for i in range(24)]
    keys = [f"key-{rng.randrange(10 ** 9)}" for _ in range(300)]
    for batch in (servers[:8], servers[8:20], servers[20:]):
        for server in batch:
            port.add_server(server)
            ref.add_server(server)
        array.add_remove_servers(batch, [])
        for server in rng.sample(sorted(port.servers), 3):
            port.remove_server(server)
            ref.remove_server(server)
            array.remove_server(server)
        assert port.servers == ref.servers == set(array.servers)
        assert port.tree.size == ref.tree.size == len(array._entries)
        for key in keys:
            want = ref.lookup(key)
            assert port.lookup(key) == want == array.lookup(key), key
            for n in (1, 3, 7):
                want_n = ref.lookup_n(key, n)
                assert port.lookup_n(key, n) == want_n == array.lookup_n(key, n), (key, n)
    assert RBRing(farmhash32).lookup("k") is None
    assert RBRing(farmhash32).lookup_n("k", 3) == []
