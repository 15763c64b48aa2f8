"""The port's device ring (``ringpop_tpu_torch/ops/ring_ops.py``) against
the reference's (``ringpop_tpu/ops/ring_ops.py``, which imports in this
process) and the host ``HashRing``: the same sorted tables, owners and
preference lists, exactly (uint32 hashes and int32 indices; the port
holds hashes in int64)."""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.hashring import HashRing as RefRing
from ringpop_tpu.ops import ring_ops as ref_ops
from ringpop_tpu.ops.farmhash import farmhash32 as ref_farmhash32
from ringpop_tpu_torch.ops import ring_ops

SERVERS = [f"10.0.0.{i}:{3000 + i}" for i in range(20)]
SHUFFLED = random.Random(4).sample(SERVERS, len(SERVERS))


def _keys(prefix: str, m: int, seed: int) -> list[str]:
    rng = random.Random(seed)
    return [f"{prefix}-{rng.randrange(10 ** 12)}" for _ in range(m)]


def _hashes(keys) -> np.ndarray:
    return np.array([ref_farmhash32(k) for k in keys], dtype=np.uint32)


def _same_ring(got: ring_ops.DeviceRing, want) -> None:
    assert got.hashes.dtype == torch.int64 and got.owners.dtype == torch.int32
    np.testing.assert_array_equal(got.hashes.numpy(), np.asarray(want.hashes).astype(np.int64))
    np.testing.assert_array_equal(got.owners.numpy(), np.asarray(want.owners))
    assert got.size == want.size


@pytest.mark.parametrize("servers", [SERVERS, SHUFFLED, SERVERS[:1], []],
                         ids=["sorted", "shuffled", "one", "empty"])
def test_build_ring_matches_reference(servers):
    _same_ring(ring_ops.build_ring(servers, device="cpu"), ref_ops.build_ring(servers))


@pytest.mark.parametrize("rank", [False, True])
@pytest.mark.parametrize("replica_points", [3, 100, 1000])
def test_build_ring_on_device_matches_reference(rank, replica_points):
    """Shuffled servers, with and without ``name_rank``; with it the
    table equals the host build's."""
    servers = SHUFFLED[:7] if replica_points == 1000 else SHUFFLED
    name_rank = np.argsort(np.argsort(np.array(servers, dtype=object))).astype(np.int32)
    bufs, lens = ref_ops.encode_strings(servers)
    want = ref_ops.build_ring_on_device(
        jnp.asarray(bufs), jnp.asarray(lens), replica_points,
        name_rank=jnp.asarray(name_rank) if rank else None,
    )
    tb, tl = ring_ops.encode_strings(servers)
    np.testing.assert_array_equal(tb, bufs)
    np.testing.assert_array_equal(tl, lens)
    got = ring_ops.build_ring_on_device(
        torch.as_tensor(tb), torch.as_tensor(tl), replica_points,
        name_rank=torch.as_tensor(name_rank) if rank else None,
    )
    _same_ring(got, want)
    if rank:
        _same_ring(got, ref_ops.build_ring(servers, replica_points))


def test_encode_strings_and_its_limits():
    for strings, pad_to in ((["a", "bb", ""], None), (SERVERS, 40), ([], None),
                            (["x" * 30, "é"], None)):
        got = ring_ops.encode_strings(strings, pad_to)
        want = ref_ops.encode_strings(strings, pad_to)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0].dtype == np.uint8 and got[1].dtype == np.int32
    with pytest.raises(ValueError, match="pad_to"):
        ring_ops.encode_strings(["a"], pad_to=24)
    bufs, lens = ring_ops.encode_strings(SERVERS[:2])
    with pytest.raises(ValueError, match="1000 replica points"):
        ring_ops.build_ring_on_device(torch.as_tensor(bufs), torch.as_tensor(lens), 1001)


@pytest.mark.parametrize("servers", [SERVERS, SHUFFLED], ids=["sorted", "shuffled"])
def test_lookup_idx_and_keys_match_host_ring(servers):
    host = RefRing()
    host.add_remove_servers(servers, [])
    ref = ref_ops.build_ring(servers)
    ring = ring_ops.build_ring(servers, device="cpu")
    keys = _keys("key", 1000, 2)
    want = np.asarray(ref_ops.lookup_idx(ref, jnp.asarray(_hashes(keys))))
    got = ring_ops.lookup_idx(ring, torch.as_tensor(_hashes(keys).astype(np.int64)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert [servers[i] for i in got.tolist()] == [host.lookup(k) for k in keys]
    bufs, lens = ring_ops.encode_strings(keys)
    by_keys = ring_ops.lookup_keys(ring, torch.as_tensor(bufs), torch.as_tensor(lens))
    np.testing.assert_array_equal(by_keys.numpy(), want)


@pytest.mark.parametrize("n,window", [(1, None), (3, None), (4, 8), (4, 5), (6, 3), (25, None)])
@pytest.mark.parametrize("masked", [False, True])
def test_lookup_n_idx_matches_reference(n, window, masked):
    ref = ref_ops.build_ring(SERVERS)
    ring = ring_ops.build_ring(SERVERS, device="cpu")
    hashes = _hashes(_keys("pref", 300, 5))
    in_ring = np.random.default_rng(n).random((300, len(SERVERS))) < 0.6 if masked else None
    want = ref_ops.lookup_n_idx(ref, jnp.asarray(hashes), n, window=window,
                                in_ring=None if in_ring is None else jnp.asarray(in_ring))
    got = ring_ops.lookup_n_idx(ring, torch.as_tensor(hashes.astype(np.int64)), n,
                                window=window,
                                in_ring=None if in_ring is None else torch.as_tensor(in_ring))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_lookup_n_matches_host_ring_across_churn():
    """Add and remove servers, re-build each time, and hold lookup and
    lookupN against the mutated host ring."""
    host = RefRing()
    host.add_remove_servers(SERVERS, [])
    servers = list(SERVERS)
    keys = _keys("churn", 150, 17)
    hashes = torch.as_tensor(_hashes(keys).astype(np.int64))
    for op, server in [("add", "10.0.1.99:4000"), ("remove", SERVERS[3]),
                       ("remove", SERVERS[0]), ("add", "10.0.2.7:5000")]:
        if op == "add":
            host.add_server(server)
            servers.append(server)
        else:
            host.remove_server(server)
            servers.remove(server)
        ring = ring_ops.build_ring(servers, device="cpu")
        owners = ring_ops.lookup_idx(ring, hashes).tolist()
        prefs, complete = ring_ops.lookup_n_idx(ring, hashes, 3)
        assert bool(complete.all())
        for key, owner, row in zip(keys, owners, prefs.tolist()):
            assert servers[owner] == host.lookup(key), (op, server, key)
            assert [servers[i] for i in row if i >= 0] == host.lookup_n(key, 3)


def test_exact_hit_and_wrap_at_ring_minimum():
    """An exact replica hash owns itself; a hash past the last replica
    wraps to the minimum, for lookup and lookupN."""
    ring = ring_ops.build_ring(SERVERS, device="cpu")
    h, o = ring.hashes.tolist(), ring.owners.tolist()
    assert h[-1] < 2 ** 32 - 1
    probes = torch.tensor([h[-1] + 1, h[-1], h[0], h[7]])
    got = ring_ops.lookup_idx(ring, probes).tolist()
    assert got == [o[0], o[-1], o[0], o[7]]
    want = ref_ops.lookup_idx(ref_ops.build_ring(SERVERS),
                              jnp.asarray(probes.numpy().astype(np.uint32)))
    assert got == np.asarray(want).tolist()
    expect = []
    for owner in o:
        if owner not in expect:
            expect.append(owner)
        if len(expect) == 4:
            break
    prefs, complete = ring_ops.lookup_n_idx(ring, probes[:1], 4)
    assert bool(complete.all()) and prefs[0].tolist() == expect


def test_empty_ring_lookup_raises():
    empty = ring_ops.build_ring([], device="cpu")
    assert empty.size == 0
    key = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError):
        ring_ops.lookup_idx(empty, key)
    with pytest.raises(ValueError):
        ring_ops.lookup_n_idx(empty, key, 3)
