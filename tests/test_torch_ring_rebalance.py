"""BASELINE config 5 (hash-ring rebalance under churn) on the port's
run (``ringpop_tpu_torch/ring_rebalance.py``) on the CPU at n = 1 000,
3 ticks and 500 keys, against the reference ``HashRing`` and
``ring_ops`` replayed on the same server sets (its churn draws
from ``random.Random(5)`` as ``benchmarks/bench_ring_rebalance.py``
does): the same owners after every tick and the same move count, with
exact equality."""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest

from ringpop_tpu.hashring import HashRing as RefRing
from ringpop_tpu.ops import ring_ops as ref_ops
from ringpop_tpu_torch import ring_rebalance

N, TICKS, KEYS, CHURN = 1_000, 3, 500, 0.05


def _reference() -> dict:
    """``bench_ring_rebalance.run``'s loop at this size, recording what
    the port's run records."""
    rng = random.Random(5)
    servers = [f"10.{i // 65536 % 256}.{i // 256 % 256}.{i % 256}:3000" for i in range(N)]
    ring = RefRing()
    ring.add_remove_servers(servers, [])
    keys = [f"key-{rng.randrange(10 ** 12)}" for _ in range(KEYS)]
    bufs, lens = ref_ops.encode_strings(keys)
    owners = [ring.lookup(k) for k in keys]
    out = {"owners0": owners, "owners": [], "device": [], "moves": [], "rings": []}
    in_ring = set(servers)
    spare = [f"10.200.{i // 256}.{i % 256}:3000" for i in range(N)]
    for _ in range(TICKS):
        leavers = rng.sample(sorted(in_ring), int(N * CHURN))
        joiners = [spare.pop() for _ in range(int(N * CHURN))]
        ring.add_remove_servers(joiners, leavers)
        in_ring.difference_update(leavers)
        in_ring.update(joiners)
        new = [ring.lookup(k) for k in keys]
        out["moves"].append(sum(1 for a, b in zip(owners, new) if a != b))
        owners = new
        out["owners"].append(owners)
        server_list = sorted(in_ring)
        dring = ref_ops.build_ring(server_list)
        idx = np.asarray(ref_ops.lookup_keys(dring, jnp.asarray(bufs), jnp.asarray(lens)))
        out["device"].append([server_list[i] for i in idx])
        out["rings"].append(dring)
    out["last_servers"] = server_list
    return out


@pytest.fixture(scope="module")
def runs():
    return ring_rebalance.run(n=N, ticks=TICKS, n_keys=KEYS, device="cpu"), _reference()


def test_move_count_matches_reference(runs):
    got, want = runs
    assert got["moves"] == want["moves"]
    assert got["moved_total"] == sum(want["moves"]) > 0
    # consistent hashing: about 2 x churn of the keys move each tick
    assert 0.05 < got["moved_fraction"] < 0.2


@pytest.mark.parametrize("tick", range(TICKS))
def test_owners_match_reference_every_tick(runs, tick):
    got, want = runs
    assert got["owners0"] == want["owners0"]
    assert got["owners"][tick] == want["owners"][tick]
    assert want["device"][tick] == want["owners"][tick]


def test_last_device_ring_matches_reference(runs):
    got, want = runs
    assert got["last_servers"] == want["last_servers"]
    ring, ref = got["last_ring"], want["rings"][-1]
    np.testing.assert_array_equal(ring.hashes.numpy(), np.asarray(ref.hashes).astype(np.int64))
    np.testing.assert_array_equal(ring.owners.numpy(), np.asarray(ref.owners))


def test_run_reports_each_tick(runs):
    got, _ = runs
    for field in ("churn_ms", "lookup_ms", "build_ms", "build_on_device_ms", "lookup_keys_ms"):
        assert len(got[field]) == TICKS and all(t >= 0 for t in got[field]), field
    assert got["device"] == "cpu"
