"""BASELINE config 5: hash-ring rebalance under churn, on the port.

The port of ``benchmarks/bench_ring_rebalance.py``: 10 000 servers
``10.a.b.c:3000``, 5% of them leaving and as many spares joining each
tick, and the owners of 2 000 keys re-resolved after every tick; the
outcome is how many keys moved.  The churn draws from
``random.Random(5)`` as the reference does, so the count is exact (961
over 5 ticks at the defaults).

Each tick runs both paths and holds them against each other:

* host: ``HashRing.add_remove_servers`` (the joiners' replica names
  hashed in one device batch) and a per-key ``lookup``;
* device: ``ring_ops.build_ring`` of the tick's server set and
  ``build_ring_on_device`` of the same list, which must be equal, and one
  ``lookup_keys`` of every key, whose owners must equal the host's.

Run: ``run(n=1000, device="cpu")`` on the host; ``chip_smoke.py`` phase f
runs it at the defaults on the card.
"""

from __future__ import annotations

import random
import time

import torch

from ringpop_tpu_torch import resolve_device
from ringpop_tpu_torch.hashring import HashRing
from ringpop_tpu_torch.ops import ring_ops


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def run(
    n: int = 10_000,
    churn: float = 0.05,
    ticks: int = 5,
    n_keys: int = 2_000,
    device: torch.device | str | None = None,
) -> dict:
    """Drive config 5 on ``device``; returns the move count, the per-tick
    host owners of every key (``owners``, after each tick; ``owners0``
    before the first) and per-tick times in ms.  Raises AssertionError if
    the two ring builds or the device and host owners differ."""
    dev = resolve_device(device)
    rng = random.Random(5)
    servers = [f"10.{i // 65536 % 256}.{i // 256 % 256}.{i % 256}:3000" for i in range(n)]
    t0 = _clock(dev)
    ring = HashRing(device=dev)
    ring.add_remove_servers(servers, [])
    build0_ms = (_clock(dev) - t0) * 1e3
    keys = [f"key-{rng.randrange(10 ** 12)}" for _ in range(n_keys)]
    key_bufs, key_lens = ring_ops.encode_strings(keys)
    key_bufs = torch.from_numpy(key_bufs).to(dev)
    key_lens = torch.from_numpy(key_lens).to(dev)
    owners = [ring.lookup(k) for k in keys]
    out = {"n": n, "churn": churn, "ticks": ticks, "n_keys": n_keys, "device": str(dev),
           "host_build_ms": build0_ms, "owners0": owners, "owners": [], "moves": [],
           "churn_ms": [], "lookup_ms": [], "build_ms": [], "build_on_device_ms": [],
           "lookup_keys_ms": []}

    in_ring = set(servers)
    spare = [f"10.200.{i // 256}.{i % 256}:3000" for i in range(n)]
    churn_count = int(n * churn)
    for _ in range(ticks):
        t0 = _clock(dev)
        leavers = rng.sample(sorted(in_ring), churn_count)
        joiners = [spare.pop() for _ in range(churn_count)]
        ring.add_remove_servers(joiners, leavers)
        in_ring.difference_update(leavers)
        in_ring.update(joiners)
        t1 = _clock(dev)
        new_owners = [ring.lookup(k) for k in keys]
        t2 = time.perf_counter()
        out["moves"].append(sum(1 for a, b in zip(owners, new_owners) if a != b))
        owners = new_owners
        out["owners"].append(owners)
        out["churn_ms"].append((t1 - t0) * 1e3)
        out["lookup_ms"].append((t2 - t1) * 1e3)

        server_list = sorted(in_ring)
        t0 = _clock(dev)
        dring = ring_ops.build_ring(server_list, device=dev)
        t1 = _clock(dev)
        bufs, lens = ring_ops.encode_strings(server_list)
        bufs, lens = torch.from_numpy(bufs).to(dev), torch.from_numpy(lens).to(dev)
        t2 = _clock(dev)
        # the list is in name order, so position breaks ties as name rank does
        on_dev = ring_ops.build_ring_on_device(bufs, lens)
        t3 = _clock(dev)
        if not (torch.equal(dring.hashes, on_dev.hashes)
                and torch.equal(dring.owners, on_dev.owners)):
            raise AssertionError("build_ring and build_ring_on_device differ")
        t4 = _clock(dev)
        idx = ring_ops.lookup_keys(dring, key_bufs, key_lens)
        t5 = _clock(dev)
        dev_owners = [server_list[i] for i in idx.tolist()]
        bad = sum(1 for a, b in zip(owners, dev_owners) if a != b)
        if bad:
            raise AssertionError(f"the device ring diverged from the host ring on {bad} keys")
        out["build_ms"].append((t1 - t0) * 1e3)
        out["build_on_device_ms"].append((t3 - t2) * 1e3)
        out["lookup_keys_ms"].append((t5 - t4) * 1e3)
    out["moved_total"] = sum(out["moves"])
    out["moved_fraction"] = out["moved_total"] / (n_keys * ticks)
    out["last_ring"] = dring
    out["last_servers"] = server_list
    return out

