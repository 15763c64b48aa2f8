"""Where a tick's time goes on the card.

Run from the root of a checkout (needs one CUDA card and nvcc):

    python3 -m ringpop_tpu_torch.profile_tick [--backend dense|delta] [--n N] [--ticks 3]
        [--shards D] [--sided]

It drives ``SimCluster(n, SwimParams(loss=0.01), seed=0)``, the BASELINE
config 3 protocol, on the dense backend (default n = 10 000) or on the
delta backend with the reference's default caps (default n = 65 536,
the BASELINE north star), through two windows of ``--ticks`` ticks each
under ``torch.profiler``: a steady window (no node killed yet; at
n = 10 000 no change is in flight and the ping-req exchange skips, at
n = 65 536 lost pings keep some suspicion in flight) and a churn window
right after a node is killed and suspected.  Each window runs twice
from the same state, net and key: once unprofiled, for the wall time
per tick, then under the profiler, for the device-busy time per tick
(the sum of kernel times) and the spans, so the idle share is
``1 - busy / wall`` of the same ticks (the profiler's own host cost
inflates its wall for a tick of thousands of small launches; that
profiled share is printed beside it).  It also prints the host syncs
per tick (counted by ``torch.cuda.set_sync_debug_mode``), the step's
phase spans (``swim.*``, ``delta.*`` and ``gossip.*`` labels: the device time
of the kernels launched inside each, and its host time), the costliest
kernels, and the port's own CUDA kernels.  ``--shards D`` ticks the
cluster under the gossip ring of D shards on the card, the ring path of
``parallel.sharded_step``/``sharded_delta_step`` (their ring context
around the same step), so the window shows the ring-hop kernel's share
of the sharded tick.

``--backend delta --sided`` profiles BASELINE config 4 instead, with the
settings of ``benchmarks/bench_partition_heal_delta.py`` in sided mode
(default n = 65 536, C = n/16, wire 64, grid 512, suspicion 8, no
loss, seed 4): a *split* window (split ticks 3 to 5 after
``split_sides``), then the bench's anti-entropy rebases after split
ticks 5, 10 and 12 and the heal, and a *heal storm* window (heal ticks
3 to 5, the cross-side full syncs, flips and refutations).  Its ticks
are single ticks, not the bench's chunks of five, so the trajectory is
like the bench's and not the same.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import time
import warnings

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ringpop_tpu_torch import parallel
from ringpop_tpu_torch.models import swim_sim as sim
from ringpop_tpu_torch.models.cluster import SimCluster

SPANS = ("swim.", "delta.", "gossip.")
PORT_KERNELS = (
    "recv_merge_sort_kernel", "recv_merge_kernel", "farmhash32_kernel", "row_searchsorted_kernel",
    "merge_insert_kernel",
    "ring_hop_kernel",
)


def _window(c: SimCluster, ticks: int, label: str, top: int) -> None:
    # the step never writes its inputs, so the window replays from here
    start = (c.state, c.net, c.key)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ticks):
        c.tick()
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3 / ticks
    c.state, c.net, c.key = start
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                for _ in range(ticks):
                    c.tick()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    syncs = sum("synchroniz" in str(w.message) for w in caught) / ticks
    events = prof.key_averages()
    # device rows are kernels and copies, plus the device-side copies of
    # the span labels (span lengths, left out of the busy sum)
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in on_device if not e.key.startswith(SPANS)]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / ticks
    print(f"[{label}] wall {bare_ms:.3f} ms/tick unprofiled, "
          f"{wall_ms:.3f} ms/tick profiled; device busy {busy_ms:.3f} ms/tick; idle share "
          f"{1 - busy_ms / bare_ms:.3f} unprofiled, {1 - busy_ms / wall_ms:.3f} profiled; "
          f"host syncs {syncs:g}/tick")
    spans = sorted((e for e in events if e.key.startswith(SPANS) and e.device_type != DeviceType.CUDA),
                   key=lambda e: -e.device_time_total)
    for e in spans:
        print(f"[{label}]   span {e.key:<22} kernels {e.device_time_total / 1e3 / ticks:9.3f} "
              f"ms/tick  host {e.cpu_time_total / 1e3 / ticks:9.3f} ms/tick  "
              f"calls/tick {e.count / ticks:g}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[{label}]   kernel {e.self_device_time_total / 1e3 / ticks:9.3f} ms/tick "
              f"x{e.count / ticks:g}  {e.key[:100]}")
    # the port's own kernels, launched through ctypes rather than ATen
    for e in kernels:
        if any(name in e.key for name in PORT_KERNELS):
            print(f"[{label}]   port kernel {e.self_device_time_total / 1e3 / ticks:9.3f} "
                  f"ms/tick x{e.count / ticks:g}  {e.key[:100]}")


def _sided_windows(n: int, ticks: int, top: int) -> None:
    """The split and heal-storm windows of config 4 in sided mode."""
    c = SimCluster(n, sim.SwimParams(loss=0.0, suspicion_ticks=8), seed=4, device="cuda",
                   backend="delta", capacity=max(256, n // 16), wire_cap=64, claim_grid=512)
    c.tick(2)
    c.split_sides([list(range(n // 2)), list(range(n // 2, n))])
    for _ in range(2):
        c.tick()
    _window(c, ticks, "split", top)
    done = 2 + ticks
    for upto in (5, 10, 12):
        while done < upto:
            c.tick()
            done += 1
        c.rebase(anti_entropy=True)
    c.heal_partition()
    for _ in range(2):
        c.tick()
    _window(c, ticks, "heal storm", top)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", choices=("dense", "delta"), default="dense")
    ap.add_argument("--n", type=int, default=None,
                    help="cluster size (default 10000 dense, 65536 delta)")
    ap.add_argument("--ticks", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--shards", type=int, default=0,
                    help="tick over a gossip ring of this many shards on the card (0: unsharded)")
    ap.add_argument("--sided", action="store_true",
                    help="BASELINE config 4 in sided mode: a split and a heal-storm window")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_tick needs a CUDA card")
    if args.sided and (args.backend != "delta" or args.shards):
        raise SystemExit("--sided profiles the unsharded delta backend (--backend delta)")
    n = args.n or (65_536 if args.backend == "delta" else 10_000)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    print(f"backend {args.backend}, n {n}, shards {args.shards or 'none'}"
          f"{', sided (config 4)' if args.sided else ''}")
    if args.sided:
        _sided_windows(n, args.ticks, args.top)
        print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return
    c = SimCluster(n, sim.SwimParams(loss=0.01), seed=0, device="cuda", backend=args.backend)
    ring = contextlib.nullcontext()
    if args.shards:
        mesh = parallel.make_mesh(devices=[torch.device("cuda")] * args.shards)
        ring = parallel.mesh.mesh_gossip(mesh)
    with ring:
        for _ in range(3):
            c.tick()
        _window(c, args.ticks, "steady", args.top)
        c.kill(n // 3)
        for _ in range(2):
            c.tick()
        _window(c, args.ticks, "churn", args.top)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
