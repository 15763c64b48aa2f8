#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ringpop_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and ``nvcc``; it imports nothing of JAX or ``ringpop_tpu``.
Phases, in order (any failure is an uncaught exception, exit != 0):

1. print the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``ringpop_tpu_torch/csrc`` (one nvcc each, in
   parallel) and print the build time and the ptxas report;
3. hold each kernel against its plain PyTorch version on the card
   (exact equality) at the main path's shapes, and time kernel, plain
   version and, where one exists, a single PyTorch call for the same
   function (CUDA events, median of 10 runs after a warm-up);
4. step a 256-node cluster with a kill on the card and on the CPU for 10
   ticks: every state field and metric must be equal on every tick;
5. the main path at BASELINE config 3 (10k nodes, 1% loss): 5 ticks,
   kill node 4242, tick until every live node holds it faulty and the
   views converge, then device checksums must form one group; both
   kernels' launch counters must have risen during this phase; then the
   device checksums of a few rows equal the host oracle's, and the
   FarmHash kernel equals its plain version on real rows' strings;
6. print the ``kernels`` JSON line, then the result line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
N_MAIN = 10_000
VICTIM = 4242
MAX_TICKS = 150
RUNS = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor-core 32-bit rate (fp32 table row)
CHAIN_OPS_PER_BLOCK = 7  # FarmHash32 long arm: dependent ops per 20-byte block
CHAIN_CYCLES_PER_OP = 4  # latency of a dependent integer add/shift/multiply-add


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, runs: int = RUNS) -> float:
    """Median device time of ``fn`` over ``runs`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return float(out.splitlines()[0])


def check_recv_merge(torch, dev) -> dict:
    import numpy as np

    from ringpop_tpu_torch.ops.recv_merge import recv_merge, recv_merge_plain

    n = N_MAIN
    rng = np.random.default_rng(0)
    fwd_np = rng.random(n) < 0.99
    t_np = np.where(fwd_np, rng.integers(0, n, n), 0)
    # phase-3-shaped claims: a few active changes per delivering sender,
    # each a lattice key (inc * 8 + status)
    active = rng.random((n, n)) < 0.002
    keys = rng.integers(1, 1 << 20, (n, n)) * 8 + rng.integers(1, 5, (n, n))
    claims_np = np.where(active & fwd_np[:, None], keys, 0).astype(np.int32)
    t_safe = torch.as_tensor(t_np, dtype=torch.int64, device=dev)
    fwd_ok = torch.as_tensor(fwd_np, device=dev)
    claims = torch.as_tensor(claims_np, device=dev)
    del active, keys, claims_np

    got = recv_merge(t_safe, fwd_ok, claims)
    want = recv_merge_plain(t_safe, fwd_ok, claims)
    torch.cuda.synchronize()
    err = max(int((got[0] - want[0]).abs().max()), int((got[1] - want[1]).abs().max()))
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"recv_merge kernel != plain at n={n} (max abs err {err})")
    # every sender to one receiver: one run of length n
    one_t = torch.full((n,), 7, dtype=torch.int64, device=dev)
    one_ok = torch.ones(n, dtype=torch.bool, device=dev)
    dense = torch.randint(0, 1 << 30, (n, n), dtype=torch.int32, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1))
    g1, w1 = recv_merge(one_t, one_ok, dense), recv_merge_plain(one_t, one_ok, dense)
    if not (torch.equal(g1[0], w1[0]) and torch.equal(g1[1], w1[1])):
        raise AssertionError("recv_merge kernel != plain for the all-to-one case")
    del dense, g1, w1

    ms = time_ms(torch, lambda: recv_merge(t_safe, fwd_ok, claims))
    plain_ms = time_ms(torch, lambda: recv_merge_plain(t_safe, fwd_ok, claims))
    recv = torch.where(fwd_ok, t_safe, n)
    idx = recv[:, None].expand(n, n)
    zeros = torch.zeros((n + 1, n), dtype=torch.int32, device=dev)
    library_ms = time_ms(
        torch, lambda: zeros.scatter_reduce(0, idx, claims, reduce="amax", include_self=True)
    )
    delivered = int(fwd_ok.sum())
    moved = 8 * n + n + 4 * delivered * n + 4 * n * n + 4 * n
    ops = delivered * n
    bound_ms = max(moved / HBM_BYTES_PER_S, ops / INT_OPS_PER_S) * 1e3
    log(f"recv_merge: exact at n={n} (delivered {delivered}) and all-to-one; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, scatter_reduce {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms")
    return {
        "name": "recv_merge", "route": "cuda",
        "source": "ringpop_tpu_torch/csrc/recv_merge.cu",
        "replaces": "ringpop_tpu/ops/recv_merge_pallas.py:70",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops / INT_OPS_PER_S else "operations",
        "library_ms": library_ms,
    }


def synthetic_rows(torch, dev, rows: int):
    """Checksum-format view rows at n = N_MAIN: a mix of every status
    and spread incarnations, as a cluster in churn holds them."""
    import numpy as np

    rng = np.random.default_rng(2)
    status = rng.choice([0, 1, 1, 1, 2, 3, 4], size=(rows, N_MAIN))
    inc = rng.integers(0, 1 << 26, (rows, N_MAIN))
    keys = np.where(status > 0, inc * 8 + status, 0).astype(np.int32)
    return torch.as_tensor(keys, device=dev)


def check_farmhash(torch, dev) -> dict:
    import numpy as np

    from ringpop_tpu_torch.models.cluster import DEFAULT_BASE_INC
    from ringpop_tpu_torch.models.checksum import default_addresses
    from ringpop_tpu_torch.ops import checksum_device as ckdev
    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch, farmhash32_plain

    # every length arm (0-4, 5-12, 13-24, > 24) on random bytes
    rng = np.random.default_rng(3)
    lens_np = np.concatenate([np.arange(0, 200), rng.integers(0, 4096, 312)]).astype(np.int32)
    bufs = torch.as_tensor(rng.integers(0, 256, (lens_np.size, 4096), dtype=np.uint8), device=dev)
    lens = torch.as_tensor(lens_np, device=dev)
    if not torch.equal(farmhash32_batch(bufs, lens), farmhash32_plain(bufs, lens)):
        raise AssertionError("farmhash32 kernel != plain on the length-arm batch")

    # checksum strings at the main path's chunk shape
    book = ckdev.DeviceBook(default_addresses(N_MAIN), DEFAULT_BASE_INC, device=dev)
    chunk = (64 * 1024 * 1024) // (book.n * book.entry_width)
    sbufs, slens = ckdev.row_strings(book, synthetic_rows(torch, dev, chunk))
    got = farmhash32_batch(sbufs, slens)
    want = farmhash32_plain(sbufs, slens)
    err = int((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"farmhash32 kernel != plain on checksum rows (max abs err {err})")

    ms = time_ms(torch, lambda: farmhash32_batch(sbufs, slens))
    plain_ms = time_ms(torch, lambda: farmhash32_plain(sbufs, slens))
    total = int(slens.to(torch.int64).sum())
    moved = total + 4 * chunk + 4 * chunk
    ops = (total // 20) * 40  # ~40 integer ops per 20-byte block
    bound_ms = max(moved / HBM_BYTES_PER_S, ops / INT_OPS_PER_S) * 1e3
    # the >24-byte arm is a chain of dependent 20-byte blocks per row: its
    # critical path is about CHAIN_OPS_PER_BLOCK dependent integer ops of
    # ~CHAIN_CYCLES_PER_OP cycles each, at the card's top SM clock
    chain = (int(slens.max()) - 1) // 20
    chain_ms = chain * CHAIN_OPS_PER_BLOCK * CHAIN_CYCLES_PER_OP / (max_sm_clock_mhz() * 1e3)
    log(f"farmhash32: exact on {lens_np.size} arm rows and {chunk} checksum rows "
        f"(max len {int(slens.max())}, chain {chain} blocks); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes and operations), "
        f"dependency-chain estimate {chain_ms:.4f} ms")
    return {
        "name": "farmhash32", "route": "cuda",
        "source": "ringpop_tpu_torch/csrc/farmhash32.cu",
        "replaces": "ringpop_tpu/ops/farmhash_pallas.py:77",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops / INT_OPS_PER_S else "operations",
        "library_ms": None,
    }


def check_cuda_equals_cpu(torch) -> None:
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.models.swim_sim import SwimParams

    params = SwimParams(loss=0.01)
    gpu = SimCluster(256, params, seed=0, device="cuda")
    cpu = SimCluster(256, params, seed=0, device="cpu")
    for t in range(10):
        if t == 3:
            gpu.kill(17)
            cpu.kill(17)
        mg, mc = gpu.tick(), cpu.tick()
        if mg != mc:
            raise AssertionError(f"tick {t}: metrics differ: cuda {mg} cpu {mc}")
        for f in ("view_key", "pb", "suspect_left", "tick"):
            a, b = getattr(gpu.state, f).cpu(), getattr(cpu.state, f)
            if not torch.equal(a, b):
                raise AssertionError(f"tick {t}: {f} differs between cuda and cpu")
    log("step: cuda == cpu on every field and metric for 10 ticks at n=256 (kill at tick 3)")


def main_path(torch) -> dict:
    """BASELINE config 3 at full size; returns launches per kernel."""
    from ringpop_tpu_torch.models import swim_sim as sim
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch
    from ringpop_tpu_torch.ops.recv_merge import recv_merge

    torch.cuda.reset_peak_memory_stats()
    recv_merge.launches = 0
    farmhash32_batch.launches = 0

    c = SimCluster(N_MAIN, sim.SwimParams(loss=0.01), seed=0, device="cuda")
    tick_ms = []

    def timed_tick():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c.tick()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)

    for _ in range(5):
        timed_tick()
    c.kill(VICTIM)
    detected = None
    for t in range(MAX_TICKS):
        timed_tick()
        live = torch.as_tensor(c.live_indices(), device="cuda")
        col = c.state.view_key[live, VICTIM] & 7
        if bool((col == sim.FAULTY).all()) and c.converged():
            detected = t + 1
            break
    if detected is None:
        raise AssertionError(f"node {VICTIM} not faulty everywhere after {MAX_TICKS} ticks")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    groups = c.checksum_groups(backend="device")
    torch.cuda.synchronize()
    ck_ms = (time.perf_counter() - t0) * 1e3
    if len(groups) != 1:
        raise AssertionError(f"{len(groups)} checksum groups after convergence")
    launches = {"recv_merge": recv_merge.launches, "farmhash32": farmhash32_batch.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"main path: n={N_MAIN} loss=0.01, node {VICTIM} faulty everywhere and views "
        f"converged {detected} ticks after the kill ({len(tick_ms)} ticks); median tick "
        f"{statistics.median(tick_ms):.3f} ms; device checksums of "
        f"{len(c.live_indices())} live nodes in one group, {ck_ms:.1f} ms; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    # the device checksums agree with the host oracle on a few real rows
    live = c.live_indices()[:3]
    host = c.checksums(indices=live, backend="host")
    dev_sums = c.checksums(indices=live, backend="device")
    if host != dev_sums:
        raise AssertionError(f"device checksums {dev_sums} != host {host}")
    log(f"checksums: device == host (pure Python) on live rows {[int(i) for i in live]}")
    check_farmhash_real_rows(torch, c)
    return launches


def check_farmhash_real_rows(torch, c) -> None:
    """The FarmHash kernel against its plain version on the checksum
    strings of real rows of the main path's cluster: a few dozen live
    nodes, the killed node's (stale) row and a row in the middle."""
    from ringpop_tpu_torch.ops import checksum_device as ckdev
    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch, farmhash32_plain

    idx = list(c.live_indices()[:30]) + [VICTIM, N_MAIN // 2]
    rows = c.state.view_key.index_select(0, torch.as_tensor(idx, device=c.device))
    book = ckdev.DeviceBook(c.book.addresses, c.base_inc, device=c.device)
    bufs, lens = ckdev.row_strings(book, rows)
    got, want = farmhash32_batch(bufs, lens), farmhash32_plain(bufs, lens)
    if not torch.equal(got, want):
        raise AssertionError("farmhash32 kernel != plain on the cluster's checksum rows")
    log(f"farmhash32: exact on the checksum strings of {len(idx)} rows of the "
        f"n={N_MAIN} cluster (lengths {int(lens.min())}..{int(lens.max())})")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "ringpop_tpu_torch")):
        print("chip_smoke: run from a checkout that holds ringpop_tpu_torch/", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from ringpop_tpu_torch import _build

    t_start = time.perf_counter()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {len(_build.kernel_sources())} kernels in {time.perf_counter() - t0:.1f} s")
    for name, text in sorted(_build.build_logs.items()):
        for line in text.strip().splitlines():
            log(f"  [{name}] {line}")

    dev = torch.device("cuda")
    rows = [check_recv_merge(torch, dev), check_farmhash(torch, dev)]
    check_cuda_equals_cpu(torch)
    launches = main_path(torch)
    for row in rows:
        row["launches"] = launches[row["name"]]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
