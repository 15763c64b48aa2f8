#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ringpop_tpu_torch``) on one card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and ``nvcc``; it imports nothing of JAX or ``ringpop_tpu``.
Phases, in order (any failure is an uncaught exception, exit != 0):

1. print the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``ringpop_tpu_torch/csrc`` (one nvcc each, in
   parallel) and print the build time and the ptxas report;
3. hold each kernel against its plain PyTorch version on the card
   (exact equality) at the main paths' shapes and at the edge shapes of
   its design (receiver merge: all-to-one, every sender silent, claims
   off a 16-byte boundary, n in {1, 4, 5, 10001, 10003, 32768, 32769};
   row-searchsorted: C in {1, 3, 33, 64, 256, 20000} by K in {5, 16, 31,
   33, 64, 65, 256}; merge-insert: C in {1, 17, 31, 33, 5000}, ki from 1
   to 20000, inputs off their alignment; FarmHash: odd row strides and
   lengths at the arm, block and tile edges), and time kernel, plain
   version and, where one exists, a single PyTorch call for the same
   function (CUDA events around one call on an idle card, after an L2
   flush; median of 10 calls after a warm-up; the plain FarmHash, which
   loops over a row's 20-byte blocks in Python, is timed by its one run);
   the receiver merge at its phase-3 and ping-req shapes, and it and the
   merge-insert split into the wrapper's prefix (its call with the
   kernel's C entry point launching nothing) and the launch alone; time
   FarmHash at the delta path's checksum chunk too;
4. step a 256-node dense cluster with a kill on the card and on the CPU
   for 10 ticks: every state field and metric must be equal on every
   tick; the same for a 256-node delta cluster at production-style caps
   for 12 ticks; and, on the card, the delta step with ample caps must
   densify to the dense step's state on every tick (n = 128); and
   (phase a) sided mode at n = 256 (capacity 64, wire 8, grid 64, 5%
   loss, suspicion 6) on the card and on the CPU: ``split_sides`` into
   halves, 8 ticks with anti-entropy rebases after 4 and 8, the heal, 30
   ticks with a rebase every 10, a cross-side join and 2 ticks, every
   field (``side`` and ``merge_to`` included) and metric equal after
   every op;
5. the dense main path at BASELINE config 3 (10k nodes, 1% loss): 5
   ticks, kill node 4242, tick until every live node holds it faulty and
   the views converge, then device checksums must form one group; both
   of its kernels' launch counters must have risen during this phase,
   and the receiver merge's launches are counted by senders delivered
   (phase 3 or a ping-req slot);
   then the device checksums of a few rows equal the host oracle's, and
   the FarmHash kernel equals its plain version on real rows' strings;
   then (phase g) the converged cluster's lookup surface: ``traffic_ring()``
   (its 1,000,000 replica names) and ``lookup_batch`` of 16,384 keys
   through viewer 0 and one other live viewer, equal to
   ``ring_for(viewer).lookup`` key for key; ``traffic_ring()`` and each
   ``lookup_batch`` must launch the short-row FarmHash kernel once and
   the warp kernel never;
6. the delta main path: the BASELINE north star's 65,536-node cluster
   on config 3's protocol with the reference's default caps: 5 ticks,
   kill node 54321, tick until every live view holds it faulty and
   ``converged()`` (exact agreement of all live views), then the device
   checksums of a stated sample of rows; the launch counters of the
   row-searchsorted, merge-insert and FarmHash kernels must have risen
   during this phase; the row-searchsorted launches by (C, K) are
   printed; then phase g on it: ``traffic_ring()`` hashes its 6,553,600
   replica names and ``lookup_batch`` of 16,384 keys through viewer 0
   must equal ``lookup_keys`` on a ``build_ring`` of the viewer's alive
   and suspect servers (a host ring of 6.5 M entries would take tens of
   seconds);
7. the dense ring path: BASELINE config 3 sharded over D = 4 shards on
   the card (``parallel.sharded_step``, every cross-shard transfer a
   launch of the ring-hop kernel): the sharded step and the unsharded
   step run in lockstep from the same state and keys for the 5 ticks
   before the kill of node 4242 and the 5 after it, every field and
   metric equal on every tick; then the sharded step alone until every
   live node holds the victim faulty and the views converge, which must
   take as many ticks as the unsharded main path of phase 5, and the
   device checksums must form one group; the hop kernel's launch counter
   must have risen;
8. the delta ring path: phase 6's cluster sharded over D = 4 shards
   (``parallel.sharded_delta_step``), in lockstep with the unsharded
   delta step for 5 + 5 ticks around the kill of node 54321, then alone
   to convergence in as many ticks as phase 6 took, and the sample
   checksums; the hop, row-searchsorted and merge-insert kernels must
   have been launched by the sharded step alone;
9. time the row-searchsorted kernel against ``torch.searchsorted`` at
   the delta main path's three most-launched shapes (and any tied with
   the third);
10. (phase b) BASELINE config 4, the 50/50 netsplit and heal, as
    ``benchmarks/bench_partition_heal_delta.py`` runs it in sided mode
    (C = n/16, wire 64, grid 512, suspicion 8, no loss, seed 4; 12
    split ticks with anti-entropy rebases after 5, 10 and 12, the heal,
    ticks in fives with a rebase every 10, the bridge join at 64 ticks
    if two groups are left) at n = 8,192 to ``converged()``, then
    ``rebase`` and ``fold_sides``: one base again, and the device
    checksums of every live row in one group; FarmHash, row-searchsorted
    and merge-insert must have been launched;
11. (phase c) config 4 at full state, n = 65,536 and C = 4,096: the
    split with its three rebases and a 20-tick heal window with rebases
    at 10 and 20 (the depth cut is stated in its log line), printing
    ``make_sides`` ms, each rebase's host fold and transfer ms, the tick
    median, checksum groups over a sample of live rows at the heal and
    at the end, the largest occupancy, overflow drops and peak memory;
    the rolling digest must equal ``compute_digest`` at the end and the
    row-searchsorted and merge-insert kernels must have been launched;
12. (phase d) the sharded sided step: n = 1,024 over D = 4 shards,
    phase a's split, rebases, heal and 8 heal ticks, in lockstep with
    the unsharded step, every field and metric equal; the hop kernel
    must have been launched;
13. (phase e) the row-searchsorted and merge-insert kernels against
    their plain versions at phase c's most-launched shapes (the
    merge-insert's unstaged path at C = 4,096 among them), each timed as
    one call, its prefix and its launch alone, beside its bound, its
    plain version and, for the searchsorted, ``torch.searchsorted``;
14. (phase f) BASELINE config 5, the hash-ring rebalance, at full size
    through ``ringpop_tpu_torch.ring_rebalance`` (the settings of
    ``benchmarks/bench_ring_rebalance.py``: 10,000 servers, 500 leaving
    and 500 joining a tick for 5 ticks, 2,000 keys, ``random.Random(5)``):
    exactly 961 key moves, ``build_ring`` == ``build_ring_on_device`` and
    ``lookup_keys`` == the host ``HashRing`` on every key every tick, the
    host and device times of each tick printed; ``lookup_keys`` and
    ``lookup_masked_idx`` rates at 16,384 keys; then the short-row
    FarmHash kernel against its plain version on every length 0-24 at an
    odd row stride and one byte past alignment, and on the replica names
    [1,000,000, 18] (config 5's first ring), the same padded to 25 bytes a
    row and [6,553,600, 17] (the delta path's ring), timed beside the warp
    kernel on the same rows;
15. (phase h) the fault model through the port's scenario host loop
    (``scenarios.runner.run_host_loop``): every family and a partition
    at n = 256 (delay 2, jitter 1) on the card and on the CPU, dense and
    delta at phase 4's caps, every state field (the in-flight buffer
    too), net field and metric equal after every segment; then three
    families of ``benchmarks/bench_faults.py`` (80 ticks: one-way link
    loss, gray periods, delay with jitter, each with a kill) and the
    kill alone as a control, at BASELINE config 3 on the dense backend
    (n = 10,000, 1% loss, seed 0), and the delay and gray families and
    the control on the delta main path (n = 65,536, default caps), each
    ticked on until the killed node is faulty in every live
    view and the views agree, to one checksum group (all live rows
    dense, the sample delta); each prints its ticks to convergence
    after the fault window, its median tick inside and outside the
    window, host syncs a tick and peak memory.  The delay runs must
    delay and mature claims, a gray window must see fewer pings than
    live nodes, and the receiver merge (dense) and the
    row-searchsorted and merge-insert kernels (delta) must launch;
16. (phase i) the remaining step arms: i1, each at n = 256 on the card
    and on the CPU, every state field and metric equal after every tick
    call (the sparse step at caps 8 and 4, both again under
    ``_SPARSE_SMALL_N = 1``, which forces the block-prefix lowerings;
    damping, alone and with the delay buffer; ``relay_full_sync``
    through ``run_host_loop``; the delta backend with the carried
    slot-base planes; ``delta_step_impl(..., upto)`` for 0..6); i2,
    config 3 on the sparse step (cap 16) in lockstep with the dense step,
    field-equal on every tick with no row past the cap, converging in
    the dense path's ticks to one checksum group; i3, the block-prefix
    selection against the int16 one at n = 32 767, then the dense
    backend at n = 40 960 (cap 16) to convergence with its peak memory
    and the allocations live at the peak, and kernel 3 timed at the
    block search's shape; i4, damping at config 3 (eight suspend/resume
    cycles quarantine node 4242 in ``ring_for`` and ``lookup_batch``,
    250 quiet ticks reinstate it); i5, the relay's full rows at config 3
    with the flag on (> 0) and off (0); i6, the delta north star with
    the carried planes against the uncarried run, then the step's
    prefixes ``upto`` = 0..7 timed;
17. (phase j) the compiled scenario runner: j1, ``run_scenario`` on the
    card and on the CPU at n = 256 (``mixed_spec``, dense, with in-scan
    revives; the delay family, delta at phase 4's caps), every trace
    series, state and net field and the key equal; j2, dense at
    n = 10,000 (``benchmarks/bench_scenario.py``'s spec, 120 ticks, seed
    11, and ``mixed_spec``), ``run_scenario`` against ``run_host_loop``
    from two clusters of one seed (states, net values, keys, loss and
    the checksums of every live row equal), and a ``tick(1)`` loop over
    the same scenario; j3, the same on the delta main path (n = 65,536,
    default caps) with the delay and gray families (cut from 80 ticks to
    32); each
    arm's ms per tick, host syncs per tick and peak memory printed, and
    ``run_scenario`` may take no more syncs a tick outside its revives
    than the ``tick(1)`` loop inside its ticks; the receiver merge
    (dense) and the row-searchsorted and merge-insert kernels (delta)
    must launch; j4, j2's first spec in two 60-tick segments and j3's
    delay family in 20-tick segments, each with a checkpoint under the
    git-ignored build directory, killed after the first checkpoint and
    resumed: trace and final state equal to the unsegmented run, each
    checkpoint's bytes and save and load seconds printed;
18. (phase k) scenario sweeps and protocol knobs: k1, ``run_sweep`` on
    the card and on the CPU from one seed, every series, final state and
    net field, replica key and the cluster key equal: dense n = 256
    (``benchmarks/bench_sweep.py``'s spec plus a flap window; loss
    scales, kill and flap jitter), a dense knob sweep (``ping_req_size``
    below capacity, ``relay_full_sync`` 0/1), the damp thresholds on a
    damping cluster, ``benchmarks/tune.py``'s boundary arm (n = 48, 80
    ticks, eight ``suspicion_ticks``) and a delta knob sweep at phase
    4's caps; k2, dense n = 10,000 (the bench spec, 60 ticks, R = 4,
    kill jitter 0-3, ``suspicion_ticks`` 3/5/8/12), replicas 0 and 3
    equal to their standalone ``run_scenario(replica_spec(...),
    param_knobs=...)`` runs on every series, state field and the
    checksums of every live row; k3, delta n = 65,536 (default caps,
    the same spec cut to 24 ticks, R = 2), the whole sweep, the same
    streamed in 20-tick
    segments pipelined and not (equal to it), and replica 1 against its
    standalone run; then the whole sweep again with knobs
    (``suspicion_ticks``, ``piggyback_factor``, ``ping_req_size`` below
    capacity and ``phase_mod`` 2 on replica 1), replica 1 against its
    standalone run; each arm's ms per replica-tick, host syncs per
    replica-tick and peak printed, and in each arm a checked replica may
    take no more syncs a tick (those of its own tick-loop calls plus an
    R-th of the sweep's per-call ones) than its standalone
    ``run_scenario``;
19. (phase l) the serving plane, the overload loop and the policies:
    l1, at n = 256 (dense, and delta at phase 4's caps) one 30-tick
    scenario (a gray window, a delay rule, a kill at tick 5, an overload
    window) served under a uniform (``every=2``), a zipf (16 latency
    buckets, ``lookup_n=3``) and a tenant workload, each policy at its
    default, and an admission ``run_sweep`` over ``shed_hi``/``shed_lo``:
    every series, histogram plane, state and net field (``ov_*``,
    ``po_*``) and the key equal on the card and on the CPU; so are 200
    ticks of ``sample_tick`` and the Gumbel transform on all 2^23 float32
    uniforms; l2, ``benchmarks/bench_policies.py``'s headline (n = 64,
    120 ticks, eight arms) equal on the card and the CPU, printed beside
    ``BASELINE.md:810-819``; l3, ``cascading_overload`` at BASELINE
    config 3's protocol (n = 10,000, cut from 120 ticks to 60; the
    workload cut to 2,048 keys a tick over a 16,384-key pool): a traffic-free control,
    the feedback arm, ``combined`` whole and in 40-tick segments (equal);
    l4, the same at n = 65,536 delta (60 ticks, 20-tick segments) with
    one serve's own peak; each arm's ms and host syncs a tick (a served
    run may take no more than the control), peak and scorecard; l5,
    ``parallel.sharded_serve`` over D = 4 shards equal to ``serve_once``
    at n = 10,000, with ring-hop launches.  The CPU side of l1 and l2
    runs in a child process (``--serving-cpu``) started after phase a;
20. (phase m) the gossip provenance plane and the stats bridge: m1, at
    n = 256 (dense, and delta at phase 4's caps) a 30-tick traced
    ``run_scenario`` (8 slots; reservations for the node killed at tick
    5 and for one that stays up; 5% loss; a delay rule) with a
    ``CaptureEmitter`` sink on the card and on the CPU: every ``pv_*``
    plane, ``pv_heard``, series, state and net field, the key,
    ``provenance_report()``, ``summary_block``, the spans file and the
    stat calls equal; on the card the untraced run has the same
    protocol trajectory, the run streamed in 10-tick segments the same
    result and stat calls, and killed after its first checkpoint and
    resumed the same result, and a traced ``run_sweep`` (R = 2) equals
    the CPU's; m2, ``benchmarks/bench_dissemination.py``'s rung at
    n = 10,000 dense (a kill at tick 4, suspicion 8, seed 7, 48 ticks, or
    96 if the rumor has not reached every live node), untraced and with
    4 slots; m3, the same at n = 65,536 delta (default caps) untraced and
    with 4 and 64 slots (the plane at its cap: the fold's [N, 256] x
    [N, 64] lookup is a kernel-3 launch a tick, checked); each prints
    the rumor's infected, depth, p50/p95/p99 and p99 / ceil(log2 n), and
    each arm's ms and host syncs a tick and peak; a traced arm must
    have the untraced arm's protocol series, state and key and may take
    no more host syncs a tick; m4, ``SimCluster(stats_emitter=
    CaptureEmitter())`` at config 3 (n = 10,000): a ``tick`` loop, a
    ``run_scenario`` and the same run streamed: every key in the
    bridge's tables or ``sim.*``, each increment total equal to its
    trace series, a closing checksum gauge, the streamed run's calls
    equal to the whole run's;
21. (phase n) the incident library and the ``tick-cluster`` CLI: n1,
    the 29 golden runs of ``tests/golden/incidents/`` (n = 16, seed 3,
    segments of 32, in the threefry mode they were pinned in) on the card,
    in four processes (``--incidents-card``; a served tick at n = 16 is
    host-bound), equal to the CPU's, summary for summary (the CPU side
    in a child process, ``--incidents-cpu``, started after phase a), and
    to the pinned files; n2, in three more processes, ``tick_cluster
    .main`` on ``--backend tpu-sim --incident NAME -n 64 --seed 3
    --segment-ticks 32`` for each incident on each backend it runs on,
    and cascading_overload's ``--policy combined`` A/B, each summary with
    ms (contended) and host syncs a tick and peak, printed beside
    ``BASELINE.md:767-772`` and ``:853-860`` (recorded, not asserted:
    measured in the other threefry mode); n3, in one more process with
    ``RINGPOP_LEDGER`` set, ``tick_cluster.main`` at BASELINE config 3
    (n = 10,000, 1% loss) on the script with ``--profile-dir``
    (converged at 9,999 after the kill and at 10,000 after the revive,
    one checksum group, the receiver merge and FarmHash launched, a
    non-empty trace directory, a ledger row for each tick() call,
    ``swim_step`` or ``swim_run``, cold once each), then on the script
    compiled to a scenario in three 27-tick segments (converged before
    the revive and at the end, one cold ledger row and two warm) and
    ``obs-ledger`` on the file; then cascading_overload dense and delta again in one
    process alone on the card, for their ms a tick uncontended;
22. (phase o) the trace-contract auditor: ``python -m ringpop_tpu_torch
    audit --fail-on error --json`` in a child process on the card over
    every registered entry on both backends at the fixture size (n = 64,
    4 ticks): each entry's host syncs a tick, peak and kernel launches,
    every entry's sync budget and every sharded entry's hop budget
    pinned, no error; meanwhile in this process ``run_scenario`` at
    n = 4,096 dense and delta (the byte rows), n = 10,000 dense and
    n = 65,536 delta (the sync rows and the flagship byte row), each
    with its ``tick(1)`` companion, and every planted fault of
    ``analysis/planted.py`` (``.item()`` and ``.tolist()`` in a step, a
    handoff that keeps a reference, a float64 field, a key drawn twice,
    mixed streams, an [N, N] plane in the delta step, a member gather),
    each of which must be reported at severity error; the receiver merge,
    row-searchsorted, merge-insert and ring-hop kernels must launch, and
    FarmHash's launches are printed;
23. (phase p) the host library: p1, BASELINE config 1, ``tick_cluster
    .main`` on ``--backend host-sim -n 5 --seed 7`` and the script of
    ``tests/test_cli.py`` (join, kill, revive, suspend, resume) on the
    card and on the CPU: the same lines (converged at 5, 4 and 5),
    elapsed ms aside; p2, a host ``harness.Cluster`` of 64 nodes on the
    card beside its CPU twin, through bootstrap (``bootstrap_all(run=
    False)``: the joins sent, no fixed wait), convergence, a kill of
    node 42, convergence, its revive and convergence: after every step
    the same member lists, checksums, rings, dissemination buffers,
    generator states and ``get_stats()`` (uuid ids and the pid aside),
    each step's ms on both, the card arm's ring batches, short FarmHash
    launches (one a batch, none of the warp kernel) and host syncs; p3,
    BASELINE config 2, ``membership.update()`` of the 1,332-member
    changeset on a fresh ``test_ringpop`` on the card (5 runs) and on the
    CPU (2 runs): the same members, checksums and ring entries, ops a
    second on each, two short launches a run; p4, p2's member list
    adopted by the tensor ``SimCluster(64, device="cuda")``: its
    checksums equal the host cluster's.  Throughout, a plain FarmHash
    call on CUDA rows fails the phase;
24. print the ``kernels`` JSON line (each kernel's launches summed over
    the main paths it runs on, each path counted from 0; FarmHash's two
    kernels on rows apart), then the result line.

``python3 chip_smoke.py --split-of ROOT`` runs only the checks and times
of the receiver merge and the merge-insert (phase 3's part for them) on
the ``ringpop_tpu_torch`` package under ROOT, such as a parent checkout,
and prints no result line.  ``python3 chip_smoke.py --config4-65k`` runs
only phase c to convergence (up to the bench's 800 heal ticks), then
``fold_sides``, and prints no result line.  ``python3 chip_smoke.py
--faults`` runs only phase h, ``--arms`` only phase i, ``--scenarios``
only phase j, ``--sweeps`` only phase k, ``--serving`` only phase l,
``--provenance`` only phase m, ``--incidents`` only phase n,
``--audit`` only phase o and ``--host`` only phase p; none prints a
result line.  The CPU sides of
phases k1, l, m1 and n1 run in child processes (``--sweeps-cpu``,
``--serving-cpu``, ``--provenance-cpu``, ``--incidents-cpu``), started
after phase a.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
N_MAIN = 10_000
VICTIM = 4242
N_DELTA = 65_536
VICTIM_DELTA = 54_321
DELTA_CAPS = {"capacity": 256, "wire_cap": 16, "claim_grid": 64}  # reference defaults
CHECKSUM_SAMPLE = 64  # live rows hashed at n = 65,536, spread over the ids
MAX_TICKS = 150
SHARDS = 4  # ring size of the sharded paths, all shards on the one card
LOCKSTEP = 5  # sharded == unsharded ticks on each side of the kill
SENTINEL = (1 << 31) - 1
SUSPECT = 2
SL_START = 26
RUNS = 10
L2_FLUSH_BYTES = 128 << 20  # read before each timed call: 2.5x the H100's 50 MB L2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT_OPS_PER_S = 67e12  # H100 SXM non-tensor-core 32-bit rate (fp32 table row)
CHAIN_OPS_PER_BLOCK = 7  # FarmHash32 long arm: dependent ops per 20-byte block
CHAIN_CYCLES_PER_OP = 4  # latency of a dependent integer add/shift/multiply-add


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, runs: int = RUNS) -> float:
    """Median time of one call of ``fn`` between two CUDA events over
    ``runs`` calls, after a warm-up.  The card is idle when the first
    event is recorded, so a time counts the host work before the launch
    (the Python wrapper) as well as the device time.  Before each call
    the L2 cache is flushed by reading a buffer larger than it (a read
    leaves no dirty lines to write back), so that no call finds its
    inputs there from the call before."""
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    fn()
    times = []
    for _ in range(runs):
        flush.sum()
        torch.cuda.synchronize()
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


class _NoLaunch:
    """A kernel library whose entry point ``entry`` returns 0 and launches
    nothing, so that a wrapper call times only its prefix: its host work
    and whatever it launches before that entry point."""

    def __init__(self, lib, entry: str):
        self._lib, self._entry = lib, entry

    def __getattr__(self, name: str):
        return (lambda *args: 0) if name == self._entry else getattr(self._lib, name)


def host_ms(torch, fn, runs: int = RUNS) -> float:
    """Median host time of one call of ``fn`` (the host clock around the
    call alone, the card idle before it, no synchronisation after it)."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def split_ms(torch, module, entry: str, call, launch) -> dict:
    """The wrapper ``call`` of ``module`` (which loads its library through
    ``module._kernel()`` into ``module._lib``) split in two: the prefix,
    the call with ``entry`` launching nothing, timed on the card and on
    the host alone; and ``launch(lib)`` alone, which calls ``entry`` on
    arguments made ahead of time."""
    lib = module._kernel()
    module._lib = _NoLaunch(lib, entry)
    try:
        prefix = time_ms(torch, call)
        host = host_ms(torch, call)
    finally:
        module._lib = lib
    from ringpop_tpu_torch import _build

    _build.check(launch(lib), entry)
    return {"prefix_ms": prefix, "prefix_host_ms": host,
            "launch_ms": time_ms(torch, lambda: launch(lib))}


def recv_merge_inputs(torch, dev, n: int, deliver: float, seed: int, aligned: bool = True,
                      density: float = 0.002):
    """Sender targets, delivery flags and claim rows for n senders: each
    delivering sender carries active changes (lattice keys inc * 8 +
    status) in a ``density`` share of its columns, a few at the default,
    and every other row is zero, as at phase 3 of the dense step (deliver
    ~0.99) and in a ping-req slot (~0.01).  With ``aligned=False`` the
    claims are a view that starts 4 bytes past a 16-byte boundary."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    fwd_ok = torch.rand(n, generator=gen, device=dev) < deliver
    t_safe = torch.where(fwd_ok, torch.randint(0, n, (n,), generator=gen, device=dev), 0)
    buf = torch.zeros(n * n + (0 if aligned else 1), dtype=torch.int32, device=dev)
    claims = buf[buf.numel() - n * n:].view(n, n)
    rows = fwd_ok.nonzero()[:, 0]
    for lo in range(0, rows.numel(), 1024):  # in row chunks, to bound the temporaries
        r = rows[lo:lo + 1024]
        active = torch.rand((r.numel(), n), generator=gen, device=dev) < density
        keys = (torch.randint(1, 1 << 20, (r.numel(), n), generator=gen, device=dev,
                              dtype=torch.int32) * 8
                + torch.randint(1, 5, (r.numel(), n), generator=gen, device=dev,
                                dtype=torch.int32))
        claims[r] = torch.where(active, keys, 0)
    return t_safe, fwd_ok, claims


def recv_merge_equal(torch, rm, t_safe, fwd_ok, claims, what: str) -> int:
    """The kernel against the plain version; returns the max abs error."""
    got = rm.recv_merge(t_safe, fwd_ok, claims)
    want = rm.recv_merge_plain(t_safe, fwd_ok, claims)
    torch.cuda.synchronize()
    err = max(int((got[0] - want[0]).abs().max()), int((got[1] - want[1]).abs().max()))
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"recv_merge kernel != plain at {what} (max abs err {err})")
    return err


def time_recv_merge(torch, rm, t_safe, fwd_ok, claims) -> dict:
    """One call of the wrapper, its prefix alone, the merge launch alone
    (on a receiver order made ahead of time by torch), the plain version
    and ``scatter_reduce``.  The bound reads the targets, the flags and
    each delivered claim row once and writes the output and the counts
    once; the merge does one max per delivered element."""
    n = t_safe.shape[0]
    dev = claims.device
    recv = torch.where(fwd_ok, t_safe, n)
    order = torch.argsort(recv, stable=True)
    starts = torch.searchsorted(recv[order], torch.arange(n + 1, dtype=torch.int64, device=dev))
    ahead = (order.to(torch.int32), starts.to(torch.int32), claims, torch.empty_like(claims))
    ptrs = [t.data_ptr() for t in ahead]
    stream = torch.cuda.current_stream().cuda_stream
    split = split_ms(
        torch, rm, "rp_recv_merge", lambda: rm.recv_merge(t_safe, fwd_ok, claims),
        lambda lib: lib.rp_recv_merge(*ptrs, n, stream))
    idx = recv[:, None].expand(n, n)
    zeros = torch.zeros((n + 1, n), dtype=torch.int32, device=dev)
    delivered = int(fwd_ok.sum())
    moved = 8 * n + n + 4 * delivered * n + 4 * n * n + 4 * n
    ops = delivered * n
    return {
        "ms": time_ms(torch, lambda: rm.recv_merge(t_safe, fwd_ok, claims)), **split,
        "plain_ms": time_ms(torch, lambda: rm.recv_merge_plain(t_safe, fwd_ok, claims)),
        "library_ms": time_ms(torch, lambda: zeros.scatter_reduce(
            0, idx, claims, reduce="amax", include_self=True)),
        "bound_ms": max(moved / HBM_BYTES_PER_S, ops / INT_OPS_PER_S) * 1e3,
        "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops / INT_OPS_PER_S else "operations",
        "delivered": delivered,
    }


def check_recv_merge(torch, dev) -> dict:
    from ringpop_tpu_torch.ops import recv_merge as rm

    n = N_MAIN
    err = 0
    timed = {}
    for label, deliver, seed in (("phase 3", 0.99, 0), ("ping-req", 0.01, 1)):
        args = recv_merge_inputs(torch, dev, n, deliver, seed)
        err = max(err, recv_merge_equal(torch, rm, *args, f"n={n}, {label} shape"))
        timed[label] = time_recv_merge(torch, rm, *args)
        del args
    # where the design is likely to break: every sender to one receiver
    # (one run of length n), every sender silent, claims that start off a
    # 16-byte boundary, rows that are not 16-byte aligned (n % 4 != 0),
    # tiny n, and more receivers than one pass of the counting sort holds
    one_t = torch.full((n,), 7, dtype=torch.int64, device=dev)
    one_ok = torch.ones(n, dtype=torch.bool, device=dev)
    dense = torch.randint(0, 1 << 30, (n, n), dtype=torch.int32, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(1))
    err = max(err, recv_merge_equal(torch, rm, one_t, one_ok, dense, "the all-to-one case"))
    err = max(err, recv_merge_equal(torch, rm, one_t, ~one_ok, dense, "every sender silent"))
    del dense
    edges = [(n, 0.99, False), (n + 1, 0.99, True), (n + 3, 0.5, False), (1, 1.0, True),
             (4, 1.0, True), (5, 1.0, False), (32_768, 0.01, True), (32_769, 0.01, False)]
    for m, deliver, aligned in edges:
        args = recv_merge_inputs(torch, dev, m, deliver, 3, aligned, density=0.3)
        err = max(err, recv_merge_equal(torch, rm, *args, f"n={m} (claims at byte "
                                        f"{args[2].data_ptr() % 16} of 16)"))
        del args
    for label, r in timed.items():
        log(f"recv_merge at n={n}, {label} shape ({r['delivered']} senders delivered): one call "
            f"{r['ms']:.4f} ms; prefix {r['prefix_ms']:.4f} ms (the wrapper with no merge "
            f"launch; host {r['prefix_host_ms']:.4f} ms); merge launch alone "
            f"{r['launch_ms']:.4f} ms; plain {r['plain_ms']:.4f} "
            f"ms, scatter_reduce {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    log(f"recv_merge: exact at n={n} (phase 3 and ping-req shapes), all-to-one, every sender "
        f"silent, and at (n, delivered, claims 16-byte aligned) in {edges}")
    r = timed["phase 3"]
    return {
        "name": "recv_merge", "route": "cuda",
        "source": "ringpop_tpu_torch/csrc/recv_merge.cu",
        "replaces": "ringpop_tpu/ops/recv_merge_pallas.py:70",
        "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    }


def synthetic_rows(torch, dev, rows: int, n: int = N_MAIN, absent: bool = True):
    """Checksum-format view rows of an n-node cluster: a mix of every
    status and spread incarnations, as a cluster in churn holds them
    (with ``absent=False``, every member present, as in a converged
    view)."""
    import numpy as np

    rng = np.random.default_rng(2)
    status = rng.choice([0, 1, 1, 1, 2, 3, 4] if absent else [1, 1, 1, 2, 3, 4], size=(rows, n))
    inc = rng.integers(0, 1 << 26, (rows, n))
    keys = np.where(status > 0, inc * 8 + status, 0).astype(np.int32)
    return torch.as_tensor(keys, device=dev)


def chain_estimate_ms(max_len: int) -> float:
    """The >24-byte arm is a chain of dependent 20-byte blocks per row: its
    critical path is about CHAIN_OPS_PER_BLOCK dependent integer ops of
    ~CHAIN_CYCLES_PER_OP cycles each, at the card's top SM clock."""
    return (max_len - 1) // 20 * CHAIN_OPS_PER_BLOCK * CHAIN_CYCLES_PER_OP / (
        max_sm_clock_mhz() * 1e3)


def farmhash_edge_cases(torch, dev) -> str:
    """The kernel against its plain version where the tiled design is
    likely to break: odd row strides (rows cut from [R, W + 1] buffers, so
    row starts take every byte phase), lengths at the arm, block and tile
    edges, 0, and the full width."""
    import numpy as np

    from ringpop_tpu_torch.ops.farmhash import (
        TILE_BLOCKS, farmhash32, farmhash32_batch, farmhash32_plain)

    tile = 20 * TILE_BLOCKS
    edges = [0, 1, 4, 5, 12, 13, 24, 25, 44, 45, 64, 65, tile - 1, tile, tile + 1,
             tile + 20, tile + 21, 2 * tile + 1, 4096]
    done = []
    rng = np.random.default_rng(7)
    for width in (4_097, 340_001):
        lens_np = np.array([x for x in edges if x <= width]
                           + [width - 1, width] + list(rng.integers(0, width + 1, 12)), np.int32)
        rows = lens_np.size
        longest = [int(i) for i in np.argsort(lens_np)[-2:]]
        # rows cut from a [R, W + 1] buffer (row stride W + 1) and a
        # contiguous batch (row stride W, odd): row starts take every phase
        wide = torch.as_tensor(rng.integers(0, 256, (rows, width + 1), dtype=np.uint8), device=dev)
        cut = wide[:, :width]
        odd = torch.as_tensor(rng.integers(0, 256, (rows, width), dtype=np.uint8), device=dev)
        lens = torch.as_tensor(lens_np, device=dev)
        for b in (cut, odd):
            got = farmhash32_batch(b, lens)
            if not torch.equal(got, farmhash32_plain(b, lens)):
                raise AssertionError(f"farmhash32 kernel != plain at width {width}, row stride "
                                     f"{b.stride(0)}")
            if not torch.equal(got, farmhash32_batch(b.contiguous(), lens)):
                raise AssertionError(f"farmhash32 differs between a strided and a contiguous "
                                     f"batch at width {width}")
            host = [farmhash32(b[i, : lens_np[i]].cpu().numpy().tobytes()) for i in longest]
            if host != got[longest].tolist():
                raise AssertionError(f"farmhash32 kernel != host oracle at width {width}")
            done.append(f"{rows} rows of width {width} at row stride {b.stride(0)}")
        del wide, cut, odd
    return (f"{', '.join(done)} (lengths {sorted(set(x for x in edges))}, the tile is {tile} "
            f"bytes)")


def check_farmhash(torch, dev) -> dict:
    import numpy as np

    from ringpop_tpu_torch.models.cluster import DEFAULT_BASE_INC
    from ringpop_tpu_torch.models.checksum import default_addresses
    from ringpop_tpu_torch.ops import checksum_device as ckdev
    from ringpop_tpu_torch.ops.farmhash import farmhash32, farmhash32_batch, farmhash32_plain

    # every length arm (0-4, 5-12, 13-24, > 24) on random bytes
    rng = np.random.default_rng(3)
    lens_np = np.concatenate([np.arange(0, 200), rng.integers(0, 4096, 312)]).astype(np.int32)
    bufs = torch.as_tensor(rng.integers(0, 256, (lens_np.size, 4096), dtype=np.uint8), device=dev)
    lens = torch.as_tensor(lens_np, device=dev)
    if not torch.equal(farmhash32_batch(bufs, lens), farmhash32_plain(bufs, lens)):
        raise AssertionError("farmhash32 kernel != plain on the length-arm batch")
    edges = farmhash_edge_cases(torch, dev)

    # checksum strings at the main path's chunk shape
    book = ckdev.DeviceBook(default_addresses(N_MAIN), DEFAULT_BASE_INC, device=dev)
    chunk = (64 * 1024 * 1024) // (book.n * book.entry_width)
    sbufs, slens = ckdev.row_strings(book, synthetic_rows(torch, dev, chunk))
    got = farmhash32_batch(sbufs, slens)
    # the plain version loops over the longest row's blocks in Python: it
    # is run once, and that run is its time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = farmhash32_plain(sbufs, slens)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"farmhash32 kernel != plain on checksum rows (max abs err {err})")

    ms = time_ms(torch, lambda: farmhash32_batch(sbufs, slens))
    total = int(slens.to(torch.int64).sum())
    moved = total + 4 * chunk + 4 * chunk
    ops = (total // 20) * 40  # ~40 integer ops per 20-byte block
    bound_ms = max(moved / HBM_BYTES_PER_S, ops / INT_OPS_PER_S) * 1e3
    chain_ms = chain_estimate_ms(int(slens.max()))
    log(f"farmhash32: exact on {lens_np.size} arm rows, on {edges}, and on {chunk} checksum "
        f"rows (max len {int(slens.max())}, row stride {sbufs.stride(0)}); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms (one timed run), bound {bound_ms:.4f} ms (bytes and "
        f"operations), dependency-chain estimate {chain_ms:.4f} ms (the least time that "
        f"applies)")
    del sbufs, slens, got, want

    # the delta path's checksum chunk: rows of a converged n = 65,536 view
    dbook = ckdev.DeviceBook(default_addresses(N_DELTA), DEFAULT_BASE_INC, device=dev)
    dchunk = (64 * 1024 * 1024) // (dbook.n * dbook.entry_width)
    dbufs, dlens = ckdev.row_strings(dbook, synthetic_rows(torch, dev, dchunk, N_DELTA, False))
    dgot = farmhash32_batch(dbufs, dlens)
    host = dbufs[:2].cpu().numpy()
    if [farmhash32(host[i, : int(dlens[i])].tobytes()) for i in range(2)] != dgot[:2].tolist():
        raise AssertionError("farmhash32 kernel != host oracle on the delta path's rows")
    dms = time_ms(torch, lambda: farmhash32_batch(dbufs, dlens))
    dtotal = int(dlens.to(torch.int64).sum())
    dbound = max((dtotal + 8 * dchunk) / HBM_BYTES_PER_S, dtotal // 20 * 40 / INT_OPS_PER_S) * 1e3
    log(f"farmhash32 at the delta path's chunk ({dchunk} rows of a converged n={N_DELTA} view, "
        f"max len {int(dlens.max())}; exact against the host oracle on 2 rows): kernel "
        f"{dms:.4f} ms, bound {dbound:.4f} ms (bytes and operations), dependency-chain "
        f"estimate {chain_estimate_ms(int(dlens.max())):.4f} ms")
    del dbufs, dlens
    return {
        "name": "farmhash32", "route": "cuda",
        "source": "ringpop_tpu_torch/csrc/farmhash32.cu",
        "replaces": "ringpop_tpu/ops/farmhash_pallas.py:77",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops / INT_OPS_PER_S else "operations",
        "library_ms": None,
    }


def sorted_table(torch, gen, n: int, c: int, span: int):
    """int32[n, c] rows sorted ascending with duplicates and SENTINEL
    tails of random length (a delta table's shape)."""
    dev = gen.device
    rows = torch.randint(0, span, (n, c), generator=gen, device=dev, dtype=torch.int32)
    rows = torch.sort(rows, dim=1).values
    live = torch.randint(0, c + 1, (n, 1), generator=gen, device=dev)
    cols = torch.arange(c, device=dev)[None, :]
    return torch.where(cols >= live, SENTINEL, rows).contiguous()


def queries(torch, gen, n: int, k: int, span: int):
    dev = gen.device
    q = torch.randint(-2, span + 2, (n, k), generator=gen, device=dev, dtype=torch.int32)
    pad = torch.rand((n, k), generator=gen, device=dev) < 0.1
    return torch.where(pad, SENTINEL, q).contiguous()


def time_searchsorted(torch, gen, n: int, c: int, k: int) -> dict:
    """Kernel, plain version and ``torch.searchsorted`` on sorted rows
    [n, c] and queries [n, k], the kernel first held exactly against the
    plain version on them (side "left"); the bound reads the table and
    the queries once and writes the positions once, a binary search doing
    ceil(log2(C + 1)) compares per query."""
    from ringpop_tpu_torch.ops.searchsorted import row_searchsorted, row_searchsorted_plain

    table = sorted_table(torch, gen, n, c, span=max(4, c // 2))
    q = queries(torch, gen, n, k, span=max(4, c // 2))
    moved = 4 * n * (c + 2 * k)
    ops = n * k * math.ceil(math.log2(c + 1))
    got, want = row_searchsorted(table, q), row_searchsorted_plain(table, q)
    err = int((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"row_searchsorted kernel != plain at [{n}, {c}] x [{n}, {k}] on the "
                             f"timed inputs (max abs err {err})")

    return {
        "max_abs_err": err,
        "ms": time_ms(torch, lambda: row_searchsorted(table, q)),
        "plain_ms": time_ms(torch, lambda: row_searchsorted_plain(table, q)),
        "library_ms": time_ms(torch, lambda: torch.searchsorted(table, q, out_int32=True)),
        "bound_ms": max(moved / HBM_BYTES_PER_S, ops / INT_OPS_PER_S) * 1e3,
        "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops / INT_OPS_PER_S else "operations",
        "moved": moved,
    }


def check_row_searchsorted(torch, dev) -> dict:
    from ringpop_tpu_torch.ops.searchsorted import row_searchsorted, row_searchsorted_plain

    gen = torch.Generator(device=dev).manual_seed(4)
    n, c, k = N_DELTA, DELTA_CAPS["capacity"], DELTA_CAPS["claim_grid"]
    # the main shape ([N, C] tables, claim-grid queries), a row too wide
    # for shared memory, and C queries per row (the converged check)
    shapes = [(n, c, k), (256, 20_000, 65), (n, c, c)]
    # where the design is likely to break: rows that are not 16-byte
    # aligned (C not a multiple of 4), K not a multiple of 4 or of 32, K
    # at and past the widths that share a warp between rows (8 and 16),
    # K > C, and a row count that is not a multiple of the rows per block
    # and, below C = 20000, more rows than the card holds warps at once
    edge_c, edge_k = (1, 3, 33, 64, 256, 20_000), (5, 16, 31, 33, 64, 65, 256)
    shapes += [(20_003 if ec < 20_000 else 257, ec, ek) for ec in edge_c for ek in edge_k]
    err = 0
    for rows, cols, kk in shapes:
        table = sorted_table(torch, gen, rows, cols, span=max(4, cols // 2))
        q = queries(torch, gen, rows, kk, span=max(4, cols // 2))
        for side in ("left", "right"):
            got = row_searchsorted(table, q, side=side)
            want = row_searchsorted_plain(table, q, side=side)
            err = max(err, int((got - want).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(
                    f"row_searchsorted kernel != plain at [{rows}, {cols}] x [{rows}, {kk}] "
                    f"side {side} (max abs err {err})")
    r = time_searchsorted(torch, gen, n, c, k)
    done = ", ".join(f"[{a}, {b}] x [{a}, {d}]" for a, b, d in shapes[:3])
    log(f"row_searchsorted: exact at {done}, and at [R, C] x [R, K] for C in {edge_c}, K in "
        f"{edge_k} (R = 20003, and 257 at C = 20000), both sides; at [{n}, {c}] x [{n}, {k}]: "
        f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, torch.searchsorted "
        f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (4 * N * (C + 2K) bytes = "
        f"{r['moved']} at 3.35 TB/s)")
    return {
        "name": "row_searchsorted", "route": "cuda",
        "source": "ringpop_tpu_torch/csrc/row_searchsorted.cu",
        "replaces": "ringpop_tpu/ops/searchsorted_pallas.py:39",
        "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    }


def time_searchsorted_shapes(torch, shapes: dict) -> None:
    """Kernel against ``torch.searchsorted`` at the delta main path's three
    most-launched (C, K) shapes and any shape tied with the third
    (``shapes``: launches by (C, K))."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    counts = sorted(shapes.values(), reverse=True)
    top = [(ck, v) for ck, v in sorted(shapes.items(), key=lambda kv: -kv[1])
           if v >= counts[min(2, len(counts) - 1)]]
    for (c, k), count in top:
        r = time_searchsorted(torch, gen, N_DELTA, c, k)
        log(f"row_searchsorted at [{N_DELTA}, {c}] x [{N_DELTA}, {k}] ({count} launches on the "
            f"delta main path): kernel {r['ms']:.4f} ms, torch.searchsorted "
            f"{r['library_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']}), kernel / library {r['ms'] / r['library_ms']:.3f}")


def merge_inputs(torch, gen, n: int, c: int, ki: int):
    """Sorted tables with free slots (every 7th row full) and sorted,
    SENTINEL-padded insert lists whose live subjects are absent from
    their row and fit its free slots; alive, suspect and faulty keys."""
    dev = gen.device
    span = 4 * (c + ki)
    # c + ki distinct subjects per row: the table takes the first occ,
    # the inserts the next m
    u = torch.rand((n, span), generator=gen, device=dev).argsort(dim=1)[:, : c + ki]
    u = u.to(torch.int32)
    occ = torch.randint(0, c + 1, (n, 1), generator=gen, device=dev)
    occ[::7] = c
    m = torch.clamp(torch.minimum(torch.full_like(occ, ki - 1), c - occ), min=0)
    cols = torch.arange(c, device=dev)[None, :]
    d_subj = torch.sort(torch.where(cols < occ, u[:, :c], SENTINEL), dim=1).values
    live = d_subj < SENTINEL

    def rand_keys(shape, statuses):
        st = torch.as_tensor(statuses, device=dev)
        pick = torch.randint(0, len(statuses), shape, generator=gen, device=dev)
        inc = torch.randint(1, 1 << 20, shape, generator=gen, device=dev, dtype=torch.int32)
        return inc * 8 + st[pick].to(torch.int32)

    d_key = torch.where(live, rand_keys((n, c), [1, 2, 3, 4]), 0)
    d_pb = torch.where(live, torch.randint(-1, 30, (n, c), generator=gen, device=dev,
                                           dtype=torch.int8), -1).to(torch.int8)
    d_sl = torch.where(live, torch.randint(-1, 26, (n, c), generator=gen, device=dev,
                                           dtype=torch.int8), -1).to(torch.int8)
    kcols = torch.arange(ki, device=dev)[None, :]
    ins = torch.gather(u, 1, torch.clamp(occ + kcols, max=c + ki - 1))
    ins_subj, order = torch.sort(torch.where(kcols < m, ins, SENTINEL), dim=1)
    ins_key = torch.where(ins_subj < SENTINEL, rand_keys((n, ki), [1, 2, 2, 3]), 0)
    return [t.contiguous() for t in (d_subj, d_key, d_pb, d_sl, ins_subj, ins_key)]


def time_merge_insert(torch, mi, args) -> dict:
    """One call of the wrapper, its prefix alone, the kernel launch alone
    (outputs made ahead of time) and the plain version.  The bound reads
    the four table channels (10 bytes a slot) and the insert list (8
    bytes an entry) once and writes the four channels once; a binary
    search per insert over the row and per slot over the positions."""
    n, c = args[0].shape
    ki = args[4].shape[1]
    lib = mi._kernel()
    scratch = (torch.empty((n, ki), dtype=torch.int32, device=args[0].device)
               if lib.rp_merge_insert_needs_scratch(ki) else None)
    outs = [torch.empty_like(t) for t in args[:4]]
    ptrs = [t.data_ptr() for t in (*args, *outs)] + [None if scratch is None else
                                                      scratch.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        return mi.merge_insert(*args, sl_start=SL_START, suspect=SUSPECT)

    split = split_ms(
        torch, mi, "rp_merge_insert", call,
        lambda lib: lib.rp_merge_insert(*ptrs, n, c, ki, SL_START, SUSPECT, stream))
    moved = 10 * n * c + 8 * n * ki + 10 * n * c
    ops = n * (ki * math.ceil(math.log2(c + 1)) + c * math.ceil(math.log2(ki + 1)))
    return {
        "ms": time_ms(torch, call), **split,
        "plain_ms": time_ms(torch, lambda: mi.merge_insert_plain(
            *args, sl_start=SL_START, suspect=SUSPECT)),
        "bound_ms": max(moved / HBM_BYTES_PER_S, ops / INT_OPS_PER_S) * 1e3,
        "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops / INT_OPS_PER_S else "operations",
        "moved": moved,
    }


def shifted(torch, t):
    """A copy of ``t`` whose storage starts one element past ``t``'s."""
    flat = torch.cat([t.reshape(-1)[:1], t.reshape(-1)])
    return flat[1:].view(t.shape)


def check_merge_insert(torch, dev) -> dict:
    from ringpop_tpu_torch.ops import delta_merge as mi

    gen = torch.Generator(device=dev).manual_seed(5)
    n, c = N_DELTA, DELTA_CAPS["capacity"]
    err = 0
    # the main shape (ki = claim_grid + 1) and more inserts than slots;
    # then where the design is likely to break: C = 1, ki = 1, int8 rows
    # that are not 16-byte aligned (C % 16 in {1, 15}), rows too wide to
    # stage, and an insert list too wide for shared memory
    shapes = [(n, c, DELTA_CAPS["claim_grid"] + 1), (n, c, c + 17), (4099, 1, 1), (4099, 1, 9),
              (4099, 17, 1), (4099, 17, 5), (4099, 31, 33), (4099, 33, 7), (4099, 256, 65),
              (257, 5000, 65), (65, 64, 20_000)]
    for rows, cols, ki in shapes:
        args = merge_inputs(torch, gen, rows, cols, ki)
        want = mi.merge_insert_plain(*args, sl_start=SL_START, suspect=SUSPECT)
        # below the main shapes, again with every input starting one
        # element past its aligned address
        for inputs in [args] + ([[shifted(torch, t) for t in args]] if rows < n else []):
            got = mi.merge_insert(*inputs, sl_start=SL_START, suspect=SUSPECT)
            for g, w in zip(got, want):
                err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"merge_insert kernel != plain at [{rows}, {cols}], ki = "
                                     f"{ki}, inputs at byte {inputs[2].data_ptr() % 16} of 16 "
                                     f"(max abs err {err})")
        if rows == n:
            fresh_suspects = int((got[3] == SL_START).sum())
            pads = int((args[4] == SENTINEL).sum())
            if fresh_suspects == 0 or pads == 0:
                raise AssertionError("merge_insert inputs hold no suspect or no SENTINEL inserts")
    ki = DELTA_CAPS["claim_grid"] + 1
    r = time_merge_insert(torch, mi, merge_inputs(torch, gen, n, c, ki))
    log(f"merge_insert: exact at [rows, C], ki in {shapes} (suspect and SENTINEL inserts, full "
        f"rows; below the main shapes also with every input one element off its alignment); "
        f"at [{n}, {c}], ki = {ki}: one call {r['ms']:.4f} ms; prefix {r['prefix_ms']:.4f} ms "
        f"(the wrapper with no launch; host {r['prefix_host_ms']:.4f} ms); launch alone "
        f"{r['launch_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"(20 * N * C + 8 * N * ki bytes = {r['moved']} at 3.35 TB/s); no single PyTorch call "
        f"computes this merge")
    return {
        "name": "merge_insert", "route": "cuda",
        "source": "ringpop_tpu_torch/csrc/delta_merge.cu",
        "replaces": "ringpop_tpu/ops/delta_merge_pallas.py:65",
        "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None,
    }


def check_ring_hop(torch, dev) -> dict:
    from ringpop_tpu_torch.ops.gossip_remote_copy import hop, hop_plain

    gen = torch.Generator(device=dev).manual_seed(6)

    def stack(shape, dtype):
        if dtype == torch.bool:
            return torch.rand(shape, generator=gen, device=dev) < 0.5
        return torch.randint(-(1 << 30), 1 << 30, shape, generator=gen, device=dev).to(dtype)

    dense_shape = (SHARDS, N_MAIN // SHARDS, N_MAIN)  # the dense path's view plane
    delta_shape = (SHARDS, N_DELTA // SHARDS, DELTA_CAPS["capacity"])  # a delta table
    # the three widths of the kernel: 16-byte steps (the main shapes, and
    # int64 at D = 8), 4-byte steps (a 140-byte block at D = 2, an int8
    # block of 17 000 bytes at D = 3, and a stack whose base is only
    # 4-byte aligned), byte steps (a bool block of 63 bytes)
    shaped = [(dense_shape, torch.int32), (delta_shape, torch.int32), ((4, 7, 9), torch.bool),
              ((2, 5, 7), torch.int32), ((3, 1000, 17), torch.int8), ((8, 64, 3), torch.int64)]
    err = 0
    cases = [stack(shape, dtype) for shape, dtype in shaped]
    cases.append(stack((1 + 4 * 64,), torch.int32)[1:].view(4, 64))
    for x in cases:
        got, want = hop(x), hop_plain(x)
        err = max(err, int((got.to(torch.int64) - want.to(torch.int64)).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"ring_hop kernel != plain at {x.dtype}{list(x.shape)} "
                                 f"(max abs err {err})")
    del cases
    rows = {}
    for shape in (dense_shape, delta_shape):
        x = stack(shape, torch.int32)
        block_bytes = x[0].numel() * x.element_size()
        moved = 2 * shape[0] * block_bytes  # each block read once and written once
        rows[shape] = {
            "ms": time_ms(torch, lambda: hop(x)),
            "plain_ms": time_ms(torch, lambda: hop_plain(x)),
            "library_ms": time_ms(torch, lambda: torch.roll(x, 1, dims=0)),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "moved": moved,
        }
        del x
    for shape, r in rows.items():
        log(f"ring_hop at int32{list(shape)}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, torch.roll {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"(2 * D * block_bytes = {r['moved']} at 3.35 TB/s)")
    done = ", ".join(f"{dt}{list(sh)}" for sh, dt in shaped)
    log(f"ring_hop: exact at {done} and a 4-byte-aligned int32[4, 64] view")
    r = rows[dense_shape]
    return {
        "name": "ring_hop", "route": "cuda",
        "source": "ringpop_tpu_torch/csrc/ring_hop.cu",
        "replaces": "ringpop_tpu/ops/gossip_remote_copy.py:184",
        "max_abs_err": err, "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": r["library_ms"],
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


def check_delta_cuda_equals_cpu(torch) -> None:
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.models.swim_sim import SwimParams
    from ringpop_tpu_torch.ops.delta_merge import merge_insert
    from ringpop_tpu_torch.ops.searchsorted import row_searchsorted

    # 30% loss makes enough suspicion churn for these caps to drop claims
    # at routing and inserts at full tables
    params = SwimParams(loss=0.3, suspicion_ticks=5)
    caps = {"capacity": 32, "wire_cap": 4, "claim_grid": 8}
    gpu = SimCluster(256, params, seed=0, device="cuda", backend="delta", **caps)
    cpu = SimCluster(256, params, seed=0, device="cpu", backend="delta", **caps)
    before = (row_searchsorted.launches, merge_insert.launches)
    claims_dropped = 0
    for t in range(12):
        if t == 3:
            gpu.kill(17)
            cpu.kill(17)
        mg, mc = gpu.tick(), cpu.tick()
        if mg != mc:
            raise AssertionError(f"delta tick {t}: metrics differ: cuda {mg} cpu {mc}")
        claims_dropped += mg["claims_dropped"]
        for f, a in gpu.state._asdict().items():
            b = getattr(cpu.state, f)
            if (a is None) != (b is None) or (a is not None and not torch.equal(a.cpu(), b)):
                raise AssertionError(f"delta tick {t}: {f} differs between cuda and cpu")
    drops = int(gpu.state.overflow_drops)
    if claims_dropped == 0 or drops == 0:
        raise AssertionError(f"the caps dropped nothing (claims {claims_dropped}, slots {drops})")
    log(f"delta step: cuda == cpu on every DeltaState field and metric for 12 ticks at n=256 "
        f"({caps}, 30% loss, kill at tick 3; claims_dropped {claims_dropped}, overflow_drops "
        f"{drops}); "
        f"kernel launches (row_searchsorted, merge_insert) {before} -> "
        f"{(row_searchsorted.launches, merge_insert.launches)}")


def check_delta_equals_dense(torch) -> None:
    """With ample caps the delta step is the dense step: both step on the
    card from the same keys, and the densified delta state equals the
    dense state on every tick."""
    from ringpop_tpu_torch import prng
    from ringpop_tpu_torch.models import swim_delta as sdelta
    from ringpop_tpu_torch.models import swim_sim as sim

    n = 128
    params = sim.SwimParams(loss=0.01)
    dparams = sdelta.DeltaParams(swim=params, wire_cap=n, claim_grid=3 * n * n)
    dense = sim.init_state(n, device="cuda")
    delta = sdelta.init_delta(n, capacity=n, device="cuda")
    net = sim.make_net(n, device="cuda")
    for t, key in enumerate(prng.split(prng.PRNGKey(7), 12)):
        if t == 3:
            up = net.up.clone()
            up[17] = False
            net = net._replace(up=up)
        dense, _ = sim.swim_step_impl(dense, net, key, params)
        delta, _ = sdelta.delta_step_impl(delta, net, key, dparams)
        dd = sdelta.densify(delta)
        for f in ("view_key", "pb", "suspect_left", "tick"):
            if not torch.equal(getattr(dd, f), getattr(dense, f)):
                raise AssertionError(f"tick {t}: densified delta {f} != dense {f}")
    log(f"delta step: densify(delta) == dense (view_key, pb, suspect_left) on the card for 12 "
        f"ticks at n={n} (ample caps: capacity {n}, wire_cap {n}, claim_grid {3 * n * n}; "
        f"1% loss, kill at tick 3)")


def main_path(torch) -> dict:
    """BASELINE config 3 at full size on the dense backend; returns
    launches per kernel."""
    from ringpop_tpu_torch.models import swim_sim as sim
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch
    from ringpop_tpu_torch.ops.recv_merge import recv_merge

    torch.cuda.reset_peak_memory_stats()
    recv_merge.launches = 0
    recv_merge.delivered = []
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
    delivered = torch.cat(recv_merge.delivered).tolist() if recv_merge.delivered else []
    recv_merge.delivered = None
    peak = torch.cuda.max_memory_allocated()
    log(f"main path: n={N_MAIN} loss=0.01, node {VICTIM} faulty everywhere and views "
        f"converged {detected} ticks after the kill ({len(tick_ms)} ticks); median tick "
        f"{statistics.median(tick_ms):.3f} ms; device checksums of "
        f"{len(c.live_indices())} live nodes in one group, {ck_ms:.1f} ms; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    # phase 3 delivers most senders' pings, a ping-req slot the few
    # failed pingers'
    wide = [d for d in delivered if 2 * d >= N_MAIN]
    few = [d for d in delivered if 2 * d < N_MAIN]
    log(f"main path: recv_merge launches by senders delivered: {len(wide)} with at least half "
        f"(phase 3; median {statistics.median(wide or [0])}), {len(few)} with fewer (ping-req "
        f"slots; median {statistics.median(few or [0])}, max {max(few or [0])})")
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
    return launches, detected, c


def delta_main_path(torch) -> dict:
    """The 65,536-node cluster of the BASELINE north star on config 3's
    protocol (1% loss, kill one node) with the reference's default caps;
    returns launches per kernel."""
    import numpy as np

    from ringpop_tpu_torch.models import swim_delta as sdelta
    from ringpop_tpu_torch.models import swim_sim as sim
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.ops.delta_merge import merge_insert
    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch
    from ringpop_tpu_torch.ops.searchsorted import row_searchsorted

    torch.cuda.reset_peak_memory_stats()
    row_searchsorted.launches = 0
    row_searchsorted.shapes = {}
    merge_insert.launches = 0
    farmhash32_batch.launches = 0

    n = N_DELTA
    c = SimCluster(n, sim.SwimParams(loss=0.01), seed=0, device="cuda", backend="delta",
                   **DELTA_CAPS)
    tick_ms, syncs = [], []
    totals = {"claims_dropped": 0}

    def timed_tick():
        # host syncs are counted as the warnings of the sync debug mode
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                m = c.tick()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
        totals["claims_dropped"] += m["claims_dropped"]

    for _ in range(5):
        timed_tick()
    c.kill(VICTIM_DELTA)
    victim = torch.full((n,), VICTIM_DELTA, dtype=torch.int32, device="cuda")
    detected = None
    for t in range(MAX_TICKS):
        timed_tick()
        live = torch.as_tensor(c.live_indices(), device="cuda")
        col = sdelta.view_lookup(c.state, victim).index_select(0, live) & 7
        if bool((col == sim.FAULTY).all()) and c.converged():
            detected = t + 1
            break
    if detected is None:
        raise AssertionError(f"node {VICTIM_DELTA} not faulty everywhere after {MAX_TICKS} ticks")

    # converged() is exact agreement of every live view, so all live rows
    # hash alike; a sweep of all 65,535 rows (2.2 MB strings each) is out
    # of reach, so a stated sample is hashed on the card
    live_ids = c.live_indices()
    spread = live_ids[np.linspace(0, len(live_ids) - 1, CHECKSUM_SAMPLE).astype(np.int64)]
    sample = [int(i) for i in spread] + [VICTIM_DELTA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sums = c.checksums(indices=sample, backend="device")
    torch.cuda.synchronize()
    ck_ms = (time.perf_counter() - t0) * 1e3
    live_sums = {sums[c.book.addresses[i]] for i in spread}
    if len(live_sums) != 1:
        raise AssertionError(f"{len(live_sums)} checksum groups among {len(spread)} sampled "
                             "live rows after convergence")
    launches = {"row_searchsorted": row_searchsorted.launches,
                "merge_insert": merge_insert.launches, "farmhash32": farmhash32_batch.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"delta main path: n={n} {DELTA_CAPS} loss=0.01, node {VICTIM_DELTA} faulty in every "
        f"live view and converged() {detected} ticks after the kill ({len(tick_ms)} ticks); "
        f"median tick {statistics.median(tick_ms):.3f} ms (first 5 ticks "
        f"{statistics.median(tick_ms[:5]):.3f} ms, max {max(tick_ms):.3f} ms); host syncs "
        f"{sum(syncs)} ({sum(syncs) / len(syncs):.2f} per tick); overflow_drops "
        f"{int(c.state.overflow_drops)}, claims_dropped {totals['claims_dropped']}; device "
        f"checksums of a sample of {len(spread)} live rows (spread over the ids) plus the "
        f"killed node's row, {ck_ms:.1f} ms: the sampled live rows form one group; peak "
        f"memory {peak / 2**30:.2f} GiB; launches {launches}")
    shapes = dict(row_searchsorted.shapes)
    log("delta main path: row_searchsorted launches by [C, K]: " + ", ".join(
        f"[{c_}, {k_}] {v}" for (c_, k_), v in sorted(shapes.items(), key=lambda kv: -kv[1])))
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the delta main path")

    host_rows = [int(i) for i in spread[:3]]
    host = c.checksums(indices=host_rows, backend="host")
    if host != {a: sums[a] for a in host}:
        raise AssertionError(f"delta device checksums != host on rows {host_rows}")
    log(f"delta checksums: device == host (pure Python) on live rows {host_rows}")
    return launches, detected, shapes, c


def _same_state(torch, a, b, what: str) -> None:
    """Every field of two states equal (both None, or equal tensors, on
    any devices)."""
    for f, x in a._asdict().items():
        y = getattr(b, f)
        if (x is None) != (y is None) or (x is not None and not torch.equal(x.cpu(), y.cpu())):
            raise AssertionError(f"{what}: {f} differs")


def ring_path(torch, backend: str, converge_ticks: int) -> dict:
    """The main path of ``backend`` sharded over SHARDS shards on the
    card, held tick for tick against the unsharded step around the kill,
    then alone to convergence; returns the launches per kernel of the
    phase and of its sharded-only part."""
    import numpy as np

    from ringpop_tpu_torch import parallel, prng
    from ringpop_tpu_torch.models import swim_delta as sdelta
    from ringpop_tpu_torch.models import swim_sim as sim
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.ops.delta_merge import merge_insert
    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch
    from ringpop_tpu_torch.ops.gossip_remote_copy import hop
    from ringpop_tpu_torch.ops.recv_merge import recv_merge
    from ringpop_tpu_torch.ops.searchsorted import row_searchsorted

    counted = {"ring_hop": hop, "recv_merge": recv_merge, "farmhash32": farmhash32_batch,
               "row_searchsorted": row_searchsorted, "merge_insert": merge_insert}
    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0

    delta = backend == "delta"
    n, victim = (N_DELTA, VICTIM_DELTA) if delta else (N_MAIN, VICTIM)
    params = sim.SwimParams(loss=0.01)
    kw = dict(backend="delta", **DELTA_CAPS) if delta else {}
    c = SimCluster(n, params, seed=0, device="cuda", **kw)  # carries the sharded run
    twin = SimCluster(n, params, seed=0, device="cuda", **kw)  # the unsharded step
    mesh = parallel.make_mesh(devices=[torch.device("cuda")] * SHARDS)
    if delta:
        c.state = parallel.shard_delta(c.state, mesh)
        step = parallel.sharded_delta_step(mesh)
        step_params = c.dparams
    else:
        c.state, c.net = parallel.shard_cluster(c.state, c.net, mesh)
        step = parallel.sharded_step(mesh)
        step_params = params
    tick_ms = []

    def sharded_tick() -> dict:
        # SimCluster.tick(1)'s key schedule, through the sharded step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c.key, sub = prng.split(c.key)
        c.state, metrics = step(c.state, c.net, sub, step_params)
        values = torch.stack(list(metrics.values())).tolist()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        return dict(zip(metrics.keys(), (int(v) for v in values)))

    def lockstep_tick(t: int) -> None:
        got = sharded_tick()
        want = {k: v for k, v in twin.tick().items() if k != "ticks"}
        if got != want:
            raise AssertionError(f"{backend} ring tick {t}: metrics differ: sharded {got} "
                                 f"unsharded {want}")
        _same_state(torch, c.state, twin.state, f"{backend} ring tick {t}, sharded vs unsharded")

    def victim_faulty() -> bool:
        live = torch.as_tensor(c.live_indices(), device="cuda")
        if delta:
            col = sdelta.view_lookup(c.state, torch.full((n,), victim, dtype=torch.int32,
                                                         device="cuda")).index_select(0, live)
        else:
            col = c.state.view_key[live, victim]
        return bool(((col & 7) == sim.FAULTY).all()) and c.converged()

    for t in range(LOCKSTEP):
        lockstep_tick(t)
    c.kill(victim)
    twin.kill(victim)
    phase = {name: fn.launches for name, fn in counted.items()}  # set again after the lockstep
    detected = None
    for t in range(1, MAX_TICKS + 1):
        if t <= LOCKSTEP:
            lockstep_tick(LOCKSTEP + t - 1)
            if t == LOCKSTEP:
                twin = None
                phase = {name: fn.launches for name, fn in counted.items()}
        else:
            sharded_tick()
        if victim_faulty():
            detected = t
            break
    alone = {name: fn.launches - phase[name] for name, fn in counted.items()}
    if detected != converge_ticks:
        raise AssertionError(f"{backend} ring path converged {detected} ticks after the kill, "
                             f"the unsharded path {converge_ticks}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if delta:
        live_ids = c.live_indices()
        spread = live_ids[np.linspace(0, len(live_ids) - 1, CHECKSUM_SAMPLE).astype(np.int64)]
        sums = c.checksums(indices=[int(i) for i in spread] + [victim], backend="device")
        groups = len({sums[c.book.addresses[i]] for i in spread})
        hashed = f"a sample of {len(spread)} live rows plus the killed node's"
    else:
        groups = len(c.checksum_groups(backend="device"))
        hashed = f"all {len(c.live_indices())} live rows"
    torch.cuda.synchronize()
    ck_ms = (time.perf_counter() - t0) * 1e3
    if groups != 1:
        raise AssertionError(f"{backend} ring path: {groups} checksum groups after convergence")
    launches = {name: fn.launches for name, fn in counted.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"{backend} ring path: n={n} over {SHARDS} shards on the card, sharded == unsharded on "
        f"every field and metric for {2 * LOCKSTEP} ticks ({LOCKSTEP} before and after the kill "
        f"of node {victim}); converged {detected} ticks after the kill (unsharded: "
        f"{converge_ticks}); median sharded tick {statistics.median(tick_ms):.3f} ms over "
        f"{len(tick_ms)} ticks (lockstep ticks {statistics.median(tick_ms[:2 * LOCKSTEP]):.3f} "
        f"ms, alone {statistics.median(tick_ms[2 * LOCKSTEP:] or [0.0]):.3f} ms); device "
        f"checksums of {hashed} in one group, {ck_ms:.1f} ms; peak memory {peak / 2**30:.2f} "
        f"GiB; launches in the phase {launches}, by the sharded step alone after the "
        f"lockstep {alone}")
    need = ("ring_hop", "row_searchsorted", "merge_insert") if delta else ("ring_hop",)
    for name in need:
        if alone[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the sharded {backend} step")
    if launches["farmhash32"] <= 0:
        raise AssertionError(f"{backend} ring path: the checksums launched no FarmHash kernel")
    return launches


SIDED_SMALL = {"n": 256, "caps": {"capacity": 64, "wire_cap": 8, "claim_grid": 64},
               "loss": 0.05, "suspicion_ticks": 6}
N_SIDED_RING = 1_024  # phase d: the sharded sided lockstep
CONFIG4_SMALL = 8_192  # phase b: BASELINE config 4 to completion
CONFIG4_HEAL_WINDOW = 20  # phase c: heal ticks at n = 65,536 (--config4-65k: to the end)
CONFIG4_MAX_HEAL = 800  # the bench's max_heal_ticks
CONFIG4_SUSPICION = 8


def sided_ops(n: int, split: int, heal: int) -> list:
    """``split_sides`` into halves, ``split`` one-tick ops with an
    anti-entropy rebase after every 4, the heal, ``heal`` one-tick ops
    with a rebase after every 10."""
    ops = [["split_sides", [list(range(n // 2)), list(range(n // 2, n))]]]
    for t in range(split):
        ops += [["tick"]] + ([["rebase", True]] if t % 4 == 3 else [])
    ops.append(["heal_partition"])
    for t in range(heal):
        ops += [["tick"]] + ([["rebase", True]] if t % 10 == 9 else [])
    return ops


def check_sided_cuda_equals_cpu(torch) -> None:
    """Phase a: sided mode on the card and on the CPU, every field (side
    and merge_to included) and metric equal after every op: the split,
    8 ticks with rebases, the heal, 30 ticks with rebases, then a
    cross-side join and two more ticks."""
    import numpy as np

    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.models.swim_sim import SwimParams

    cfg = SIDED_SMALL
    n = cfg["n"]
    params = SwimParams(loss=cfg["loss"], suspicion_ticks=cfg["suspicion_ticks"])
    gpu = SimCluster(n, params, seed=0, device="cuda", backend="delta", **cfg["caps"])
    cpu = SimCluster(n, params, seed=0, device="cpu", backend="delta", **cfg["caps"])
    ticks, full_syncs = 0, 0
    for i, op in enumerate(sided_ops(n, 8, 30) + [["join"], ["tick"], ["tick"]]):
        if op[0] == "join":
            side = cpu.state.side.numpy()
            seed = int(np.flatnonzero(side == 0)[0])
            joiner = int(np.flatnonzero(side == 1)[0])
            op = ["join", joiner, seed]
        if op[0] == "tick":
            mg, mc = gpu.tick(), cpu.tick()
            if mg != mc:
                raise AssertionError(f"sided tick {ticks}: metrics differ: cuda {mg} cpu {mc}")
            ticks += 1
            full_syncs += mg["full_syncs"]
        else:
            getattr(gpu, op[0])(*op[1:])
            getattr(cpu, op[0])(*op[1:])
        _same_state(torch, gpu.state, cpu.state, f"sided op {i} {op[0]}, cuda vs cpu")
    flipped = int((gpu.state.side == 2).sum())
    if full_syncs == 0 or flipped == 0 or int(gpu.state.side[joiner]) != 2:
        raise AssertionError(f"the sided run flipped nobody ({full_syncs} full syncs)")
    log(f"sided: cuda == cpu on every DeltaState field (side, merge_to, [3, {n}] bases) and "
        f"metric after every op at n={n} ({cfg['caps']}, loss {cfg['loss']}, suspicion "
        f"{cfg['suspicion_ticks']}): split, 8 ticks with anti-entropy rebases after 4 and 8, "
        f"heal, 30 ticks with a rebase every 10, the cross-side join of {joiner} (side 1) "
        f"through {seed} (side 0), 2 ticks; {full_syncs} full syncs, {flipped} viewers on the "
        f"merge row, overflow_drops {int(gpu.state.overflow_drops)}")


def _sample_rows(c, count: int = CHECKSUM_SAMPLE) -> list[int]:
    """``count`` live rows spread over the ids, plus the first live row of
    each base row in use (sided mode)."""
    import numpy as np

    live = c.live_indices()
    rows = [int(i) for i in live[np.linspace(0, len(live) - 1, count).astype(np.int64)]]
    if getattr(c.state, "side", None) is not None:
        side = c.state.side.cpu().numpy()[live]
        rows += [int(live[np.flatnonzero(side == g)[0]]) for g in np.unique(side)]
    return sorted(set(rows))


def _groups(c, sample: bool) -> int:
    """Checksum groups among all live rows, or among ``_sample_rows``."""
    if not sample:
        return len(c.checksum_groups(backend="device"))
    return len(set(c.checksums(indices=_sample_rows(c), backend="device").values()))


def config4(torch, n: int, max_heal: int) -> dict:
    """BASELINE config 4 as ``benchmarks/bench_partition_heal_delta.py``
    runs it in sided mode (its :35-85 and :187 settings: C = max(256,
    n/16), wire 64, grid 512, suspicion 8, loss 0, seed 4): two warm-up
    ticks, ``split_sides`` into halves, 12 split ticks in chunks of 5 with
    an anti-entropy rebase after each (5, 10, 12), the heal, then ticks
    in fives with a rebase every 10 until ``converged()`` or ``max_heal``
    ticks, bridging with ``join(n/2, 0)`` if two checksum groups are left
    at 8 x suspicion ticks.  Above 8,192 nodes the checksum groups are
    those of ``_sample_rows`` (a full sweep is out of reach).  Returns
    the run's numbers; every rebase's host fold and transfer are timed
    apart (their ``torch.profiler`` spans)."""
    from torch.profiler import ProfilerActivity, profile

    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.models.swim_sim import SwimParams

    torch.cuda.reset_peak_memory_stats()
    sample = n > CONFIG4_SMALL
    cap = max(256, n // 16)
    c = SimCluster(n, SwimParams(loss=0.0, suspicion_ticks=CONFIG4_SUSPICION), seed=4,
                   device="cuda", backend="delta", capacity=cap, wire_cap=64, claim_grid=512)
    out = {"n": n, "capacity": cap, "tick_ms": [], "rebases": [], "occupancy": 0}
    t_start = time.perf_counter()

    def timed(fn):
        """(fn(), its ms on the host clock, the card synchronised)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, (time.perf_counter() - t0) * 1e3

    def ticks(k: int) -> None:
        out["m"], ms = timed(lambda: c.tick(k))
        out["tick_ms"].append(ms / k)
        out["occupancy"] = max(out["occupancy"], out["m"]["max_occupancy"])

    def rebase() -> None:
        occ = int((c.state.d_subj < SENTINEL).sum(dim=1).max())
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _, ms = timed(lambda: c.rebase(anti_entropy=True))
        spans = {e.key: e.cpu_time_total / 1e3 for e in prof.key_averages()
                 if e.key.startswith("delta.rebase_")}
        out["rebases"].append({"ms": ms, "fold_ms": spans.get("delta.rebase_fold", 0.0),
                               "transfer_ms": spans.get("delta.rebase_transfer", 0.0),
                               "occupancy_before": occ})
        out["occupancy"] = max(out["occupancy"], occ)

    c.tick(2)  # the bench's warm-up
    _, out["make_sides_ms"] = timed(
        lambda: c.split_sides([list(range(n // 2)), list(range(n // 2, n))]))
    for k in (5, 5, 2):
        ticks(k)
        rebase()
    out["groups_at_heal"] = _groups(c, sample)
    c.heal_partition()
    heal, bridged, converged = 0, False, False
    while heal < max_heal:
        ticks(5)
        heal += 5
        if heal % 10 == 0:
            rebase()
        if heal % 50 == 0:
            log(f"  config 4 at n={n}: heal tick {heal}, {time.perf_counter() - t_start:.1f} s, "
                f"last tick {out['m']}")
        if c.converged():
            converged = True
            break
        if not bridged and heal >= 8 * CONFIG4_SUSPICION and _groups(c, sample) == 2:
            c.join(n // 2, 0)
            bridged = True
    out.update(heal_ticks=heal, bridged=bridged, converged=converged,
               wall_s=time.perf_counter() - t_start, groups_at_end=_groups(c, sample),
               overflow_drops=int(c.state.overflow_drops), cluster=c)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _config4_log(label: str, r: dict) -> None:
    rebases = "; ".join(
        f"{x['ms']:.1f} (fold {x['fold_ms']:.1f}, transfer {x['transfer_ms']:.1f}, occupancy "
        f"{x['occupancy_before']})" for x in r["rebases"])
    log(f"{label}: n={r['n']} C={r['capacity']} wire 64 grid 512 suspicion {CONFIG4_SUSPICION} "
        f"loss 0 seed 4; make_sides {r['make_sides_ms']:.1f} ms; groups at heal "
        f"{r['groups_at_heal']}; {r['heal_ticks']} heal ticks, converged {r['converged']}, "
        f"bridged {r['bridged']}, groups at the end {r['groups_at_end']}; tick median "
        f"{statistics.median(r['tick_ms']):.3f} ms over {len(r['tick_ms'])} chunks (max "
        f"{max(r['tick_ms']):.3f}); rebases in ms: {rebases}; largest occupancy "
        f"{r['occupancy']}; overflow_drops {r['overflow_drops']}; peak memory "
        f"{r['peak_gib']:.2f} GiB; wall {r['wall_s']:.1f} s")


def _counted():
    from ringpop_tpu_torch.ops.delta_merge import merge_insert
    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch
    from ringpop_tpu_torch.ops.gossip_remote_copy import hop
    from ringpop_tpu_torch.ops.searchsorted import row_searchsorted

    return {"farmhash32": farmhash32_batch, "row_searchsorted": row_searchsorted,
            "merge_insert": merge_insert, "ring_hop": hop}


def _reset_counts() -> None:
    for fn in _counted().values():
        fn.launches = 0
        if hasattr(fn, "shapes"):
            fn.shapes = {}
    _counted()["farmhash32"].short_launches = 0


def config4_small(torch) -> dict:
    """Phase b: BASELINE config 4 at n = 8,192 to completion: one checksum
    group over every live row, then ``fold_sides`` back to one base."""
    _reset_counts()
    r = config4(torch, CONFIG4_SMALL, CONFIG4_MAX_HEAL)
    c = r.pop("cluster")
    if not r["converged"]:
        raise AssertionError(f"config 4 at n={CONFIG4_SMALL}: not converged after "
                             f"{r['heal_ticks']} heal ticks")
    c.rebase(anti_entropy=True)
    c.fold_sides()
    groups = len(c.checksum_groups(backend="device"))
    launches = {k: fn.launches for k, fn in _counted().items()}
    _config4_log("config 4 (phase b)", r)
    log(f"config 4 (phase b): after rebase and fold_sides: side {c.state.side}, device checksums "
        f"of all {len(c.live_indices())} live rows in {groups} group(s); launches {launches}")
    if c.state.side is not None or groups != 1:
        raise AssertionError(f"config 4 at n={CONFIG4_SMALL} did not end in one group and one base")
    for name in ("farmhash32", "row_searchsorted", "merge_insert"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by config 4 at n={CONFIG4_SMALL}")
    return launches


def config4_full(torch, max_heal: int) -> tuple[dict, dict]:
    """Phase c (and ``--config4-65k``): config 4 at n = 65,536, C = 4,096.
    The digest invariant must hold at the end and kernels 3 and 4 must
    have been launched; returns (launches, row_searchsorted and
    merge_insert launches by shape)."""
    from ringpop_tpu_torch.models import swim_delta as sdelta

    _reset_counts()
    r = config4(torch, N_DELTA, max_heal)
    c = r.pop("cluster")
    counted = _counted()
    launches = {k: fn.launches for k, fn in counted.items()}
    shapes = {"row_searchsorted": dict(counted["row_searchsorted"].shapes),
              "merge_insert": dict(counted["merge_insert"].shapes)}
    if not torch.equal(c.state.digest, sdelta.compute_digest(c.state)):
        raise AssertionError("config 4 at n=65536: the rolling digest != compute_digest")
    cut = "" if max_heal >= CONFIG4_MAX_HEAL else (
        f"; depth cut to a {max_heal}-tick heal window to keep the default run short (the "
        f"bench runs up to {CONFIG4_MAX_HEAL}; --config4-65k runs them)")
    _config4_log(f"config 4 at full state (phase c{cut})", r)
    log(f"config 4 at full state: digest == compute_digest at the end; checksum groups over "
        f"{len(_sample_rows(c))} sampled live rows (64 spread over the ids, plus one on each "
        f"base row in use): {r['groups_at_heal']} at heal, {r['groups_at_end']} at the end; launches "
        f"{launches}; row_searchsorted by [C, K]: " + ", ".join(
            f"[{a}, {b}] {v}" for (a, b), v in sorted(shapes["row_searchsorted"].items(),
                                                      key=lambda kv: -kv[1]))
        + "; merge_insert by [C, ki]: " + ", ".join(
            f"[{a}, {b}] {v}" for (a, b), v in sorted(shapes["merge_insert"].items(),
                                                      key=lambda kv: -kv[1])))
    for name in ("row_searchsorted", "merge_insert"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by config 4 at n={N_DELTA}")
    if r["converged"]:
        c.rebase(anti_entropy=True)
        c.fold_sides()
        groups = _groups(c, True)
        log(f"config 4 at full state: converged after {r['heal_ticks']} heal ticks; after "
            f"rebase and fold_sides: side {c.state.side}, {groups} checksum group(s) in the "
            f"sample")
    return launches, shapes


def sided_ring_path(torch) -> dict:
    """Phase d: the sharded sided step (D = SHARDS shards on the card) in
    lockstep with the unsharded one at n = 1,024: split, 8 ticks with
    anti-entropy rebases after 4 and 8, heal, 8 ticks; every field and
    metric equal after every op, and the hop kernel launched."""
    from ringpop_tpu_torch import parallel, prng
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.models.swim_sim import SwimParams

    _reset_counts()
    cfg = SIDED_SMALL
    n = N_SIDED_RING
    params = SwimParams(loss=cfg["loss"], suspicion_ticks=cfg["suspicion_ticks"])
    c = SimCluster(n, params, seed=0, device="cuda", backend="delta", **cfg["caps"])
    twin = SimCluster(n, params, seed=0, device="cuda", backend="delta", **cfg["caps"])
    mesh = parallel.make_mesh(devices=[torch.device("cuda")] * SHARDS)
    ticks, tick_ms = 0, []
    for i, op in enumerate(sided_ops(n, 8, 8)):
        if op[0] == "tick":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step = parallel.sharded_delta_step(mesh, net_like=c.net)
            c.key, sub = prng.split(c.key)
            c.state, metrics = step(parallel.shard_delta(c.state, mesh), c.net, sub, c.dparams)
            got = dict(zip(metrics.keys(), (int(v) for v in torch.stack(
                list(metrics.values())).tolist())))
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            want = {k: v for k, v in twin.tick().items() if k != "ticks"}
            if got != want:
                raise AssertionError(f"sided ring tick {ticks}: metrics differ: sharded {got} "
                                     f"unsharded {want}")
            ticks += 1
        else:
            getattr(c, op[0])(*op[1:])
            getattr(twin, op[0])(*op[1:])
        _same_state(torch, c.state, twin.state, f"sided ring op {i} {op[0]}, sharded vs unsharded")
    launches = {k: fn.launches for k, fn in _counted().items()}
    flipped = int((c.state.side == 2).sum())
    log(f"sided ring path: n={n} over {SHARDS} shards on the card ({cfg['caps']}, loss "
        f"{cfg['loss']}), sharded == unsharded on every field and metric after every op of "
        f"the split (8 ticks, rebases after 4 and 8), heal and 8 ticks; {flipped} viewers on "
        f"the merge row; median sharded tick {statistics.median(tick_ms):.3f} ms; launches "
        f"(both steps) {launches}")
    if launches["ring_hop"] <= 0 or flipped == 0:
        raise AssertionError("the sharded sided step launched no ring hop or flipped nobody")
    return launches


def merge_path(c: int, ki: int) -> str:
    """Which path of ``csrc/delta_merge.cu`` merges rows of C slots with ki
    inserts (its ``slice_bytes`` against the 48 KB a block gets)."""
    def staged(b: int) -> int:
        return (b + 30) & ~15

    slice_bytes = 2 * staged(4 * c) + 2 * staged(c) + 2 * staged(4 * ki) + ((4 * ki + 15) & ~15)
    if 8 * slice_bytes <= 48 * 1024:
        return "rows staged in shared memory"
    where = "shared memory" if 8 * 4 * ki <= 48 * 1024 else "a global scratch row"
    return f"rows merged in place from global memory (unstaged), positions in {where}"


def time_sided_kernels(torch, shapes: dict) -> None:
    """Phase e: kernels 3 and 4 against their plain versions and timed at
    phase c's most-launched shapes (n = 65,536): one call, the wrapper's
    prefix and the launch alone, the plain version, the bound and, for
    the searchsorted, ``torch.searchsorted``."""
    from ringpop_tpu_torch.ops import delta_merge as mi
    from ringpop_tpu_torch.ops import searchsorted as ss

    gen = torch.Generator(device="cuda").manual_seed(9)
    stream = torch.cuda.current_stream().cuda_stream
    top = sorted(shapes["row_searchsorted"].items(), key=lambda kv: -kv[1])[:3]
    for (c, k), count in top:
        table = sorted_table(torch, gen, N_DELTA, c, span=max(4, c // 2))
        q = queries(torch, gen, N_DELTA, k, span=max(4, c // 2))
        if not torch.equal(ss.row_searchsorted(table, q), ss.row_searchsorted_plain(table, q)):
            raise AssertionError(f"row_searchsorted kernel != plain at [{N_DELTA}, {c}] x [{k}]")
        r = time_searchsorted(torch, gen, N_DELTA, c, k)
        out = torch.empty_like(q)
        split = split_ms(torch, ss, "rp_row_searchsorted", lambda: ss.row_searchsorted(table, q),
                         lambda lib: lib.rp_row_searchsorted(
                             table.data_ptr(), q.data_ptr(), out.data_ptr(), N_DELTA, c, k, 0,
                             stream))
        log(f"row_searchsorted at the sided shape [{N_DELTA}, {c}] x [{N_DELTA}, {k}] ({count} "
            f"launches in phase c; exact against plain): one call {r['ms']:.4f} ms; prefix "
            f"{split['prefix_ms']:.4f} ms (host {split['prefix_host_ms']:.4f}); launch alone "
            f"{split['launch_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms, torch.searchsorted "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        del table, q, out
    for (c, ki), count in sorted(shapes["merge_insert"].items(), key=lambda kv: -kv[1])[:2]:
        args = merge_inputs(torch, gen, N_DELTA, c, ki)
        got = mi.merge_insert(*args, sl_start=SL_START, suspect=SUSPECT)
        want = mi.merge_insert_plain(*args, sl_start=SL_START, suspect=SUSPECT)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"merge_insert kernel != plain at [{N_DELTA}, {c}], ki = {ki}")
        del got, want
        r = time_merge_insert(torch, mi, args)
        log(f"merge_insert at the sided shape [{N_DELTA}, {c}], ki = {ki} ({count} launches in "
            f"phase c; exact against plain; {merge_path(c, ki)}): one call {r['ms']:.4f} ms; prefix "
            f"{r['prefix_ms']:.4f} ms (host {r['prefix_host_ms']:.4f}); launch alone "
            f"{r['launch_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']}); no single PyTorch call computes this merge")
        del args


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


N_CONFIG5 = 10_000  # phase f: benchmarks/bench_ring_rebalance.py's defaults
CONFIG5_MOVES = 961  # its key moves over 5 ticks (BASELINE.md:46), exact
LOOKUP_KEYS = 16_384  # the largest rung of benchmarks/bench_lookup.py
SHORT_ROWS = (1_000_000, 6_553_600)  # replica names of config 5 and of the delta path


def _keys(count: int, seed: int) -> list[str]:
    import random

    rng = random.Random(seed)
    return [f"key-{rng.randrange(10 ** 12)}" for _ in range(count)]


def _encoded(torch, keys):
    from ringpop_tpu_torch.ops import ring_ops

    bufs, lens = ring_ops.encode_strings(keys)
    return torch.from_numpy(bufs).cuda(), torch.from_numpy(lens).cuda()


def short_edge_cases(torch, dev) -> str:
    """The short-row kernel against its plain version where a thread-a-row
    design is likely to break: every length 0-24, rows cut at an odd
    stride, and rows starting one byte past a 16-byte boundary."""
    import numpy as np

    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch, farmhash32_plain

    rng = np.random.default_rng(25)
    lens = torch.as_tensor(np.tile(np.arange(25, dtype=np.int32), 4001), device=dev)
    rows = lens.numel()
    wide = torch.as_tensor(rng.integers(0, 256, (rows, 26), dtype=np.uint8), device=dev)
    flat = torch.as_tensor(rng.integers(0, 256, rows * 25 + 1, dtype=np.uint8), device=dev)
    shifted = flat[1:].view(rows, 25)
    if shifted.data_ptr() % 16 != 1:
        raise AssertionError("the unaligned rows do not start one byte past a boundary")
    for what, b in (("row stride 26", wide[:, :25]),
                    ("row stride 25, one byte past alignment", shifted)):
        short = farmhash32_batch.short_launches
        got = farmhash32_batch(b, lens)
        if farmhash32_batch.short_launches != short + 1:
            raise AssertionError(f"farmhash32 short path not taken on {what}")
        if not torch.equal(got, farmhash32_plain(b, lens)):
            raise AssertionError(f"farmhash32 short kernel != plain on {what}")
    return f"{rows} rows of every length 0..24 at row stride 26 and one byte past alignment"


def check_farmhash_short(torch, dev) -> dict:
    """The short-row FarmHash path at the ring's shapes: the replica names
    of config 5's first ring ([1 000 000, 18], the main path's rows), the
    same names padded to the reference's 25-byte rows, and the delta
    path's global ring ([6 553 600, 17]); exact against the plain version
    (and the host oracle on a few rows), timed beside the warp kernel on
    the same rows.  Returns the kernels row of the first shape."""
    import numpy as np

    from ringpop_tpu_torch.hashring import replica_rows
    from ringpop_tpu_torch.models.checksum import default_addresses
    from ringpop_tpu_torch.ops import farmhash as fh

    edges = short_edge_cases(torch, dev)
    lib = fh._kernel()
    config5_servers = [f"10.{i // 65536 % 256}.{i // 256 % 256}.{i % 256}:3000"
                       for i in range(N_CONFIG5)]
    row = None
    for servers, pad_to in ((config5_servers, None), (config5_servers, 25),
                            (default_addresses(N_DELTA), None)):
        b_np, l_np = replica_rows(servers, 100)
        if pad_to is not None:
            b_np = np.pad(b_np, ((0, 0), (0, pad_to - b_np.shape[1])))
        bufs, lens = torch.from_numpy(b_np).to(dev), torch.from_numpy(l_np).to(dev)
        rows, width = bufs.shape
        short = fh.farmhash32_batch.short_launches
        got = fh.farmhash32_batch(bufs, lens)
        if fh.farmhash32_batch.short_launches != short + 1:
            raise AssertionError("farmhash32 short path not taken on replica names")
        want = fh.farmhash32_plain(bufs, lens)
        err = int((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"farmhash32 short kernel != plain at [{rows}, {width}]")
        picks = [0, rows // 3, rows - 1]
        if [fh.farmhash32(b_np[i, : l_np[i]].tobytes()) for i in picks] != got[picks].tolist():
            raise AssertionError("farmhash32 short kernel != host oracle")
        out64 = torch.empty(rows, dtype=torch.int64, device=dev)
        out32 = torch.empty(rows, dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        ms = time_ms(torch, lambda: fh.farmhash32_batch(bufs, lens))
        alone = time_ms(torch, lambda: lib.rp_farmhash32_short(
            bufs.data_ptr(), lens.data_ptr(), out64.data_ptr(), rows, bufs.stride(0), stream))
        warp = time_ms(torch, lambda: lib.rp_farmhash32(
            bufs.data_ptr(), lens.data_ptr(), out32.data_ptr(), rows, bufs.stride(0), stream))
        if not torch.equal(out32.to(torch.int64) & 0xFFFFFFFF, want):
            raise AssertionError("farmhash32 warp kernel != plain on replica names")
        plain_ms = time_ms(torch, lambda: fh.farmhash32_plain(bufs, lens))
        # the function's bytes: each row and its length read once, a uint32
        # hash written (the wrapper's int64 widening is the port's, not the
        # function's)
        moved = rows * (width + 4 + 4)
        ops = rows * 40  # ~40 integer ops per row of the 13-24 byte arm
        bound_ms = max(moved / HBM_BYTES_PER_S, ops / INT_OPS_PER_S) * 1e3
        log(f"farmhash32 short path at [{rows}, {width}] (replica names, lengths "
            f"{int(lens.min())}..{int(lens.max())}; exact against plain and the host oracle): "
            f"one call {ms:.4f} ms, launch alone {alone:.4f} ms; the warp kernel's launch alone "
            f"on the same rows {warp:.4f} ms; plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
            f"(bytes, {width} + 4 + 4 B a row)")
        if row is None:
            row = {"name": "farmhash32_short", "route": "cuda",
                   "source": "ringpop_tpu_torch/csrc/farmhash32.cu",
                   "replaces": "ringpop_tpu/ops/farmhash_pallas.py:77", "max_abs_err": err,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": "bytes" if moved / HBM_BYTES_PER_S >= ops / INT_OPS_PER_S
                   else "operations", "library_ms": None}
        del bufs, lens, got, want, out64, out32
    log(f"farmhash32 short path: exact on {edges}")
    return row


def config5(torch) -> tuple[int, dict]:
    """Phase f: BASELINE config 5 at full size (the settings of
    ``benchmarks/bench_ring_rebalance.py``) through the port's ``ring_rebalance.run`` on
    the card: 961 key moves, both ring builds equal and the device owners
    equal to the host ring's every tick; then lookup rates at 16 384 keys
    and the short FarmHash path at the ring's shapes.  Returns the short
    kernel's launches in that run, and its kernels row."""
    from ringpop_tpu_torch import ring_rebalance
    from ringpop_tpu_torch.ops import ring_ops
    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch
    from ringpop_tpu_torch.traffic import engine

    _reset_counts()
    t0 = time.perf_counter()
    r = ring_rebalance.run(n=N_CONFIG5, device="cuda")
    wall = time.perf_counter() - t0
    launches = farmhash32_batch.short_launches
    warp = farmhash32_batch.launches
    log(f"config 5 (phase f): n={N_CONFIG5}, churn {r['churn']} a tick, {r['ticks']} ticks, "
        f"{r['n_keys']} keys: {r['moved_total']} key moves ({r['moves']} a tick; fraction "
        f"{r['moved_fraction']}); build_ring == build_ring_on_device and lookup_keys == the "
        f"host ring on every key every tick; first host ring {r['host_build_ms']:.1f} ms; "
        f"{wall:.1f} s in all; short FarmHash launches {launches}, warp {warp}")
    for t in range(r["ticks"]):
        log(f"config 5 tick {t}: host churn {r['churn_ms'][t]:.3f} ms, host lookups "
            f"{r['lookup_ms'][t]:.3f} ms, build_ring {r['build_ms'][t]:.3f} ms, "
            f"build_ring_on_device {r['build_on_device_ms'][t]:.3f} ms, lookup_keys of "
            f"{r['n_keys']} keys {r['lookup_keys_ms'][t]:.3f} ms")
    if r["moved_total"] != CONFIG5_MOVES:
        raise AssertionError(f"config 5 moved {r['moved_total']} keys, not {CONFIG5_MOVES}")
    if launches <= 0 or warp != 0:
        raise AssertionError(f"config 5: short FarmHash launches {launches}, warp {warp}")

    ring = r["last_ring"]
    kb, kl = _encoded(torch, _keys(LOOKUP_KEYS, 16))
    khash = farmhash32_batch(kb, kl)
    mask = torch.ones((LOOKUP_KEYS, len(r["last_servers"])), dtype=torch.bool, device="cuda")
    want = ring_ops.lookup_idx(ring, khash)
    owner, found = engine.lookup_masked_idx(ring.hashes, ring.owners, khash, mask, window=256)
    if not (bool(found.all()) and torch.equal(owner, want)
            and torch.equal(ring_ops.lookup_keys(ring, kb, kl), want)):
        raise AssertionError("lookup_keys / lookup_masked_idx != lookup_idx at 16 384 keys")
    keys_ms = time_ms(torch, lambda: ring_ops.lookup_keys(ring, kb, kl))
    masked_ms = time_ms(torch, lambda: engine.lookup_masked_idx(
        ring.hashes, ring.owners, khash, mask, window=256))
    log(f"config 5 lookups at {LOOKUP_KEYS} keys on the last ring ({ring.size} replicas): "
        f"lookup_keys {keys_ms:.4f} ms ({LOOKUP_KEYS / keys_ms * 1e3:.0f} keys/s, hashing "
        f"included); lookup_masked_idx (pre-hashed, all-true [M, S] mask, window 256) "
        f"{masked_ms:.4f} ms ({LOOKUP_KEYS / masked_ms * 1e3:.0f} keys/s)")
    del r, ring, mask
    return launches, check_farmhash_short(torch, torch.device("cuda"))


def _one_short_launch(torch, label: str, what: str, fn):
    """``fn()``, which must launch the short FarmHash kernel exactly once
    and the warp kernel not at all; returns its result and its ms."""
    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch

    short, warp = farmhash32_batch.short_launches, farmhash32_batch.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = (farmhash32_batch.short_launches - short, farmhash32_batch.launches - warp)
    if got != (1, 0):
        raise AssertionError(f"{label}: {what} launched the short FarmHash kernel {got[0]} "
                             f"times and the warp kernel {got[1]} times, not once and 0")
    return out, ms


def lookup_surface(torch, c, label: str) -> int:
    """Phase g on a converged main-path cluster: ``lookup_batch`` of
    16 384 keys through viewer 0 (and, on the dense path, one other live
    viewer) must equal ``ring_for(viewer).lookup`` (the dense path) or
    ``lookup_keys`` on a ``build_ring`` of the viewer's alive and suspect
    servers (the delta path at n = 65 536, where a host ring of 6.5 M
    tuples would take tens of seconds).  ``traffic_ring()`` and each
    ``lookup_batch`` must launch the short FarmHash kernel once and the
    warp kernel never.  Returns the short kernel's launches by those
    calls alone (the checks' own hashing is not counted)."""
    import numpy as np

    from ringpop_tpu_torch.models import swim_sim as sim
    from ringpop_tpu_torch.ops import ring_ops

    keys = _keys(LOOKUP_KEYS, 17)
    if c._traffic_ring is not None:
        raise AssertionError(f"{label}: the traffic ring was built before phase g")
    ring, ring_ms = _one_short_launch(torch, label, "traffic_ring()", c.traffic_ring)
    launches = 1
    live = c.live_indices()
    viewers = [0] if c.backend == "delta" else [0, int(live[len(live) // 2])]
    done = []
    for v in viewers:
        got, batch_ms = _one_short_launch(torch, label, f"lookup_batch (viewer {v})",
                                          lambda: c.lookup_batch(keys, viewer=v))
        launches += 1
        t0 = time.perf_counter()
        if c.backend == "delta":
            status = c._view_rows(np.asarray([v]))[0] & 7
            members = np.flatnonzero((status == sim.ALIVE) | (status == sim.SUSPECT))
            servers = [c.book.addresses[i] for i in members]
            kb, kl = _encoded(torch, keys)
            idx = ring_ops.lookup_keys(ring_ops.build_ring(servers, device="cuda"), kb, kl)
            want = [servers[i] for i in idx.tolist()]
            how = f"lookup_keys on a build_ring of its {len(servers)} alive and suspect servers"
        else:
            host = c.ring_for(v)
            want = [host.lookup(k) for k in keys]
            how = f"ring_for(viewer).lookup ({host.get_server_count()} servers)"
        check_ms = (time.perf_counter() - t0) * 1e3
        bad = sum(1 for a, b in zip(got, want) if a != b)
        if bad:
            raise AssertionError(f"{label}: lookup_batch != {how} on {bad} keys (viewer {v})")
        done.append(f"viewer {v}: lookup_batch {batch_ms:.1f} ms == {how}, {check_ms:.1f} ms")
    log(f"lookup surface (phase g, {label}): traffic_ring() of {c.n} servers ({ring.size} "
        f"replica names) {ring_ms:.1f} ms; {LOOKUP_KEYS} keys, {'; '.join(done)}; short FarmHash "
        f"launches by traffic_ring() and lookup_batch {launches}, one each, warp 0")
    return launches


N_FAULTS_SMALL = 256  # phase h lockstep
FAULT_TICKS = 80  # benchmarks/bench_faults.py's scenario horizon at full size
FAULT_CAPS_SMALL = {"capacity": 32, "wire_cap": 4, "claim_grid": 8}  # phase 4's delta caps


def mixed_spec(n: int) -> dict:
    """Every fault family and a partition at once: ``MIXED`` of the
    reference's fault tests scaled from 10 nodes to ``n``, with delay 2
    and jitter 1."""
    f = n // 10
    return {"ticks": 30, "events": [
        {"at": 2, "op": "link_loss", "src": list(range(2 * f)), "dst": list(range(4 * f, 6 * f)),
         "p": 0.9, "until": 20},
        {"at": 3, "op": "gray", "nodes": list(range(2 * f, 3 * f)), "factor": 4, "until": 25},
        {"at": 4, "op": "flap", "node": 7 * f, "until": 16, "down": 2, "up": 3},
        {"at": 5, "op": "rolling_restart", "nodes": [8 * f, 9 * f], "down": 2, "every": 4},
        {"at": 6, "op": "delay", "src": list(range(3 * f, 4 * f)), "dst": list(range(6 * f, 7 * f)),
         "delay": 2, "jitter": 1, "until": 22},
        {"at": 10, "op": "partition", "groups": [list(range(n // 2)), list(range(n // 2, n))]},
        {"at": 18, "op": "heal"},
    ]}


def fam_specs(n: int, ticks: int) -> dict:
    """Three families of ``benchmarks/bench_faults.py``'s ``_fam_specs``
    (copied here: this script imports nothing of the JAX package)."""
    quarter = list(range(n // 4))
    half = list(range(n // 2, n))
    until = int(ticks * 0.7)
    return {
        "link_loss": {"ticks": ticks, "events": [
            {"at": 10, "op": "kill", "node": n - 1},
            {"at": 12, "op": "link_loss", "src": quarter, "dst": [n - 2, n - 3], "p": 0.9,
             "until": until}]},
        "gray": {"ticks": ticks, "events": [
            {"at": 8, "op": "gray", "nodes": quarter, "factor": 6, "until": until},
            {"at": 12, "op": "kill", "node": n - 1}]},
        "delay": {"ticks": ticks, "events": [
            {"at": 8, "op": "delay", "src": quarter, "dst": half, "delay": 2, "jitter": 3,
             "until": until},
            {"at": 12, "op": "kill", "node": n - 1}]},
        # the control: the gray and delay families' kill with no fault
        "kill_only": {"ticks": ticks, "events": [{"at": 12, "op": "kill", "node": n - 1}]},
    }


def _record_segments(c, sink: list) -> None:
    """Wrap ``c.tick`` so that each call (a segment of the host loop)
    appends its metrics, state and net, copied to the host, to ``sink``."""
    real = c.tick

    def host(obj):
        return {f: None if v is None else v.cpu() for f, v in obj._asdict().items()}

    def tick(k=1):
        m = real(k)
        sink.append((m, host(c.state), host(c.net)))
        return m

    c.tick = tick


def check_faults_cuda_equals_cpu(torch) -> dict:
    """Phase h, lockstep: every fault family and a partition at n = 256
    through ``run_host_loop`` on the card and on the CPU, dense and delta
    (phase 4's caps): every state field (the in-flight buffer too), net
    field and metric equal after every segment."""
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.models.swim_sim import SwimParams
    from ringpop_tpu_torch.scenarios.runner import run_host_loop
    from ringpop_tpu_torch.scenarios.spec import ScenarioSpec

    spec = ScenarioSpec.from_dict(mixed_spec(N_FAULTS_SMALL))
    params = SwimParams(loss=0.01, suspicion_ticks=8)
    out = {}
    for backend, caps in (("dense", {}), ("delta", FAULT_CAPS_SMALL)):
        runs = []
        for device in ("cpu", "cuda"):
            c = SimCluster(N_FAULTS_SMALL, params, seed=0, device=device, backend=backend, **caps)
            segs: list = []
            _record_segments(c, segs)
            run_host_loop(c, spec)
            runs.append(segs)
        want, got = runs
        if len(want) != len(got):
            raise AssertionError(
                f"faults {backend}: {len(got)} segments on cuda, {len(want)} on cpu")
        for t, ((mw, sw, nw), (mg, sg, ng)) in enumerate(zip(want, got)):
            if mw != mg:
                raise AssertionError(f"faults {backend} segment {t}: metrics cuda {mg} cpu {mw}")
            for what, a, b in (("state", sg, sw), ("net", ng, nw)):
                for f, x in a.items():
                    y = b[f]
                    if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
                        raise AssertionError(f"faults {backend} segment {t}: {what} {f} differs")
        def in_flight(st) -> bool:
            if backend == "dense":
                return bool((st["pending"] > 0).any())
            return bool((st["pend_recv"] < N_FAULTS_SMALL).any())

        pending = sum(in_flight(sg) for _, sg, _ in got)
        out[backend] = len(got)
        log(f"faults (phase h): {backend} cuda == cpu on every state field (the in-flight "
            f"buffer included), net field and metric after each of {len(got)} host-loop "
            f"segments of the mixed scenario at n={N_FAULTS_SMALL} (every family, a partition, "
            f"delay 2 jitter 1{', caps ' + str(caps) if caps else ''}); segments ending with "
            f"claims in flight {pending}")
        if pending == 0:
            raise AssertionError(f"faults {backend}: no claim was ever in flight at a boundary")
    return out


def _fault_window(spec: dict) -> tuple[int, int]:
    """The fault event's window; the control's is the gray and delay
    families' [8, 0.7 ticks), so its medians compare with theirs."""
    for e in spec["events"]:
        if e["op"] in ("link_loss", "gray", "delay"):
            return e["at"], e.get("until", spec["ticks"])
    return 8, int(spec["ticks"] * 0.7)


def fault_run(torch, backend: str, family: str, spec_dict: dict, n: int, caps: dict) -> dict:
    """One full-width fault scenario through ``run_host_loop`` on the card,
    then ticks until the killed node is faulty in every live view and the
    views agree; every step timed (host clock, synchronised), its host
    syncs counted (sync debug mode) and its metrics kept.  Returns the
    launches of the path's kernels and what it measured."""
    import numpy as np

    from ringpop_tpu_torch.models import swim_delta as sdelta
    from ringpop_tpu_torch.models import swim_sim as sim
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch
    from ringpop_tpu_torch.ops.recv_merge import recv_merge
    from ringpop_tpu_torch.scenarios.runner import run_host_loop
    from ringpop_tpu_torch.scenarios.spec import ScenarioSpec

    _reset_counts()
    recv_merge.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_run = time.perf_counter()
    spec = ScenarioSpec.from_dict(spec_dict)
    start, end = _fault_window(spec_dict)
    victim = n - 1
    kill_at = next(e["at"] for e in spec_dict["events"] if e["op"] == "kill")
    c = SimCluster(n, sim.SwimParams(loss=0.01), seed=0, device="cuda", backend=backend, **caps)
    # the dense cluster's tick hands its state over to swim_sim._swim_step_handed
    mod, name = (sdelta, "delta_step_impl") if backend == "delta" else (sim, "_swim_step_handed")
    real = getattr(mod, name)
    vcol = torch.full((n,), victim, dtype=torch.int32, device="cuda")
    steps: list[dict] = []

    def done(state, net) -> bool:
        if backend == "delta":
            own = sdelta.view_lookup(state, torch.arange(n, dtype=torch.int32, device="cuda")) & 7
            col = sdelta.view_lookup(state, vcol) & 7
            conv = sdelta._converged_impl(state, net.up, net.responsive)
        else:
            own = torch.diagonal(state.view_key) & 7
            col = state.view_key[:, victim] & 7
            conv = sim.converged_impl(state, net)
        live = net.up & net.responsive & ((own == sim.ALIVE) | (own == sim.SUSPECT))
        return bool(conv & torch.where(live, col == sim.FAULTY, True).all())

    def timed(state, net, key, params, *args, **kwargs):
        tick = int((state if backend == "delta" else state.state).tick)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                new, metrics = real(state, net, key, params, *args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        values = torch.stack(list(metrics.values())).tolist()
        steps.append({"tick": tick, "ms": ms, "m": dict(zip(metrics, values)),
                      "syncs": sum("synchroniz" in str(w.message) for w in caught),
                      "live": int((net.up & net.responsive).sum()),
                      "done": tick >= kill_at and done(new, net)})
        return new, metrics

    setattr(mod, name, timed)
    try:
        run_host_loop(c, spec)
        while not steps[-1]["done"]:
            if len(steps) >= spec.ticks + MAX_TICKS:
                raise AssertionError(f"faults {backend} {family}: node {victim} not faulty "
                                     f"everywhere {MAX_TICKS} ticks after the scenario")
            c.tick()
    finally:
        setattr(mod, name, real)
    first_done = next(s["tick"] + 1 for s in steps if s["done"])
    converged_at = next(s["tick"] + 1 for s in steps if s["done"] and s["tick"] + 1 >= end)
    if backend == "delta":
        groups = _groups(c, sample=True)
        ck = f"device checksums of {len(_sample_rows(c))} sampled live rows"
    else:
        groups = _groups(c, sample=False)
        ck = f"device checksums of all {len(c.live_indices())} live rows"
    if groups != 1:
        raise AssertionError(f"faults {backend} {family}: {groups} checksum groups")
    inside = [s["ms"] for s in steps if start <= s["tick"] < end]
    outside = [s["ms"] for s in steps if not start <= s["tick"] < end]
    total = {k: sum(s["m"].get(k, 0) for s in steps) for k in ("delayed_claims", "matured_applied",
                                                               "claims_dropped")}
    gray_min = min((s["m"]["pings_sent"] - s["live"] for s in steps if start <= s["tick"] < end),
                   default=0)
    launches = {"recv_merge": recv_merge.launches, "farmhash32": farmhash32_batch.launches,
                **{k: _counted()[k].launches for k in ("row_searchsorted", "merge_insert")}}
    peak = torch.cuda.max_memory_allocated()
    syncs = [s["syncs"] for s in steps]
    r = {"ticks_after_window": converged_at - end, "first_converged": first_done,
         "inside_ms": statistics.median(inside),
         "outside_ms": statistics.median(outside), "syncs": sum(syncs) / len(syncs),
         "peak_gib": peak / 2**30, "launches": launches, **total, "gray_min": gray_min}
    log(f"faults (phase h): {backend} n={n}{' ' + str(caps) if caps else ''} loss=0.01 "
        f"'{family}' (window [{start}, {end}), kill node {victim} at tick {kill_at}): "
        f"{len(steps)} ticks; the victim faulty in every live view and the views converged "
        f"first at tick {first_done}, and from the window's close on at tick {converged_at}, "
        f"{r['ticks_after_window']} ticks after it; {ck} in one group; median "
        f"tick {r['inside_ms']:.3f} ms inside the window ({len(inside)} ticks), "
        f"{r['outside_ms']:.3f} ms outside ({len(outside)}); host syncs {sum(syncs)} "
        f"({r['syncs']:.2f} per tick); delayed_claims {total['delayed_claims']}, "
        f"matured_applied {total['matured_applied']}, claims_dropped {total['claims_dropped']}; "
        f"fewest pings minus live nodes inside the window {gray_min}; peak memory "
        f"{r['peak_gib']:.2f} GiB; launches {launches}; {time.perf_counter() - t_run:.1f} s")
    if family == "delay" and not (total["delayed_claims"] > 0 and total["matured_applied"] > 0):
        raise AssertionError(f"faults {backend} delay: delayed {total['delayed_claims']}, "
                             f"matured {total['matured_applied']}")
    if family == "gray" and gray_min >= 0:
        raise AssertionError(f"faults {backend} gray: no tick in the window sent fewer pings "
                             "than there were live nodes")
    want = ("recv_merge",) if backend == "dense" else ("row_searchsorted", "merge_insert")
    for k in want:
        if launches[k] <= 0:
            raise AssertionError(f"faults {backend} {family}: kernel {k} was not launched")
    return r


def faults_phase(torch) -> dict:
    """Phase h: the lockstep, then the full-width families; returns the
    kernels' launches summed over the full-width runs."""
    check_faults_cuda_equals_cpu(torch)
    launches: dict[str, int] = {}
    runs = [("dense", fam, N_MAIN, {}) for fam in ("link_loss", "gray", "delay", "kill_only")]
    runs += [("delta", fam, N_DELTA, DELTA_CAPS) for fam in ("delay", "gray", "kill_only")]
    for backend, fam, n, caps in runs:
        r = fault_run(torch, backend, fam, fam_specs(n, FAULT_TICKS)[fam], n, caps)
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


# ---------------------------------------------------------------------------
# phase i: the remaining step arms (sparse dissemination, the block-prefix
# lowerings past n = 32 768, flap damping, the relay's full rows, the
# delta backend's carried slot-base planes and truncated steps)
# ---------------------------------------------------------------------------

N_ARMS_SMALL = 256
ARMS_CAP = 16  # benchmarks/profile_sparse.py:56
N_WIDE = 40_960  # 640 blocks of 64: the dense backend past 32 768
N_SPLIT = 32_767  # the largest n where both selection branches are valid
DAMP = {"damp_penalty": 1000.0, "damp_suppress": 2000.0, "damp_reuse": 400.0,
        "damp_decay_per_tick": 0.98}  # tests/test_sim_core.py:185
DAMP_CYCLES = 8
QUIET_TICKS = 250
ARMS_CAPS_SMALL = {"capacity": 32, "wire_cap": 4, "claim_grid": 8}  # phase 4's delta caps


def relay_spec(n: int) -> dict:
    """``tests/test_faults.py``'s relay case (n = 12) scaled to n: the
    last node killed at 2, 30% loss from 4, a one-way 95% link loss from
    the first quarter to three nodes at 0.8 n from 8 to 40, no loss
    from 40; 60 ticks."""
    dst = int(0.8 * n)
    return {"ticks": 60, "events": [
        {"at": 2, "op": "kill", "node": VICTIM if n == N_MAIN else n - 1},
        {"at": 4, "op": "loss", "p": 0.3},
        {"at": 8, "op": "link_loss", "src": list(range(n // 4)), "dst": [dst, dst + 1, dst + 2],
         "p": 0.95, "until": 40},
        {"at": 40, "op": "loss", "p": 0.0},
    ]}


@contextlib.contextmanager
def _carry_env():
    """``RINGPOP_CARRY_SLOTBASE=1`` while delta states are built in the
    block (the reference's build-time switch of the carried planes)."""
    old = os.environ.get("RINGPOP_CARRY_SLOTBASE")
    os.environ["RINGPOP_CARRY_SLOTBASE"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("RINGPOP_CARRY_SLOTBASE", None)
        else:
            os.environ["RINGPOP_CARRY_SLOTBASE"] = old


@contextlib.contextmanager
def _small_n(value):
    """``swim_sim._SPARSE_SMALL_N`` set to ``value`` (None: unchanged) in
    the block: 1 forces every block-prefix lowering at any n."""
    from ringpop_tpu_torch.models import swim_sim as sim

    old = sim._SPARSE_SMALL_N
    if value is not None:
        sim._SPARSE_SMALL_N = value
    try:
        yield
    finally:
        sim._SPARSE_SMALL_N = old


def _arms_lockstep(torch, label: str, kwargs: dict, ops: list, small_n=None,
                   carry: bool = False) -> int:
    """Phase i1: ``SimCluster(**kwargs)`` on the card and on the CPU
    through ``ops`` (``["tick", k]``, a method with its arguments, or
    ``["run_host_loop", spec]``): every state field and metric equal
    after every tick (each host-loop segment).  Returns the ticks held."""
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.scenarios.runner import run_host_loop
    from ringpop_tpu_torch.scenarios.spec import ScenarioSpec

    with _small_n(small_n):
        pair = []
        for device in ("cuda", "cpu"):
            if carry:
                with _carry_env():
                    c = SimCluster(N_ARMS_SMALL, device=device, **kwargs)
            else:
                c = SimCluster(N_ARMS_SMALL, device=device, **kwargs)
            segs: list = []
            _record_segments(c, segs)
            pair.append((c, segs))
        held = 0
        for i, op in enumerate(ops):
            for c, _ in pair:
                if op[0] == "run_host_loop":
                    run_host_loop(c, ScenarioSpec.from_dict(op[1]))
                elif op[0] == "tick":
                    c.tick(op[1])
                else:
                    getattr(c, op[0])(*op[1:])
            (_, got), (_, want) = pair
            if len(got) != len(want):
                raise AssertionError(f"arms {label}: {len(got)} ticks on cuda, {len(want)} on cpu")
            for t in range(held, len(got)):
                (mg, sg, _), (mw, sw, _) = got[t], want[t]
                if mg != mw:
                    raise AssertionError(f"arms {label} tick {t}: metrics cuda {mg} cpu {mw}")
                for f, x in sg.items():
                    y = sw[f]
                    if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
                        raise AssertionError(f"arms {label} tick {t}: {f} differs")
            held = len(got)
    return held


def check_arms_cuda_equals_cpu(torch) -> None:
    """Phase i1: each arm at n = 256 on the card and on the CPU."""
    from ringpop_tpu_torch import prng
    from ringpop_tpu_torch.models import swim_delta as sdelta
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.models.swim_sim import SwimParams

    n, t1 = N_ARMS_SMALL, ["tick", 1]
    cycles = [["suspend", 4], ["tick", 4], ["resume", 4], ["tick", 4]]
    every = [[True] * n]
    sparse_kill = ({"params": SwimParams(loss=0.05, suspicion_ticks=5, sparse_cap=8), "seed": 0},
                   [t1] * 3 + [["kill", 7]] + [t1] * 12)
    sparse_over = ({"params": SwimParams(sparse_cap=4), "seed": 0, "init": "self"},
                   [["join", j, 0] for j in range(1, n)] + [t1] * 20)
    cases = [
        ("sparse cap 8, 5% loss, a kill", *sparse_kill, None, False),
        ("sparse cap 4 from mode='self' with admin joins", *sparse_over, None, False),
        ("sparse cap 8 under _SPARSE_SMALL_N = 1", *sparse_kill, 1, False),
        ("sparse cap 4 self-mode under _SPARSE_SMALL_N = 1", *sparse_over, 1, False),
        ("damping, test_sim_core's parameters and flap cycle",
         {"params": SwimParams(**DAMP), "seed": 3, "damping": True}, cycles * 8, None, False),
        ("damping with the delay buffer",
         {"params": SwimParams(**DAMP), "seed": 2, "damping": True},
         [["enable_delay", 3], ["set_link_rules", every, every, [0.0], [1], [1]]] + cycles * 3,
         None, False),
        ("relay_full_sync, test_faults' relay spec scaled",
         {"params": SwimParams(suspicion_ticks=8, relay_full_sync=True), "seed": 2},
         [["run_host_loop", relay_spec(n)]], None, False),
        ("delta with carried planes at phase 4's caps",
         {"params": SwimParams(loss=0.3, suspicion_ticks=5), "seed": 0, "backend": "delta",
          **ARMS_CAPS_SMALL}, [t1] * 3 + [["kill", 17]] + [t1] * 9, None, True),
    ]
    for label, kwargs, ops, small_n, carry in cases:
        t0 = time.perf_counter()
        held = _arms_lockstep(torch, label, kwargs, ops, small_n, carry)
        log(f"arms (phase i1): {label}: cuda == cpu on every state field and metric after "
            f"each of {held} tick calls (a tick(k) or a host-loop segment is one) at n={n} "
            f"({time.perf_counter() - t0:.1f} s)")

    # delta upto = 0..6 from one state and key, on the card and the CPU
    params = sdelta.DeltaParams(swim=SwimParams(loss=0.3, suspicion_ticks=5),
                                wire_cap=ARMS_CAPS_SMALL["wire_cap"],
                                claim_grid=ARMS_CAPS_SMALL["claim_grid"])
    c = SimCluster(n, params.swim, seed=0, device="cpu", backend="delta", **ARMS_CAPS_SMALL)
    c.tick(2)
    c.kill(17)
    c.tick(3)
    key = prng.split(c.key)[1]
    for upto in range(7):
        outs = []
        for device in ("cuda", "cpu"):
            st = c.state._replace(**{f: None if v is None else v.to(device)
                                     for f, v in c.state._asdict().items()})
            net = c.net._replace(**{f: None if v is None else v.to(device)
                                    for f, v in c.net._asdict().items()})
            outs.append(sdelta.delta_step_impl(st, net, key.to(device), params, upto))
        (sg, mg), (sc, mc) = outs
        _same_state(torch, sg, sc, f"delta upto={upto}")
        if {k: v.cpu().tolist() for k, v in mg.items()} != {k: v.tolist() for k, v in mc.items()}:
            raise AssertionError(f"delta upto={upto}: metrics differ")
    log(f"arms (phase i1): delta upto = 0..6 from one state and key at n={n}: cuda == cpu on "
        "every field and the partial metrics")


def _max_active(state) -> int:
    return int((state.pb >= 0).sum(dim=1).max())


def sparse_config3(torch, dense_ticks: int) -> dict:
    """Phase i2: BASELINE config 3 on the sparse step (cap 16), in
    lockstep with the dense step on the same keys: field-equal on every
    tick on which no row holds more than the cap's active changes, to
    convergence in the dense main path's tick count, one checksum
    group."""
    from ringpop_tpu_torch.models import swim_sim as sim
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch
    from ringpop_tpu_torch.ops.recv_merge import recv_merge

    _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dense = SimCluster(N_MAIN, sim.SwimParams(loss=0.01), seed=0, device="cuda")
    sparse = SimCluster(N_MAIN, sim.SwimParams(loss=0.01, sparse_cap=ARMS_CAP), seed=0,
                        device="cuda")
    times = {"dense": [], "sparse": []}
    syncs, launches_rm = [], 0
    within, equal, diverged = 0, 0, None

    def step(name, c):
        nonlocal launches_rm
        before = recv_merge.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                m = c.tick()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        if name == "sparse":
            syncs.append(sum("synchroniz" in str(w.message) for w in caught))
            launches_rm += recv_merge.launches - before
        return m

    detected = None
    for t in range(5 + MAX_TICKS):
        if t == 5:
            dense.kill(VICTIM)
            sparse.kill(VICTIM)
        pre = max(_max_active(dense.state), _max_active(sparse.state))
        md, ms = step("dense", dense), step("sparse", sparse)
        ok = pre <= ARMS_CAP and max(_max_active(dense.state), _max_active(sparse.state)) <= ARMS_CAP
        if ok and diverged is None:
            within += 1
            same = {k: v for k, v in md.items() if k != "damped_pairs"} == {
                k: v for k, v in ms.items() if k != "damped_pairs"}
            for f in ("view_key", "pb", "suspect_left", "tick"):
                same = same and torch.equal(getattr(dense.state, f), getattr(sparse.state, f))
            if not same:
                raise AssertionError(f"sparse (phase i2): tick {t} within the cap but the sparse "
                                     "step differs from the dense one")
            equal += 1
        elif diverged is None:
            diverged = t
        if t >= 5:
            live = torch.as_tensor(sparse.live_indices(), device="cuda")
            col = sparse.state.view_key[live, VICTIM] & 7
            if bool((col == sim.FAULTY).all()) and sparse.converged():
                detected = t - 4
                break
    if detected is None:
        raise AssertionError(f"sparse (phase i2): node {VICTIM} not faulty everywhere")
    groups = _groups(sparse, sample=False)
    launches = {"recv_merge": launches_rm, "farmhash32": farmhash32_batch.launches}
    peak = torch.cuda.max_memory_allocated()
    log(f"sparse (phase i2): n={N_MAIN} loss=0.01 sparse_cap={ARMS_CAP} seed 0 in lockstep with "
        f"the dense step: {within} of {len(times['sparse'])} ticks with no row past the cap "
        f"(first past it: {diverged}), field- and metric-equal to the dense step on all {equal} "
        f"of them; node {VICTIM} faulty everywhere and views converged {detected} ticks after the "
        f"kill (dense main path {dense_ticks}); device checksums of all "
        f"{len(sparse.live_indices())} live rows: {groups} group; median tick sparse "
        f"{statistics.median(times['sparse']):.3f} ms, dense "
        f"{statistics.median(times['dense']):.3f} ms (same call); sparse host syncs "
        f"{sum(syncs)} ({sum(syncs) / len(syncs):.2f} per tick); peak memory (both clusters "
        f"resident) {peak / 2**30:.2f} GiB; launches of the sparse ticks {launches}")
    if groups != 1 or detected != dense_ticks or launches_rm <= 0 or diverged is not None:
        raise AssertionError(f"sparse (phase i2): groups {groups}, ticks {detected} (dense "
                             f"{dense_ticks}), recv_merge launches {launches_rm}, first tick "
                             f"past the cap {diverged}")
    return launches


def _peak_breakdown(snapshot: dict, top: int = 10) -> tuple[int, list]:
    """Replay the allocator trace of ``torch.cuda.memory._snapshot()``:
    the largest total of live allocations, and the live allocations at
    that moment grouped by the innermost frame in the package (bytes,
    count, site), largest first."""
    live: dict[int, tuple[int, str]] = {}
    total = best = 0
    best_live: list = []
    for ev in snapshot["device_traces"][0]:
        act = ev["action"]
        if act == "alloc":
            site = "outside the package"
            for fr in ev.get("frames", []):
                if "ringpop_tpu_torch" in fr["filename"]:
                    site = (f"{fr['filename'].split('ringpop_tpu_torch/')[-1]}:{fr['line']} "
                            f"{fr['name']}")
                    break
            live[ev["addr"]] = (ev["size"], site)
            total += ev["size"]
            if total > best:
                best, best_live = total, list(live.values())
        elif act == "free_requested" and ev["addr"] in live:
            total -= live.pop(ev["addr"])[0]
    groups: dict[str, list] = {}
    for size, site in best_live:
        g = groups.setdefault(site, [0, 0])
        g[0] += size
        g[1] += 1
    return best, sorted(((b, k, s) for s, (b, k) in groups.items()), reverse=True)[:top]


def check_selection_split(torch) -> None:
    """Phase i3, first: at n = 32 767 both selection branches are valid;
    the block-prefix branch picks what the int16-prefix branch picks."""
    from ringpop_tpu_torch import prng
    from ringpop_tpu_torch.models import swim_sim as sim

    n = N_SPLIT
    gen = torch.Generator(device="cuda").manual_seed(11)
    pingable = torch.rand((n, n), generator=gen, device="cuda") > 0.05
    pingable.fill_diagonal_(False)
    key = prng.PRNGKey(12)
    small = sim._choose_targets_and_witnesses(pingable, 3, key)
    with _small_n(1):
        large = sim._choose_targets_and_witnesses(pingable, 3, key)
    t0, v0, w0, wv0 = small
    t1, v1, w1, wv1 = large
    if not (torch.equal(v0, v1) and torch.equal(wv0, wv1) and torch.equal(t0, t1)
            and torch.equal(torch.where(wv0, w0, 0), torch.where(wv1, w1, 0))):
        raise AssertionError(f"selection at n={n}: the block-prefix branch picks differently")
    log(f"wide (phase i3): at n={n} the block-prefix selection (row-searchsorted kernel over "
        f"[{n}, {-(-n // 64)}] block offsets) picks the int16-prefix branch's target and "
        "witnesses wherever they are valid (95% pingable, key 12)")


def wide_dense(torch) -> tuple[dict, int]:
    """Phase i3: the dense backend at n = 40 960 (sparse cap 16): 5 ticks,
    kill node 4242, tick to convergence; the checksums of a sample of live
    rows in one group; kernel 3 at the block search's shape, held against
    its plain version on the kill tick's own block search and timed;
    peak memory and what holds it.  Returns the launches and kernel 3's
    max abs error there."""
    from ringpop_tpu_torch.models import swim_sim as sim
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch
    from ringpop_tpu_torch.ops.recv_merge import recv_merge
    from ringpop_tpu_torch.ops.searchsorted import row_searchsorted, row_searchsorted_plain

    check_selection_split(torch)
    n = N_WIDE
    nb = -(-n // 64)
    _reset_counts()
    rm0 = recv_merge.launches
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=1_000_000)
    captured: dict = {}

    def capture(offs, want, side="left"):
        # the kill tick's block search, kept for the check after the run
        if not captured and len(tick_ms) == 5 and tuple(offs.shape) == (n, nb):
            captured.update(offs=offs.clone(), want=want.clone(), side=side)
        return row_searchsorted(offs, want, side=side)

    sim.row_searchsorted = capture
    try:
        c = SimCluster(n, sim.SwimParams(loss=0.01, sparse_cap=ARMS_CAP), seed=0, device="cuda")
        state_bytes = sum(v.numel() * v.element_size() for v in c.state._asdict().values()
                          if v is not None)
        tick_ms, tick_peak = [], []
        detected = None
        for t in range(5 + MAX_TICKS):
            if t == 5:
                c.kill(VICTIM)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            c.tick()
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            tick_peak.append(torch.cuda.max_memory_allocated())
            if t >= 5:
                live = torch.as_tensor(c.live_indices(), device="cuda")
                col = c.state.view_key[live, VICTIM] & 7
                if bool((col == sim.FAULTY).all()) and c.converged():
                    detected = t - 4
                    break
        snap = torch.cuda.memory._snapshot()
    except torch.OutOfMemoryError:
        best, sites = _peak_breakdown(torch.cuda.memory._snapshot())
        log(f"wide (phase i3): out of memory; allocations live at the traced peak "
            f"({best / 2**30:.2f} GiB), by the innermost package frame:")
        for b, k, s in sites:
            log(f"  {b / 2**30:7.2f} GiB in {k:3d} blocks: {s}")
        raise
    finally:
        sim.row_searchsorted = row_searchsorted
        torch.cuda.memory._record_memory_history(enabled=None)
    if detected is None:
        raise AssertionError(f"wide (phase i3): node {VICTIM} not faulty everywhere")
    rows = _sample_rows(c)
    groups = len(set(c.checksums(indices=rows, backend="device").values()))
    converged = c.converged()
    peak = max(tick_peak)
    best, sites = _peak_breakdown(snap)
    blk_launches = row_searchsorted.shapes.get((nb, 4), 0)
    launches = {"recv_merge": recv_merge.launches - rm0, "farmhash32": farmhash32_batch.launches,
                "row_searchsorted": row_searchsorted.launches}
    log(f"wide (phase i3): n={n} ({nb} blocks of 64) loss=0.01 sparse_cap={ARMS_CAP} seed 0: "
        f"node {VICTIM} faulty everywhere and views converged {detected} ticks after the kill "
        f"({len(tick_ms)} ticks); converged() {converged}, device checksums of {len(rows)} "
        f"sampled live rows: {groups} group; median tick {statistics.median(tick_ms):.3f} ms "
        f"(max {max(tick_ms):.3f}); state {state_bytes / 2**30:.2f} GiB, peak "
        f"{peak / 2**30:.2f} GiB = {peak / n**2:.2f} B per n^2 (the tick of the peak: "
        f"{tick_peak.index(peak)}); row_searchsorted launches at [{n}, {nb}] x [{n}, 4]: "
        f"{blk_launches}; launches {launches}")
    log(f"wide (phase i3): allocations live at the traced peak ({best / 2**30:.2f} GiB), by the "
        "innermost package frame:")
    for b, k, s in sites:
        log(f"  {b / 2**30:7.2f} GiB in {k:3d} blocks: {s}")
    if groups != 1 or not converged or blk_launches <= 0:
        raise AssertionError(f"wide (phase i3): groups {groups}, converged {converged}, block "
                             f"searches {blk_launches}")
    offs, want, side = captured["offs"], captured["want"], captured["side"]
    got, plain = row_searchsorted(offs, want, side=side), row_searchsorted_plain(offs, want, side=side)
    err = int((got - plain).abs().max())
    if tuple(want.shape) != (n, 4) or not torch.equal(got, plain):
        raise AssertionError(f"wide (phase i3): row_searchsorted kernel != plain on the kill "
                             f"tick's block search {tuple(offs.shape)} x {tuple(want.shape)} "
                             f"side {side} (max abs err {err})")
    gen = torch.Generator(device="cuda").manual_seed(13)
    r = time_searchsorted(torch, gen, n, nb, 4)
    err = max(err, r["max_abs_err"])
    log(f"row_searchsorted at [{n}, {nb}] x [{n}, 4] (the block search): kernel == plain on the "
        f"kill tick's own offs/want (side {side}, {int((got == nb).sum())} queries past the "
        f"last block offset) and on the timed inputs, max abs err {err}; kernel "
        f"{r['ms']:.4f} ms, torch.searchsorted {r['library_ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
        f"{r['moved']} bytes at 3.35 TB/s)")
    del captured, offs, want, got, plain
    per_n2 = peak / n**2
    need = 65_536**2 * per_n2
    log(f"wide (phase i3): at this density n = 65 536 would need {need / 1e9:.1f} GB on one card "
        f"(state {65_536**2 * 6 / 1e9:.1f} GB)")
    return launches, err


def damping_config3(torch) -> dict:
    """Phase i4: flap damping at BASELINE config 3: eight suspend/resume
    cycles of node 4242 quarantine it in some viewers' rings (``ring_for``
    and ``lookup_batch`` agree key for key), 250 quiet ticks reinstate it;
    the same cycles without damping, for the tick's cost."""
    from ringpop_tpu_torch.models import swim_sim as sim
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch
    from ringpop_tpu_torch.ops.recv_merge import recv_merge

    _reset_counts()
    rm0 = recv_merge.launches
    params = sim.SwimParams(loss=0.01, **DAMP)
    times = {True: [], False: []}
    for damping in (False, True):
        c = SimCluster(N_MAIN, params, seed=0, device="cuda", damping=damping)
        for _ in range(DAMP_CYCLES):
            for flag in (False, True):
                (c.resume if flag else c.suspend)(VICTIM)
                for _ in range(4):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    c.tick()
                    torch.cuda.synchronize()
                    times[damping].append((time.perf_counter() - t0) * 1e3)
        if not damping:
            del c
    pairs = c.damped_pairs()
    live = set(int(i) for i in c.live_indices())
    damped_col = c.state.damped[:, VICTIM].cpu().numpy()
    viewers = [v for v in range(N_MAIN) if damped_col[v] and v in live and v != VICTIM]
    if pairs <= 0 or not viewers:
        raise AssertionError(f"damping (phase i4): damped pairs {pairs}, viewers {len(viewers)}")
    v = viewers[0]
    addr = c.book.addresses[VICTIM]
    ring = c.ring_for(v)
    keys = _keys(16_384, 14)
    batch = c.lookup_batch(keys, viewer=v)
    host = [ring.lookup(k) for k in keys]
    if ring.has_server(addr) or batch != host:
        raise AssertionError(f"damping (phase i4): viewer {v}'s ring holds {addr}: "
                             f"{ring.has_server(addr)}; lookup_batch == ring_for: {batch == host}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c.tick(QUIET_TICKS)
    torch.cuda.synchronize()
    quiet_s = time.perf_counter() - t0
    pairs_after = c.damped_pairs()
    back = c.ring_for(v).has_server(addr)
    launches = {"recv_merge": recv_merge.launches - rm0, "farmhash32": farmhash32_batch.launches}
    log(f"damping (phase i4): n={N_MAIN} loss=0.01 {DAMP}: after {DAMP_CYCLES} suspend/resume "
        f"cycles of node {VICTIM} (4 + 4 ticks) {pairs} damped pairs, {len(viewers)} live "
        f"viewers damp it; viewer {v}'s ring_for lacks it and lookup_batch of {len(keys)} keys "
        f"== ring_for({v}).lookup key for key; after {QUIET_TICKS} quiet ticks ({quiet_s:.1f} s) "
        f"{pairs_after} damped pairs and it is back in the ring: {back}; median tick over the "
        f"cycles {statistics.median(times[True]):.3f} ms with damping, "
        f"{statistics.median(times[False]):.3f} ms without (same call); launches {launches}")
    if pairs_after != 0 or not back:
        raise AssertionError("damping (phase i4): the quiet ticks did not reinstate the node")
    return launches


def relay_config3(torch) -> dict:
    """Phase i5: the relay's full rows at BASELINE config 3 through
    ``run_host_loop`` (``relay_spec``), flag on and off, each on to
    convergence: ``relay_full_syncs`` > 0 with it, 0 without."""
    from ringpop_tpu_torch.models import swim_sim as sim
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch
    from ringpop_tpu_torch.ops.recv_merge import recv_merge
    from ringpop_tpu_torch.scenarios.runner import run_host_loop
    from ringpop_tpu_torch.scenarios.spec import ScenarioSpec

    _reset_counts()
    rm0 = recv_merge.launches
    spec = relay_spec(N_MAIN)
    real = sim._swim_step_handed  # what the dense cluster's tick calls
    out = {}
    for flag in (True, False):
        c = SimCluster(N_MAIN, sim.SwimParams(suspicion_ticks=8, relay_full_sync=flag), seed=2,
                       device="cuda")
        steps: list = []

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new, m = real(*args, **kwargs)
            torch.cuda.synchronize()
            steps.append(((time.perf_counter() - t0) * 1e3, int(m["relay_full_syncs"])))
            return new, m

        sim._swim_step_handed = timed
        try:
            run_host_loop(c, ScenarioSpec.from_dict(spec))
            extra = 0
            while True:
                live = torch.as_tensor(c.live_indices(), device="cuda")
                col = c.state.view_key[live, VICTIM] & 7
                if bool((col == sim.FAULTY).all()) and c.converged():
                    break
                if extra >= MAX_TICKS:
                    raise AssertionError(f"relay (phase i5): flag {flag} did not converge")
                c.tick()
                extra += 1
        finally:
            sim._swim_step_handed = real
        groups = _groups(c, sample=False)
        total = sum(r for _, r in steps)
        out[flag] = (statistics.median(ms for ms, _ in steps), total, len(steps), groups)
        log(f"relay (phase i5): n={N_MAIN} relay_full_sync={flag}: test_faults' relay spec "
            f"scaled (kill {VICTIM} at 2, loss 0.3 at 4, link loss 0.95 from nodes 0-"
            f"{N_MAIN // 4 - 1} to {int(0.8 * N_MAIN)}-{int(0.8 * N_MAIN) + 2} over [8, 40), loss 0 "
            f"at 40; 60 ticks) then {extra} ticks to convergence: relay_full_syncs {total}, "
            f"median tick {out[flag][0]:.3f} ms over {len(steps)} ticks, device checksums "
            f"of all live rows in {groups} group")
        if groups != 1:
            raise AssertionError(f"relay (phase i5): {groups} checksum groups")
    if out[True][1] <= 0 or out[False][1] != 0:
        raise AssertionError(f"relay (phase i5): relay_full_syncs on {out[True][1]}, off "
                             f"{out[False][1]}")
    return {"recv_merge": recv_merge.launches - rm0, "farmhash32": farmhash32_batch.launches}


def delta_carry_north_star(torch, delta_ticks: int) -> dict:
    """Phase i6: the delta main path with the carried slot-base planes in
    lockstep with the uncarried run (every other field and metric equal
    on every tick, converging in the main path's tick count), then the
    step's prefixes ``upto`` = 0..7 timed from one state and key."""
    from ringpop_tpu_torch.models import swim_delta as sdelta
    from ringpop_tpu_torch.models import swim_sim as sim
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.ops.delta_merge import merge_insert
    from ringpop_tpu_torch.ops.searchsorted import row_searchsorted

    _reset_counts()
    n = N_DELTA
    params = sim.SwimParams(loss=0.01)
    with _carry_env():
        carried = SimCluster(n, params, seed=0, device="cuda", backend="delta", **DELTA_CAPS)
    plain = SimCluster(n, params, seed=0, device="cuda", backend="delta", **DELTA_CAPS)
    if carried.state.d_bpmask is None or plain.state.d_bpmask is not None:
        raise AssertionError("carry (phase i6): the switch did not select the planes")
    times = {"carried": [], "plain": []}
    launches = {"carried": {}, "plain": {}}
    victim = torch.full((n,), VICTIM_DELTA, dtype=torch.int32, device="cuda")
    detected, probe = None, None
    for t in range(5 + MAX_TICKS):
        if t == 5:
            carried.kill(VICTIM_DELTA)
            plain.kill(VICTIM_DELTA)
        if t == 8:
            probe = (plain.state, plain.net, plain.key)
        for name, c in (("carried", carried), ("plain", plain)):
            before = {k: _counted()[k].launches for k in ("row_searchsorted", "merge_insert")}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = c.tick()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            for k, v in before.items():
                launches[name][k] = launches[name].get(k, 0) + _counted()[k].launches - v
            if name == "carried":
                mc = m
        if mc != m:
            raise AssertionError(f"carry (phase i6) tick {t}: metrics differ")
        for f, x in plain.state._asdict().items():
            if f in ("d_bpmask", "d_bprank"):
                continue
            y = getattr(carried.state, f)
            if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
                raise AssertionError(f"carry (phase i6) tick {t}: {f} differs")
        if t >= 5:
            live = torch.as_tensor(plain.live_indices(), device="cuda")
            col = sdelta.view_lookup(carried.state, victim).index_select(0, live) & 7
            if bool((col == sim.FAULTY).all()) and carried.converged():
                detected = t - 4
                break
    bpm, bpr = sdelta.compute_slot_base(carried.state)
    planes_ok = (torch.equal(carried.state.d_bpmask, sdelta.bitpack.pack_bits(bpm))
                 and torch.equal(carried.state.d_bprank, bpr))
    log(f"carry (phase i6): n={n} {DELTA_CAPS} loss=0.01: the carried run equals the uncarried "
        f"one on every other field and metric on each of {len(times['plain'])} ticks; node "
        f"{VICTIM_DELTA} faulty everywhere and converged() {detected} ticks after the kill "
        f"(delta main path {delta_ticks}); the planes equal compute_slot_base at the end: "
        f"{planes_ok}; median tick carried {statistics.median(times['carried']):.3f} ms, "
        f"uncarried {statistics.median(times['plain']):.3f} ms (same call); launches carried "
        f"{launches['carried']}, uncarried {launches['plain']}")
    if detected != delta_ticks or not planes_ok or launches["plain"]["merge_insert"] <= 0:
        raise AssertionError(f"carry (phase i6): ticks {detected}, planes {planes_ok}, "
                             f"merge_insert {launches['plain']}")
    from ringpop_tpu_torch import prng

    state, net, key = probe
    key = prng.split(key)[1]
    dparams = plain.dparams
    prefix = {}
    for upto in range(8):
        runs = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sdelta.delta_step_impl(state, net, key, dparams, upto)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        prefix[upto] = statistics.median(runs[1:])
    log("carry (phase i6): delta step prefixes at n=65536 from the state 3 ticks after the kill, "
        "median of 5 synchronised calls (ms; upto 7 the full step): " + ", ".join(
            f"upto {u} {ms:.3f}" for u, ms in prefix.items()) + "; per phase: " + ", ".join(
            f"{u} {prefix[u] - (prefix[u - 1] if u else 0):.3f}" for u in range(8)))
    out = {}
    for name in ("carried", "plain"):
        for k, v in launches[name].items():
            out[k] = out.get(k, 0) + v
    return out


def arms_phase(torch, dense_ticks: int = 34, delta_ticks: int = 36) -> dict:
    """Phase i: i1 the lockstep at n = 256, then the full-width runs;
    returns the kernels' launches summed over i2-i6, and kernel 3's max
    abs error at i3's block search."""
    t0 = time.perf_counter()
    check_arms_cuda_equals_cpu(torch)
    log(f"arms (phase i1): {time.perf_counter() - t0:.1f} s")
    launches: dict[str, int] = {}
    errs: dict[str, int] = {}

    def wide() -> dict:
        out, errs["row_searchsorted"] = wide_dense(torch)
        return out

    for run in (lambda: sparse_config3(torch, dense_ticks), wide,
                lambda: damping_config3(torch), lambda: relay_config3(torch),
                lambda: delta_carry_north_star(torch, delta_ticks)):
        t1 = time.perf_counter()
        for k, v in run().items():
            launches[k] = launches.get(k, 0) + v
        log(f"arms: {time.perf_counter() - t1:.1f} s")
    log(f"arms (phase i): {time.perf_counter() - t0:.1f} s; launches {launches}")
    for name in ("recv_merge", "farmhash32", "row_searchsorted", "merge_insert"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"arms (phase i): kernel {name} was not launched")
    return launches, errs


# ---------------------------------------------------------------------------
# phase j: the compiled scenario runner (SimCluster.run_scenario), streamed
# soaks and v5 checkpoints
# ---------------------------------------------------------------------------

N_SCEN_SMALL = 256
SCEN_TICKS = 120  # benchmarks/bench_scenario.py's horizon
# j3's delta families cut from bench_faults.py's 80 ticks to 32 (the
# window [8, 22), the kill at 12), and j4's delta soak in segments of
# them: room for phases n and o within the script's time limit
SCEN_TICKS_DELTA = 32
SCEN_SEGMENT = 20
# the dense soak in two segments: one checkpoint mid-run (each dense
# checkpoint write takes 14-32 s on one host core), the kill and the resume
SCEN_SEGMENT_DENSE = SCEN_TICKS // 2
SCEN_SEED = 11  # benchmarks/bench_scenario.py:47


def scenario_spec(n: int, ticks: int) -> dict:
    """``benchmarks/bench_scenario.py``'s ``_spec`` (copied here: this
    script imports nothing of the JAX package): a kill, a 50/50
    partition with 5% loss, the heal and a loss ramp back to 0."""
    half = n // 2
    return {"ticks": ticks, "events": [
        {"at": ticks // 8, "op": "kill", "node": n - 1},
        {"at": ticks // 4, "op": "partition", "groups": [list(range(half)), list(range(half, n))]},
        {"at": ticks // 4, "op": "loss", "p": 0.05},
        {"at": ticks // 2, "op": "heal"},
        {"at": ticks // 2 + 5, "op": "loss_ramp", "until": ticks // 2 + 15, "to": 0.0},
    ]}


def _host_copy(c) -> dict:
    """A cluster's state, net, key and loss copied to the host."""
    def host(obj):
        return {f: None if v is None else v.cpu() for f, v in obj._asdict().items()}

    return {"state": host(c.state), "net": host(c.net), "key": c.key.clone(),
            "loss": c.params.loss}


def _same_run(torch, a: dict, b: dict, what: str, net_values: bool = False) -> None:
    """Equal host copies (``_host_copy``).  ``net_values`` compares the
    net by value where the host loop's dtypes differ (its period row is
    int32, the runner's carry int16) and skips an adjacency the host
    loop left None (fully connected, the runner's group-id zeros)."""
    import numpy as np

    for f, x in a["state"].items():
        y = b["state"][f]
        if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
            raise AssertionError(f"{what}: state {f} differs")
    for f, x in a["net"].items():
        y = b["net"][f]
        if net_values and f == "adj" and (x is None or y is None):
            continue
        if (x is None) != (y is None):
            raise AssertionError(f"{what}: net {f} present on one side only")
        if x is None:
            continue
        same = (np.array_equal(x.numpy(), y.numpy()) if net_values
                else x.dtype == y.dtype and torch.equal(x, y))
        if not same:
            raise AssertionError(f"{what}: net {f} differs")
    if not torch.equal(a["key"], b["key"]):
        raise AssertionError(f"{what}: keys differ")
    if np.float32(a["loss"]) != np.float32(b["loss"]):
        raise AssertionError(f"{what}: loss {a['loss']} != {b['loss']}")


def _same_trace(a, b, what: str) -> None:
    import numpy as np

    ta, tb = a.to_arrays(), b.to_arrays()
    if ta.keys() != tb.keys():
        raise AssertionError(f"{what}: trace series differ ({sorted(ta)} vs {sorted(tb)})")
    for k, v in ta.items():
        if v.dtype != tb[k].dtype or not np.array_equal(v, tb[k]):
            raise AssertionError(f"{what}: trace {k} differs")


def check_scenarios_cuda_equals_cpu(torch) -> None:
    """Phase j1: ``run_scenario`` on the card and on the CPU at n = 256,
    dense on ``mixed_spec`` (every family, in-scan revives) and delta on
    the delay family: equal traces, states, nets and keys."""
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.models.swim_sim import SwimParams

    params = SwimParams(loss=0.01, suspicion_ticks=8)
    for backend, spec, caps in (
            ("dense", mixed_spec(N_SCEN_SMALL), {}),
            ("delta", fam_specs(N_SCEN_SMALL, 40)["delay"], FAULT_CAPS_SMALL)):
        runs = []
        for device in ("cpu", "cuda"):
            c = SimCluster(N_SCEN_SMALL, params, seed=0, device=device, backend=backend, **caps)
            runs.append((c.run_scenario(spec), _host_copy(c)))
        (tw, hw), (tg, hg) = runs
        _same_trace(tg, tw, f"scenarios (phase j1) {backend}")
        _same_run(torch, hg, hw, f"scenarios (phase j1) {backend}")
        log(f"scenarios (phase j1): {backend} run_scenario cuda == cpu at n={N_SCEN_SMALL} "
            f"({spec['ticks']} ticks{', caps ' + str(caps) if caps else ''}): every trace "
            f"series, state field, net field and the key; live {tg.live[0]} -> "
            f"{min(tg.live)} -> {tg.live[-1]}, converged at the end {bool(tg.converged[-1])}")


def _kernel_counts() -> dict:
    from ringpop_tpu_torch.ops.recv_merge import recv_merge

    return {"recv_merge": recv_merge.launches,
            **{k: _counted()[k].launches for k in ("farmhash32", "row_searchsorted",
                                                  "merge_insert")}}


@contextlib.contextmanager
def _syncs(torch, sink: dict):
    """Count the host syncs of the block (``set_sync_debug_mode``) into
    ``sink["syncs"]``, those inside the runner's revives apart into
    ``sink["revive_syncs"]``; yields the warnings caught so far."""
    from ringpop_tpu_torch.scenarios import runner

    real = runner._apply_revives
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def revives(*args, **kwargs):
            before = len(caught)
            try:
                return real(*args, **kwargs)
            finally:
                sink["revive_syncs"] = sink.get("revive_syncs", 0) + sum(
                    "synchroniz" in str(w.message) for w in caught[before:])
                sink["revive_ticks"] = sink.get("revive_ticks", 0) + 1

        runner._apply_revives = revives
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            torch.cuda.set_sync_debug_mode("default")
            runner._apply_revives = real
    sink["syncs"] = sum("synchroniz" in str(w.message) for w in caught)


def _scenario_arm(torch, arm: str, make, spec: dict) -> tuple:
    """One arm of phase j2/j3 from a fresh cluster (made inside the
    measured window): ``run_scenario``, ``run_host_loop``, or the host
    loop with every ``tick(k)`` run as k ``tick(1)`` calls.  Returns
    (cluster, trace or None, what it measured)."""
    from ringpop_tpu_torch.scenarios.runner import run_host_loop
    from ringpop_tpu_torch.scenarios.spec import ScenarioSpec

    _reset_counts()
    _counted_recv_merge_reset()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sink: dict = {}
    t0 = time.perf_counter()
    c = make()
    trace = None
    with _syncs(torch, sink) as caught:
        if arm == "run_scenario":
            trace = c.run_scenario(spec)
        else:
            if arm == "tick(1)":
                real = c.tick

                def ticks(k=1):
                    for _ in range(k):
                        before = len(caught)
                        m = real(1)
                        sink["tick_syncs"] = sink.get("tick_syncs", 0) + sum(
                            "synchroniz" in str(w.message) for w in caught[before:])
                    return m

                c.tick = ticks
            run_host_loop(c, ScenarioSpec.from_dict(spec))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ticks_n = spec["ticks"]
    # per tick: run_scenario's syncs outside its revives (its per-call
    # ones included), the host loop's all, the tick(1) loop's inside its
    # tick() calls
    per_tick = sink.get("tick_syncs", sink["syncs"] - sink.get("revive_syncs", 0))
    r = {"ms_per_tick": wall * 1e3 / ticks_n, "syncs": sink["syncs"],
         "revive_syncs": sink.get("revive_syncs", 0),
         "syncs_per_tick": per_tick / ticks_n,
         "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
         "launches": _kernel_counts()}
    return c, trace, r


def _counted_recv_merge_reset() -> None:
    from ringpop_tpu_torch.ops.recv_merge import recv_merge

    recv_merge.launches = 0


def scenario_compare(torch, label: str, make, spec: dict, sample: bool) -> tuple:
    """Phase j2/j3 for one spec: ``run_scenario`` against ``run_host_loop``
    from two clusters of one seed (states, nets, keys, loss and checksum
    groups equal), and a ``tick(1)`` loop over the same ticks; each
    arm's ms per tick, host syncs per tick and peak.  Returns the
    run's host copy, its trace and the launches of ``run_scenario``."""
    import numpy as np

    t_all = time.perf_counter()
    a, trace, ra = _scenario_arm(torch, "run_scenario", make, spec)
    got = _host_copy(a)
    b, _, rb = _scenario_arm(torch, "host loop", make, spec)
    _same_run(torch, got, _host_copy(b), f"scenarios {label}: run_scenario vs host loop",
              net_values=True)
    _reset_counts()
    rows = _sample_rows(a) if sample else a.live_indices().tolist()
    ca = a.checksums(indices=rows, backend="device")
    cb = b.checksums(indices=rows, backend="device")
    if ca != cb:
        raise AssertionError(f"scenarios {label}: checksums differ between the two runs")
    ck_launches = _counted()["farmhash32"].launches
    del a, b
    _, _, rc = _scenario_arm(torch, "tick(1)", make, spec)
    groups = len(set(ca.values()))
    revive = (f"; revives {ra['revive_syncs']} syncs over the revive ticks"
              if ra["revive_syncs"] else "")
    for arm, r in (("run_scenario", ra), ("host loop", rb), ("tick(1) loop", rc)):
        log(f"scenarios {label} {arm}: {r['ms_per_tick']:.3f} ms per tick over {spec['ticks']} "
            f"ticks, host syncs {r['syncs']} ({r['syncs_per_tick']:.2f} per tick: run_scenario's "
            f"outside revives, the tick(1) loop's inside tick()), "
            f"peak {r['peak_gib']:.2f} GiB over the start, launches {r['launches']}")
    log(f"scenarios {label}: run_scenario == host loop on every state field, net value, the "
        f"key and the loss; checksums of {len(rows)} live rows equal, {groups} group(s) "
        f"(FarmHash launches {ck_launches}); live {trace.live[0]} -> {int(np.min(trace.live))} "
        f"-> {trace.live[-1]}, converged ticks {int(trace.converged.sum())}, first "
        f"{trace.first_converged_tick()}{revive}; {time.perf_counter() - t_all:.1f} s")
    if "dense" in label and ra["peak_gib"] > 1.1 * rb["peak_gib"]:
        raise AssertionError(f"scenarios {label}: run_scenario's peak {ra['peak_gib']:.2f} GiB is "
                             f"more than 10% above the host loop's {rb['peak_gib']:.2f}")
    if ra["syncs_per_tick"] > rc["syncs_per_tick"]:
        raise AssertionError(f"scenarios {label}: run_scenario takes {ra['syncs_per_tick']:.2f} "
                             f"host syncs a tick outside revives, tick(1) {rc['syncs_per_tick']:.2f}")
    launches = dict(ra["launches"])
    launches["farmhash32"] += ck_launches
    return got, trace, launches, (ra, rb, rc)


def streamed_soak(torch, label: str, make, spec: dict, want: dict, want_trace,
                  segment: int) -> dict:
    """Phase j4: the spec streamed in ``segment``-tick segments with a
    checkpoint under the git-ignored build directory, killed after the
    first checkpoint (``interrupt_after=1``) and resumed; the trace and
    final state must equal the unsegmented run's.  Times each checkpoint
    save and the load."""
    import shutil

    from ringpop_tpu_torch import checkpoint
    from ringpop_tpu_torch.scenarios import stream

    d = os.path.join(REPO, "ringpop_tpu_torch", "_build", "phase_j")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    path = os.path.join(d, f"{label}.npz")
    saves, loads = [], []
    real_save, real_load = checkpoint.save, checkpoint.load

    def save(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_save(*args, **kwargs)
        saves.append((time.perf_counter() - t0, os.path.getsize(path)))

    def load(*args, **kwargs):
        t0 = time.perf_counter()
        out = real_load(*args, **kwargs)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t0)
        return out

    _reset_counts()
    _counted_recv_merge_reset()
    t0 = time.perf_counter()
    checkpoint.save, checkpoint.load = save, load
    try:
        c = make()
        try:
            stream.run_streamed(c, spec, segment_ticks=segment, checkpoint_path=path,
                                interrupt_after=1)
            raise AssertionError(f"scenarios {label}: the soak was not interrupted")
        except stream.StreamInterrupted:
            pass
        del c
        c, trace = stream.resume(path)
    finally:
        checkpoint.save, checkpoint.load = real_save, real_load
    wall = time.perf_counter() - t0
    _same_trace(trace, want_trace, f"scenarios (phase j4) {label}")
    _same_run(torch, _host_copy(c), want, f"scenarios (phase j4) {label}")
    launches = _kernel_counts()
    log(f"scenarios (phase j4): {label} streamed ({segment}-tick segments), killed after "
        f"the first checkpoint and resumed: trace, state, net and key equal to the unsegmented "
        f"run; checkpoint saves (s, bytes) {[(round(t, 3), b) for t, b in saves]}, load "
        f"{[round(t, 3) for t in loads]} s; {wall:.1f} s; launches {launches}")
    del c
    shutil.rmtree(d, ignore_errors=True)
    return launches


def scenarios_phase(torch) -> dict:
    """Phase j: j1 the n = 256 lockstep, j2 dense at n = 10 000, j3 delta
    at n = 65 536, j4 the streamed soaks; returns the kernels' launches
    summed over j2-j4."""
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.models.swim_sim import SwimParams

    t0 = time.perf_counter()
    check_scenarios_cuda_equals_cpu(torch)
    launches: dict[str, int] = {}

    def add(more: dict) -> None:
        for k, v in more.items():
            launches[k] = launches.get(k, 0) + v

    def dense():
        return SimCluster(N_MAIN, SwimParams(), seed=SCEN_SEED, device="cuda")

    def delta():
        return SimCluster(N_DELTA, SwimParams(loss=0.01), seed=0, device="cuda",
                          backend="delta", **DELTA_CAPS)

    soaks = []
    for label, make, spec, sample in (
            (f"(phase j2) dense n={N_MAIN} bench_scenario", dense,
             scenario_spec(N_MAIN, SCEN_TICKS), False),
            (f"(phase j2) dense n={N_MAIN} mixed", dense, mixed_spec(N_MAIN), False),
            (f"(phase j3) delta n={N_DELTA} delay", delta,
             fam_specs(N_DELTA, SCEN_TICKS_DELTA)["delay"], True),
            (f"(phase j3) delta n={N_DELTA} gray", delta,
             fam_specs(N_DELTA, SCEN_TICKS_DELTA)["gray"], True)):
        got, trace, runs_launches, _ = scenario_compare(torch, label, make, spec, sample)
        add(runs_launches)
        want = ("recv_merge",) if make is dense else ("row_searchsorted", "merge_insert")
        for k in want:
            if runs_launches[k] <= 0:
                raise AssertionError(f"scenarios {label}: kernel {k} was not launched")
        if "bench_scenario" in label or "delay" in label:
            soaks.append(("dense" if make is dense else "delta", make, spec, got, trace))
    for name, make, spec, got, trace in soaks:
        segment = SCEN_SEGMENT_DENSE if name == "dense" else SCEN_SEGMENT
        add(streamed_soak(torch, name, make, spec, got, trace, segment))
    log(f"scenarios (phase j): {time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase k: scenario sweeps (SimCluster.run_sweep) and protocol knobs
# (run_scenario(param_knobs=))
# ---------------------------------------------------------------------------

N_SWEEP_SMALL = 256
SWEEP_TICKS = 60  # benchmarks/bench_sweep.py's horizon
# k3's delta sweeps cut to 24 ticks (the kill at 3, the loss at 6, the
# ramp from 12 to 22): room for phases n and o within the script's time
# limit
SWEEP_TICKS_DELTA = 24
SWEEP_SEGMENT = 20  # k3's streamed segments
TUNE_SEED = 3  # benchmarks/tune.py:60
TUNE_SUSPICION = [1, 2, 3, 4, 6, 8, 10, 12]  # tune.py's full boundary axis


def sweep_spec(n: int, ticks: int) -> dict:
    """``benchmarks/bench_sweep.py``'s ``_experiment_spec`` (copied here:
    this script imports nothing of the JAX package): a kill, 5% loss,
    then a ramp back to 0."""
    return {"ticks": ticks, "events": [
        {"at": ticks // 8, "op": "kill", "node": n - 1},
        {"at": ticks // 4, "op": "loss", "p": 0.05},
        {"at": ticks // 2, "op": "loss_ramp", "until": ticks // 2 + 10, "to": 0.0},
    ]}


def boundary_spec(n: int, ticks: int) -> dict:
    """``benchmarks/tune.py``'s ``arm_boundary`` flap storm (down 3, up 4)."""
    return {"ticks": ticks, "events": [{
        "at": 10, "op": "flap", "nodes": [n - 2, n - 3, n - 4], "until": int(ticks * 0.6),
        "down": 3, "up": 4, "stagger": 2}]}


def _same_sweep(torch, a, b, what: str) -> None:
    """Two ``SweepTrace``s equal: every series with its dtype, the meta
    (axes, replica keys), and every replica's final state and net field
    (compared on the host)."""
    import numpy as np

    ta, tb = a.to_arrays(), b.to_arrays()
    if ta.keys() != tb.keys():
        raise AssertionError(f"{what}: sweep series differ ({sorted(ta)} vs {sorted(tb)})")
    for k, v in ta.items():
        if v.dtype != tb[k].dtype or not np.array_equal(v, tb[k]):
            raise AssertionError(f"{what}: sweep {k} differs")
    if a.meta() != b.meta():
        raise AssertionError(f"{what}: sweep meta differs")
    for kind in ("final_states", "final_nets"):
        for r, (x, y) in enumerate(zip(getattr(a, kind), getattr(b, kind))):
            for f, u in x._asdict().items():
                v = getattr(y, f)
                if (u is None) != (v is None) or (
                        u is not None and (u.dtype != v.dtype or not torch.equal(u.cpu(), v.cpu()))):
                    raise AssertionError(f"{what}: replica {r} {kind} {f} differs")


def _sweep_on(torch, device: str, n: int, params, spec: dict, replicas: int, kwargs: dict,
              seed: int = 0, **cluster_kw):
    from ringpop_tpu_torch.models.cluster import SimCluster

    c = SimCluster(n, params, seed=seed, device=device, **cluster_kw)
    trace = c.run_sweep(spec, replicas, **kwargs)
    return trace, c.key.clone()


def sweep_cases_small() -> list:
    """Phase k1's sweeps: a dense sweep with loss scales, kill and flap
    jitter; a dense knob sweep (``ping_req_size`` below capacity,
    ``relay_full_sync`` 0/1); the damp thresholds on a damping cluster;
    ``tune.py``'s boundary arm; a delta knob sweep at phase 4's caps."""
    from ringpop_tpu_torch.models.swim_sim import SwimParams

    n = N_SWEEP_SMALL
    flap = sweep_spec(n, SWEEP_TICKS)
    flap["events"].append({"at": SWEEP_TICKS // 5, "op": "flap", "nodes": [n - 2, n - 3],
                           "until": SWEEP_TICKS * 2 // 3, "down": 3, "up": 4})
    storm = boundary_spec(48, 80)
    cases = [
        ("dense scales, kill and flap jitter", n, SwimParams(loss=0.01, suspicion_ticks=8),
         flap, 3, {"loss_scales": [1.0, 0.5, 2.0], "kill_jitter": [0, 1, 2],
                   "flap_jitter": [0, 2, 4]}, {}),
        ("dense knobs ping_req_size, relay_full_sync", n, SwimParams(loss=0.05,
                                                                     suspicion_ticks=8),
         sweep_spec(n, 40), 3,
         {"param_axes": {"ping_req_size": [3, 2, 1], "relay_full_sync": [0, 1, 1]}}, {}),
        ("dense damp thresholds", n, SwimParams(loss=0.01, suspicion_ticks=8),
         boundary_spec(n, 40), 2,
         {"param_axes": {"damp_suppress": [1200.0, 2500.0], "damp_reuse": [400.0, 500.0],
                         "damp_penalty": [700.0, 500.0]}}, {"damping": True}),
        ("tune.py boundary arm, n=48", 48, SwimParams(), storm, len(TUNE_SUSPICION),
         {"param_axes": {"suspicion_ticks": TUNE_SUSPICION}}, {"seed": TUNE_SEED}),
        ("delta knobs suspicion_ticks, piggyback_factor", n,
         SwimParams(loss=0.05, suspicion_ticks=8), sweep_spec(n, 40), 2,
         {"param_axes": {"suspicion_ticks": [5, 10], "piggyback_factor": [3, 5]}},
         {"backend": "delta", **FAULT_CAPS_SMALL}),
    ]
    return cases


def sweeps_cpu_reference(path: str) -> None:
    """The CPU side of phase k1, run in a child process while the card
    works (``--sweeps-cpu``): each sweep's trace and the cluster key
    after it, saved to ``path`` with ``torch.save``."""
    import torch

    torch.set_num_threads(EARLY_CPU_THREADS)
    t0 = time.perf_counter()
    out = {"runs": [_sweep_on(torch, "cpu", nn, params, spec, reps, kwargs, **ckw)
                    for _, nn, params, spec, reps, kwargs, ckw in sweep_cases_small()]}
    out["total_s"] = time.perf_counter() - t0
    log(f"k1 cpu sweeps {out['total_s']:.1f} s")
    torch.save(out, path + ".tmp")
    os.replace(path + ".tmp", path)


def check_sweeps_cuda_equals_cpu(torch, cpu_ref: "CpuReference") -> None:
    """Phase k1: ``run_sweep`` on the card and on the CPU (the CPU's in the
    child process ``cpu_ref``) from one seed: every series, final state
    and net field, replica key and the cluster key equal, for each of
    ``sweep_cases_small``."""
    cases = sweep_cases_small()
    t_wait = time.perf_counter()
    cpu = cpu_ref.result(torch)
    log(f"sweeps (phase k1): the CPU side took {cpu['total_s']:.1f} s in its child process "
        f"({EARLY_CPU_THREADS} threads, started {time.perf_counter() - cpu_ref.t0:.1f} s ago; "
        f"waited {time.perf_counter() - t_wait:.1f} s for it)")
    for (label, nn, params, spec, reps, kwargs, ckw), (tw, kw) in zip(cases, cpu["runs"]):
        t0 = time.perf_counter()
        tg, kg = _sweep_on(torch, "cuda", nn, params, spec, reps, kwargs, **ckw)
        _same_sweep(torch, tg, tw, f"sweeps (phase k1) {label}")
        if not torch.equal(kg, kw):
            raise AssertionError(f"sweeps (phase k1) {label}: cluster keys differ")
        extra = ""
        if "tune" in label:
            det = tg.detect_ticks()
            evading = [s for s, d in zip(TUNE_SUSPICION, det) if d < 0]
            extra = (f"; detect ticks {det.tolist()}, boundary "
                     f"{min(evading) if evading else None}")
        log(f"sweeps (phase k1): {label} R={reps} n={nn} {spec['ticks']} ticks: cuda == cpu "
            f"on every series, final state and net field, replica key and the cluster key; "
            f"heal ticks {tg.heal_ticks().tolist()}{extra}; the card's run "
            f"{time.perf_counter() - t0:.1f} s")


def _sweep_arm(torch, label: str, make, run) -> tuple:
    """One measured arm of k2/k3 on a fresh cluster made before the
    window: (cluster, result, what it measured over ``run``), with the
    host syncs inside each call of the runner's tick loop apart
    (``scan_syncs``: a sweep's calls go segment by segment, replica by
    replica within a segment)."""
    from ringpop_tpu_torch.scenarios import runner

    c = make()
    _reset_counts()
    _counted_recv_merge_reset()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sink: dict = {}
    scan_syncs: list[int] = []
    real = runner._scenario_scan_impl
    t0 = time.perf_counter()
    with _syncs(torch, sink) as caught:
        def counted(*args, **kwargs):
            before = len(caught)
            try:
                return real(*args, **kwargs)
            finally:
                scan_syncs.append(sum("synchroniz" in str(w.message) for w in caught[before:]))

        runner._scenario_scan_impl = counted
        try:
            out = run(c)
        finally:
            runner._scenario_scan_impl = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return c, out, {"wall_s": wall, "syncs": sink["syncs"],
                    "revive_syncs": sink.get("revive_syncs", 0), "scan_syncs": scan_syncs,
                    "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
                    "launches": _kernel_counts()}


def _replica_syncs(r: dict, replica: int, replicas: int) -> float:
    """Replica ``replica``'s host syncs in a sweep arm: those inside its
    own tick-loop calls plus an R-th of the sweep's per-call ones."""
    own = sum(r["scan_syncs"][replica::replicas])
    return own + (r["syncs"] - r["revive_syncs"] - sum(r["scan_syncs"])) / replicas


def _arm_line(label: str, arm: str, r: dict, replica_ticks: int) -> str:
    return (f"sweeps {label} {arm}: {r['wall_s'] * 1e3 / replica_ticks:.3f} ms per replica-tick "
            f"over {replica_ticks} replica-ticks, host syncs {r['syncs']} "
            f"({(r['syncs'] - r['revive_syncs']) / replica_ticks:.2f} per replica-tick outside "
            f"revives), peak {r['peak_gib']:.2f} GiB over the start, launches {r['launches']}")


def sweep_compare(torch, label: str, make, spec: dict, replicas: int, kwargs: dict,
                  check: list[int], streamed: bool, sample: bool) -> dict:
    """Phase k2/k3: ``run_sweep`` at full width, the replicas in ``check``
    held against standalone ``run_scenario(replica_spec(...),
    param_knobs=replica_param_knobs(...))`` runs from their replica keys
    (every series, final state field and the checksums of the live rows,
    a sample of them with ``sample``); with ``streamed`` the sweep again
    in ``SWEEP_SEGMENT``-tick segments, pipelined and not, equal to it.
    Checks the sync rule and returns the launches of the sweep arms."""
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.scenarios import sweep as ssweep
    from ringpop_tpu_torch.scenarios.spec import ScenarioSpec

    t_all = time.perf_counter()
    ticks = spec["ticks"]
    rt = replicas * ticks
    _, whole, rs = _sweep_arm(torch, label, make, lambda c: c.run_sweep(spec, replicas, **kwargs))
    log(_arm_line(label, "run_sweep", rs, rt))
    launches = dict(rs["launches"])
    arms = {"run_sweep": rs}
    if streamed:
        for pipe in (True, False):
            arm = f"streamed pipeline={pipe}"
            _, got, r = _sweep_arm(torch, label, make, lambda c, p=pipe: c.run_sweep(
                spec, replicas, **kwargs, segment_ticks=SWEEP_SEGMENT, pipeline=p))
            _same_sweep(torch, got, whole, f"sweeps {label}: {arm} vs run_sweep")
            del got
            log(_arm_line(label, arm, r, rt) + "; equal to run_sweep")
            arms[arm] = r
            for k, v in r["launches"].items():
                launches[k] += v
    axes = kwargs.get("param_axes")
    for r in check:
        spec_r = ssweep.replica_spec(
            ScenarioSpec.from_dict(spec), kill_jitter=whole.kill_jitter[r],
            loss_scale=whole.loss_scales[r], flap_jitter=whole.flap_jitter[r])

        def standalone(c, r=r, spec_r=spec_r):
            c.key = convert.key_from_numpy(whole.replica_keys[r])
            return c.run_scenario(spec_r, param_knobs=ssweep.replica_param_knobs(axes, r))

        c, trace, ra = _sweep_arm(torch, label, make, standalone)
        log(_arm_line(label, f"standalone run_scenario of replica {r}", ra, ticks))
        want = whole.replica(r).to_arrays()
        for k, v in trace.to_arrays().items():
            if v.dtype != want[k].dtype or not (v == want[k]).all():
                raise AssertionError(f"sweeps {label}: replica {r} series {k} differs from its "
                                     "standalone run")
        for f, x in c.state._asdict().items():
            y = getattr(whole.final_states[r], f)
            if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
                raise AssertionError(f"sweeps {label}: replica {r} state {f} differs from its "
                                     "standalone run")
        _reset_counts()
        rows = _sample_rows(c) if sample else c.live_indices().tolist()
        ck_run = c.checksums(indices=rows, backend="device")
        c.state, c.net = whole.final_states[r], whole.final_nets[r]
        ck_sweep = c.checksums(indices=rows, backend="device")
        launches["farmhash32"] += _counted()["farmhash32"].launches
        if ck_run != ck_sweep:
            raise AssertionError(f"sweeps {label}: replica {r} checksums differ")
        del c
        # the sync rule, replica by replica: the replicas' knobs give
        # them different trajectories, so each is held against its own
        # standalone run
        per_run = (ra["syncs"] - ra["revive_syncs"]) / ticks
        per_rep = [_replica_syncs(a, r, replicas) / ticks for a in arms.values()]
        log(f"sweeps {label}: replica {r} == its standalone run_scenario on every series and "
            f"state field; checksums of {len(rows)} live rows equal, "
            f"{len(set(ck_run.values()))} group(s); heal tick {whole.heal_ticks()[r]}, detect "
            f"tick {whole.detect_ticks()[r]}; host syncs a tick outside revives: "
            f"{' / '.join(f'{x:.2f}' for x in per_rep)} in {' / '.join(arms)}, "
            f"{per_run:.2f} standalone")
        if max(per_rep) > per_run:
            raise AssertionError(f"sweeps {label}: replica {r} takes {max(per_rep):.2f} host "
                                 f"syncs a tick outside revives in a sweep, run_scenario "
                                 f"{per_run:.2f}")
    log(f"sweeps {label}: summary {whole.summary()['replicas']}; "
        f"{time.perf_counter() - t_all:.1f} s")
    return launches


def sweeps_phase(torch, cpu_ref: "CpuReference") -> dict:
    """Phase k: k1 the lockstep at small n (the CPU side from
    ``cpu_ref``), k2 dense at n = 10 000, k3 delta at n = 65 536; returns
    the kernels' launches summed over k2 and k3."""
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.models.swim_sim import SwimParams

    t0 = time.perf_counter()
    check_sweeps_cuda_equals_cpu(torch, cpu_ref)
    log(f"sweeps (phase k1): {time.perf_counter() - t0:.1f} s")
    launches: dict[str, int] = {}

    def dense():
        return SimCluster(N_MAIN, SwimParams(loss=0.01), seed=0, device="cuda")

    def delta():
        return SimCluster(N_DELTA, SwimParams(loss=0.01), seed=0, device="cuda",
                          backend="delta", **DELTA_CAPS)

    for label, make, spec, reps, kwargs, check, streamed, sample in (
            (f"(phase k2) dense n={N_MAIN}", dense, sweep_spec(N_MAIN, SWEEP_TICKS), 4,
             {"kill_jitter": [0, 1, 2, 3], "param_axes": {"suspicion_ticks": [3, 5, 8, 12]}},
             [0, 3], False, False),
            (f"(phase k3) delta n={N_DELTA}", delta, sweep_spec(N_DELTA, SWEEP_TICKS_DELTA), 2,
             {"kill_jitter": [0, 3]}, [1], True, True),
            # every delta knob site at full width (streamed sweeps take no
            # knobs): replica 1 carries a later countdown, a smaller
            # piggyback factor, ping_req_size below capacity and a
            # dividing phase_mod
            (f"(phase k3) delta n={N_DELTA} knobs", delta,
             sweep_spec(N_DELTA, SWEEP_TICKS_DELTA), 2,
             {"kill_jitter": [0, 3], "param_axes": {
                 "suspicion_ticks": [5, 8], "piggyback_factor": [15, 5],
                 "ping_req_size": [3, 2], "phase_mod": [1, 2]}}, [1], False, True)):
        got = sweep_compare(torch, label, make, spec, reps, kwargs, check, streamed, sample)
        want = ("recv_merge",) if make is dense else ("row_searchsorted", "merge_insert")
        for k in (*want, "farmhash32"):
            if got[k] <= 0:
                raise AssertionError(f"sweeps {label}: kernel {k} was not launched")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    log(f"sweeps (phase k): {time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase l: the serving plane (traffic=), the overload feedback loop and the
# remediation policies (policy=), sharded and standalone serving
# ---------------------------------------------------------------------------

N_SERVE_SMALL = 256
SERVE_TICKS_SMALL = 30
SERVE_WLS_SMALL = {
    "uniform": {"kind": "uniform", "keys_per_tick": 128, "pool": 1024, "every": 2},
    "zipf": {"kind": "zipf", "keys_per_tick": 128, "pool": 1024, "zipf_s": 1.2,
             "latency_buckets": 16, "lookup_n": 3},
    "tenant": {"kind": "tenant", "keys_per_tick": 128, "pool": 1024, "tenants": 8},
}
POLICY_NAMES = ("admission", "combined", "quarantine", "retry_budget")
SWEEP_AXES = {"shed_hi": [2, 4], "shed_lo": [1, 2]}
SAMPLE_TICKS_CHECK = 200
HEADLINE_N = 64  # benchmarks/bench_policies.py:30-32
HEADLINE_SEED = 3
HEADLINE_TICKS = 120
HEADLINE_SEGMENT = 32
SERVE_TICKS = 120  # the cascading_overload incident's horizon
# l3 (n = 10 000) and l4 (n = 65 536) cut to 60 ticks: room in the
# script's time limit for j4's dense soak at n = 10 000 and phase n
SERVE_TICKS_FULL = 60
SERVE_KEYS = 2048  # cut from 8n keys a tick
SERVE_POOL = 16384  # cut from a 32n pool
SERVE_SEGMENT = 40
SERVE_SEGMENT_DELTA = 20
# BASELINE.md:810-819 (the reference on the CPU, jax 0.4.37's PRNG mode):
# arm -> goodput, amplification, lat p99 ms, gray timeouts, failed, peak
# gray, shed, peak quarantine, retry-cap min
BASELINE_HEADLINE = {
    ("dense", "control"): (1.000, 1.00, 0, 0, 0, 0, None, None, None),
    ("dense", "feedback"): (0.766, 2.71, 4096, 80658, 14353, 8, None, None, None),
    ("dense", "admission"): (0.392, 2.55, 0, 0, 0, 8, 37370, 0, 3),
    ("dense", "retry_budget"): (0.619, 1.66, 0, 25235, 23438, 8, 0, 0, 0),
    ("dense", "quarantine"): (1.000, 1.00, 0, 0, 0, 11, 0, 24, 3),
    ("dense", "combined"): (1.000, 1.00, 0, 0, 0, 11, 0, 24, 3),
    ("delta", "feedback"): (0.766, 2.71, 4096, 80658, 14353, 8, None, None, None),
    ("delta", "combined"): (1.000, 1.00, 0, 0, 0, 11, 0, 24, 3),
}


def serving_spec_small(n: int, ticks: int = SERVE_TICKS_SMALL) -> dict:
    """Phase l1's scenario: a gray window (factor 4), a delay rule, a kill
    at tick 5 and an overload window."""
    return {"ticks": ticks, "events": [
        {"at": 3, "op": "gray", "nodes": [1, 2, 3], "factor": 4, "until": 20},
        {"at": 4, "op": "delay", "src": list(range(n // 4)), "dst": list(range(n // 2, n)),
         "delay": 1, "jitter": 2, "until": 24},
        {"at": 5, "op": "kill", "node": n - 1},
        {"at": 2, "op": "overload", "until": ticks - 2, "capacity": 3, "threshold": 12,
         "recover": 4, "factor": 4},
    ]}


def cascading_overload(n: int, ticks: int, overload: bool = True) -> tuple[dict, dict]:
    """The incident library's ``cascading_overload`` for n and ticks as
    the dicts the phases edit (spec, workload); ``overload=False`` is the
    control arm."""
    from ringpop_tpu_torch.scenarios import library as lib

    spec, wl = lib.build_incident("cascading_overload", n, ticks=ticks, overload=overload)
    return spec.to_dict(), wl.to_dict()


def incident_summary(trace) -> dict:
    """The library's ``incident_summary``, with ``ov_gray_peak`` 0 for a
    run without the overload loop (the control arms)."""
    from ringpop_tpu_torch.scenarios import library as lib

    return {"ov_gray_peak": 0, **lib.incident_summary(trace)}


def _np_copy(c) -> dict:
    """A cluster's state, net, key and loss as numpy (picklable)."""
    def host(obj):
        return {f: None if v is None else v.cpu().numpy() for f, v in obj._asdict().items()}

    return {"state": host(c.state), "net": host(c.net), "key": c.key.numpy().copy(),
            "loss": c.params.loss}


def _sweep_copy(tr) -> dict:
    return {"trace": tr.to_arrays(),
            "states": [{f: None if v is None else v.cpu().numpy() for f, v in s._asdict().items()}
                       for s in tr.final_states],
            "nets": [{f: None if v is None else v.cpu().numpy() for f, v in s._asdict().items()}
                     for s in tr.final_nets]}


def serving_small_runs(device: str) -> dict:
    """Phase l1's runs on ``device``: the scenario under each workload,
    each policy at its default under the zipf workload, on both
    backends, and the admission sweep over ``SWEEP_AXES`` (dense)."""
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.models.swim_sim import SwimParams

    n = N_SERVE_SMALL
    spec = serving_spec_small(n)
    params = SwimParams(loss=0.01, suspicion_ticks=8)
    out = {}
    for backend, caps in (("dense", {}), ("delta", FAULT_CAPS_SMALL)):
        def make():
            return SimCluster(n, params, seed=0, device=device, backend=backend, **caps)

        for name, wl in SERVE_WLS_SMALL.items():
            c = make()
            out[f"{backend}/{name}"] = {"trace": c.run_scenario(spec, traffic=wl).to_arrays(),
                                        **_np_copy(c)}
        for name in POLICY_NAMES:
            c = make()
            tr = c.run_scenario(spec, traffic=SERVE_WLS_SMALL["zipf"], policy=name)
            out[f"{backend}/policy_{name}"] = {"trace": tr.to_arrays(), **_np_copy(c)}
    c = SimCluster(n, params, seed=0, device=device)
    tr = c.run_sweep(spec, 2, traffic=SERVE_WLS_SMALL["zipf"], policy="admission",
                     policy_axes=SWEEP_AXES)
    out["dense/sweep_admission"] = {**_sweep_copy(tr), "key": c.key.numpy().copy()}
    return out


def sample_ticks(device: str) -> dict:
    """Phase l1's sampler check: 200 ticks of a zipf workload (128 keys a
    tick, a 1 024-key pool), and 3 ticks at phase l3's shape."""
    from ringpop_tpu_torch.traffic import engine
    from ringpop_tpu_torch.traffic.workloads import compile_traffic

    out = {}
    addrs = [f"10.0.0.{i}:3000" for i in range(N_SERVE_SMALL)]
    for label, wl, ticks in (
            ("small", SERVE_WLS_SMALL["zipf"], SAMPLE_TICKS_CHECK),
            ("l3", {"kind": "zipf", "zipf_s": 1.2, "keys_per_tick": SERVE_KEYS,
                    "pool": SERVE_POOL}, 3)):
        ct = compile_traffic(wl, N_SERVE_SMALL, addrs, device=device)
        out[label] = [_pair_np(engine.sample_tick(ct.tensors, t, ct.static.m))
                      for t in range(ticks)]
    return out


def _pair_np(pair):
    """A sampled batch (keys, viewers) as one int32 [2, M] host array."""
    import numpy as np

    return np.stack([x.cpu().numpy() for x in pair])


def headline_runs(device: str) -> dict:
    """Phase l2's arms on ``device``: ``benchmarks/bench_policies.py``'s
    headline (n = 64, 120 ticks, 32-tick segments, seed 3): the control,
    the feedback arm and each policy at its default on the dense
    backend, the feedback arm and ``combined`` on the delta backend."""
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.models.swim_sim import SwimParams

    n = HEADLINE_N
    spec, wl = cascading_overload(n, HEADLINE_TICKS)
    spec_ctl, _ = cascading_overload(n, HEADLINE_TICKS, overload=False)
    arms = [("dense", "control", spec_ctl, None), ("dense", "feedback", spec, None)]
    arms += [("dense", p, spec, p) for p in POLICY_NAMES]
    arms += [("delta", "feedback", spec, None), ("delta", "combined", spec, "combined")]
    out = {}
    for backend, name, sp, policy in arms:
        kw = {} if backend == "dense" else {"capacity": n, "wire_cap": n,
                                              "claim_grid": 3 * n * n}
        c = SimCluster(n, SwimParams(), seed=HEADLINE_SEED, device=device, backend=backend,
                       **kw)
        tr = c.run_scenario(sp, traffic=wl, segment_ticks=HEADLINE_SEGMENT, policy=policy)
        out[f"{backend}/{name}"] = {"trace": tr.to_arrays(), "summary": incident_summary(tr),
                                    **_np_copy(c)}
    return out


def serving_cpu_reference(path: str) -> None:
    """The CPU side of phases l1 and l2, run in a child process while the
    card works (``--serving-cpu``): saved to ``path`` with ``torch.save``."""
    import torch

    torch.set_num_threads(SERVE_CPU_THREADS)
    t0 = time.perf_counter()
    out = {"small": serving_small_runs("cpu")}
    log(f"l1 runs {time.perf_counter() - t0:.1f} s")
    out["samples"] = sample_ticks("cpu")
    out["small_s"] = time.perf_counter() - t0
    log(f"l1 samples {out['small_s']:.1f} s")
    out["headline"] = headline_runs("cpu")
    out["total_s"] = time.perf_counter() - t0
    log(f"l2 arms {out['total_s']:.1f} s")
    tmp = path + ".tmp"
    torch.save(out, tmp)
    os.replace(tmp, path)


SERVE_CPU_THREADS = 4  # of the machine's 8 cores; the card's host loop keeps the rest
EARLY_CPU_THREADS = 1  # each of phases k1's, m1's and n1's children
SERVE_CPU_TIMEOUT = 1000


class CpuReference:
    """A child process computing a phase's CPU side, started early so that
    it overlaps the card's phases (stopped at exit either way): phase
    k1's (``--sweeps-cpu``), phase l's (``--serving-cpu``), phase m1's
    (``--provenance-cpu``) or phase n1's (``--incidents-cpu``)."""

    def __init__(self, phase: str = "l"):
        self.what = {"k": "sweeps (phase k1)", "l": "serving (phase l)",
                     "m": "provenance (phase m1)", "n": "incidents (phase n1)"}[phase]
        self.dir = os.path.join(REPO, "ringpop_tpu_torch", "_build", f"phase_{phase}")
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "cpu_reference.pt")
        if os.path.exists(self.path):
            os.remove(self.path)
        self.log = open(os.path.join(self.dir, "cpu_reference.log"), "w")
        self.t0 = time.perf_counter()
        flag = {"k": "--sweeps-cpu", "l": "--serving-cpu", "m": "--provenance-cpu",
                "n": "--incidents-cpu"}[phase]
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, self.path],
            cwd=REPO, stdout=self.log, stderr=subprocess.STDOUT)

    def result(self, torch) -> dict:
        left = SERVE_CPU_TIMEOUT - (time.perf_counter() - self.t0)
        try:
            rc = self.proc.wait(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            self.stop()
            raise AssertionError(f"{self.what}: the CPU reference child timed out")
        self.log.flush()
        if rc != 0:
            with open(self.log.name) as f:
                tail = f.read()[-3000:]
            raise AssertionError(f"{self.what}: the CPU reference child failed:\n{tail}")
        return torch.load(self.path, weights_only=False)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()


def _same_record(a: dict, b: dict, what: str) -> None:
    """Equal run records (``_np_copy`` plus a trace's arrays, or a sweep's
    trace, final states and nets): every array with its dtype."""
    import numpy as np

    def same(x, y, where):
        if (x is None) != (y is None):
            raise AssertionError(f"{what}: {where} present on one side only")
        if x is None:
            return
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(x, y):
            raise AssertionError(f"{what}: {where} differs")

    if a["trace"].keys() != b["trace"].keys():
        raise AssertionError(f"{what}: trace series differ "
                             f"({sorted(set(a['trace']) ^ set(b['trace']))})")
    for k in a["trace"]:
        same(a["trace"][k], b["trace"][k], f"trace {k}")
    for part in ("state", "net"):
        for f in a.get(part, {}):
            same(a[part][f], b[part][f], f"{part} {f}")
    for part in ("states", "nets"):
        for r, (x, y) in enumerate(zip(a.get(part, []), b.get(part, []))):
            for f in x:
                same(x[f], y[f], f"replica {r} {part} {f}")
    same(a["key"], b["key"], "key")
    if "loss" in a and np.float32(a["loss"]) != np.float32(b["loss"]):
        raise AssertionError(f"{what}: loss differs")


def check_serving_cuda_equals_cpu(torch, cpu: dict) -> None:
    """Phase l1: the runs, the sampler and the Gumbel transform on the
    card equal the CPU's."""
    import numpy as np

    from ringpop_tpu_torch import prng

    t0 = time.perf_counter()
    got = serving_small_runs("cuda")
    want = cpu["small"]
    if got.keys() != want.keys():
        raise AssertionError("serving (phase l1): run sets differ")
    for name in got:
        _same_record(got[name], want[name], f"serving (phase l1) {name}")
    fired = {name: (int(r["trace"]["m.ov_gray_nodes"].max()),
                    int(r["trace"].get("m.policy_shed", np.zeros(1)).sum()),
                    int(r["trace"].get("m.policy_quarantined", np.zeros(1)).max()),
                    int(r["trace"]["m.delivered"].sum()))
             for name, r in got.items() if "m.ov_gray_nodes" in r["trace"]}
    log(f"serving (phase l1): {len(got)} runs at n={N_SERVE_SMALL} ({SERVE_TICKS_SMALL} ticks: "
        f"gray, delay, kill, overload; workloads {sorted(SERVE_WLS_SMALL)}; each policy at its "
        f"default; the admission sweep over {SWEEP_AXES}) cuda == cpu: every trace series and "
        f"histogram plane, state and net field (ov_*, po_*) and the key; (peak gray, shed, peak "
        f"quarantine, delivered) {fired}; {time.perf_counter() - t0:.1f} s")
    samples = sample_ticks("cuda")
    for label, rows in samples.items():
        for t, (a, b) in enumerate(zip(rows, cpu["samples"][label])):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"serving (phase l1): sample_tick {label} tick {t} differs")
    u = np.maximum(np.arange(2**23, dtype=np.float32) * np.float32(2**-23),
                   np.finfo(np.float32).tiny)
    ut = torch.from_numpy(u)
    g_card = prng.gumbel_from_uniform(ut.cuda()).cpu().numpy()
    g_cpu = prng.gumbel_from_uniform(ut).numpy()
    misses = int((g_card.view(np.int32) != g_cpu.view(np.int32)).sum())
    if misses:
        raise AssertionError(f"serving (phase l1): the Gumbel transform differs on {misses} "
                             "of 2^23 uniforms between the card and the CPU")
    log(f"serving (phase l1): sample_tick cuda == cpu on {SAMPLE_TICKS_CHECK} ticks of "
        f"{SERVE_WLS_SMALL['zipf']['keys_per_tick']} keys and 3 ticks of {SERVE_KEYS} keys over "
        f"a {SERVE_POOL}-key pool; the Gumbel transform cuda == cpu on all 2^23 uniform "
        f"outputs (0 misses); {time.perf_counter() - t0:.1f} s")


def check_headline(torch, cpu: dict) -> None:
    """Phase l2: the policy headline on the card, equal to the CPU's,
    printed beside BASELINE.md's table."""
    t0 = time.perf_counter()
    got = headline_runs("cuda")
    for name in got:
        _same_record(got[name], cpu["headline"][name], f"serving (phase l2) {name}")
    log(f"serving (phase l2): bench_policies.py's headline (n={HEADLINE_N}, {HEADLINE_TICKS} "
        f"ticks, zipf 1.2 at {8 * HEADLINE_N} keys a tick, {HEADLINE_SEGMENT}-tick segments, "
        f"seed {HEADLINE_SEED}): all {len(got)} arms cuda == cpu (every series, state, net, "
        f"key); {time.perf_counter() - t0:.1f} s.  The port's numbers, then BASELINE.md:810-819 "
        "(the reference under jax 0.4.37's PRNG mode, so its draws, and these rows, may "
        "differ):")
    log("| backend | arm | goodput | amplification | lat p99 ms | gray timeouts | failed "
        "| peak gray | shed | peak quar | cap min || BASELINE row |")
    for (backend, name), base in BASELINE_HEADLINE.items():
        s = got[f"{backend}/{name}"]["summary"]
        goodput = s["delivered"] / max(s["lookups"], 1)
        amp = s["sends"] / max(s["delivered"], 1)
        log(f"| {backend} | {name} | {goodput:.3f} | {amp:.2f} | {s['lat_p99_ms']} "
            f"| {s['gray_timeouts']} | {s['proxy_failed']} | {s['ov_gray_peak']}/{HEADLINE_N} "
            f"| {s.get('policy_shed', '-')} | {s.get('policy_quar_peak', '-')} "
            f"| {s.get('policy_retry_cap_min', '-')} || {base} |")


def _serve_counts() -> dict:
    """The launch counters phase l reads: ``_kernel_counts`` and the
    short-row FarmHash kernel (the key pool, the traffic ring's names)."""
    return {**_kernel_counts(), "farmhash32_short": _counted()["farmhash32"].short_launches}


def _serve_arm(torch, label: str, make, spec: dict, traffic, policy,
               segment: int | None = None) -> tuple:
    """One arm of phases l3/l4 from a fresh cluster (made, and its
    workload lowered, before the measured window): ms a tick, host syncs
    a tick outside revives, peak memory, launches and the scorecard."""
    _reset_counts()
    _counted_recv_merge_reset()
    c = make()
    ct = c.compile_traffic(traffic) if traffic is not None else None
    build_launches = _serve_counts()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sink: dict = {}
    t0 = time.perf_counter()
    with _syncs(torch, sink):
        trace = c.run_scenario(spec, traffic=ct, policy=policy, segment_ticks=segment)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ticks = spec["ticks"]
    run_launches = _serve_counts()
    r = {"ms_per_tick": wall * 1e3 / ticks,
         "syncs_per_tick": (sink["syncs"] - sink.get("revive_syncs", 0)) / ticks,
         "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
         "launches": {k: build_launches[k] + run_launches[k] for k in run_launches},
         "summary": incident_summary(trace) if traffic is not None else None}
    s = r["summary"]
    score = ""
    if s is not None:
        score = (f"; goodput {s['delivered'] / max(s['lookups'], 1):.4f}, amplification "
                 f"{s['sends'] / max(s['delivered'], 1):.3f}, lat p99 {s['lat_p99_ms']} ms, "
                 f"gray timeouts {s['gray_timeouts']}, peak gray {s['ov_gray_peak']}, shed "
                 f"{s.get('policy_shed', '-')}, peak quarantine {s.get('policy_quar_peak', '-')}")
    log(f"serving {label}: {r['ms_per_tick']:.3f} ms per tick over {ticks} ticks"
        f"{f' ({segment}-tick segments)' if segment else ''}, host syncs "
        f"{r['syncs_per_tick']:.2f} per tick, peak {r['peak_gib']:.2f} GiB over the start, "
        f"launches {r['launches']}{score}")
    return c, ct, trace, r


def serving_full(torch, backend: str) -> dict:
    """Phase l3 (dense, BASELINE config 3's protocol at n = 10 000) or l4
    (delta, the north star at n = 65 536): the cascading_overload spec
    with the cut workload, the feedback arm (l3 only), ``combined``
    whole and streamed (equal), and the traffic-free control, whose host
    syncs a tick the served runs may not exceed."""
    import numpy as np

    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.models.swim_sim import SwimParams

    dense = backend == "dense"
    n = N_MAIN if dense else N_DELTA
    ticks = SERVE_TICKS_FULL
    phase = "(phase l3)" if dense else "(phase l4)"
    spec, wl = cascading_overload(n, ticks)
    spec_ctl, _ = cascading_overload(n, ticks, overload=False)
    wl = dict(wl, keys_per_tick=SERVE_KEYS, pool=SERVE_POOL)
    t_all = time.perf_counter()

    def make():
        if dense:
            return SimCluster(N_MAIN, SwimParams(loss=0.01), seed=0, device="cuda")
        return SimCluster(N_DELTA, SwimParams(loss=0.01), seed=0, device="cuda",
                          backend="delta", **DELTA_CAPS)

    log(f"serving {phase}: {backend} n={n}, cascading_overload for {ticks} ticks "
        f"(overload {spec['events'][0]}), workload {wl} (cut from {8 * n} keys a tick and a "
        f"{32 * n}-key pool)")
    runs = {}
    _, _, _, runs["control"] = _serve_arm(torch, f"{phase} {backend} control (no traffic, "
                                          "no overload)", make, spec_ctl, None, None)
    if dense:
        _, _, _, runs["feedback"] = _serve_arm(torch, f"{phase} {backend} feedback (no policy)",
                                               make, spec, wl, None)
    c, ct, whole, runs["combined"] = _serve_arm(torch, f"{phase} {backend} combined", make,
                                                spec, wl, "combined")
    want = _np_copy(c)
    want["trace"] = whole.to_arrays()
    serve_peak = None
    if not dense:
        # the serve's own peak: one serve of the final views, standalone
        from ringpop_tpu_torch.policies import core as pol
        from ringpop_tpu_torch.scenarios import runner
        from ringpop_tpu_torch.traffic import engine

        st = runner.policy_traffic(ct, pol.compile_policy("combined", n=n, m=SERVE_KEYS))
        policy = (c.net.po_shed, c.net.po_quar, c.net.po_retry_cap)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        engine.serve_once(engine.DeltaRows(c.state), c.net.up, c.net.responsive, st.tensors,
                          ticks, static=st.static, policy=policy)
        torch.cuda.synchronize()
        serve_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        log(f"serving {phase}: one serve of the final delta views (DeltaRows: the {SERVE_KEYS} "
            f"viewers' rows and each hop's holders' from the tables, the divergence and "
            f"self-in-ring counts without the [N, N] table) peaks at {serve_peak:.3f} GiB over "
            "its start")
    del c
    seg = SERVE_SEGMENT if dense else SERVE_SEGMENT_DELTA
    c2, _, _, runs["streamed"] = _serve_arm(torch, f"{phase} {backend} combined streamed", make,
                                            spec, wl, "combined", segment=seg)
    got = _np_copy(c2)
    got["trace"] = c2.traces[-1].to_arrays()
    _same_record(got, want, f"serving {phase} combined streamed vs whole")
    del c2
    # the streamed arm reads each segment back (a sync a segment) and is
    # held to the whole run's result, not to the control's syncs
    for arm in ("feedback", "combined"):
        if arm in runs and runs[arm]["syncs_per_tick"] > runs["control"]["syncs_per_tick"]:
            raise AssertionError(
                f"serving {phase}: the served {arm} run takes {runs[arm]['syncs_per_tick']:.2f} "
                f"host syncs a tick, the traffic-free control {runs['control']['syncs_per_tick']:.2f}")
    want_k = ("recv_merge",) if dense else ("row_searchsorted", "merge_insert")
    for arm in ("combined", "streamed"):
        la = runs[arm]["launches"]
        for k in want_k:
            if la[k] <= 0:
                raise AssertionError(f"serving {phase}: kernel {k} was not launched ({arm})")
        if la["farmhash32"] + la["farmhash32_short"] <= 0:
            raise AssertionError(f"serving {phase}: FarmHash was not launched ({arm})")
    s = runs["combined"]["summary"]
    if s["ov_gray_peak"] <= 0 and s.get("policy_quar_peak", 0) <= 0:
        raise AssertionError(f"serving {phase}: neither the overload meter nor the policy fired")
    if not np.isfinite(runs["combined"]["ms_per_tick"]):
        raise AssertionError(f"serving {phase}: no tick time")
    log(f"serving {phase}: combined streamed ({seg}-tick segments) == whole on every series, "
        f"state and net field (ov_*, po_*) and the key; served runs' host syncs a tick <= the "
        f"control's; {time.perf_counter() - t_all:.1f} s")
    launches: dict[str, int] = {}
    for r in runs.values():
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"launches": launches, "runs": runs, "serve_peak_gib": serve_peak}


def sharded_serving(torch) -> dict:
    """Phase l5: phase l3's workload served from a converged dense cluster
    at n = 10 000 by ``parallel.sharded_serve`` over D = 4 shards on the
    card (every viewer and holder row a ring fetch, hop kernel launches)
    and by ``serve_once`` on the same rows: every counter equal."""
    from ringpop_tpu_torch import parallel
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.models.swim_sim import SwimParams
    from ringpop_tpu_torch.traffic import engine

    t0 = time.perf_counter()
    c = SimCluster(N_MAIN, SwimParams(loss=0.01), seed=0, device="cuda")
    c.tick(5)
    c.kill(VICTIM)
    c.tick(3)
    _, wl = cascading_overload(N_MAIN, SERVE_TICKS)
    ct = c.compile_traffic(dict(wl, keys_per_tick=SERVE_KEYS, pool=SERVE_POOL))
    mesh = parallel.make_mesh(devices=[torch.device("cuda")] * SHARDS)
    serve = parallel.sharded_serve(mesh, static=ct.static)
    _reset_counts()
    for t in (0, 1, 2):
        want = engine.serve_once(c.state.view_key, c.net.up, c.net.responsive, ct.tensors, t,
                                 static=ct.static)
        got = serve(c.state.view_key, c.net.up, c.net.responsive, ct.tensors, t)
        for k in want:
            if not torch.equal(got[k], want[k]):
                raise AssertionError(f"serving (phase l5): sharded {k} differs at t={t}")
    hops = _counted()["ring_hop"].launches
    if hops <= 0:
        raise AssertionError("serving (phase l5): sharded_serve launched no ring hop")
    log(f"serving (phase l5): sharded_serve over D={SHARDS} shards == serve_once at "
        f"n={N_MAIN} (3 ticks of {SERVE_KEYS} keys, a kill 3 ticks back; lookups "
        f"{int(want['lookups'])}, delivered {int(want['delivered'])}, ring divergence "
        f"{int(want['ring_divergence'])}); ring hop launches {hops}; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"ring_hop": hops}


def serving_phase(torch, cpu_ref: "CpuReference") -> dict:
    """Phase l: l1 cuda == cpu at n = 256 (and the sampler, the Gumbel
    transform), l2 the policy headline, l3 dense n = 10 000, l4 delta
    n = 65 536, l5 sharded serving; returns the kernels' launches summed
    over l3-l5."""
    t0 = time.perf_counter()
    t_wait = time.perf_counter()
    cpu = cpu_ref.result(torch)
    log(f"serving (phase l): the CPU side took {cpu['small_s']:.1f} s (l1) and "
        f"{cpu['total_s']:.1f} s (l1 + l2) in its child process ({SERVE_CPU_THREADS} threads, "
        f"started {time.perf_counter() - cpu_ref.t0:.1f} s ago; waited "
        f"{time.perf_counter() - t_wait:.1f} s for it)")
    check_serving_cuda_equals_cpu(torch, cpu)
    check_headline(torch, cpu)
    del cpu
    launches: dict[str, int] = {}
    for backend in ("dense", "delta"):
        for k, v in serving_full(torch, backend)["launches"].items():
            launches[k] = launches.get(k, 0) + v
    launches["ring_hop"] = launches.get("ring_hop", 0) + sharded_serving(torch)["ring_hop"]
    log(f"serving (phase l): {time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase m: the gossip provenance plane (trace_rumors, track) and the stats
# bridge (SimCluster(stats_emitter=))
# ---------------------------------------------------------------------------

N_PROV_SMALL = 256
PROV_TICKS_SMALL = 30
PROV_SEGMENT_SMALL = 10
PROV_SLOTS_SMALL = 8
RUNG_TICKS = 48  # benchmarks/bench_dissemination.py's ladder horizon
RUNG_SEED = 7  # bench_dissemination.py's run_ladder seed
RUNG_SLOTS = 4  # bench_dissemination.py's run_ladder rumors
PROV_CAP_SLOTS = 64  # obs.provenance.MAX_RUMORS: the plane at its cap
BRIDGE_TICKS = 24
BRIDGE_SEGMENT = 8


def prov_spec_small(n: int, ticks: int, slots: int = PROV_SLOTS_SMALL) -> dict:
    """m1's scenario: a reservation for the node killed at tick 5 (it
    fires) and one for a node that stays up (it never does), 5% loss so
    that suspicions are refuted, and a delay rule, so that nodes hear a
    rumor with no in-tick edge to explain it."""
    q = n // 4
    return {"ticks": ticks, "trace_rumors": slots, "events": [
        {"at": 0, "op": "track", "node": n - 1},
        {"at": 0, "op": "track", "node": 1},
        {"at": 0, "op": "loss", "p": 0.05},
        {"at": 2, "op": "delay", "src": list(range(q)), "dst": list(range(q, 2 * q)),
         "delay": 1, "jitter": 1, "until": ticks - 8},
        {"at": 5, "op": "kill", "node": n - 1},
    ]}


def untraced(spec: dict) -> dict:
    """The spec without the plane: no slots, no ``track`` events."""
    return {"ticks": spec["ticks"],
            "events": [e for e in spec["events"] if e["op"] != "track"]}


def rung_spec(n: int, ticks: int, k: int) -> dict:
    """``benchmarks/bench_dissemination.py``'s ``_rung_spec`` (copied here:
    this script imports nothing of the JAX package): one kill at tick 4,
    whose suspect rumor auto-arms a slot."""
    return {"ticks": ticks, "trace_rumors": k,
            "events": [{"at": 4, "op": "kill", "node": n - 1}]}


def _same_protocol(torch, a: tuple, b: tuple, what: str) -> None:
    """Two runs' protocol trajectories equal: every trace series but the
    plane's, the state and the key (the plane only observes).  ``a`` and
    ``b`` are (trace, state fields, key)."""
    import numpy as np

    ta = {k: v for k, v in a[0].to_arrays().items() if "pv_" not in k}
    tb = {k: v for k, v in b[0].to_arrays().items() if "pv_" not in k}
    if ta.keys() != tb.keys():
        raise AssertionError(f"{what}: series differ ({sorted(ta)} vs {sorted(tb)})")
    for k, v in ta.items():
        if v.dtype != tb[k].dtype or not np.array_equal(v, tb[k]):
            raise AssertionError(f"{what}: series {k} differs")
    for f, x in a[1].items():
        y = b[1][f]
        if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
            raise AssertionError(f"{what}: state {f} differs")
    if not torch.equal(a[2], b[2]):
        raise AssertionError(f"{what}: keys differ")


def _prov_record(c, trace, cap, path: str) -> dict:
    """What m1 compares of a traced run: the trace, host copies of the
    cluster (every ``pv_*`` plane on the net), ``provenance_report()``,
    its summary block, the ``write_spans`` file and the stat calls."""
    from ringpop_tpu_torch.obs import provenance as pvn
    from ringpop_tpu_torch.obs import spans

    rep = c.provenance_report()
    spans.write_spans(rep, path)
    with open(path) as f:
        text = f.read()
    return {"trace": trace, "host": _host_copy(c), "report": rep,
            "summary": pvn.summary_block(rep), "spans": text,
            "stats": None if cap is None else list(cap.calls)}


def _same_prov(torch, a: dict, b: dict, what: str) -> None:
    _same_trace(a["trace"], b["trace"], what)
    _same_run(torch, a["host"], b["host"], what)
    for k in ("report", "summary", "spans", "stats"):
        if a[k] != b[k]:
            raise AssertionError(f"{what}: {k} differs")


def _prov_small(device: str, backend: str, cap=None):
    """m1's cluster: n = 256, suspicion 4, seed 3 (delta at phase 4's caps)."""
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.models.swim_sim import SwimParams

    caps = FAULT_CAPS_SMALL if backend == "delta" else {}
    return SimCluster(N_PROV_SMALL, SwimParams(suspicion_ticks=4), seed=3, device=device,
                      backend=backend, stats_emitter=cap, **caps)


def provenance_small_runs(device: str, tmp: str) -> dict:
    """m1's runs compared across devices, per backend: the traced run's
    record (``_prov_record``, with a ``CaptureEmitter`` sink) and a traced
    ``run_sweep`` of two replicas."""
    from ringpop_tpu_torch.obs import CaptureEmitter

    spec = prov_spec_small(N_PROV_SMALL, PROV_TICKS_SMALL)
    out = {}
    for backend in ("dense", "delta"):
        cap = CaptureEmitter()
        c = _prov_small(device, backend, cap)
        out[backend] = {
            "run": _prov_record(c, c.run_scenario(spec), cap,
                                os.path.join(tmp, f"{backend}-{device}.json")),
            "sweep": _prov_small(device, backend).run_sweep(spec, 2),
        }
    return out


def provenance_cpu_reference(path: str) -> None:
    """The CPU side of phase m1, run in a child process while the card
    works (``--provenance-cpu``): saved to ``path`` with ``torch.save``."""
    import torch

    torch.set_num_threads(EARLY_CPU_THREADS)
    t0 = time.perf_counter()
    tmp = os.path.dirname(path)
    out = provenance_small_runs("cpu", tmp)
    out["total_s"] = time.perf_counter() - t0
    log(f"m1 cpu runs {out['total_s']:.1f} s")
    torch.save(out, path + ".tmp")
    os.replace(path + ".tmp", path)




def check_provenance_cuda_equals_cpu(torch, cpu_ref: "CpuReference") -> dict:
    """Phase m1: a traced ``run_scenario`` at n = 256 (dense, and delta at
    phase 4's caps) on the card and on the CPU (the CPU's in the child
    process ``cpu_ref``) with a ``CaptureEmitter`` sink: every ``pv_*``
    plane, ``pv_heard``, every series, the state, the key, the report,
    its summary block, the spans file and the stat calls equal, and a
    traced ``run_sweep`` (R = 2) equal too.  On the card also: the
    untraced run from the seed has the same protocol trajectory; the run
    streamed in 10-tick segments has the whole run's result and stat
    calls; killed after its first checkpoint and resumed, it ends where
    the whole run does."""
    import shutil

    from ringpop_tpu_torch.obs import CaptureEmitter
    from ringpop_tpu_torch.scenarios import stream

    t0 = time.perf_counter()
    tmp = os.path.join(REPO, "ringpop_tpu_torch", "_build", "phase_m", "card")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    spec = prov_spec_small(N_PROV_SMALL, PROV_TICKS_SMALL)
    out = {}
    try:
        card_runs = provenance_small_runs("cuda", tmp)
        t_wait = time.perf_counter()
        cpu_runs = cpu_ref.result(torch)
        log(f"provenance (phase m1): the CPU side took {cpu_runs['total_s']:.1f} s in its child "
            f"process ({EARLY_CPU_THREADS} threads, started {time.perf_counter() - cpu_ref.t0:.1f} "
            f"s ago; waited {time.perf_counter() - t_wait:.1f} s for it)")
        for backend in ("dense", "delta"):
            what = f"provenance (phase m1) {backend}"
            card, cpu = card_runs[backend]["run"], cpu_runs[backend]["run"]
            _same_prov(torch, card, cpu, f"{what} cuda vs cpu")
            sweeps = card_runs[backend]["sweep"], cpu_runs[backend]["sweep"]
            _same_sweep(torch, sweeps[0], sweeps[1], f"{what} run_sweep cuda vs cpu")
            off = _prov_small("cuda", backend)
            t_off = off.run_scenario(untraced(spec))
            h_off = _host_copy(off)
            _same_protocol(torch, (card["trace"], card["host"]["state"], card["host"]["key"]),
                           (t_off, h_off["state"], h_off["key"]), f"{what} traced vs untraced")
            if off.net.pv_slot is not None:
                raise AssertionError(f"{what}: the untraced run left planes on the net")
            cap = CaptureEmitter()
            s = _prov_small("cuda", backend, cap)
            seg = _prov_record(s, s.run_scenario(spec, segment_ticks=PROV_SEGMENT_SMALL), cap,
                               os.path.join(tmp, f"{backend}-seg.json"))
            _same_prov(torch, seg, card, f"{what} streamed vs whole")
            ck = os.path.join(tmp, f"{backend}.npz")
            try:
                stream.run_streamed(_prov_small("cuda", backend), spec,
                                    segment_ticks=PROV_SEGMENT_SMALL, checkpoint_path=ck,
                                    interrupt_after=1)
                raise AssertionError(f"{what}: the streamed run was not killed")
            except stream.StreamInterrupted:
                pass
            r, tr = stream.resume(ck, device="cuda")
            res = _prov_record(r, tr, None, os.path.join(tmp, f"{backend}-res.json"))
            _same_prov(torch, res, {**card, "stats": None}, f"{what} resumed vs whole")
            by_slot = {x["slot"]: x for x in card["report"]["rumors"]}
            if by_slot.get(0, {}).get("subject") != N_PROV_SMALL - 1 or 1 in by_slot:
                raise AssertionError(f"{what}: the reservations did not behave ({sorted(by_slot)})")
            out[backend] = card["summary"]
            caps = FAULT_CAPS_SMALL if backend == "delta" else {}
            log(f"provenance (phase m1): {backend} run_scenario with trace_rumors="
                f"{spec['trace_rumors']} at n={N_PROV_SMALL} ({spec['ticks']} ticks: "
                f"reservations for node {N_PROV_SMALL - 1}, killed at 5, and node 1, 5% loss, a "
                f"delay rule{', caps ' + str(caps) if caps else ''}) cuda == cpu on every pv_* "
                f"plane, pv_heard, series, state, net field, the key, provenance_report(), "
                f"summary_block, the spans file ({len(card['spans'])} bytes) and "
                f"{len(card['stats'])} stat calls; run_sweep R=2 cuda == cpu (pv_heard "
                f"{tuple(sweeps[0].planes['pv_heard'].shape)}); on the card the untraced run the "
                f"same trajectory, streamed ({PROV_SEGMENT_SMALL}-tick segments) == whole with "
                f"its stat calls, killed after the first checkpoint and resumed == whole; "
                f"summary {card['summary']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"provenance (phase m1): {time.perf_counter() - t0:.1f} s")
    return out


def _check_planes(torch, c, trace, rep: dict, what: str) -> None:
    """The full-width planes on the card against what the report and the
    trace say of them: the knows bits are exactly ``first >= 0`` (the
    run revives no node, so no view falls back below a rumor); every
    parent >= 0 heard strictly earlier than its child (it knew at the
    start of the child's tick); each slot's last ``pv_heard`` equals the
    knows count and the report's ``infected`` of it."""
    from ringpop_tpu_torch.ops import bitpack

    net = c.net
    first, parent = net.pv_first, net.pv_parent
    k, n = first.shape
    if first.dtype != torch.int16 or parent.dtype != torch.int32 or not first.is_cuda:
        raise AssertionError(f"{what}: planes {first.dtype}/{parent.dtype} on {first.device}")
    knows = bitpack.unpack_bits(net.pv_knows, n)
    if not torch.equal(knows, first >= 0):
        bad = int((knows != (first >= 0)).sum())
        raise AssertionError(f"{what}: {bad} knows bits differ from first_heard >= 0")
    has = parent >= 0
    pf = torch.gather(first, 1, parent.clamp(0, n - 1).long())
    late = int((has & ((pf < 0) | (pf >= first))).sum())
    if late:
        raise AssertionError(f"{what}: {late} parents did not hear before their child")
    heard = knows.sum(dim=1).cpu().tolist()
    last = [int(x) for x in trace.planes["pv_heard"][-1]]
    if last != heard:
        raise AssertionError(f"{what}: pv_heard[-1] {last} != knows counts {heard}")
    for x in rep["rumors"]:
        if x["infected"] != last[x["slot"]]:
            raise AssertionError(f"{what}: slot {x['slot']} infected {x['infected']} != "
                                 f"pv_heard[-1] {last[x['slot']]}")
    log(f"{what}: on the card, the [{k}, {n}] planes: knows == (first >= 0), "
        f"{int(has.sum())} parent edges each heard earlier than its child, pv_heard[-1] == "
        f"each rumor's infected")


def dissemination(torch, backend: str, n: int, caps: dict, slots: tuple, label: str) -> dict:
    """Phases m2 and m3: the dissemination ladder's rung at full width
    (``rung_spec(n, 48, k)``, ``SwimParams(suspicion_ticks=8)``, seed 7)
    untraced and with each slot count in ``slots``, from one seed: the
    kill's rumor (infected, depth, p50/p95/p99, p99 / ceil(log2 n)),
    each arm's ms and host syncs a tick and peak; the protocol series,
    state and key equal to the untraced run's, and no more host syncs a
    tick.  If the rumor has not reached every live node by tick 48 the
    rung runs again to 96.  Returns the kernels' launches summed over the
    arms and kernel 3's launches by (C, K) in each."""
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.models.swim_sim import SwimParams
    from ringpop_tpu_torch.ops.searchsorted import row_searchsorted

    t0 = time.perf_counter()
    params = SwimParams(suspicion_ticks=8)

    def make():
        return SimCluster(n, params, seed=RUNG_SEED, device="cuda", backend=backend, **caps)

    ticks = RUNG_TICKS
    while True:
        arms = {}
        first = None  # the untraced run's (trace, state, key), on the card
        for k in (0, *slots):
            c, trace, r = _scenario_arm(torch, "run_scenario", make, rung_spec(n, ticks, k))
            r["shapes"] = dict(row_searchsorted.shapes)
            run = (trace, c.state._asdict(), c.key)
            if k:
                _same_protocol(torch, run, first, f"provenance {label} k={k} vs untraced")
            else:
                first = run
            arms[k] = (r, c.provenance_report() if k else None)
            if k:
                _check_planes(torch, c, trace, arms[k][1], f"provenance {label} k={k}")
            del c, run
        del first
        rumor = [x for x in arms[slots[0]][1]["rumors"] if x["subject"] == n - 1]
        if (rumor and rumor[0]["infected"] == n - 1) or ticks > RUNG_TICKS:
            break
        log(f"provenance {label}: the kill's rumor reached "
            f"{rumor[0]['infected'] if rumor else 0} of {n - 1} live nodes by tick {ticks}; "
            f"running the rung to {2 * RUNG_TICKS} ticks")
        ticks = 2 * RUNG_TICKS
    if not rumor:
        raise AssertionError(f"provenance {label}: the kill armed no slot")
    bound = max(1, math.ceil(math.log2(n)))
    x = rumor[0]
    log(f"provenance {label}: rung n={n} {backend}{' ' + str(caps) if caps else ''}, "
        f"{ticks} ticks, seed {RUNG_SEED}, suspicion 8: the kill of node {n - 1} at tick 4 "
        f"armed slot {x['slot']} at tick {x['origin_tick']} (origin node {x['origin']}, "
        f"resolution {x['resolution']} at tick {x['resolution_tick']}); infected "
        f"{x['infected']}/{n}, depth {x['depth_max']}, infect p50/p95/p99 "
        f"{x['infection_p50']}/{x['infection_p95']}/{x['infection_p99']} ticks, log2(n) "
        f"{bound}, p99/bound {x['infection_p99'] / bound:.2f}, stragglers {x['stragglers']}, "
        f"unattributed {x['unattributed']}")
    launches: dict[str, int] = {}
    base = arms[0][0]
    for k, (r, rep) in arms.items():
        what = "untraced" if not k else f"trace_rumors={k}"
        log(f"provenance {label} {what}: {r['ms_per_tick']:.3f} ms per tick over {ticks} "
            f"ticks, host syncs {r['syncs']} ({r['syncs_per_tick']:.2f} per tick), peak "
            f"{r['peak_gib']:.2f} GiB over the start, launches {r['launches']}"
            + (f", rumors {len(rep['rumors'])}" if rep else "")
            + (f", row_searchsorted by (C, K) {dict(sorted(r['shapes'].items()))}"
               if backend == "delta" else ""))
        if r["syncs_per_tick"] > base["syncs_per_tick"]:
            raise AssertionError(f"provenance {label}: {what} takes {r['syncs_per_tick']:.2f} "
                                 f"host syncs a tick, the untraced run "
                                 f"{base['syncs_per_tick']:.2f}")
        for name, v in r["launches"].items():
            launches[name] = launches.get(name, 0) + v
    if backend == "delta":
        c_cap = caps["capacity"]
        for k in slots:
            if k <= 4:
                continue  # at most 4 queries a row take the fused compare, not kernel 3
            extra = arms[k][0]["shapes"].get((c_cap, k), 0) - base["shapes"].get((c_cap, k), 0)
            if extra != ticks:
                raise AssertionError(f"provenance {label}: trace_rumors={k} launched kernel 3 "
                                     f"at ({c_cap}, {k}) {extra} more times than the untraced "
                                     f"run, not once a tick ({ticks})")
            log(f"provenance {label}: trace_rumors={k}: the fold's [N, {c_cap}] x [N, {k}] "
                f"lookup launched kernel 3 once a tick ({extra} over {ticks} ticks beyond the "
                f"untraced run's)")
    log(f"provenance {label}: {time.perf_counter() - t0:.1f} s")
    return launches


def stats_bridge(torch, n: int = N_MAIN) -> dict:
    """Phase m4: ``SimCluster(stats_emitter=CaptureEmitter())`` at BASELINE
    config 3's protocol: a ``tick`` loop, a ``run_scenario`` and the same
    run streamed.  Every key is in ``obs.bridge``'s tables or carries the
    ``sim.`` prefix; each increment's total equals the trace series it
    replays (``membership-update.alive``: the bootstrap live count and
    the rises); the run closes with the checksum gauge of the first live
    node; the streamed run emits the whole run's calls.  Returns the
    kernels' launches."""
    import numpy as np

    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.models.swim_sim import SwimParams
    from ringpop_tpu_torch.obs import CaptureEmitter, bridge

    t0 = time.perf_counter()
    _reset_counts()
    _counted_recv_merge_reset()
    params = SwimParams(loss=0.01)
    known = (set(bridge.REFERENCE_KEYS) | set(bridge.TRAFFIC_COUNTER_KEYS.values())
             | set(bridge.TRAFFIC_TIMING_KEYS.values()))
    pre = bridge.DEFAULT_PREFIX + "."

    def check_keys(cap, what):
        bad = {k for k in cap.suffixes(bridge.DEFAULT_PREFIX)
               if k not in known and not k.startswith("sim.")}
        if bad:
            raise AssertionError(f"stats bridge (phase m4) {what}: keys outside the tables {bad}")

    cap = CaptureEmitter()
    c = SimCluster(n, params, seed=0, device="cuda", stats_emitter=cap)
    logged = [c.tick() for _ in range(5)]
    check_keys(cap, "tick loop")
    for series, key in bridge.PROTOCOL_COUNTER_KEYS.items():
        if cap.counters[pre + key] != sum(m[series] for m in logged):
            raise AssertionError(f"stats bridge (phase m4) tick loop: {key} total differs")
    if cap.gauges[pre + "num-members"] != len(c.live_indices()):
        raise AssertionError("stats bridge (phase m4) tick loop: num-members differs")
    n_tick = len(cap.calls)
    runs = []
    for seg in (None, BRIDGE_SEGMENT):
        cap = CaptureEmitter()
        c = SimCluster(n, params, seed=0, device="cuda", stats_emitter=cap)
        trace = c.run_scenario(rung_spec(n, BRIDGE_TICKS, 0), segment_ticks=seg)
        what = "run_scenario" if seg is None else f"streamed ({seg}-tick segments)"
        check_keys(cap, what)
        for series, key in bridge.PROTOCOL_COUNTER_KEYS.items():
            if cap.counters[pre + key] != int(trace.metrics[series].sum()):
                raise AssertionError(f"stats bridge (phase m4) {what}: {key} total differs")
        ups = np.diff(trace.live.astype(np.int64), prepend=0)
        if cap.counters[pre + "membership-update.alive"] != int(ups[ups > 0].sum()):
            raise AssertionError(f"stats bridge (phase m4) {what}: alive total differs")
        if cap.calls[-1] != ("gauge", pre + "checksum", c.first_live_checksum()):
            raise AssertionError(f"stats bridge (phase m4) {what}: no closing checksum gauge")
        runs.append(cap)
    if runs[0].calls != runs[1].calls:
        raise AssertionError("stats bridge (phase m4): the streamed run's stat calls differ")
    launches = {**_kernel_counts()}
    log(f"stats bridge (phase m4): n={n} dense loss 0.01 with a CaptureEmitter sink: 5 tick() "
        f"calls ({n_tick} stat calls), run_scenario of {BRIDGE_TICKS} ticks (a kill at 4; "
        f"{len(runs[0].calls)} calls) and the same in {BRIDGE_SEGMENT}-tick segments (the same "
        f"calls): every key in the bridge's tables or sim.*, each increment total == its trace "
        f"series, the closing checksum gauge {runs[0].calls[-1][2]}; "
        f"{time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches


def provenance_phase(torch, cpu_ref: "CpuReference") -> dict:
    """Phase m: m1 cuda == cpu at n = 256 (the CPU side from ``cpu_ref``),
    m2 the dissemination rung at n = 10 000 dense, m3 at n = 65 536 delta
    (the plane at its cap too), m4 the stats bridge; returns the
    kernels' launches summed over m2-m4."""
    t0 = time.perf_counter()
    check_provenance_cuda_equals_cpu(torch, cpu_ref)
    launches: dict[str, int] = {}
    for more in (dissemination(torch, "dense", N_MAIN, {}, (RUNG_SLOTS,), "(phase m2)"),
                 dissemination(torch, "delta", N_DELTA, DELTA_CAPS,
                               (RUNG_SLOTS, PROV_CAP_SLOTS), "(phase m3)"),
                 stats_bridge(torch)):
        for k, v in more.items():
            launches[k] = launches.get(k, 0) + v
    for k in ("recv_merge", "row_searchsorted", "merge_insert", "farmhash32"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"provenance (phase m): kernel {k} was not launched")
    log(f"provenance (phase m): {time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches



# ---------------------------------------------------------------------------
# phase n: the incident library and the tick-cluster CLI
# ---------------------------------------------------------------------------

INCIDENT_N = 64  # BASELINE.md round 8/9's size (BASELINE.md:752-765)
INCIDENT_SEED = 3
INCIDENT_SEGMENT = 32  # the CLI's default segments for an incident
CLI_SCRIPT = "j,t,k,w7800,t,K,w7800,t,s,q"  # n3: kill, converge, revive, converge
CLI_SEGMENT = 27  # n3's streamed form: the script's 81-tick scenario in three segments
INCIDENT_GOLDEN_PROCS = 4  # n1's processes on the card, beside n2's and n3's
INCIDENT_CLI_PROCS = 3  # n2's
# n2's runs timed again in one process alone on the card, after the rest
SOLO_JOBS = ("cascading_overload/dense/", "cascading_overload/delta/")
# BASELINE.md:767-772 (round 8, n = 64: goodput, amplification) and
# :853-860 (the per-policy scorecards at the golden n = 16, dense: bare
# and combined goodput / amplification), measured under jax 0.4.37's
# threefry mode: printed beside the port's, not asserted
BASELINE_ROUND8 = {"feedback": (0.766, 2.71), "control": (1.000, 1.00)}
BASELINE_SCORECARDS = {
    "region_partition_asym_heal": ((1.000, 1.00), (1.000, 1.00)),
    "cascading_overload": ((0.805, 2.37), (1.000, 1.00)),
    "deploy_during_partition": ((0.991, 1.04), (0.996, 1.02)),
    "slow_network_hot_key": ((1.000, 1.00), (1.000, 1.00)),
    "thundering_rejoin": ((0.952, 1.20), (0.953, 1.07)),
    "gray_failure_storm": ((0.922, 1.40), (0.958, 1.19)),
    "brownout_loss_ramp": ((0.990, 1.09), (0.994, 1.04)),
    "hot_tenant_blackhole": ((1.000, 1.00), (1.000, 1.00)),
}


def golden_grid() -> list:
    """The 29 (incident, backend, policy) runs pinned under
    ``tests/golden/incidents/``: every incident on each backend it runs
    on, and ``library.policy_golden_grid``'s policy-armed triples."""
    from ringpop_tpu_torch.scenarios import library as lib

    grid = [(name, backend, None) for name in lib.incident_names()
            for backend in lib.INCIDENTS[name].backends]
    return grid + [(name, backend, policy) for name, policy, backend in lib.policy_golden_grid()]


def _share(items: list, cost, i: int, k: int) -> list:
    """The i-th of k shares of ``items`` of about equal ``cost``: the
    costliest first, each to the share that holds the least."""
    loads, shares = [0.0] * k, [[] for _ in range(k)]
    for item in sorted(items, key=cost, reverse=True):
        j = loads.index(min(loads))
        shares[j].append(item)
        loads[j] += cost(item)
    return shares[i]


def _run_cost(name: str, backend: str, runs: int = 1) -> float:
    """A run's share of a phase n process: its ticks, a delta tick
    counted as 2.5 dense ones (its ~12-24 host syncs a tick)."""
    from ringpop_tpu_torch.scenarios import library as lib

    return runs * lib.INCIDENTS[name].default_ticks * (2.5 if backend == "delta" else 1.0)


def golden_runs(device: str, part: int = 0, parts: int = 1) -> dict:
    """The summary of each golden run of the ``part``-th of ``parts``
    shares on ``device``, in the threefry mode the files were pinned in
    (jax 0.4.37's non-partitionable one)."""
    from ringpop_tpu_torch import prng
    from ringpop_tpu_torch.scenarios import library as lib

    out = {}
    with prng.partitionable_mode(False):
        for name, backend, policy in _share(golden_grid(), lambda r: _run_cost(*r[:2]),
                                            part, parts):
            out[(name, backend, policy)] = lib.run_golden(name, backend, policy, device=device)
    return out


def incidents_cpu_reference(path: str) -> None:
    """The CPU side of phase n1, run in a child process while the card
    works (``--incidents-cpu``): the 29 golden summaries, saved to
    ``path`` with ``torch.save``."""
    import torch

    torch.set_num_threads(EARLY_CPU_THREADS)
    t0 = time.perf_counter()
    out = {"runs": golden_runs("cpu")}
    out["total_s"] = time.perf_counter() - t0
    log(f"n1 cpu golden runs {out['total_s']:.1f} s")
    torch.save(out, path + ".tmp")
    os.replace(path + ".tmp", path)


def _goodput_amp(s: dict) -> tuple[float, float]:
    return s["delivered"] / max(s["lookups"], 1), s["sends"] / max(s["delivered"], 1)


def check_golden_cuda_equals_cpu(torch, cpu_ref: "CpuReference", parts: list[dict],
                                 wall: float) -> dict:
    """Phase n1: the 29 golden runs (n = 16, seed 3, segments of 32) the
    card processes ``parts`` made equal the CPU child's, summary for
    summary, and the pinned files where the checkout has them; returns
    the kernels' launches (the processes')."""
    card = {k: v for r in parts for k, v in r["runs"].items()}
    launches = {k: sum(r["launches"][k] for r in parts) for k in parts[0]["launches"]}
    if set(card) != set(golden_grid()):
        raise AssertionError("incidents (phase n1): the card processes missed golden runs")
    t_wait = time.perf_counter()
    cpu = cpu_ref.result(torch)
    log(f"incidents (phase n1): CPU golden runs took {cpu['total_s']:.1f} s in the child "
        f"(started {time.perf_counter() - cpu_ref.t0:.1f} s ago; waited "
        f"{time.perf_counter() - t_wait:.1f} s for it)")
    golden_dir = os.path.join(REPO, "tests", "golden", "incidents")
    pinned = 0
    for key, s in card.items():
        if s != cpu["runs"][key]:
            diff = {k: (s.get(k), cpu["runs"][key].get(k)) for k in set(s) | set(cpu["runs"][key])
                    if s.get(k) != cpu["runs"][key].get(k)}
            raise AssertionError(f"incidents (phase n1) {key}: cuda != cpu: {diff}")
        name, backend, policy = key
        stem = f"{name}+{policy}" if policy else name
        path = os.path.join(golden_dir, f"{stem}.{backend}.json")
        if os.path.exists(path):
            with open(path) as f:
                if json.load(f) != s:
                    raise AssertionError(f"incidents (phase n1) {key}: != {path}")
            pinned += 1
    ticks = sum(s["ticks"] for s in card.values())
    log(f"incidents (phase n1): {len(card)} golden runs cuda == cpu, summary for summary; "
        f"{pinned} equal to their pinned files; {ticks} ticks in {len(parts)} processes "
        f"(each {[round(r['wall'], 1) for r in parts]} s after its start; phase n's card "
        f"processes {wall:.1f} s in all); launches {launches}")
    for name, (bare, comb) in BASELINE_SCORECARDS.items():
        g0, a0 = _goodput_amp(card[(name, "dense", None)])
        g1, a1 = _goodput_amp(card[(name, "dense", "combined")])
        log(f"incidents (phase n1): {name} dense goodput / amplification bare {g0:.3f} / "
            f"{a0:.2f}, combined {g1:.3f} / {a1:.2f} (BASELINE.md:853-860, the "
            f"reference's CPU: {bare[0]:.3f} / {bare[1]:.2f}, {comb[0]:.3f} / {comb[1]:.2f})")
    for k in ("recv_merge", "farmhash32_short", "row_searchsorted", "merge_insert"):
        if launches[k] <= 0:
            raise AssertionError(f"incidents (phase n1): kernel {k} was not launched")
    return launches


def _cli_in_process(torch, argv: list[str]) -> tuple[str, dict]:
    """``tick_cluster.main(argv)`` in this process on the card: its printed
    lines, wall, host syncs (outside revives) and peak over the start."""
    import io

    from ringpop_tpu_torch.cli import tick_cluster

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    sink: dict = {}
    t0 = time.perf_counter()
    with _syncs(torch, sink), contextlib.redirect_stdout(buf):
        tick_cluster.main(argv)
    torch.cuda.synchronize()
    return buf.getvalue(), {"wall": time.perf_counter() - t0,
                            "syncs": sink["syncs"] - sink.get("revive_syncs", 0),
                            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}


def _summary_of(out: str, name: str) -> str:
    lines = [ln for ln in out.splitlines() if ln.startswith(f"incident {name}:")]
    if len(lines) != 1:
        raise AssertionError(f"incidents (phase n2) {name}: no summary line in:\n{out}")
    return lines[0]


def cli_jobs() -> list[tuple[str, list[str]]]:
    """Phase n2's CLI runs, (label, argv): ``--incident NAME -n 64 --seed
    3 --segment-ticks 32`` for each incident on each backend it runs on
    (delta at capacity n), and cascading_overload with ``--policy
    combined`` (control and policy arm)."""
    from ringpop_tpu_torch.scenarios import library as lib

    base = ["--backend", "tpu-sim", "-n", str(INCIDENT_N), "--seed", str(INCIDENT_SEED)]
    jobs = []
    for name in lib.incident_names():
        for backend in lib.INCIDENTS[name].backends:
            for policy in ((None, "combined") if name == "cascading_overload" else (None,)):
                argv = base + ["--incident", name, "--segment-ticks", str(INCIDENT_SEGMENT)]
                if backend == "delta":
                    argv += ["--layout", "delta", "--capacity", str(INCIDENT_N)]
                if policy:
                    argv += ["--policy", policy]
                jobs.append((f"{name}/{backend}/{policy or ''}", argv))
    return jobs


def _check_script(out: str, n: int) -> list[str]:
    """The script's printed lines: three ``tick:`` lines, converged at n,
    at n - 1 after the kill and at n after the revive (``CLI_SCRIPT``),
    and one checksum group; returns the ``tick:`` lines."""
    ticks = [ln.split("  (")[0] for ln in out.splitlines() if ln.startswith("tick:")]
    groups = [ln for ln in out.splitlines() if ln.startswith("  checksum ")]
    if (len(ticks) != 3 or f"CONVERGED [{n - 1}]" not in ticks[1]
            or f"CONVERGED [{n}]" not in ticks[2] or len(groups) != 1):
        raise AssertionError(f"incidents (phase n3): the script did not converge:\n{out}")
    return ticks


def _incident_line(label: str, out: str, r: dict, how: str) -> str:
    """The summary of one ``cli_jobs`` incident run with its ms and host
    syncs a tick and peak, ``how`` saying what shared the card."""
    from ringpop_tpu_torch.scenarios import library as lib

    name, backend, policy = label.split("/")
    line = _summary_of(out, name)
    if "CONVERGED" not in out and "NOT converged" not in out:
        raise AssertionError(f"incidents (phase n2) {name}: no scenario line:\n{out}")
    runs = 2 if policy else 1
    ticks = runs * lib.INCIDENTS[name].default_ticks
    return (f"{backend}{' --policy ' + policy if policy else ''}: {line}; "
            f"{r['wall'] * 1e3 / ticks:.3f} ms a tick {how} over {ticks} ticks ({runs} "
            f"run{'s' if runs > 1 else ''}), host syncs {r['syncs'] / ticks:.2f} a tick, peak "
            f"{r['peak_gib']:.3f} GiB")


def _job_cost(job: tuple[str, list[str]]) -> float:
    name, backend, policy = job[0].split("/")
    return _run_cost(name, backend, 2 if policy else 1)


def check_cli_incidents(parts: list[dict], procs: int) -> dict:
    """Phase n2: the CLI runs of ``cli_jobs`` the card processes ``parts``
    made, in the jobs' order: each incident prints its summary, with ms and host syncs a tick and peak (ms
    contended: ``procs`` processes of phase n on the card), and
    cascading_overload's scorecard and A/B beside BASELINE.md's round 8.
    Returns the kernels' launches."""
    done = {label: (out, r) for p in parts for label, out, r in p["n2"]}
    for label, _ in cli_jobs():
        out, r = done[label]
        log(f"incidents (phase n2) {_incident_line(label, out, r, f'contended ({procs} processes on the card)')}")
        name, backend, policy = label.split("/")
        if name != "cascading_overload":
            continue
        line = _summary_of(out, name)
        if policy:
            (ab,) = [ln for ln in out.splitlines() if ln.startswith("policy ")]
            log(f"incidents (phase n2) {backend}: {ab} (BASELINE.md:767-772, the reference's "
                f"CPU, jax 0.4.37's PRNG mode: feedback {BASELINE_ROUND8['feedback'][0]:.3f} / "
                f"{BASELINE_ROUND8['feedback'][1]:.2f}; BASELINE.md:854 combined at n = 16 "
                f"1.000 / 1.00)")
        else:
            m = line.split("goodput ")[1]
            log(f"incidents (phase n2) {backend}: cascading_overload goodput "
                f"{m.split(',')[0]}, amplification {m.split('amplification ')[1].split(',')[0]} "
                f"(BASELINE.md:767-772 feedback {BASELINE_ROUND8['feedback'][0]:.3f} / "
                f"{BASELINE_ROUND8['feedback'][1]:.2f}, recorded, not asserted)")
    launches = {k: sum(p["launches"][k] for p in parts) for k in parts[0]["launches"]}
    for k in ("recv_merge", "farmhash32", "farmhash32_short", "row_searchsorted",
              "merge_insert"):
        if launches[k] <= 0:
            raise AssertionError(f"incidents (phase n2): kernel {k} was not launched")
    log(f"incidents (phase n2): {len(done)} CLI runs in {len(parts)} processes (each "
        f"{[round(p['wall'], 1) for p in parts]} s after its start); launches {launches}")
    return launches


def check_cli_solo(part: dict) -> dict:
    """Phase n2's ``SOLO_JOBS`` rerun in one process alone on the card,
    after the others: their ms and host syncs a tick uncontended, and
    the same summary line as in the shared run.  Returns the kernels'
    launches."""
    for label, out, r in part["solo"]:
        log(f"incidents (phase n2, alone) {_incident_line(label, out, r, 'alone on the card')}")
    return part["launches"]


def check_n3(part: dict) -> dict:
    """Phase n3's checks on ``n3_runs``' results: the script converged at
    9 999 after the kill and at 10 000 after the revive, in one checksum
    group, through the receiver merge and FarmHash's warp kernel (each
    launched in the script's own run), with a non-empty profile
    directory and a ledger row for each of its tick() calls (``swim_step``
    or ``swim_run``, cold once each); the scenario form converged at
    9 999 before the revive and at 10 000 at the end (``--trace-out``),
    with one cold ledger row and warm rows for its one segment shape;
    ``obs-ledger`` summarizes the file.  Returns the kernels' launches of both runs."""
    import io
    from collections import Counter
    import shutil

    from ringpop_tpu_torch import __main__ as entry
    from ringpop_tpu_torch.obs import ledger
    from ringpop_tpu_torch.scenarios.spec import ScenarioSpec
    from ringpop_tpu_torch.scenarios.trace import Trace

    d = n3_dir()
    runs = part["n3"]
    out, r, la = runs["script"]
    ticks = _check_script(out, N_MAIN)
    for k in ("recv_merge", "farmhash32"):
        if la[k] <= 0:
            raise AssertionError(f"incidents (phase n3): kernel {k} was not launched by the "
                                 f"script's run: {la}")
    prof = os.path.join(d, "profile")
    traces = [f for f in os.listdir(prof) if os.path.getsize(os.path.join(prof, f))]
    if not traces:
        raise AssertionError("incidents (phase n3): the profile directory is empty")
    prof_mb = sum(os.path.getsize(os.path.join(prof, f)) for f in traces) / 2**20
    log(f"incidents (phase n3): tick-cluster -n {N_MAIN} --loss 0.01 --script {CLI_SCRIPT} "
        f"--profile-dir (profiled, in one of phase n's processes on the card): "
        f"{' | '.join(ticks)}; one checksum group; {r['wall']:.1f} s, host syncs {r['syncs']}, "
        f"peak {r['peak_gib']:.2f} GiB; trace {len(traces)} file(s), {prof_mb:.1f} MiB; "
        f"launches {la}")
    out, r, la_scen = runs["scenario"]
    spec = ScenarioSpec.load(os.path.join(d, "script.json"))
    final = [ln for ln in out.splitlines() if ln.startswith("final checksums:")]
    trace = Trace.load(os.path.join(d, "trace.npz"))
    revive = min(e.at for e in spec.events if e.op == "revive")
    if (len(final) != 1 or len(final[0].split()) != 3
            or not (trace.converged[revive - 1] and trace.live[revive - 1] == N_MAIN - 1)
            or not (trace.converged[-1] and trace.live[-1] == N_MAIN)):
        raise AssertionError(f"incidents (phase n3): the scenario did not converge:\n{out}")
    led_path = os.path.join(d, "ledger.jsonl")
    rows = ledger.DispatchLedger.load_rows(led_path)
    # the script's ticks first (a row a tick() call: tick(1) as swim_step,
    # each w7800's tick(39) as swim_run, cold once each), then the
    # scenario form's segments (cold once for its one segment shape)
    ticked = [row for row in rows if row["program"] != "run_scenario"]
    scen = rows[len(ticked):]
    cold = [row for row in scen if row["cold"]]
    shapes = {(row["program"], row["ticks"]) for row in ticked}
    if (sorted({row["ticks"] for row in scen}) != [CLI_SEGMENT] or len(cold) != 1
            or not scen[0]["cold"] or len(scen) < 2
            or {row["program"] for row in scen} != {"run_scenario"}
            or {row["program"] for row in ticked} != {"swim_step", "swim_run"}
            or sum(row["cold"] for row in ticked) != len(shapes)
            or any(row["backend"] != "dense" or row["n"] != N_MAIN or row["replicas"] != 1
                   for row in ticked)
            or any(row["platform"] != "gpu" for row in rows)):
        raise AssertionError(f"incidents (phase n3): ledger rows {rows}")
    buf, argv = io.StringIO(), sys.argv
    sys.argv = ["ringpop_tpu_torch", "obs-ledger", led_path]
    try:
        with contextlib.redirect_stdout(buf):
            entry.main()
    finally:
        sys.argv = argv
    summary = buf.getvalue()
    if f"{len(rows)} dispatches in" not in summary or "1 streamed soaks:" not in summary:
        raise AssertionError(f"incidents (phase n3): obs-ledger printed:\n{summary}")
    log(f"incidents (phase n3): the script compiled to a scenario, tick-cluster --scenario "
        f"--segment-ticks {CLI_SEGMENT} with RINGPOP_LEDGER set: {final[0]}; converged at "
        f"{N_MAIN - 1} live before the revive at tick {revive}, at {N_MAIN} at the end; "
        f"{r['wall'] * 1e3 / spec.ticks:.3f} ms a tick (contended); ledger {len(scen)} rows "
        f"({len(cold)} cold), peak {max(row['peak_bytes'] for row in scen) / 2**30:.2f} GiB, "
        f"after the script's {len(ticked)} tick rows ({sum(r['cold'] for r in ticked)} cold, "
        f"{dict(Counter(r['program'] for r in ticked))}); "
        f"obs-ledger: {' | '.join(ln.strip() for ln in summary.splitlines()[1:])}; "
        f"launches {la_scen}")
    shutil.rmtree(d, ignore_errors=True)
    return part["launches"]


def incidents_phase(torch, cpu_ref: "CpuReference") -> dict:
    """Phase n: n1's golden runs, n2's CLI runs and n3 in
    ``INCIDENT_GOLDEN_PROCS`` + ``INCIDENT_CLI_PROCS`` + 1 processes on
    the card at once (n1 and n2 host-bound), then ``SOLO_JOBS`` in one
    process alone; then n1 cuda == cpu (the CPU side from ``cpu_ref``),
    n2's summaries and n3's checks.  Returns the kernels' launches of
    all of them."""
    import shutil

    from ringpop_tpu_torch.obs import ledger

    t0 = time.perf_counter()
    d = n3_dir()
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    parts = ([f"n1:{i}:{INCIDENT_GOLDEN_PROCS}" for i in range(INCIDENT_GOLDEN_PROCS)]
             + [f"n2:{i}:{INCIDENT_CLI_PROCS}" for i in range(INCIDENT_CLI_PROCS)] + ["n3:0:1"])
    workers = CardWorkers(parts, env={"n3:0:1": {
        ledger.ENV_VAR: os.path.join(d, "ledger.jsonl"), "PYTHONPATH": REPO}})
    solo = None
    try:
        done = workers.results(torch)
        wall = time.perf_counter() - workers.t0
        solo = CardWorkers(["solo:0:1"])
        (alone,) = solo.results(torch)
        solo_wall = time.perf_counter() - solo.t0
        launches: dict[str, int] = {}
        for more in (check_golden_cuda_equals_cpu(torch, cpu_ref, [p for p in done if "runs" in p],
                                                  wall),
                     check_cli_incidents([p for p in done if "n2" in p], len(parts)),
                     check_cli_solo(alone),
                     check_n3(next(p for p in done if "n3" in p))):
            for k, v in more.items():
                launches[k] = launches.get(k, 0) + v
    finally:
        workers.stop()
        if solo is not None:
            solo.stop()
    log(f"incidents (phase n): {time.perf_counter() - t0:.1f} s (the shared processes "
        f"{wall:.1f} s, the one alone {solo_wall:.1f} s); "
        f"launches {launches}")
    return launches


def n3_dir() -> str:
    return os.path.join(REPO, "ringpop_tpu_torch", "_build", "phase_n3")


def n3_runs(torch) -> dict:
    """Phase n3, in its card process (``RINGPOP_LEDGER`` set to
    ``n3_dir()/ledger.jsonl`` in its environment): ``tick_cluster.main``
    at BASELINE config 3 (n = 10 000, 1% loss), first the script with
    ``--profile-dir``, then the script compiled to a scenario
    (``script_to_spec``) with ``--scenario`` in three 27-tick segments
    and ``--trace-out`` (the ledger's rows); each with its printed
    lines, wall, syncs, peak and the kernels' launches, each counted
    from 0."""
    from ringpop_tpu_torch.scenarios.spec import script_to_spec

    d = n3_dir()
    spec = script_to_spec(CLI_SCRIPT, N_MAIN)
    spec.save(os.path.join(d, "script.json"))
    base = ["--backend", "tpu-sim", "-n", str(N_MAIN), "--loss", "0.01", "--seed", "0"]
    out = {}
    for label, argv in (
            ("script", base + ["--script", CLI_SCRIPT, "--profile-dir",
                               os.path.join(d, "profile")]),
            ("scenario", base + ["--scenario", os.path.join(d, "script.json"),
                                 "--segment-ticks", str(CLI_SEGMENT), "--trace-out",
                                 os.path.join(d, "trace.npz")])):
        _reset_counts()
        _counted_recv_merge_reset()
        printed, r = _cli_in_process(torch, argv)
        out[label] = (printed, r, _serve_counts())
    return out


def incidents_card_worker(part: str, path: str) -> None:
    """One of phase n's processes on the card (``--incidents-card
    KIND:I:K``): for ``n1`` the I-th of K shares of the golden runs; for
    ``n2`` that of ``cli_jobs``; for ``solo`` those of
    ``SOLO_JOBS``; for ``n3`` ``n3_runs``; with the kernels' launches
    they made, saved to ``path`` with ``torch.save``.  At n = 16 and 64
    a served tick is host-bound (the card idles between ~1 000 small
    launches), so n1, n2 and n3 share the card in several processes;
    ``solo`` runs alone after them, for ms a tick without the others."""
    import torch

    kind, i, k = part.split(":")
    i, k = int(i), int(k)
    torch.set_num_threads(1)
    _reset_counts()
    _counted_recv_merge_reset()
    t0 = time.perf_counter()
    if kind == "n1":
        out = {"runs": golden_runs("cuda", i, k)}
    elif kind == "n3":
        out = {"n3": n3_runs(torch)}
    else:
        jobs = _share(cli_jobs(), _job_cost, i, k) if kind == "n2" else [
            j for j in cli_jobs() if j[0] in SOLO_JOBS]
        out = {kind: [(label, *_cli_in_process(torch, argv)) for label, argv in jobs]}
    torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t0
    out["launches"] = (_serve_counts() if kind != "n3" else
                       {key: sum(r[2][key] for r in out["n3"].values())
                        for key in _serve_counts()})
    torch.save(out, path + ".tmp")
    os.replace(path + ".tmp", path)


class CardWorkers:
    """Phase n's processes on the card (``incidents_card_worker``), one
    for each of ``parts``, started together (stopped at exit either
    way); ``env`` adds to the environment of the parts it names."""

    def __init__(self, parts: list[str], env: dict[str, dict[str, str]] | None = None):
        self.dir = os.path.join(REPO, "ringpop_tpu_torch", "_build", "phase_n_card")
        os.makedirs(self.dir, exist_ok=True)
        self.t0 = time.perf_counter()
        self.procs = []
        for part in parts:
            stem = os.path.join(self.dir, part.replace(":", "_"))
            if os.path.exists(stem + ".pt"):
                os.remove(stem + ".pt")
            log_f = open(stem + ".log", "w")
            self.procs.append((stem + ".pt", log_f, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--incidents-card", part,
                 stem + ".pt"], cwd=REPO, stdout=log_f, stderr=subprocess.STDOUT,
                env={**os.environ, **(env or {}).get(part, {})})))

    def results(self, torch) -> list[dict]:
        out = []
        for path, log_f, proc in self.procs:
            rc = proc.wait(timeout=SERVE_CPU_TIMEOUT)
            log_f.flush()
            if rc != 0:
                with open(log_f.name) as f:
                    tail = f.read()[-3000:]
                raise AssertionError(f"incidents (phase n): a card process failed:\n{tail}")
            out.append(torch.load(path, weights_only=False))
        return out

    def stop(self) -> None:
        for _, log_f, proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_f.close()


# ---------------------------------------------------------------------------
# phase o: the trace-contract auditor on the card
# ---------------------------------------------------------------------------

AUDIT_N = 64  # the audit's fixture size (its CLI default)
AUDIT_TICKS = 4
# run_scenario at 4 ticks: the byte rows (the reference's three) and the
# sync rows at the main paths' sizes, each with its tick(1) companion
AUDIT_BIG = (("dense", 4096), ("delta", 4096), ("dense", N_MAIN), ("delta", N_DELTA))
AUDIT_TIMEOUT = 300


def _audit_row(r) -> str:
    peak = "" if r.peak_bytes is None else f", peak {r.peak_bytes} B"
    tick1 = "" if r.tick1_syncs is None else f", tick(1) {r.tick1_syncs:g}"
    return (f"{r.entry} [{r.backend}] n={r.n}: syncs {r.syncs} a tick{tick1}, host reads "
            f"{r.host_reads:g}{peak}, launches {r.launches}, syncs by line {r.sync_sites}")


class AuditChild:
    """Phase o's ``python -m ringpop_tpu_torch audit --fail-on error
    --json`` in a child process on the card (every entry at the fixture
    size), its JSON lines and errors written under ``_build/``.  The
    whole script starts it before phase m, whose small-n part is
    host-bound, so that the child runs beside it."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.path = os.path.join(REPO, "ringpop_tpu_torch", "_build", "phase_o.jsonl")
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.out = open(self.path, "w")
        self.err = open(self.path + ".err", "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ringpop_tpu_torch", "audit", "--fail-on", "error", "--json",
             "--n", str(AUDIT_N), "--ticks", str(AUDIT_TICKS)],
            cwd=REPO, stdout=self.out, stderr=self.err, text=True)
        self.wall = None

    def result(self) -> tuple[int, list[dict], str]:
        """(exit code, JSON lines, stderr) once the child has ended."""
        rc = self.proc.wait(timeout=AUDIT_TIMEOUT)
        if self.wall is None:
            self.wall = time.perf_counter() - self.t0
        self.out.flush()
        self.err.seek(0)
        with open(self.path) as f:
            lines = [json.loads(line) for line in f if line.strip()]
        return rc, lines, self.err.read()

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.out.close()
        self.err.close()


def audit_phase(torch, child: AuditChild | None = None) -> dict:
    """Phase o: the audit ``child`` (started here when not given) over
    every entry at the fixture size, while this process audits
    ``run_scenario`` at ``AUDIT_BIG`` (the byte and sync rows, each with
    its tick(1) companion) and runs every planted fault of
    ``analysis/planted.py``, each of which must be reported at severity
    error.  Every entry's syncs, the byte rows and the sharded entries'
    hops must be pinned.  Returns the kernels' launches of the phase (the
    child's entries and this process's runs)."""
    from ringpop_tpu_torch.analysis import budgets, planted
    from ringpop_tpu_torch.analysis.contracts import audit_entry
    from ringpop_tpu_torch.analysis.registry import iter_entries

    t0 = time.perf_counter()
    child = child or AuditChild()
    problems = []
    try:
        _reset_counts()
        _counted_recv_merge_reset()
        for backend, n in AUDIT_BIG:
            t1 = time.perf_counter()
            r = audit_entry("run_scenario", backend, n=n, ticks=AUDIT_TICKS, device="cuda")
            bad = [str(f) for f in r.findings if f.severity != "info"]
            ref = budgets.REFERENCE_CPU_PEAK.get(("run_scenario", backend, n))
            log(f"audit (phase o) {_audit_row(r)}"
                + (f" (the reference's CPU-XLA derived peak {ref} B, for information)"
                   if ref else "") + f"; {time.perf_counter() - t1:.1f} s")
            problems += bad
        for name, p in planted.PLANTED.items():
            hits, _ = planted.run_planted(name, n=AUDIT_N, ticks=AUDIT_TICKS, device="cuda")
            log(f"audit (phase o) planted {name} ({p.what}) on {p.entry} [{p.backend}]: "
                f"{len(hits)} {p.contract} error(s)"
                + (f", e.g. {hits[0].message[:160]}" if hits else ""))
            if not hits:
                problems.append(f"planted fault {name} was not found on the card")
        launches = _serve_counts()
        own = time.perf_counter() - t0
        rc, lines, err = child.result()
    finally:
        child.stop()
    entries = [d for d in lines if d["kind"] == "entry"]
    others = [d for d in lines if d["kind"] == "finding"]
    if rc != 0:
        problems.append(f"audit --fail-on error exited {rc}: "
                        f"{[d for d in others if d['severity'] == 'error'][:5]} {err[-2000:]}")
    want = set(iter_entries())
    got = {(d["entry"], d["backend"]) for d in entries}
    skipped = {(d["entry"], d["message"].split("[")[1].split("]")[0]) for d in others
               if d["contract"] == "registry"}
    if got | skipped != want or skipped != {("run_sweep+shard", "dense"),
                                             ("run_sweep+shard", "delta")}:
        problems.append(f"the audit reported {sorted(got)} and skipped {sorted(skipped)}")
    for d in entries:
        row = budgets.SYNC_BUDGETS.get((d["entry"], d["backend"], AUDIT_N))
        hops = d["launches"].get("ring_hop", 0)
        log(f"audit (phase o) {d['entry']} [{d['backend']}] n={AUDIT_N}: syncs {d['syncs']} a "
            f"tick (pinned {row and row['per_tick']}), host reads {d['host_reads']:g} (pinned "
            f"{row and row.get('reads')}), tick(1) {d['tick1_syncs']}, peak {d['peak_bytes']} B, "
            f"member gathers {d['member_gathers']}, launches {d['launches']}, syncs by line "
            f"{d['sync_sites']}")
        missing = [f["message"] for f in d["findings"] if "no pin" in f["message"]]
        if row is None or missing:
            problems.append(f"{d['entry']} [{d['backend']}]: not pinned ({missing})")
        if d["mesh_size"] and budgets.HOP_BUDGETS.get((d["entry"], d["mesh_size"])) is None:
            problems.append(f"{d['entry']}: no hop pin ({hops} hops)")
        for k, v in d["launches"].items():
            launches[k] = launches.get(k, 0) + v
    for backend, n in AUDIT_BIG:
        if budgets.SYNC_BUDGETS.get(("run_scenario", backend, n)) is None:
            problems.append(f"run_scenario [{backend}] n={n}: no sync pin")
    for key in budgets.REFERENCE_CPU_PEAK:
        if key not in budgets.BYTE_BUDGETS:
            problems.append(f"{key}: no byte pin")
    for k in ("recv_merge", "row_searchsorted", "merge_insert", "ring_hop"):
        if launches.get(k, 0) <= 0:
            problems.append(f"kernel {k} was not launched")
    log(f"audit (phase o): {len(entries)} entries clean of errors on the card, "
        f"{len(planted.PLANTED)} planted faults; FarmHash launched "
        f"{launches['farmhash32']} (warp) and {launches['farmhash32_short']} (short) times "
        f"(the traffic fixtures hash their key pools); launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s here ({own:.1f} s of this process's own runs), the "
        f"audit child {child.wall:.1f} s from its start")
    if problems:
        raise AssertionError("audit (phase o):\n" + "\n".join(problems))
    return launches



# ---------------------------------------------------------------------------
# phase p: the host library (RingPop on the in-process transport)

HOST_SCRIPT = "j,w3000,t,s,k,w1000,t,K,w10000,t,l,w1000,L,q"  # tests/test_cli.py's
HOST_SCRIPT_N = 5  # BASELINE config 1: tick-cluster's 5-node ring
HOST_SCRIPT_SEED = 7
HOST_N = 64  # phase p2's cluster
HOST_SEED = 1
HOST_VICTIM = 42
CONFIG2_MEMBERS = 1332  # BASELINE config 2: benchmarks/fixtures.py's changeset
CONFIG2_RUNS_CARD = 5
CONFIG2_RUNS_CPU = 2


def large_membership(n: int = CONFIG2_MEMBERS) -> list[dict]:
    """The reference's 1 332-member changeset (a copy of the generator of
    ``benchmarks/fixtures.py``: realistic 10.x addresses, status alive,
    wall-clock incarnation numbers)."""
    return [{"address": f"10.{30 + i // 2500}.{(i // 25) % 100}.{i % 25 + 1}:{31000 + i % 1000}",
             "status": "alive", "incarnationNumber": 1414143508000 + i} for i in range(n)]


def host_node_state(rp) -> tuple:
    """What a host node holds, for the card == CPU check: member list in
    its order, checksums, ring, dissemination buffer (update ids left
    out: uuid4 on both sides), its generator's state and get_stats()
    without the pid."""
    stats = rp.get_stats()
    del stats["process"]
    return ([(m.address, m.status, m.incarnation_number) for m in rp.membership.members],
            rp.membership.checksum, rp.ring.checksum, list(rp.ring._entries),
            {a: {k: v for k, v in c.items() if k != "id"}
             for a, c in rp.dissemination.changes.items()},
            rp.rng.getstate(), stats)


def host_cluster_state(c) -> tuple:
    return (c.scheduler.now(), c.scheduler.pending(), c.network.message_count,
            c.checksums(), [host_node_state(n) for n in c.nodes])


@contextlib.contextmanager
def _ring_on_card_guard(torch):
    """Phase p's rings on the card may never hash with the plain FarmHash:
    a plain call on CUDA rows raises here; counts the rings' batches
    (``hash_replicas`` calls) into the yielded dict."""
    from ringpop_tpu_torch import hashring
    from ringpop_tpu_torch.ops import farmhash

    plain, batch = farmhash.farmhash32_plain, hashring.hash_replicas
    seen = {"batches": 0, "cuda_batches": 0}

    def guarded(bufs, lens):
        if bufs.is_cuda:
            raise AssertionError("the plain FarmHash ran on CUDA rows of a ring")
        return plain(bufs, lens)

    def counted(servers, replica_points, device):
        seen["batches"] += 1
        seen["cuda_batches"] += torch.device(device).type == "cuda"
        return batch(servers, replica_points, device)

    farmhash.farmhash32_plain, hashring.hash_replicas = guarded, counted
    try:
        yield seen
    finally:
        farmhash.farmhash32_plain, hashring.hash_replicas = plain, batch


def host_cli(torch) -> None:
    """Phase p1: BASELINE config 1, ``tick-cluster --backend host-sim`` at
    n = 5 on the card and on the CPU: the same lines, elapsed ms aside."""
    import io
    import re

    from ringpop_tpu_torch.cli import tick_cluster

    outs, walls = {}, {}
    for device in ("cuda", "cpu"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            tick_cluster.main(["--backend", "host-sim", "--device", device, "--size",
                               str(HOST_SCRIPT_N), "--seed", str(HOST_SCRIPT_SEED), "--script",
                               HOST_SCRIPT])
        walls[device] = time.perf_counter() - t0
        outs[device] = re.sub(r"(?m)^(tick: .*) in \d+ms$", r"\1 in <ms>", buf.getvalue())
    ticks = [line for line in outs["cuda"].splitlines() if line.startswith("tick:")]
    want = ["tick: CONVERGED [5]", "tick: CONVERGED [4]", "tick: CONVERGED [5]"]
    if [t.split(" in ")[0] for t in ticks] != want or outs["cuda"] != outs["cpu"]:
        raise AssertionError(f"host-sim script: cuda {outs['cuda']!r} cpu {outs['cpu']!r}")
    log(f"host (phase p1) config 1: tick-cluster --backend host-sim -n {HOST_SCRIPT_N} --seed "
        f"{HOST_SCRIPT_SEED} --script {HOST_SCRIPT}: {' / '.join(t.split(' in ')[0] for t in ticks)}"
        f"; cuda == cpu line for line; {walls['cuda']:.2f} s on cuda, {walls['cpu']:.2f} s on "
        f"cpu")


def host_cluster(torch, seen: dict):
    """Phase p2: a host ``Cluster`` of ``HOST_N`` nodes on the card beside
    its CPU twin: bootstrap, convergence, a kill, convergence, a revive,
    convergence; the same state after every step.  Prints each step's ms
    on both, the card arm's host syncs and ring batches.  Returns the
    card's converged cluster."""
    from ringpop_tpu_torch.harness import Cluster
    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch

    steps = [("bootstrap", lambda c: c.bootstrap_all(run=False)),
             ("converge", lambda c: c.run_until_converged()),
             ("kill", lambda c: (c.kill(HOST_VICTIM), c.run(8000))),
             ("kill_converge", lambda c: c.run_until_converged()),
             ("revive", lambda c: c.revive(HOST_VICTIM)),
             ("revive_converge", lambda c: c.run_until_converged())]
    short0, warp0 = farmhash32_batch.short_launches, farmhash32_batch.launches
    card = Cluster(size=HOST_N, seed=HOST_SEED, device="cuda")
    twin = Cluster(size=HOST_N, seed=HOST_SEED, device="cpu")
    syncs = batches = 0
    rows = []
    with warnings.catch_warnings():  # torch's own first sync warning: an empty window
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode("default")
    for label, step in steps:
        b0 = seen["cuda_batches"]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                got = step(card)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            card_ms = (time.perf_counter() - t0) * 1e3
        step_syncs = sum("synchroniz" in str(w.message) for w in caught)
        t0 = time.perf_counter()
        want = step(twin)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        if got != want or host_cluster_state(card) != host_cluster_state(twin):
            raise AssertionError(f"host cluster (phase p2) {label}: cuda != cpu")
        step_batches = seen["cuda_batches"] - b0
        syncs += step_syncs
        batches += step_batches
        groups = card.checksum_groups()
        rows.append(f"{label} {card_ms:.1f}/{cpu_ms:.1f} ms ({step_batches} ring batches, "
                    f"{step_syncs} syncs; groups {sorted(len(v) for v in groups.values())})")
    short = farmhash32_batch.short_launches - short0
    warp = farmhash32_batch.launches - warp0
    if not card.is_converged() or len(card.live_nodes()) != HOST_N:
        raise AssertionError("host cluster (phase p2) did not end converged at full size")
    if short < 1 or short != batches or warp != 0:
        raise AssertionError(f"host cluster (phase p2): {short} short FarmHash launches, "
                             f"{warp} warp, for {batches} ring batches on the card")
    log(f"host (phase p2) Cluster n={HOST_N} seed {HOST_SEED}, kill and revive node "
        f"{HOST_VICTIM}, cuda == cpu after every step (members, checksums, rings, "
        f"dissemination, rng state, get_stats); cuda/cpu per step: {'; '.join(rows)}; "
        f"on the card {batches} ring batches = {short} short FarmHash launches (warp {warp}), "
        f"{syncs} host syncs ({syncs / max(batches, 1):.2f} a batch); virtual time "
        f"{card.scheduler.now() - 1.4e12:.0f} ms, {card.network.message_count} messages")
    twin.destroy_all()
    return card, short


def host_config2(torch) -> int:
    """Phase p3: BASELINE config 2, one ``membership.update()`` of the
    1 332-member changeset on a fresh ``test_ringpop`` on the card and on
    the CPU: the same members, membership checksum, ring checksum and
    entries; ops a second on each.  Returns the short kernel's launches."""
    from ringpop_tpu_torch.harness import test_ringpop as make
    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch

    changes = large_membership()
    result, secs = {}, {}
    short0, warp0 = farmhash32_batch.short_launches, farmhash32_batch.launches
    for device, runs in (("cuda", CONFIG2_RUNS_CARD), ("cpu", CONFIG2_RUNS_CPU)):
        secs[device] = []
        for _ in range(runs):
            rp = make(host_port="10.30.0.1:30000", device=device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rp.membership.update(changes)
            torch.cuda.synchronize()
            secs[device].append(time.perf_counter() - t0)
        result[device] = ([(m.address, m.status, m.incarnation_number)
                           for m in rp.membership.members], rp.membership.checksum,
                          rp.ring.checksum, rp.ring._entries)
    short = farmhash32_batch.short_launches - short0
    warp = farmhash32_batch.launches - warp0
    if result["cuda"] != result["cpu"] or len(result["cuda"][3]) != 100 * (CONFIG2_MEMBERS + 1):
        raise AssertionError("config 2 (phase p3): cuda != cpu")
    if short != 2 * CONFIG2_RUNS_CARD or warp != 0:
        raise AssertionError(f"config 2 (phase p3): {short} short launches, {warp} warp, not "
                             f"2 a run on the card")
    rate = {d: len(s) / sum(s) for d, s in secs.items()}
    log(f"host (phase p3) config 2: membership.update of {CONFIG2_MEMBERS} members "
        f"({CONFIG2_MEMBERS * 100} replica names in one short FarmHash launch): membership "
        f"checksum {result['cuda'][1]}, ring checksum {result['cuda'][2]}, cuda == cpu; "
        f"{rate['cuda']:.2f} ops/s on cuda (runs {', '.join(f'{s * 1e3:.1f}' for s in secs['cuda'])}"
        f" ms), {rate['cpu']:.2f} ops/s on cpu (runs "
        f"{', '.join(f'{s * 1e3:.1f}' for s in secs['cpu'])} ms); {short} short launches "
        f"(2 a run: the local member, then the changeset)")
    return short


def host_north_star(torch, host) -> int:
    """Phase p4: phase p2's converged member list adopted by the tensor
    ``SimCluster`` on the card: its checksums equal the host cluster's.
    Returns FarmHash's warp launches (the device checksums)."""
    from ringpop_tpu_torch.models.cluster import SimCluster
    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch

    members = host.nodes[0].membership.get_stats()["members"]
    if {m["status"] for m in members} != {"alive"} or len(members) != HOST_N:
        raise AssertionError(f"host (phase p4): the member list is not {HOST_N} alive")
    warp0 = farmhash32_batch.launches
    simc = SimCluster(HOST_N, addresses=[m["address"] for m in members],
                      base_inc=min(m["incarnationNumber"] for m in members),
                      inc=[m["incarnationNumber"] for m in members], init="converged",
                      device="cuda")
    sim_sums, host_sums = set(simc.checksums().values()), set(host.checksums().values())
    warp = farmhash32_batch.launches - warp0
    if sim_sums != host_sums or len(host_sums) != 1 or simc.members(0) != members or warp < 1:
        raise AssertionError(f"host (phase p4): tensor {sim_sums} != host {host_sums} "
                             f"(warp launches {warp})")
    log(f"host (phase p4) north star: SimCluster({HOST_N}, device='cuda') on phase p2's member "
        f"list: checksum {sorted(sim_sums)[0]} == the host cluster's, members(0) equal; "
        f"{warp} FarmHash warp launches")
    return warp


def host_phase(torch) -> dict:
    """Phase p: the host library (p1-p4), every ring on the card guarded
    against the plain FarmHash.  Returns the FarmHash kernels' launches
    of the phase, counted from 0."""
    _reset_counts()
    t0 = time.perf_counter()
    with _ring_on_card_guard(torch) as seen:
        host_cli(torch)
        host, _ = host_cluster(torch, seen)
        host_config2(torch)
        host_north_star(torch, host)
    host.destroy_all()
    counted = _counted()["farmhash32"]
    launches = {"farmhash32_short": counted.short_launches, "farmhash32": counted.launches}
    log(f"host (phase p) {time.perf_counter() - t0:.1f} s; ring batches on the card "
        f"{seen['cuda_batches']}, on the cpu {seen['batches'] - seen['cuda_batches']}; "
        f"FarmHash launches: short {launches['farmhash32_short']}, warp "
        f"{launches['farmhash32']}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--split-of", metavar="ROOT",
                    help="only check and time the receiver merge and the merge-insert "
                         "(one call, prefix, launch alone) of the ringpop_tpu_torch package "
                         "under ROOT, such as a parent checkout, and print no result line")
    ap.add_argument("--config4-65k", action="store_true",
                    help="only run BASELINE config 4 at n = 65,536 (phase c) to convergence, up "
                         "to the bench's 800 heal ticks, then fold_sides; print no result line")
    ap.add_argument("--faults", action="store_true",
                    help="only run phase h (the fault model's lockstep and full-width "
                         "families); print no result line")
    ap.add_argument("--arms", action="store_true",
                    help="only run phase i (the remaining step arms: sparse, n = 40 960, "
                         "damping, relay full sync, carried delta planes); print no result line")
    ap.add_argument("--sweeps", action="store_true",
                    help="only run phase k (run_sweep and param_knobs: cuda == cpu at small n, "
                         "n = 10 000 dense and n = 65 536 delta against standalone runs); print "
                         "no result line")
    ap.add_argument("--serving", action="store_true",
                    help="only run phase l (the serving plane, the overload loop and the "
                         "policies: cuda == cpu at small n, the policy headline, n = 10 000 "
                         "dense, n = 65 536 delta, sharded serving); print no result line")
    ap.add_argument("--serving-cpu", metavar="PATH", help=argparse.SUPPRESS)
    ap.add_argument("--provenance", action="store_true",
                    help="only run phase m (the provenance plane: cuda == cpu at n = 256, the "
                         "dissemination rung at n = 10 000 dense and n = 65 536 delta, the stats "
                         "bridge); print no result line")
    ap.add_argument("--scenarios", action="store_true",
                    help="only run phase j (run_scenario against the host loop at n = 10 000 "
                         "dense and n = 65 536 delta, streamed soaks and checkpoints); print no "
                         "result line")
    ap.add_argument("--provenance-cpu", metavar="PATH", help=argparse.SUPPRESS)
    ap.add_argument("--sweeps-cpu", metavar="PATH", help=argparse.SUPPRESS)
    ap.add_argument("--incidents", action="store_true",
                    help="only run phase n (the incident library's 29 golden runs cuda == cpu, "
                         "the tick-cluster CLI's incidents at n = 64 and its script at n = 10 000 "
                         "with the ledger and the profiler); print no result line")
    ap.add_argument("--audit", action="store_true",
                    help="only run phase o (the trace-contract auditor on the card: every "
                         "entry, the byte and sync rows, the planted faults); print no result "
                         "line")
    ap.add_argument("--host", action="store_true",
                    help="only run phase p (the host library: tick-cluster --backend host-sim "
                         "at n = 5, a 64-node host Cluster cuda == cpu through a kill and a "
                         "revive, BASELINE config 2, the tensor SimCluster on its member "
                         "list); print no result line")
    ap.add_argument("--incidents-cpu", metavar="PATH", help=argparse.SUPPRESS)
    ap.add_argument("--incidents-card", nargs=2, metavar=("KIND:I:K", "PATH"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.incidents_card:
        # one of phase n's processes on the card
        sys.path.insert(0, REPO)
        incidents_card_worker(*args.incidents_card)
        return 0
    if args.incidents_cpu:
        # the child of phase n: n1's CPU side, written to the given path
        sys.path.insert(0, REPO)
        incidents_cpu_reference(args.incidents_cpu)
        return 0
    if args.serving_cpu:
        # the child of phase l: its CPU side, written to the given path
        sys.path.insert(0, REPO)
        serving_cpu_reference(args.serving_cpu)
        return 0
    if args.provenance_cpu:
        # the child of phase m: m1's CPU side, written to the given path
        sys.path.insert(0, REPO)
        provenance_cpu_reference(args.provenance_cpu)
        return 0
    if args.sweeps_cpu:
        # the child of phase k: k1's CPU side, written to the given path
        sys.path.insert(0, REPO)
        sweeps_cpu_reference(args.sweeps_cpu)
        return 0
    root = os.path.abspath(args.split_of) if args.split_of else REPO
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(root, "ringpop_tpu_torch")):
        print(f"chip_smoke: {root} holds no ringpop_tpu_torch/", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
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
    refs: list[CpuReference] = []
    try:
        return run_phases(torch, args, root, dev, refs, t_start)
    finally:
        for ref in refs:
            ref.stop()


def run_phases(torch, args, root: str, dev, refs: list, t_start: float) -> int:
    """The phases ``main`` was asked for.  Phase l's CPU side is started
    into ``refs`` (which ``main`` stops at exit)."""
    if args.serving:
        refs.append(CpuReference())
        serving_phase(torch, refs[0])
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.config4_65k:
        config4_full(torch, CONFIG4_MAX_HEAL)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.faults:
        faults_phase(torch)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.arms:
        arms_phase(torch)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.scenarios:
        scenarios_phase(torch)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.sweeps:
        refs.append(CpuReference("k"))
        sweeps_phase(torch, refs[0])
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.provenance:
        refs.append(CpuReference("m"))
        provenance_phase(torch, refs[0])
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.incidents:
        refs.append(CpuReference("n"))
        incidents_phase(torch, refs[0])
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.audit:
        audit_phase(torch)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.host:
        host_phase(torch)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.split_of:
        log(f"split of the package under {root}")
        check_recv_merge(torch, dev)
        check_merge_insert(torch, dev)
        log(f"total {time.perf_counter() - t_start:.1f} s")
        return 0
    rows = [check_recv_merge(torch, dev), check_farmhash(torch, dev),
            check_row_searchsorted(torch, dev), check_merge_insert(torch, dev),
            check_ring_hop(torch, dev)]
    check_cuda_equals_cpu(torch)
    check_delta_cuda_equals_cpu(torch)
    check_delta_equals_dense(torch)
    check_sided_cuda_equals_cpu(torch)
    # the CPU sides of phases l and m run in child processes from here on,
    # after the lockstep phases that run on the CPU themselves
    refs.append(CpuReference("l"))
    refs.append(CpuReference("k"))
    refs.append(CpuReference("m"))
    refs.append(CpuReference("n"))
    launches, converged_dense, c = main_path(torch)
    short_launches = lookup_surface(torch, c, f"dense, n={N_MAIN}")
    del c
    launches_delta, converged_delta, searchsorted_shapes, c = delta_main_path(torch)
    short_launches += lookup_surface(torch, c, f"delta, n={N_DELTA}")
    del c
    launches_ring = ring_path(torch, "dense", converged_dense)
    launches_ring_delta = ring_path(torch, "delta", converged_delta)
    time_searchsorted_shapes(torch, searchsorted_shapes)
    launches_c4 = config4_small(torch)
    launches_c4_full, sided_shapes = config4_full(torch, CONFIG4_HEAL_WINDOW)
    launches_ring_sided = sided_ring_path(torch)
    time_sided_kernels(torch, sided_shapes)
    config5_launches, short_row = config5(torch)
    rows.append(short_row)
    launches_faults = faults_phase(torch)
    launches_arms, arms_errs = arms_phase(torch, converged_dense, converged_delta)
    launches_scen = scenarios_phase(torch)
    launches_sweeps = sweeps_phase(torch, refs[1])
    launches_serving = serving_phase(torch, refs[0])
    # phase o's audit child runs beside phase m (host-bound at n = 256)
    audit_child = AuditChild()
    refs.append(audit_child)
    launches_prov = provenance_phase(torch, refs[2])
    launches_inc = incidents_phase(torch, refs[3])
    launches_audit = audit_phase(torch, audit_child)
    launches_host = host_phase(torch)
    # each kernel's launches on the main paths it belongs to, each path
    # counted from 0 (each printed above): the dense path and the dense
    # runs of phases h-n for the receiver merge; FarmHash's warp kernel on
    # the dense path, both config-4 paths, phases h-n, its short-row
    # kernel on both lookup surfaces, config 5 and phases l and n; the
    # delta kernels on the delta path, both config-4 paths and the delta
    # runs of phases h-n (kernel 3 also at phase i's block search and
    # phase m's fold); the hop on the three ring paths and phase l5.
    # (phase n's launches are counted in its own processes on the card, and
    # phase o's in its audit child and in this process); phase p's FarmHash
    # launches (the host rings' batches, the tensor cluster's checksums)
    launches["farmhash32_short"] = (short_launches + config5_launches
                                    + launches_serving["farmhash32_short"]
                                    + launches_inc["farmhash32_short"]
                                    + launches_audit["farmhash32_short"]
                                    + launches_host["farmhash32_short"])
    launches["ring_hop"] = (launches_ring["ring_hop"] + launches_ring_delta["ring_hop"]
                            + launches_ring_sided["ring_hop"] + launches_serving["ring_hop"]
                            + launches_audit["ring_hop"])
    for name in ("row_searchsorted", "merge_insert"):
        launches[name] = launches_delta[name]
    for name in ("farmhash32", "row_searchsorted", "merge_insert"):
        launches[name] += launches_c4[name] + launches_c4_full[name]
    for name in ("recv_merge", "farmhash32", "row_searchsorted", "merge_insert"):
        launches[name] += (launches_faults[name] + launches_arms.get(name, 0)
                           + launches_scen.get(name, 0) + launches_sweeps.get(name, 0)
                           + launches_serving.get(name, 0) + launches_prov.get(name, 0)
                           + launches_inc.get(name, 0) + launches_audit.get(name, 0)
                           + launches_host.get(name, 0))
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["max_abs_err"] = max(row["max_abs_err"], arms_errs.get(row["name"], 0))
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
