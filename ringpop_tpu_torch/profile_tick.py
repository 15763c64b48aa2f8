"""Where a dense tick's time goes on the card.

Run from the root of a checkout (needs one CUDA card and nvcc):

    python3 -m ringpop_tpu_torch.profile_tick [--n 10000] [--ticks 3]

It drives ``SimCluster(n, SwimParams(loss=0.01), seed=0)``, the BASELINE
config 3 deployment, through two windows of ``--ticks`` ticks each under
``torch.profiler``: a steady window (no membership change in flight, the
ping-req exchange skipped) and a churn window right after a node is
killed and suspected (the exchange stages run).  For each window it
prints the wall time per tick, the device-busy time per tick (the sum of
kernel times, so the idle share is ``1 - busy / wall``), the step's
phase spans (``swim.*`` labels: the device time of the kernels
launched inside each, and its host time), the costliest kernels, and
the port's own CUDA kernels.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ringpop_tpu_torch.models import swim_sim as sim
from ringpop_tpu_torch.models.cluster import SimCluster


def _window(c: SimCluster, ticks: int, label: str, top: int) -> None:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            c.tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    events = prof.key_averages()
    # device rows are kernels and copies, plus the device-side copies of
    # the swim.* labels (span lengths, left out of the busy sum)
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in on_device if not e.key.startswith("swim.")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / ticks
    print(f"[{label}] wall {wall_ms:.3f} ms/tick, device busy {busy_ms:.3f} ms/tick, "
          f"idle share {1 - busy_ms / wall_ms:.3f}")
    spans = sorted((e for e in events if e.key.startswith("swim.") and e.device_type != DeviceType.CUDA),
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
        if "recv_merge_kernel" in e.key or "farmhash32_kernel" in e.key:
            print(f"[{label}]   port kernel {e.self_device_time_total / 1e3 / ticks:9.3f} "
                  f"ms/tick x{e.count / ticks:g}  {e.key[:100]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--ticks", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_tick needs a CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    c = SimCluster(args.n, sim.SwimParams(loss=0.01), seed=0, device="cuda")
    for _ in range(3):
        c.tick()
    _window(c, args.ticks, "steady", args.top)
    c.kill(args.n // 3)
    for _ in range(2):
        c.tick()
    _window(c, args.ticks, "churn", args.top)
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
