"""``worker`` subcommand: run one real ringpop node over TCP.

Reference: main.js — builds a channel, constructs RingPop, listens,
bootstraps from a hosts file (main.js:24-61).

The port of ``ringpop_tpu/cli/main.py``.  Its one addition is
``--device``, the device of the node's ``HashRing`` (``cuda`` unless
told; with no card and no ``--device`` the worker raises, as
``RingPop(device=)`` does).  On the card the worker creates its CUDA
context and loads the FarmHash32 kernel (building it if it is not built
yet) before it listens, so that the first ring batch does not stall the
event loop while joins and pings wait on their timeouts.  Its stats hook
``device`` (in ``/admin/stats`` under ``hooks``) reports the device, that
warm-up's seconds and, since the warm-up, the ring's batches, the
FarmHash kernels' launches and, on the card, the host syncs (counted with
``torch.cuda``'s sync debug mode).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
import warnings
from typing import Any


class StdoutLogger:
    """Line-per-event JSON logger (the reference injects winston here)."""

    def __init__(self, name: str, level: str = "info"):
        self.name = name
        self.level = level
        self._levels = {"trace": 0, "debug": 1, "info": 2, "warn": 3, "error": 4}

    def _log(self, level: str, msg: str, extra: Any = None) -> None:
        if self._levels[level] < self._levels.get(self.level, 2):
            return
        record = {"ts": round(time.time(), 3), "name": self.name, "level": level, "msg": msg}
        if extra is not None:
            record["extra"] = extra
        try:
            print(json.dumps(record), flush=True)
        except (TypeError, ValueError):
            print(json.dumps({**record, "extra": repr(extra)}), flush=True)

    def trace(self, msg: str, extra: Any = None) -> None:
        self._log("trace", msg, extra)

    def debug(self, msg: str, extra: Any = None) -> None:
        self._log("debug", msg, extra)

    def info(self, msg: str, extra: Any = None) -> None:
        self._log("info", msg, extra)

    def warn(self, msg: str, extra: Any = None) -> None:
        self._log("warn", msg, extra)

    def error(self, msg: str, extra: Any = None) -> None:
        self._log("error", msg, extra)


def add_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--listen", "-l", required=True, metavar="HOST:PORT",
        help="address to listen on (main.js --listen)",
    )
    parser.add_argument(
        "--hosts", "-f", default="./hosts.json", metavar="FILE",
        help="bootstrap hosts json file (main.js --hosts)",
    )
    parser.add_argument("--app", default="ringpop", help="app/service name")
    parser.add_argument("--log-level", default="info",
                        choices=["trace", "debug", "info", "warn", "error"])
    parser.add_argument("--device", default=None,
                        help="the torch device of the node's ring (cuda unless told, "
                             "e.g. cpu; with no card and no --device the worker raises)")


class DeviceStats:
    """The worker's stats hook ``device``: where the ring hashes and what
    that has cost since the warm-up."""

    name = "device"

    def __init__(self, ring, device, warmup_s: float):
        from ringpop_tpu_torch.ops.farmhash import farmhash32_batch

        self.ring = ring
        self.device = device
        self.warmup_s = warmup_s
        self._kernel = farmhash32_batch
        self._short0 = farmhash32_batch.short_launches
        self._warp0 = farmhash32_batch.launches
        self.syncs: int | None = None
        if device.type == "cuda":
            self._count_syncs()

    def _count_syncs(self) -> None:
        """Count the host syncs from here on, each a warning of the sync
        debug mode that goes no further; other warnings show as before."""
        import torch

        with warnings.catch_warnings():
            # torch reports one sync of its own the first time the mode is on
            warnings.simplefilter("ignore")
            torch.cuda.set_sync_debug_mode("warn")
            torch.cuda.set_sync_debug_mode("default")
        self.syncs = 0
        show = warnings.showwarning

        def counted(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" in str(message):
                self.syncs += 1
            else:
                show(message, category, filename, lineno, file, line)

        warnings.showwarning = counted
        warnings.filterwarnings("always", message=".*synchroniz")
        torch.cuda.set_sync_debug_mode("warn")

    def get_stats(self) -> dict[str, Any]:
        return {
            "device": str(self.device),
            "warmupS": self.warmup_s,
            "ringBatches": self.ring.batches,
            "shortLaunches": self._kernel.short_launches - self._short0,
            "warpLaunches": self._kernel.launches - self._warp0,
            "hostSyncs": self.syncs,
        }


def warm_up(device, host_port: str) -> float:
    """On the card: create the CUDA context and load (or build) the
    FarmHash32 kernel by hashing one replica name there; seconds taken.
    Nothing to do on the CPU."""
    if device.type != "cuda":
        return 0.0
    from ringpop_tpu_torch.hashring import hash_replicas

    t0 = time.perf_counter()
    hash_replicas([host_port], 1, device).tolist()
    return time.perf_counter() - t0


async def run_node(args: argparse.Namespace) -> None:
    from ringpop_tpu_torch import resolve_device
    from ringpop_tpu_torch.clock import AsyncioScheduler
    from ringpop_tpu_torch.ringpop import RingPop
    from ringpop_tpu_torch.transport.tcp import TcpChannel

    device = resolve_device(args.device)
    loop = asyncio.get_event_loop()
    logger = StdoutLogger(args.listen, level=args.log_level)
    warmup_s = warm_up(device, args.listen)
    channel = TcpChannel(args.listen, loop)
    ringpop = RingPop(
        app=args.app,
        host_port=args.listen,
        channel=channel,
        clock=AsyncioScheduler(loop),
        logger=logger,
        device=device,
    )
    hook = DeviceStats(ringpop.ring, device, warmup_s)
    ringpop.register_stats_hook(hook)
    ringpop.setup_channel()
    await channel.listen()
    logger.info("ringpop listening", {"address": args.listen, "device": str(device),
                                      "warmupS": warmup_s})

    done: asyncio.Future = loop.create_future()

    def on_bootstrap(err: Any, nodes_joined: Any = None) -> None:
        if err:
            logger.error("bootstrap failed", {"error": str(err)})
            if not done.done():
                done.set_exception(SystemExit(1))
            return
        logger.info("ringpop ready", {"nodesJoined": nodes_joined})

    ringpop.bootstrap(args.hosts, on_bootstrap)
    try:
        await done  # runs forever unless bootstrap hard-fails
    finally:
        ringpop.destroy()


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(prog="ringpop-tpu-torch worker")
    add_args(parser)
    args = parser.parse_args(argv)
    try:
        asyncio.run(run_node(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main(sys.argv[1:])
