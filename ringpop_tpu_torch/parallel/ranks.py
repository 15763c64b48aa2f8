"""Start a process group of D ranks, one shard each, and run a function in
every rank on the group's mesh.

``launch("module:function", D, kwargs, workdir=...)`` starts D processes of
``python -m ringpop_tpu_torch.parallel.ranks``; each joins a gloo process
group (a file store in ``workdir``: no port to pick), builds
``make_mesh(group=WORLD, device=...)`` (``cuda:{rank % device_count}``
unless ``device="cpu"``), calls ``function(mesh, **kwargs)``, frees its
receive buffers and writes the function's result (JSON) to
``workdir/rank{r}.json``.  ``launch`` returns the D results in rank order.
If a rank fails, the others are killed and ``launch`` raises with the end
of every rank's log; nothing is retried or passed over.

The group carries the ring's barriers and the receive buffers' handles
(``ops/peer_hop.py``); the payloads move through the peer hop.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
import subprocess
import sys
import time
from typing import Any, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GROUP_TIMEOUT_S = 300  # a barrier that waits longer fails its rank


def launch(
    target: str,
    world: int,
    kwargs: dict | None = None,
    *,
    workdir: str,
    device: str | None = None,
    paths: Sequence[str] = (),
    timeout: float | None = None,
) -> list[Any]:
    """Run ``target`` (``"module:function"``) as ``function(mesh,
    **kwargs)`` in ``world`` rank processes; returns their results.
    ``paths`` go before the repo on the ranks' ``PYTHONPATH``.  Each rank
    runs torch on one CPU thread: D ranks share the host's cores."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "rendezvous")
    if os.path.exists(store):
        os.remove(store)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [*map(os.path.abspath, paths), REPO, *filter(None, [env.get("PYTHONPATH")])])
    procs, logs = [], []
    for r in range(world):
        out = os.path.join(workdir, f"rank{r}.json")
        if os.path.exists(out):
            os.remove(out)
        log = open(os.path.join(workdir, f"rank{r}.log"), "w")
        logs.append(log)
        argv = [sys.executable, "-m", "ringpop_tpu_torch.parallel.ranks", "--rank", str(r),
                "--world", str(world), "--init", "file://" + store, "--target", target,
                "--kwargs", json.dumps(kwargs or {}), "--out", out]
        if device is not None:
            argv += ["--device", str(device)]
        procs.append(subprocess.Popen(argv, cwd=REPO, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
    t0 = time.monotonic()
    failed = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {codes[bad[0]]}"
                break
            if all(c == 0 for c in codes):
                break
            if timeout is not None and time.monotonic() - t0 > timeout:
                failed = f"the ranks did not finish in {timeout} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if failed:
        tails = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.log")) as f:
                tails.append(f"--- rank {r} ---\n" + "".join(f.readlines()[-40:]))
        raise RuntimeError(f"{target} on {world} ranks: {failed}\n" + "\n".join(tails))
    results = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def _rank_main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="one rank of parallel.ranks.launch")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--target", required=True)
    ap.add_argument("--kwargs", default="{}")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ringpop_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    module, _, name = args.target.partition(":")
    fn = getattr(importlib.import_module(module), name)
    dist.init_process_group(
        "gloo", init_method=args.init, world_size=args.world, rank=args.rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    mesh = make_mesh(group=dist.group.WORLD, device=args.device)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    result = fn(mesh, **json.loads(args.kwargs))
    mesh.close()
    dist.destroy_process_group()
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f)
    os.replace(tmp, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main())
