"""Pipelined request bursts over loopback TCP: whose is a stall?

Run from the root of a checkout:

    python3 -m ringpop_tpu_torch.tcp_burst [--servers 5] [--requests 2000]
        [--timeout-s 90] [--cases echo/plain,echo/channel,channel/channel,workers-cpu/channel]

A case is ``SERVER/CLIENT``.  The client sends ``--requests`` requests to
each of ``--servers`` servers, all written at once (no window), one
connection a server, every server at the same time, and waits for every
response up to ``--timeout-s``.  Each request is the transport's request
frame for ``/admin/lookup`` with a key as its body; each response its
response frame, as a worker's lookup gives it.

Servers (``--servers`` listeners on a free run of ports):

* ``echo``: a plain ``asyncio.start_server`` that answers each line with
  a response frame, in a child process; no code of this package;
* ``channel``: one port ``TcpChannel`` a listener whose
  ``/admin/lookup`` answers at once, in a child process (``serve`` takes
  another package's ``TcpChannel`` class too);
* ``workers-cpu`` / ``workers-cuda``: ``tick-cluster --backend proc``'s
  workers (``ProcCluster``) on that device, joined and converged, whose
  ``/admin/lookup`` looks the key up in the node's ring.

Clients: ``plain``, one ``asyncio.open_connection`` a server writing each
frame with its own ``write`` call, as the transport does; ``channel``,
the port's ``TcpChannel``.

Each case prints one line: per server, the requests that failed or got
no answer, and the seconds after the first write at which 80 % and all
of its responses had come; then the case's wall time.  The last line is
every case as one JSON object.  A stall that shows with the echo server
and the plain client is the host's loopback, not the transport's.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import time

ENDPOINT = "/admin/lookup"
DEST = "127.0.0.1:3000"  # the owner every synthetic server answers
LIMIT = 16 * 1024 * 1024  # the transport's stream limit (tcp.MAX_FRAME_BYTES)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_ports(count: int) -> list[int]:
    """``count`` ports the OS hands out free now (bound to port 0)."""
    socks = [socket.socket() for _ in range(count)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def lookup_result(key) -> str:
    return json.dumps({"key": key, "dest": DEST})


async def serve(kind: str, ports: list[int], channel_cls=None) -> None:
    """The ``echo`` or ``channel`` listeners on ``ports`` (``channel_cls``
    the ``TcpChannel`` class, the port's unless given); prints ``ready``
    once all listen, then serves until killed."""
    servers = []
    if kind == "echo":
        async def on_conn(reader, writer):
            while line := await reader.readline():
                frame = json.loads(line)
                writer.write(json.dumps({"t": "res", "id": frame["id"], "err": None,
                                         "res1": None,
                                         "res2": lookup_result(frame["body"])}).encode()
                             + b"\n")
            writer.close()

        for port in ports:
            servers.append(await asyncio.start_server(on_conn, "127.0.0.1", port, limit=LIMIT))
    else:
        if channel_cls is None:
            from ringpop_tpu_torch.transport.tcp import TcpChannel as channel_cls

        def lookup(head, body, src, respond):
            respond(None, None, lookup_result(body))

        for port in ports:
            channel = channel_cls(f"127.0.0.1:{port}")
            channel.register({ENDPOINT: lookup})
            await channel.listen()
            servers.append(channel)
    print("ready", flush=True)
    await asyncio.Event().wait()


def frames(requests: int) -> list[tuple[int, str]]:
    return [(i + 1, f"key-{i}") for i in range(requests)]


async def plain_client(host_port: str, requests: int, timeout_s: float, t0: float) -> dict:
    host, port = host_port.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port), limit=LIMIT)
    got: dict[int, float] = {}
    want = frames(requests)
    for req_id, key in want:
        writer.write(json.dumps({"t": "req", "id": req_id, "ep": ENDPOINT, "src": "burst:0",
                                 "head": None, "body": key}).encode() + b"\n")

    async def read():
        while len(got) < requests:
            line = await reader.readline()
            if not line:
                break
            frame = json.loads(line)
            if frame.get("err") is None:
                got[frame["id"]] = time.perf_counter() - t0

    with contextlib.suppress(asyncio.TimeoutError):
        await asyncio.wait_for(read(), timeout_s)
    writer.close()
    return {"failed": requests - len(got), "times": sorted(got.values())}


async def channel_clients(host_ports: list[str], requests: int, timeout_s: float,
                          t0: float) -> dict:
    from ringpop_tpu_torch.transport.tcp import TcpChannel

    channel = TcpChannel("burst:0")  # a client only: never listens
    loop = asyncio.get_running_loop()
    out = {}

    async def one(host_port: str) -> None:
        futs = []
        times = []
        for _, key in frames(requests):
            fut = loop.create_future()

            def done(err, res1=None, res2=None, fut=fut):
                if err is None:
                    times.append(time.perf_counter() - t0)
                fut.set_result(err)

            channel.request(host_port, ENDPOINT, None, key, timeout_s * 1000, done)
            futs.append(fut)
        errs = await asyncio.gather(*futs)
        out[host_port] = {"failed": sum(e is not None for e in errs), "times": sorted(times)}

    try:
        await asyncio.gather(*(one(hp) for hp in host_ports))
    finally:
        channel.close()
    return out


async def run_clients(client: str, host_ports: list[str], requests: int,
                      timeout_s: float) -> dict:
    t0 = time.perf_counter()
    if client == "channel":
        return await channel_clients(host_ports, requests, timeout_s, t0)
    res = await asyncio.gather(*(plain_client(hp, requests, timeout_s, t0)
                                 for hp in host_ports))
    return dict(zip(host_ports, res))


@contextlib.contextmanager
def servers_up(kind: str, count: int, startup_s: float = 120.0):
    """The host:ports of ``count`` servers of ``kind``, stopped at exit."""
    if kind.startswith("workers-"):
        from ringpop_tpu_torch.cli import tick_cluster as tc

        cluster = tc.ProcCluster(count, tc.free_port_run(count), log_level="error",
                                 device=kind.split("-", 1)[1])
        try:
            cluster.wait_healthy(startup_s)
            with contextlib.redirect_stdout(io.StringIO()):
                cluster.cmd("j")
            end = time.perf_counter() + startup_s
            while True:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    cluster.cmd("t")
                if buf.getvalue().startswith(f"tick: CONVERGED [{count}]"):
                    break
                if time.perf_counter() > end:
                    raise RuntimeError(f"workers not converged: {buf.getvalue()!r}")
                time.sleep(0.1)
            yield list(cluster.host_ports)
        finally:
            with contextlib.redirect_stdout(io.StringIO()):
                cluster.shutdown()
        return
    ports = free_ports(count)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        # the file as a script: the echo server imports nothing of the package
        [sys.executable, os.path.abspath(__file__), "--serve", kind,
         "--ports", ",".join(map(str, ports))],
        cwd=REPO, env=env, stdout=subprocess.PIPE, text=True)
    try:
        if proc.stdout.readline().strip() != "ready":
            raise RuntimeError(f"{kind} servers did not start (exit {proc.wait()})")
        yield [f"127.0.0.1:{p}" for p in ports]
    finally:
        proc.kill()
        proc.wait()


def burst(case: str, servers: int = 5, requests: int = 2000, timeout_s: float = 90.0,
          host_ports: list[str] | None = None) -> dict:
    """One case ``SERVER/CLIENT``: per server its failed requests and the
    seconds at which 80 % and all of its answers had come, and the wall.
    Given ``host_ports``, the servers are those, already up."""
    server, client = case.split("/")
    with contextlib.ExitStack() as stack:
        if host_ports is None:
            host_ports = stack.enter_context(servers_up(server, servers))
        t0 = time.perf_counter()
        res = asyncio.run(run_clients(client, host_ports, requests, timeout_s))
        wall = time.perf_counter() - t0
    per = {}
    for host_port, r in res.items():
        times = r["times"]
        per[host_port] = {
            "failed": r["failed"],
            "p80_s": round(times[int(0.8 * (len(times) - 1))], 3) if times else None,
            "last_s": round(times[-1], 3) if times else None,
        }
    return {"case": case, "servers": len(host_ports), "requests": requests, "per_server": per,
            "wall_s": round(wall, 3)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ringpop_tpu_torch.tcp_burst",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--servers", type=int, default=5)
    ap.add_argument("--requests", type=int, default=2000)
    ap.add_argument("--timeout-s", type=float, default=90.0)
    ap.add_argument("--cases", default="echo/plain,echo/channel,channel/channel,"
                                       "workers-cpu/channel")
    ap.add_argument("--serve", help=argparse.SUPPRESS)
    ap.add_argument("--ports", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.serve:
        asyncio.run(serve(args.serve, [int(p) for p in args.ports.split(",")]))
        return 0
    out = []
    for case in args.cases.split(","):
        r = burst(case, args.servers, args.requests, args.timeout_s)
        out.append(r)
        print(f"burst {case}: {args.servers} servers x {args.requests} requests at once; "
              + "; ".join(f"{hp} failed {v['failed']}, 80% by {v['p80_s']} s, all by "
                          f"{v['last_s']} s" for hp, v in r["per_server"].items())
              + f"; wall {r['wall_s']} s", flush=True)
    print(json.dumps({"bursts": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
