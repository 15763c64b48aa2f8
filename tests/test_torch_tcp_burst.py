"""Pipelined bursts over loopback TCP (``ringpop_tpu_torch.tcp_burst``).

2 000 requests written at once on each of 5 connections, all at the same
time, must every one be answered: by a plain asyncio echo server, by the
port's ``TcpChannel`` and by the reference's, each to a plain asyncio
client and to the port's ``TcpChannel``.  Neither channel applies
back-pressure on a write, so a transport that stalled such a burst would
show here beside the echo server, which does not.  The servers run on an
event loop of their own in a thread of this process (the reference's
transport imports no JAX), each kind started once for both clients; the
tool's own command line, whose servers are child processes, runs once
at a small size.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import socket
import threading
import time

import pytest

from ringpop_tpu_torch import tcp_burst

SERVERS = 5
REQUESTS = 2000
TIMEOUT_S = 30.0


@contextlib.contextmanager
def thread_servers(kind: str, channel_cls=None):
    """``SERVERS`` servers of ``kind`` on a loop in a thread; their
    host:ports once every one accepts a connection."""
    ports = tcp_burst.free_ports(SERVERS)
    loop = asyncio.new_event_loop()
    task = loop.create_task(tcp_burst.serve(kind, ports, channel_cls))
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        end = time.monotonic() + TIMEOUT_S
        for port in ports:
            while True:
                try:
                    socket.create_connection(("127.0.0.1", port), timeout=1).close()
                    break
                except OSError:
                    assert not task.done() and time.monotonic() < end, task
                    time.sleep(0.02)
        yield [f"127.0.0.1:{p}" for p in ports]
    finally:
        loop.call_soon_threadsafe(task.cancel)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(TIMEOUT_S)
        loop.close()


@pytest.fixture(scope="module")
def servers():
    """host:ports of each kind of server, started on first use."""
    up: dict[str, list[str]] = {}
    with contextlib.ExitStack() as stack:
        def get(kind: str) -> list[str]:
            if kind not in up:
                if kind == "reference":
                    from ringpop_tpu.transport.tcp import TcpChannel

                    up[kind] = stack.enter_context(thread_servers("channel", TcpChannel))
                else:
                    up[kind] = stack.enter_context(thread_servers(kind))
            return up[kind]

        yield get


@pytest.mark.parametrize("server", ["echo", "channel", "reference"])
@pytest.mark.parametrize("client", ["plain", "channel"])
def test_burst_answered(servers, server, client):
    r = tcp_burst.burst(f"{server}/{client}", SERVERS, REQUESTS, TIMEOUT_S,
                        host_ports=servers(server))
    assert len(r["per_server"]) == SERVERS, r
    for host_port, v in r["per_server"].items():
        assert v["failed"] == 0, (host_port, r)
        assert v["last_s"] is not None and v["last_s"] < TIMEOUT_S, (host_port, r)


def test_command_line_with_child_servers(capsys):
    assert tcp_burst.main(["--cases", "echo/plain,echo/channel", "--servers", "2",
                           "--requests", "200", "--timeout-s", str(TIMEOUT_S)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0] for line in lines[:-1]] == ["burst echo/plain",
                                                           "burst echo/channel"]
    bursts = json.loads(lines[-1])["bursts"]
    assert [b["case"] for b in bursts] == ["echo/plain", "echo/channel"]
    for b in bursts:
        assert b["servers"] == 2 and b["requests"] == 200, b
        assert all(v["failed"] == 0 for v in b["per_server"].values()), b


def test_free_ports_are_distinct_and_bindable():
    ports = tcp_burst.free_ports(SERVERS)
    assert len(set(ports)) == SERVERS
    for port in ports:
        with socket.socket() as s:
            s.bind(("127.0.0.1", port))
