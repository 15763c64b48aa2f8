"""The port's TCP transport (``ringpop_tpu_torch/transport/tcp.py``):
every case of ``tests/test_tcp_transport.py`` on the port's
``TcpChannel`` and ``RingPop(device="cpu")``.

Framing, a typed timeout, connection refusal, a missing handler as a
remote error, two nodes converging over localhost, ``handle_or_proxy``
forwarding across real sockets and a frame far beyond asyncio's default
stream limit.  Every address is a port the OS hands out (bound to port 0
and released), never a fixed range, so that the suite's workers and the
reference's own TCP tests can run at the same moment.
"""

from __future__ import annotations

import asyncio
import json
import socket

from ringpop_tpu_torch.clock import AsyncioScheduler
from ringpop_tpu_torch.transport import TcpChannel as ExportedTcpChannel
from ringpop_tpu_torch.transport.tcp import (
    MAX_FRAME_BYTES,
    TcpChannel,
    TransportConnectionError,
    TransportTimeoutError,
)


def free_address() -> str:
    """``127.0.0.1:PORT`` for a port the OS just handed out and released."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{sock.getsockname()[1]}"


def run(coro, timeout=20):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def make_echo_channel(host_port: str) -> TcpChannel:
    channel = TcpChannel(host_port)

    def echo(head, body, src, respond):
        respond(None, head, json.dumps({"echo": json.loads(body)["x"], "src": src}))

    def slow(head, body, src, respond):
        # Never responds: exercises the client-side timeout.
        pass

    channel.register({"/echo": echo, "/slow": slow})
    return channel


def test_exports_and_limits():
    assert ExportedTcpChannel is TcpChannel
    assert MAX_FRAME_BYTES == 16 * 1024 * 1024
    assert TransportTimeoutError.type == "ringpop.transport.timeout"
    assert TransportConnectionError.type == "ringpop.transport.connection-refused"


def test_request_response():
    async def scenario():
        a = TcpChannel(free_address())
        b = make_echo_channel(free_address())
        await a.listen()
        await b.listen()
        fut = asyncio.get_event_loop().create_future()
        a.request(
            b.host_port, "/echo", "HEAD", json.dumps({"x": 42}), 5000,
            lambda err, res1, res2=None: fut.set_result((err, res1, res2)),
        )
        err, res1, res2 = await fut
        assert err is None
        assert res1 == "HEAD"
        parsed = json.loads(res2)
        assert parsed["echo"] == 42
        assert parsed["src"] == a.host_port  # identified reverse route
        assert b._peer_conn[a.host_port] in b._conns
        a.close()
        b.close()

    run(scenario())


def test_timeout_is_typed():
    async def scenario():
        a = TcpChannel(free_address())
        b = make_echo_channel(free_address())
        await a.listen()
        await b.listen()
        fut = asyncio.get_event_loop().create_future()
        a.request(b.host_port, "/slow", None, None, 200,
                  lambda err, *res: fut.set_result(err))
        err = await fut
        assert isinstance(err, TransportTimeoutError)
        assert err.type == "ringpop.transport.timeout"
        assert not a._pending
        a.close()
        b.close()

    run(scenario())


def test_connection_refused():
    async def scenario():
        a = TcpChannel(free_address())
        await a.listen()
        fut = asyncio.get_event_loop().create_future()
        a.request(free_address(), "/echo", None, None, 5000,
                  lambda err, *res: fut.set_result(err))
        err = await fut
        assert isinstance(err, TransportConnectionError)
        assert err.type == "ringpop.transport.connection-refused"
        a.close()

    run(scenario())


def test_no_handler_is_remote_error():
    async def scenario():
        a = TcpChannel(free_address())
        b = make_echo_channel(free_address())
        await a.listen()
        await b.listen()
        fut = asyncio.get_event_loop().create_future()
        a.request(b.host_port, "/nope", None, None, 5000,
                  lambda err, *res: fut.set_result(err))
        err = await fut
        assert err is not None
        assert "no handler" in str(err)
        assert err.type == "ringpop.transport.connection-refused"
        a.close()
        b.close()

    run(scenario())


def test_close_fails_pending_and_later_requests():
    """Closing a channel fails its requests in flight and any made after,
    each with a connection error, as the reference's does."""
    async def scenario():
        a = TcpChannel(free_address())
        b = make_echo_channel(free_address())
        await a.listen()
        await b.listen()
        loop = asyncio.get_event_loop()
        pending, later = loop.create_future(), loop.create_future()
        a.request(b.host_port, "/slow", None, None, 5000,
                  lambda err, *res: pending.set_result(err))
        await asyncio.sleep(0.2)  # the dial and the frame are out
        a.close()
        a.request(b.host_port, "/echo", None, None, 5000,
                  lambda err, *res: later.set_result(err))
        for fut in (pending, later):
            err = await fut
            assert isinstance(err, TransportConnectionError)
            assert "channel destroyed" in str(err)
        b.close()

    run(scenario())


def test_connection_loss_fails_pending():
    """A peer that goes away fails the requests still waiting on it."""
    async def scenario():
        a = TcpChannel(free_address())
        b = make_echo_channel(free_address())
        await a.listen()
        await b.listen()
        fut = asyncio.get_event_loop().create_future()
        a.request(b.host_port, "/slow", None, None, 10000,
                  lambda err, *res: fut.set_result(err))
        await asyncio.sleep(0.2)
        b.close()
        err = await fut
        assert isinstance(err, TransportConnectionError)
        assert "connection lost" in str(err)
        a.close()

    run(scenario())


def start_nodes(app: str, hosts: list[str], loop) -> list:
    from ringpop_tpu_torch.ringpop import RingPop

    nodes = []
    for host_port in hosts:
        channel = TcpChannel(host_port, loop)
        node = RingPop(app=app, host_port=host_port, channel=channel,
                       clock=AsyncioScheduler(loop), device="cpu")
        node.setup_channel()
        nodes.append(node)
    return nodes


def test_two_ringpops_converge_over_tcp():
    """Two real RingPop nodes gossip to one checksum over localhost TCP."""
    async def scenario():
        loop = asyncio.get_event_loop()
        hosts = [free_address(), free_address()]
        nodes = start_nodes("tcp-test", hosts, loop)
        for node in nodes:
            await node.channel.listen()
        boot = [loop.create_future() for _ in nodes]
        for node, fut in zip(nodes, boot):
            node.bootstrap(hosts, lambda err, joined=None, fut=fut:
                           fut.set_result(err))
        errs = await asyncio.gather(*boot)
        assert all(e is None for e in errs), errs
        for _ in range(100):
            checksums = {n.membership.checksum for n in nodes}
            if len(checksums) == 1 and None not in checksums:
                break
            await asyncio.sleep(0.1)
        assert len({n.membership.checksum for n in nodes}) == 1
        assert nodes[0].membership.get_member_count() == 2
        for node in nodes:
            node.destroy()

    run(scenario(), timeout=30)


def test_forwarding_over_tcp():
    """handleOrProxy end to end across real sockets: the non-owner
    forwards to the key's owner, which answers via the 'request' event
    (test/integration/proxy-test.js shape, on the TCP transport)."""
    from ringpop_tpu_torch.request_proxy.http import ProxyRequest, ProxyResponse

    async def scenario():
        loop = asyncio.get_event_loop()
        hosts = [free_address(), free_address()]
        nodes = start_nodes("tcp-proxy", hosts, loop)
        for node in nodes:
            await node.channel.listen()
        boot = [loop.create_future() for _ in nodes]
        for node, fut in zip(nodes, boot):
            node.bootstrap(hosts, lambda err, joined=None, fut=fut:
                           fut.set_result(err))
        assert all(e is None for e in await asyncio.gather(*boot))
        for _ in range(100):
            if len({n.membership.checksum for n in nodes}) == 1:
                break
            await asyncio.sleep(0.05)

        sender = nodes[0]
        key = next(f"k{i}" for i in range(1000)
                   if sender.lookup(f"k{i}") != sender.whoami())
        owner = next(n for n in nodes if n.whoami() == sender.lookup(key))

        def on_request(req, res, head):
            assert head["ringpopKeys"] == [key]
            res.status_code = 200
            res.end(f"handled:{req.body}")

        owner.on("request", on_request)

        done: asyncio.Future = loop.create_future()
        req = ProxyRequest(url="/data", method="PUT", body="payload")
        res = ProxyResponse(lambda err, resp: done.set_result((err, resp)))
        assert sender.handle_or_proxy(key, req, res) is None
        err, resp = await asyncio.wait_for(done, 10)
        assert err is None
        assert resp.body == "handled:payload"
        for node in nodes:
            node.destroy()

    run(scenario(), timeout=30)


def test_large_frame_roundtrip():
    """Frames far beyond asyncio's default 64 KiB stream limit survive.

    Join/full-sync/stats bodies exceed 64 KiB at a few hundred members
    (reference bodies are unbounded JSON); the stream limit must be the
    protocol's MAX_FRAME_BYTES, not asyncio's default."""
    async def scenario():
        a = TcpChannel(free_address())
        b = make_echo_channel(free_address())
        await a.listen()
        await b.listen()
        fut = asyncio.get_event_loop().create_future()
        big = "x" * (512 * 1024)  # 512 KiB body
        a.request(
            b.host_port, "/echo", "HEAD", json.dumps({"x": big}), 10000,
            lambda err, res1, res2=None: fut.set_result((err, res1, res2)),
        )
        err, res1, res2 = await fut
        assert err is None
        assert json.loads(res2)["echo"] == big
        a.close()
        b.close()

    run(scenario())
