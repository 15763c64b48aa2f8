"""The port's TCP half against the reference's, across packages.

The reference's ``transport/tcp.py``, ``ringpop.py``, ``cli/admin_client``
and ``cli/generate_hosts`` import no JAX, so both packages run in this
process, on one asyncio loop, and talk over localhost sockets:

* **Frames.** Each package's ``TcpChannel`` writes the same request line,
  byte for byte, and each package's server answers a raw request with the
  same response line (a result, a typed error, no handler, a handler that
  raises).  A response's ``err`` comes back with the same ``type`` on both.
* **Channels.** The port's channel serves the reference's requests and the
  other way round: ``res1``/``res2`` and the error types equal.
* **Nodes.** A reference ``RingPop`` and a port ``RingPop(device="cpu")``
  (and a cluster of two of each) bootstrap from one hosts list and converge
  to one membership checksum, equal to what each package's ``Membership``
  computes alone for the converged member list; their rings hold the same
  servers.
* **Admin client.** The port's ``admin_request`` reads ``/admin/stats`` and
  ``/admin/lookup`` from a reference node and the reference's from a port
  node.
* **generate-hosts.** Both packages' ``main`` write byte-equal files and
  print the same line.

Every address is a port the OS hands out, never a fixed range.
"""

from __future__ import annotations

import asyncio
import contextlib
import io
import json
import socket

import pytest

import ringpop_tpu.cli.admin_client as ref_admin
import ringpop_tpu.cli.generate_hosts as ref_hosts
import ringpop_tpu.clock as ref_clock
import ringpop_tpu.member as ref_member
import ringpop_tpu.membership as ref_membership
import ringpop_tpu.harness as ref_harness
import ringpop_tpu.ringpop as ref_ringpop
import ringpop_tpu.transport.tcp as ref_tcp
from ringpop_tpu.errors import RingpopError as RefRingpopError
from ringpop_tpu_torch import clock as port_clock
from ringpop_tpu_torch import harness as port_harness
from ringpop_tpu_torch import member as port_member
from ringpop_tpu_torch import membership as port_membership
from ringpop_tpu_torch import ringpop as port_ringpop
from ringpop_tpu_torch.cli import admin_client as port_admin
from ringpop_tpu_torch.cli import generate_hosts as port_hosts
from ringpop_tpu_torch.errors import RingpopError as PortRingpopError
from ringpop_tpu_torch.transport import tcp as port_tcp

PACKAGES = {"port": port_tcp, "ref": ref_tcp}


def free_address() -> str:
    """``127.0.0.1:PORT`` for a port the OS just handed out and released."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{sock.getsockname()[1]}"


def run(coro, timeout=20):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class TypedError(Exception):
    type = "app.custom-error"


def make_server(tcp, host_port: str):
    channel = tcp.TcpChannel(host_port)

    def echo(head, body, src, respond):
        respond(None, head, json.dumps({"echo": json.loads(body)["x"], "src": src}))

    def fail(head, body, src, respond):
        respond(TypedError("it failed"))

    def boom(head, body, src, respond):
        raise ValueError("boom")

    channel.register({"/echo": echo, "/fail": fail, "/boom": boom, "/slow": lambda *a: None})
    return channel


async def call(channel, host, endpoint, head=None, body=None, timeout_ms=5000):
    fut = asyncio.get_event_loop().create_future()
    channel.request(host, endpoint, head, body, timeout_ms,
                    lambda err, res1=None, res2=None: fut.set_result((err, res1, res2)))
    return await fut


def test_request_frames_byte_equal():
    """Each package's channel writes the same request line, and reads a
    response line (a result, then a typed error) the same way."""
    async def scenario():
        lines: list[bytes] = []

        async def on_conn(reader, writer):
            while True:
                line = await reader.readline()
                if not line:
                    break
                lines.append(line)
                frame = json.loads(line)
                err = None
                if frame["ep"] == "/err":
                    err = {"type": "app.custom-error", "message": "m"}
                writer.write(json.dumps({"t": "res", "id": frame["id"], "err": err,
                                         "res1": "h", "res2": "b"}).encode() + b"\n")

        server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
        dest = f"127.0.0.1:{server.sockets[0].getsockname()[1]}"
        got = {}
        for name, tcp in PACKAGES.items():
            channel = tcp.TcpChannel("127.0.0.1:1")  # a client only: never listens
            ok = await call(channel, dest, "/ep", "HEAD", json.dumps({"k": [1, "\n"]}))
            err, _, _ = await call(channel, dest, "/err")
            got[name] = (ok, type(err).__name__, err.type, str(err))
            channel.close()
        server.close()
        return lines, got

    lines, got = run(scenario())
    assert len(lines) == 4
    assert lines[:2] == lines[2:]
    assert json.loads(lines[0]) == {"t": "req", "id": 1, "ep": "/ep", "src": "127.0.0.1:1",
                                    "head": "HEAD", "body": json.dumps({"k": [1, "\n"]})}
    assert got["port"] == got["ref"] == ((None, "h", "b"), "RemoteError", "app.custom-error", "m")


def test_response_frames_byte_equal():
    """Each package's server answers the same raw requests with the same
    response lines."""
    requests = [
        {"t": "req", "id": 7, "ep": "/echo", "src": "127.0.0.1:1", "head": "H",
         "body": json.dumps({"x": [1, 2]})},
        {"t": "req", "id": 8, "ep": "/fail", "src": "127.0.0.1:1", "head": None, "body": None},
        {"t": "req", "id": 9, "ep": "/nope", "src": "127.0.0.1:1", "head": None, "body": None},
        {"t": "req", "id": 10, "ep": "/boom", "src": "127.0.0.1:1", "head": None, "body": None},
    ]

    async def scenario():
        out = {}
        for name, tcp in PACKAGES.items():
            server = make_server(tcp, free_address())
            await server.listen()
            host, port = server.host_port.rsplit(":", 1)
            reader, writer = await asyncio.open_connection(host, int(port))
            for frame in requests:
                writer.write(json.dumps(frame).encode() + b"\n")
            out[name] = [await reader.readline() for _ in requests]
            writer.close()
            server.close()
        return out

    out = run(scenario())
    assert out["port"] == out["ref"]
    types = [(json.loads(line)["err"] or {}).get("type") for line in out["port"]]
    assert types == [None, "app.custom-error", "ringpop.transport.connection-refused",
                     "ringpop.error"]


@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "ref"), ("ref", "port")])
def test_channels_serve_each_other(client_pkg, server_pkg):
    async def scenario():
        client = PACKAGES[client_pkg].TcpChannel(free_address())
        server = make_server(PACKAGES[server_pkg], free_address())
        await client.listen()
        await server.listen()
        err, res1, res2 = await call(client, server.host_port, "/echo", "HEAD",
                                     json.dumps({"x": 42}))
        assert err is None and res1 == "HEAD"
        assert json.loads(res2) == {"echo": 42, "src": client.host_port}
        errs = {}
        for endpoint in ("/fail", "/nope", "/boom"):
            err, _, _ = await call(client, server.host_port, endpoint)
            errs[endpoint] = (type(err).__name__, err.type)
        err, _, _ = await call(client, server.host_port, "/slow", timeout_ms=200)
        errs["/slow"] = (type(err).__name__, err.type)
        err, _, _ = await call(client, free_address(), "/echo")
        errs["refused"] = (type(err).__name__, err.type)
        client.close()
        server.close()
        return errs

    assert run(scenario()) == {
        "/fail": ("RemoteError", "app.custom-error"),
        "/nope": ("RemoteError", "ringpop.transport.connection-refused"),
        "/boom": ("RemoteError", "ringpop.error"),
        "/slow": ("TransportTimeoutError", "ringpop.transport.timeout"),
        "refused": ("TransportConnectionError", "ringpop.transport.connection-refused"),
    }


def make_node(pkg: str, host_port: str, loop):
    if pkg == "port":
        channel = port_tcp.TcpChannel(host_port, loop)
        node = port_ringpop.RingPop(app="mixed", host_port=host_port, channel=channel,
                                    clock=port_clock.AsyncioScheduler(loop), device="cpu")
    else:
        channel = ref_tcp.TcpChannel(host_port, loop)
        node = ref_ringpop.RingPop(app="mixed", host_port=host_port, channel=channel,
                                   clock=ref_clock.AsyncioScheduler(loop))
    node.setup_channel()
    return node


async def start_mixed(pkgs: list[str], deadline_s: float = 10.0) -> list:
    """Nodes of the given packages on one loop, bootstrapped from one hosts
    list and waited on (up to ``deadline_s``) until their membership
    checksums agree over every member alive."""
    loop = asyncio.get_event_loop()
    hosts = [free_address() for _ in pkgs]
    nodes = [make_node(pkg, hp, loop) for pkg, hp in zip(pkgs, hosts)]
    for node in nodes:
        await node.channel.listen()
    boot = [loop.create_future() for _ in nodes]
    for node, fut in zip(nodes, boot):
        node.bootstrap(list(hosts), lambda err, joined=None, fut=fut: fut.set_result(err))
    errs = await asyncio.gather(*boot)
    assert all(e is None for e in errs), errs
    end = loop.time() + deadline_s
    while loop.time() < end:
        sums = {n.membership.checksum for n in nodes}
        counts = {n.membership.get_member_count() for n in nodes}
        if len(sums) == 1 and None not in sums and counts == {len(nodes)}:
            break
        await asyncio.sleep(0.05)
    return nodes


def checksum_alone(membership_mod, member_mod, make, members) -> int:
    """What a package's ``Membership`` computes alone for a member list."""
    m = membership_mod.Membership(make())
    m.members = [member_mod.Member(a, s, i) for a, s, i in members]
    return m.compute_checksum()


@pytest.mark.parametrize("pkgs", [["ref", "port"], ["port", "ref", "port", "ref"]],
                         ids=["1+1", "2+2"])
def test_mixed_cluster_converges_to_one_checksum(pkgs):
    async def scenario():
        nodes = await start_mixed(pkgs)
        try:
            sums = {n.membership.checksum for n in nodes}
            members = sorted((m.address, m.status, m.incarnation_number)
                             for m in nodes[0].membership.members)
            views = [sorted((m.address, m.status, m.incarnation_number)
                            for m in n.membership.members) for n in nodes]
            rings = [sorted(n.ring.servers) for n in nodes]
            ring_sums = {n.ring.checksum for n in nodes}
            return sums, members, views, rings, ring_sums
        finally:
            for node in nodes:
                node.destroy()

    sums, members, views, rings, ring_sums = run(scenario(), timeout=30)
    assert len(sums) == 1 and None not in sums, sums
    assert len(members) == len(pkgs) and {s for _, s, _ in members} == {"alive"}
    assert all(v == members for v in views)
    assert all(r == [a for a, _, _ in members] for r in rings)
    assert len(ring_sums) == 1
    (checksum,) = sums
    assert checksum == checksum_alone(port_membership, port_member,
                                      lambda: port_harness.test_ringpop(device="cpu"), members)
    assert checksum == checksum_alone(ref_membership, ref_member, ref_harness.test_ringpop,
                                      members)


def test_admin_client_across_packages():
    """The port's client reads a reference node and the reference's client
    a port node: the same stats and owners from both nodes."""
    keys = [f"key-{i}" for i in range(40)]

    async def scenario():
        loop = asyncio.get_event_loop()
        ref_node, port_node = await start_mixed(["ref", "port"])
        try:
            def read(client, node):
                stats = client.admin_request(node.host_port, "/admin/stats")
                owners = [client.admin_request(node.host_port, "/admin/lookup", k)["dest"]
                          for k in keys]
                with pytest.raises(client.AdminRequestError, match="no handler"):
                    client.admin_request(node.host_port, "/admin/nope")
                return stats, owners

            # the clients block: run them off the loop that serves the nodes
            got_ref = await loop.run_in_executor(None, read, port_admin, ref_node)
            got_port = await loop.run_in_executor(None, read, ref_admin, port_node)
            local = [ref_node.lookup(json.dumps(k)) for k in keys]
            return got_ref, got_port, local
        finally:
            ref_node.destroy()
            port_node.destroy()

    (ref_stats, ref_owners), (port_stats, port_owners), local = run(scenario(), timeout=30)
    assert ref_owners == port_owners == local
    assert len(set(ref_owners)) == 2
    for stats in (ref_stats, port_stats):
        assert isinstance(stats["process"]["pid"], int)
        assert stats["membership"]["checksum"] == ref_stats["membership"]["checksum"]
    assert sorted(port_stats["ring"]) == sorted(ref_stats["ring"])
    assert sorted(port_stats) == sorted(ref_stats)
    assert sorted(port_stats["membership"]) == sorted(ref_stats["membership"])
    assert sorted(port_stats["protocol"]) == sorted(ref_stats["protocol"])


@pytest.mark.parametrize("argv", [
    [],
    ["--hosts", "127.0.0.1,10.0.0.2", "--base-port", "3100", "-n", "3"],
    ["--hosts", "10.1.2.3", "--base-port", "24000", "--num-ports", "12"],
    ["--hosts", "a.example,b.example,c.example", "--base-port", "1", "-n", "1"],
    ["--hosts", "127.0.0.1", "-n", "0"],
], ids=["defaults", "two-hosts", "twelve-ports", "names", "none"])
def test_generate_hosts_main_byte_equal(argv, tmp_path, monkeypatch):
    outs = {}
    for name, mod in (("port", port_hosts), ("ref", ref_hosts)):
        side = tmp_path / name
        side.mkdir()
        monkeypatch.chdir(side)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(list(argv))
        outs[name] = (buf.getvalue(), (side / "hosts.json").read_bytes())
        monkeypatch.chdir(tmp_path)
        with contextlib.redirect_stdout(io.StringIO()):
            mod.main(argv + ["-o", str(tmp_path / f"{name}.json")])
    assert outs["port"] == outs["ref"]
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert port_hosts.generate(["h1", "h2"], 7, 2) == ref_hosts.generate(["h1", "h2"], 7, 2)


def test_error_bases_agree():
    """The wire's error types come from one base in each package."""
    for tcp, base in ((port_tcp, PortRingpopError), (ref_tcp, RefRingpopError)):
        for cls in (tcp.TransportTimeoutError, tcp.TransportConnectionError, tcp.RemoteError):
            assert issubclass(cls, base)
    assert port_tcp.RemoteError("", "m").type == ref_tcp.RemoteError("", "m").type
    assert port_tcp.parse_host_port("10.0.0.1:3000") == ref_tcp.parse_host_port("10.0.0.1:3000")
