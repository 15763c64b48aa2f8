"""Asyncio TCP transport: newline-delimited JSON frames.

The TChannel replacement for real multi-process clusters (SURVEY §5.8).
The reference's wire pattern — ``channel.request({host, timeout,
serviceName:'ringpop'}).send(endpoint, head, body, cb)`` with JSON-string
bodies (lib/swim/ping-sender.js:57-99) and 14 server endpoints
(server/index.js:32-75) — maps to:

* one persistent TCP connection per peer (dialed lazily, like TChannel's
  ``waitForIdentified`` — ping-sender.js:81-90),
* request frame  ``{"t":"req","id":N,"ep":endpoint,"src":hostPort,
  "head":str|null,"body":str|null}``,
* response frame ``{"t":"res","id":N,"err":{type,message}|null,
  "res1":str|null,"res2":str|null}``,

each JSON-encoded on a single ``\n``-terminated line (JSON escapes interior
newlines, so the framing is unambiguous).

``TcpChannel`` implements the same channel interface as
``InProcessChannel`` (register/request/close/destroyed), so ``RingPop``
code is transport-agnostic.  It must run inside an asyncio event loop —
pair it with ``clock.AsyncioScheduler``.

The port of ``ringpop_tpu/transport/tcp.py``: the same frames, stream
limit and error types, so that a node of either package serves the
other's requests.  It also holds each dial task until it ends (the
loop keeps tasks only weakly).
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Callable

from ringpop_tpu_torch.errors import RingpopError

Handler = Callable[[Any, Any, str, Callable[..., None]], None]

MAX_FRAME_BYTES = 16 * 1024 * 1024


class TransportTimeoutError(RingpopError):
    """Request timed out waiting for a response frame."""

    type = "ringpop.transport.timeout"


class TransportConnectionError(RingpopError):
    """Peer unreachable / connection refused or dropped."""

    type = "ringpop.transport.connection-refused"


class RemoteError(RingpopError):
    """An error returned by the remote handler, reconstructed locally."""

    type = "ringpop.remote-error"

    def __init__(self, type_: str, message: str):
        super().__init__(message)
        self.type = type_ or "ringpop.remote-error"


def _err_to_wire(err: Any) -> dict | None:
    if err is None:
        return None
    return {"type": getattr(err, "type", "error"), "message": str(err)}


def _err_from_wire(obj: Any) -> Any:
    if not obj:
        return None
    return RemoteError(obj.get("type"), obj.get("message") or "")


def parse_host_port(host_port: str) -> tuple[str, int]:
    host, port = host_port.rsplit(":", 1)
    return host, int(port)


class _Conn:
    """One live TCP connection (either direction) with frame dispatch."""

    def __init__(self, channel: "TcpChannel", reader, writer):
        self.channel = channel
        self.reader = reader
        self.writer = writer
        self.closed = False
        self.reader_task = asyncio.ensure_future(self._read_loop())

    def send_frame(self, frame: dict) -> None:
        if self.closed:
            return
        try:
            self.writer.write(json.dumps(frame).encode() + b"\n")
        except Exception:
            self.close()

    async def _read_loop(self) -> None:
        try:
            while True:
                # readline raises (LimitOverrunError wrapped in ValueError)
                # past the stream limit — set to MAX_FRAME_BYTES at
                # connection setup; the default 64 KiB would kill the conn
                # on any full-sync/stats body of a few hundred members.
                line = await self.reader.readline()
                if not line:
                    break
                if len(line) > MAX_FRAME_BYTES:
                    break
                try:
                    frame = json.loads(line)
                except ValueError:
                    break
                self.channel._on_frame(self, frame)
        except (asyncio.CancelledError, ConnectionError, OSError, ValueError):
            pass  # ValueError: oversized/garbage frame — close deliberately
        finally:
            self.close()

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            self.writer.close()
        except Exception:
            pass
        self.channel._on_conn_closed(self)


class TcpChannel:
    """Per-node TCP channel.  Call ``await listen()`` before bootstrap."""

    def __init__(self, host_port: str, loop=None):
        self.host_port = host_port
        self.loop = loop or asyncio.get_event_loop()
        self.destroyed = False
        self.endpoints: dict[str, Handler] = {}
        self.server: asyncio.AbstractServer | None = None
        self._next_id = 1
        # id -> (callback, timeout_handle, dest)
        self._pending: dict[int, tuple[Callable[..., None], Any, str]] = {}
        self._conns: set[_Conn] = set()
        self._peer_conn: dict[str, _Conn] = {}
        self._dialing: dict[str, list[tuple[dict, float]]] = {}
        self._dials: set[asyncio.Future] = set()

    # -- lifecycle -----------------------------------------------------------

    async def listen(self) -> None:
        host, port = parse_host_port(self.host_port)
        self.server = await asyncio.start_server(
            self._on_accept, host, port, limit=MAX_FRAME_BYTES
        )

    def _on_accept(self, reader, writer) -> None:
        if self.destroyed:
            writer.close()
            return
        self._conns.add(_Conn(self, reader, writer))

    def close(self) -> None:
        self.destroyed = True
        if self.server is not None:
            self.server.close()
            self.server = None
        for conn in list(self._conns):
            conn.close()
        for req_id in list(self._pending):
            self._fail_pending(req_id, TransportConnectionError("channel destroyed"))

    # -- channel interface ---------------------------------------------------

    def register(self, endpoints: dict[str, Handler]) -> None:
        self.endpoints.update(endpoints)

    def request(
        self,
        host: str,
        endpoint: str,
        head: Any,
        body: Any,
        timeout_ms: float,
        callback: Callable[..., None],
    ) -> None:
        if self.destroyed:
            self.loop.call_soon(
                lambda: callback(TransportConnectionError("channel destroyed"))
            )
            return
        req_id = self._next_id
        self._next_id += 1
        frame = {
            "t": "req",
            "id": req_id,
            "ep": endpoint,
            "src": self.host_port,
            "head": head,
            "body": body,
        }
        timeout_handle = self.loop.call_later(
            max(0.0, timeout_ms) / 1000.0,
            lambda: self._fail_pending(
                req_id, TransportTimeoutError(f"request to {host} {endpoint} timed out")
            ),
        )
        self._pending[req_id] = (callback, timeout_handle, host)
        conn = self._peer_conn.get(host)
        if conn is not None and not conn.closed:
            conn.send_frame(frame)
        elif host in self._dialing:
            self._dialing[host].append((frame, timeout_ms))
        else:
            self._dialing[host] = [(frame, timeout_ms)]
            task = asyncio.ensure_future(self._dial(host))
            self._dials.add(task)
            task.add_done_callback(self._dials.discard)

    async def _dial(self, host: str) -> None:
        try:
            h, p = parse_host_port(host)
            reader, writer = await asyncio.open_connection(h, p, limit=MAX_FRAME_BYTES)
        except (ConnectionError, OSError, ValueError) as e:
            queued = self._dialing.pop(host, [])
            for frame, _ in queued:
                self._fail_pending(
                    frame["id"],
                    TransportConnectionError(f"connection refused: {host} ({e})"),
                )
            return
        if self.destroyed:  # closed while the dial was in flight
            writer.close()
            self._dialing.pop(host, None)
            return
        conn = _Conn(self, reader, writer)
        self._conns.add(conn)
        self._peer_conn[host] = conn
        for frame, _ in self._dialing.pop(host, []):
            conn.send_frame(frame)

    # -- frame dispatch ------------------------------------------------------

    def _on_frame(self, conn: _Conn, frame: dict) -> None:
        if frame.get("t") == "req":
            self._handle_request(conn, frame)
        elif frame.get("t") == "res":
            self._handle_response(frame)

    def _handle_request(self, conn: _Conn, frame: dict) -> None:
        endpoint = frame.get("ep")
        req_id = frame.get("id")
        src = frame.get("src") or "?"
        # Learn the reverse route: the dialer's listening address serves
        # as its identity (TChannel "identified" semantics).
        if src != "?" and src not in self._peer_conn:
            self._peer_conn[src] = conn
        handler = self.endpoints.get(endpoint)
        state = {"done": False}

        def respond(err: Any = None, res1: Any = None, res2: Any = None) -> None:
            if state["done"]:
                return
            state["done"] = True
            conn.send_frame(
                {
                    "t": "res",
                    "id": req_id,
                    "err": _err_to_wire(err),
                    "res1": res1,
                    "res2": res2,
                }
            )

        if handler is None:
            respond(TransportConnectionError(f"no handler for {endpoint}"))
            return
        try:
            handler(frame.get("head"), frame.get("body"), src, respond)
        except Exception as e:  # handler bug: surface, don't kill the loop
            respond(RingpopError(f"handler error on {endpoint}: {e!r}"))

    def _handle_response(self, frame: dict) -> None:
        entry = self._pending.pop(frame.get("id"), None)
        if entry is None:
            return
        callback, timeout_handle, _ = entry
        timeout_handle.cancel()
        callback(_err_from_wire(frame.get("err")), frame.get("res1"), frame.get("res2"))

    def _fail_pending(self, req_id: int, err: Exception) -> None:
        entry = self._pending.pop(req_id, None)
        if entry is None:
            return
        callback, timeout_handle, _ = entry
        timeout_handle.cancel()
        callback(err)

    def _on_conn_closed(self, conn: _Conn) -> None:
        self._conns.discard(conn)
        dead_hosts = {host for host, peer in self._peer_conn.items() if peer is conn}
        for host in dead_hosts:
            del self._peer_conn[host]
        # Fail requests that were in flight to those peers.
        if not self.destroyed:
            for req_id, (_, _, host) in list(self._pending.items()):
                if host in dead_hosts:
                    self._fail_pending(
                        req_id, TransportConnectionError(f"connection lost: {host}")
                    )
