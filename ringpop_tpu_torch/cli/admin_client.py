"""Blocking admin-endpoint client for drivers and operators.

tick-cluster.js drives nodes purely over TChannel ``/admin/*`` requests
(tick-cluster.js:518-551); this is the equivalent: one short-lived TCP
connection per request, speaking the transport's newline-JSON framing
(transport/tcp.py).

The port of ``ringpop_tpu/cli/admin_client.py``.
"""

from __future__ import annotations

import json
import socket
from typing import Any

from ringpop_tpu_torch.transport.tcp import parse_host_port


class AdminRequestError(Exception):
    pass


def admin_request(
    host_port: str,
    endpoint: str,
    body: Any = None,
    head: Any = None,
    timeout_s: float = 5.0,
    source: str = "admin-client",
) -> Any:
    """Send one request; return the parsed res2 body (or raise)."""
    host, port = parse_host_port(host_port)
    frame = {
        "t": "req",
        "id": 1,
        "ep": endpoint,
        "src": source,
        "head": head,
        "body": json.dumps(body) if body is not None else None,
    }
    with socket.create_connection((host, port), timeout=timeout_s) as sock:
        sock.settimeout(timeout_s)
        sock.sendall(json.dumps(frame).encode() + b"\n")
        buf = b""
        while b"\n" not in buf:
            chunk = sock.recv(65536)
            if not chunk:
                raise AdminRequestError(f"{host_port} closed connection")
            buf += chunk
    response = json.loads(buf.split(b"\n", 1)[0])
    if response.get("err"):
        raise AdminRequestError(
        f"{endpoint} @ {host_port}: {response['err'].get('type')}:"
            f" {response['err'].get('message')}"
        )
    res2 = response.get("res2")
    if isinstance(res2, (str, bytes)) and res2:
        try:
            return json.loads(res2)
        except ValueError:
            return res2
    return res2
