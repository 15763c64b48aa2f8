"""Lightweight HTTP-ish request/response shims.

The reference forwards real Node HTTP requests and reconstructs them with
PassThrough + uber-hammock mocks (lib/request-proxy/index.js:189-204).  In
this rebuild the app-facing surface is duck-typed: anything with
``url/method/headers/body`` works as a request; responses collect status,
headers and body and fire a completion callback.

The port of ``ringpop_tpu/request_proxy/http.py``.
"""

from __future__ import annotations

from typing import Any, Callable


class ProxyRequest:
    def __init__(
        self,
        url: str = "/",
        method: str = "GET",
        headers: dict[str, str] | None = None,
        body: bytes | str = b"",
        http_version: str = "1.1",
    ):
        self.url = url
        self.method = method
        self.headers = headers or {}
        self.body = body if isinstance(body, (bytes, str)) else b""
        self.http_version = http_version


class ProxyResponse:
    """Collects a response; calls ``on_complete(err, self)`` on end()."""

    def __init__(self, on_complete: Callable[[Any, "ProxyResponse"], None] | None = None):
        self.status_code = 200
        self.headers: dict[str, str] = {}
        self.body: Any = None
        self.ended = False
        self._on_complete = on_complete

    def set_header(self, key: str, value: str) -> None:
        self.headers[key] = value

    def end(self, body: Any = None) -> None:
        if self.ended:
            return
        self.ended = True
        self.body = body
        if self._on_complete is not None:
            self._on_complete(None, self)

    def error(self, err: Any) -> None:
        if self.ended:
            return
        self.ended = True
        if self._on_complete is not None:
            self._on_complete(err, self)
