"""Forwarding middleware (reference: lib/request-proxy/index.js).

Sender side: ``proxy_req`` ships the request to the key owner with retries.
Receiver side: ``handle_request`` enforces ring-checksum consistency and
re-emits the request locally as a ``request`` event.

The port of ``ringpop_tpu/request_proxy/proxy.py``.
"""

from __future__ import annotations

from typing import Any, Callable

from ringpop_tpu_torch import errors
from ringpop_tpu_torch.request_proxy.http import ProxyRequest, ProxyResponse
from ringpop_tpu_torch.request_proxy.send import send_request
from ringpop_tpu_torch.utils.misc import num_or_default, safe_parse, to_json


class RequestProxy:
    def __init__(
        self,
        ringpop: Any,
        max_retries: int | None = None,
        retry_schedule: list[float] | None = None,
        enforce_consistency: bool | None = None,
    ):
        self.ringpop = ringpop
        self.max_retries = max_retries
        self.retry_schedule = retry_schedule
        self.enforce_consistency = (
            True if enforce_consistency is None else enforce_consistency
        )
        self.sends: list[Any] = []

    def destroy(self) -> None:
        for send in self.sends:
            send.destroy()
        self.sends = []

    def remove_send(self, send: Any) -> None:
        if send in self.sends:
            self.sends.remove(send)
        send.destroy()

    # -- sender side (index.js:74-162) --------------------------------------

    def proxy_req(self, opts: dict[str, Any]) -> None:
        keys = opts["keys"]
        dest = opts["dest"]
        req = opts["req"]
        res = opts["res"]
        endpoint = opts.get("endpoint", "/proxy/req")
        timeout = opts.get("timeout") or self.ringpop.proxy_req_timeout

        raw_body = getattr(req, "body", b"")

        def on_proxy(err: Any, res1: Any = None, res2: Any = None) -> None:
            self.remove_send(send)
            if err:
                self.ringpop.stat("increment", "requestProxy.send.error")
                self.ringpop.logger.warn(
                    "requestProxy got error from channel",
                    {"error": str(err), "url": getattr(req, "url", None)},
                )
                return _send_error(res, err)
            self.ringpop.stat("increment", "requestProxy.send.success")
            response_head = safe_parse(res1) or {}
            for key, value in (response_head.get("headers") or {}).items():
                res.set_header(key, value)
            res.status_code = response_head.get("statusCode", 200)
            res.end(res2)

        send = send_request(
            self.ringpop,
            self,
            keys,
            {"host": dest, "timeout": timeout, "endpoint": endpoint},
            {"obj": req, "body": raw_body},
            {
                "max": num_or_default(opts.get("maxRetries"), self.max_retries)
                if opts.get("maxRetries") is not None or self.max_retries is not None
                else None,
                "schedule": opts.get("retrySchedule") or self.retry_schedule,
            },
            on_proxy,
        )
        self.sends.append(send)

    # -- receiver side (index.js:164-227) -----------------------------------

    def handle_request(
        self, head: dict[str, Any], body: Any, cb: Callable[..., None]
    ) -> None:
        ringpop = self.ringpop
        checksum = head.get("ringpopChecksum")

        if checksum != ringpop.ring.checksum:
            err = errors.InvalidCheckSumError(
                expected=ringpop.ring.checksum, actual=checksum
            )
            ringpop.logger.warn(
                "handleRequest got invalid checksum",
                {"url": head.get("url"), "enforceConsistency": self.enforce_consistency},
            )
            ringpop.emit("requestProxy.checksumsDiffer")
            ringpop.stat("increment", "requestProxy.checksumsDiffer")
            if self.enforce_consistency:
                return cb(err)

        http_request = ProxyRequest(
            url=head.get("url"),
            method=head.get("method"),
            headers=head.get("headers"),
            body=body,
            http_version=head.get("httpVersion", "1.1"),
        )

        def on_response(err: Any, resp: ProxyResponse) -> None:
            if err:
                ringpop.logger.warn(
                    "handleRequest got response error",
                    {"error": str(err), "url": head.get("url")},
                )
                return cb(err)
            response_head = to_json(
                {"statusCode": resp.status_code, "headers": resp.headers}
            )
            cb(None, response_head, resp.body)

        http_response = ProxyResponse(on_response)
        ringpop.emit("request", http_request, http_response, head)


def _send_error(res: Any, err: Any) -> None:
    res.status_code = getattr(err, "statusCode", None) or 500
    res.end(str(err))
