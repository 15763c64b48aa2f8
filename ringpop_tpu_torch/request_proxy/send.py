"""Single proxied request with retry/reroute (reference: lib/request-proxy/send.js).

Retry schedule defaults to [0, 1, 3.5] seconds.  Before each retry the keys
are re-looked-up: if destinations diverged to more than one node the retry
aborts; if the destination moved, the request reroutes (including a local
loopback to handle_request when the key now belongs to this node).

The port of ``ringpop_tpu/request_proxy/send.py``.
"""

from __future__ import annotations

from typing import Any, Callable

from ringpop_tpu_torch import errors
from ringpop_tpu_torch.request_proxy.head import raw_head, str_head
from ringpop_tpu_torch.utils.misc import num_or_default

RETRY_SCHEDULE = [0, 1, 3.5]  # seconds (send.js:49)


class RequestProxySend:
    def __init__(
        self,
        ringpop: Any,
        request_proxy: Any,
        keys: list[str],
        channel_opts: dict[str, Any],
        request: dict[str, Any],
        retries: dict[str, Any],
    ):
        self.ringpop = ringpop
        self.request_proxy = request_proxy
        self.keys = keys
        self.channel_opts = channel_opts
        self.request = request
        self.retry_schedule = retries.get("schedule") or RETRY_SCHEDULE
        self.max_retries = int(num_or_default(retries.get("max"), len(self.retry_schedule)))
        self.max_retry_timeout = self.retry_schedule[-1] * 1000
        self.destinations = [channel_opts["host"]]
        self.errors: list[Exception] = []
        self.num_retries = 0
        self.timeout_timer = None

    def destroy(self) -> None:
        self.ringpop.clock.cancel(self.timeout_timer)

    def get_raw_head(self) -> dict[str, Any]:
        return raw_head(self.request["obj"], self.ringpop.ring.checksum, self.keys)

    def get_str_head(self) -> str:
        return str_head(self.request["obj"], self.ringpop.ring.checksum, self.keys)

    def lookup_keys(self) -> list[str]:
        dests: dict[str, bool] = {}
        for key in self.keys:
            dests[self.ringpop.lookup(key)] = True
        return list(dests.keys())

    def send(self, channel_opts: dict[str, Any], callback: Callable[..., None]) -> None:
        if self.ringpop.channel.destroyed:
            self.ringpop.clock.call_soon(
                lambda: callback(errors.ChannelDestroyedError())
            )
            return

        def on_send(err: Any, res1: Any = None, res2: Any = None) -> None:
            if self.max_retries == 0:
                callback(err, res1 if not err else None, res2 if not err else None)
                return
            if not err:
                self._handle_success(res1, res2, callback)
                return
            self.errors.append(err)
            if self.num_retries >= self.max_retries:
                self._handle_max_retries_exceeded(callback)
                return
            self._schedule_retry(callback)

        self.ringpop.channel.request(
            channel_opts["host"],
            channel_opts.get("endpoint", "/proxy/req"),
            self.get_str_head(),
            self.request["body"],
            channel_opts.get("timeout", 5000),
            on_send,
        )
        self.ringpop.emit("requestProxy.requestProxied")

    def _handle_success(self, res1: Any, res2: Any, callback: Callable[..., None]) -> None:
        if self.num_retries > 0:
            self.ringpop.stat("increment", "requestProxy.retry.succeeded")
            self.ringpop.emit("requestProxy.retrySucceeded")
        callback(None, res1, res2)

    def _handle_max_retries_exceeded(self, callback: Callable[..., None]) -> None:
        self.ringpop.stat("increment", "requestProxy.retry.failed")
        self.ringpop.emit("requestProxy.retryFailed")
        callback(errors.MaxRetriesExceededError(self.max_retries))

    def _schedule_retry(self, callback: Callable[..., None]) -> None:
        if self.num_retries < len(self.retry_schedule):
            delay = self.retry_schedule[self.num_retries] * 1000
        else:
            delay = self.max_retry_timeout
        self.timeout_timer = self.ringpop.clock.call_later(
            delay, lambda: self._attempt_retry(callback)
        )
        self.ringpop.emit("requestProxy.retryScheduled")

    def _attempt_retry(self, callback: Callable[..., None]) -> None:
        self.num_retries += 1
        dests = self.lookup_keys()
        if len(dests) > 1:
            self._abort_on_key_divergence(dests, callback)
            return
        self.ringpop.stat("increment", "requestProxy.retry.attempted")
        self.ringpop.emit("requestProxy.retryAttempted")
        new_dest = dests[0]
        if new_dest == self.channel_opts["host"]:
            self.send(self.channel_opts, callback)
            return
        self._reroute_retry(new_dest, callback)

    def _abort_on_key_divergence(self, dests: list[str], callback: Callable[..., None]) -> None:
        self.ringpop.stat("increment", "requestProxy.retry.aborted")
        self.ringpop.emit("requestProxy.retryAborted")
        callback(errors.KeysDivergedError(keys=self.keys))

    def _reroute_retry(self, new_dest: str, callback: Callable[..., None]) -> None:
        self.destinations.append(new_dest)
        self.ringpop.emit("requestProxy.retryRerouted", self.channel_opts["host"], new_dest)
        if new_dest == self.ringpop.whoami():
            self.ringpop.stat("increment", "requestProxy.retry.reroute.local")
            self.request_proxy.handle_request(
                self.get_raw_head(), self.request["body"], callback
            )
            return
        self.ringpop.stat("increment", "requestProxy.retry.reroute.remote")
        self.send(
            {
                "host": new_dest,
                "timeout": self.channel_opts.get("timeout", 5000),
                "endpoint": self.channel_opts.get("endpoint", "/proxy/req"),
            },
            callback,
        )


def send_request(
    ringpop: Any,
    request_proxy: Any,
    keys: list[str],
    channel_opts: dict[str, Any],
    request: dict[str, Any],
    retries: dict[str, Any],
    callback: Callable[..., None],
) -> RequestProxySend:
    sender = RequestProxySend(
        ringpop, request_proxy, keys, channel_opts, request, retries
    )
    sender.send(channel_opts, callback)
    return sender
