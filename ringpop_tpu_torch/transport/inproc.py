"""Deterministic in-process transport with fault injection.

Replaces the reference's TChannel for single-process multi-node clusters
(the shape of test/lib/test-ringpop-cluster.js) and doubles as the fault
injector that tick-cluster.js implements with SIGSTOP/SIGKILL
(tick-cluster.js:418-471): ``pause`` = black-hole (timeouts), ``kill`` =
fast connection errors, ``partition`` = block-structured reachability.

The port of ``ringpop_tpu/transport/inproc.py``.
"""

from __future__ import annotations

from typing import Any, Callable

Handler = Callable[[Any, Any, str, Callable[..., None]], None]


class TimeoutError_(Exception):
    type = "ringpop.transport.timeout"


class ConnectionRefusedError_(Exception):
    type = "ringpop.transport.connection-refused"


class InProcessNetwork:
    """Registry + message scheduler shared by all in-process channels."""

    def __init__(self, scheduler, latency_ms: float = 1.0, rng=None):
        self.scheduler = scheduler
        self.latency_ms = latency_ms
        self.rng = rng
        self.endpoints: dict[str, dict[str, Handler]] = {}
        self.paused: set[str] = set()
        self.killed: set[str] = set()
        self.partition_of: dict[str, int] = {}
        self.drop_rate = 0.0
        self.message_count = 0

    # -- fault injection -----------------------------------------------------

    def pause(self, host: str) -> None:
        """SIGSTOP analog: messages to/from host vanish (requests time out)."""
        self.paused.add(host)

    def resume(self, host: str) -> None:
        self.paused.discard(host)

    def kill(self, host: str) -> None:
        """SIGKILL analog: requests fail fast with connection refused."""
        self.killed.add(host)
        self.endpoints.pop(host, None)

    def revive(self, host: str) -> None:
        self.killed.discard(host)

    def partition(self, groups: dict[str, int]) -> None:
        """Assign hosts to partition ids; cross-partition traffic is dropped."""
        self.partition_of = dict(groups)

    def heal_partition(self) -> None:
        self.partition_of = {}

    def set_drop_rate(self, rate: float) -> None:
        """Random packet loss applied per request round-trip."""
        self.drop_rate = rate

    # -- registry ------------------------------------------------------------

    def register(self, host: str, endpoints: dict[str, Handler]) -> None:
        self.endpoints[host] = endpoints

    def unregister(self, host: str) -> None:
        self.endpoints.pop(host, None)

    # -- delivery ------------------------------------------------------------

    def _reachable(self, src: str, dst: str) -> bool:
        if src in self.paused or dst in self.paused:
            return False
        if self.partition_of:
            if self.partition_of.get(src, 0) != self.partition_of.get(dst, 0):
                return False
        if self.drop_rate > 0 and self.rng is not None:
            if self.rng.random() < self.drop_rate:
                return False
        return True

    def request(
        self,
        src: str,
        dst: str,
        endpoint: str,
        head: Any,
        body: Any,
        timeout_ms: float,
        callback: Callable[..., None],
    ) -> None:
        self.message_count += 1
        state = {"done": False}

        def finish(err: Any, res1: Any = None, res2: Any = None) -> None:
            if state["done"]:
                return
            state["done"] = True
            self.scheduler.cancel(timeout_timer)
            callback(err, res1, res2)

        def on_timeout() -> None:
            finish(TimeoutError_(f"request to {dst} {endpoint} timed out"))

        timeout_timer = self.scheduler.call_later(timeout_ms, on_timeout)

        if src in self.killed:
            # A killed process cannot send; swallow the request entirely.
            return
        if dst in self.killed:
            self.scheduler.call_later(
                self.latency_ms,
                lambda: finish(ConnectionRefusedError_(f"connection refused: {dst}")),
            )
            return

        if not self._reachable(src, dst):
            # Black hole: let the timeout fire.
            return

        def deliver() -> None:
            table = self.endpoints.get(dst)
            if table is None or endpoint not in table:
                finish(ConnectionRefusedError_(f"no handler at {dst} {endpoint}"))
                return

            def respond(err: Any, res1: Any = None, res2: Any = None) -> None:
                # Response leg is subject to the same reachability rules.
                if not self._reachable(dst, src):
                    return
                self.scheduler.call_later(
                    self.latency_ms, lambda: finish(err, res1, res2)
                )

            table[endpoint](head, body, src, respond)

        self.scheduler.call_later(self.latency_ms, deliver)


class InProcessChannel:
    """Per-node channel bound to an InProcessNetwork (TChannel stand-in)."""

    def __init__(self, network: InProcessNetwork, host_port: str):
        self.network = network
        self.host_port = host_port
        self.destroyed = False

    def register(self, endpoints: dict[str, Handler]) -> None:
        self.network.register(self.host_port, endpoints)

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
            self.network.scheduler.call_soon(
                lambda: callback(ConnectionRefusedError_("channel destroyed"))
            )
            return
        self.network.request(
            self.host_port, host, endpoint, head, body, timeout_ms, callback
        )

    def close(self) -> None:
        self.destroyed = True
        self.network.unregister(self.host_port)
