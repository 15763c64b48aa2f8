"""Protocol-period driver: self-rescheduling gossip loop with adaptive
delay (reference: lib/swim/gossip.js).

The port of ``ringpop_tpu/gossip.py``.
"""

from __future__ import annotations

from typing import Any

from ringpop_tpu_torch.stats import Histogram

DEFAULT_MIN_PROTOCOL_PERIOD = 200  # ms (gossip.js:127-129)


class Gossip:
    def __init__(self, ringpop: Any, min_protocol_period: float | None = None):
        self.ringpop = ringpop
        self.min_protocol_period = min_protocol_period or DEFAULT_MIN_PROTOCOL_PERIOD

        self.is_stopped = True
        self.last_protocol_period = self.ringpop.clock.now()
        self.last_protocol_rate = 0.0
        self.num_protocol_periods = 0
        self.protocol_period_timer = None
        self.protocol_rate_timer = None
        self.protocol_timing = Histogram(seed=0)
        self.protocol_timing.update(self.min_protocol_period)

    def compute_protocol_delay(self) -> float:
        if self.num_protocol_periods:
            target = self.last_protocol_period + self.last_protocol_rate
            return max(target - self.ringpop.clock.now(), self.min_protocol_period)
        # First tick is staggered randomly in [0, minProtocolPeriod].
        return int(self.ringpop.rng.random() * (self.min_protocol_period + 1))

    def compute_protocol_rate(self) -> float:
        observed = self.protocol_timing.percentiles([0.5])["0.5"] * 2
        return max(observed, self.min_protocol_period)

    def run(self) -> None:
        protocol_delay = self.compute_protocol_delay()
        self.ringpop.stat("timing", "protocol.delay", protocol_delay)
        start_time = self.ringpop.clock.now()

        def on_gossip_timer() -> None:
            ping_start = self.ringpop.clock.now()

            def on_member_pinged(*_args: Any) -> None:
                now = self.ringpop.clock.now()
                self.last_protocol_period = now
                self.num_protocol_periods += 1
                self.ringpop.stat("timing", "protocol.frequency", now - start_time)
                self.protocol_timing.update(now - ping_start)
                if self.is_stopped:
                    self.ringpop.logger.debug(
                        "stopped recurring gossip loop",
                        {"local": self.ringpop.whoami()},
                    )
                    return
                self.run()

            self.ringpop.ping_member_now(on_member_pinged)

        self.protocol_period_timer = self.ringpop.clock.call_later(
            protocol_delay, on_gossip_timer
        )

    def start(self) -> None:
        if not self.is_stopped:
            self.ringpop.logger.debug(
                "gossip has already started", {"local": self.ringpop.whoami()}
            )
            return
        self.ringpop.membership.shuffle()
        self.is_stopped = False
        self.run()
        self._start_protocol_rate_timer()
        self.ringpop.logger.debug(
            "started gossip protocol", {"local": self.ringpop.whoami()}
        )

    def _start_protocol_rate_timer(self) -> None:
        def on_rate_timer() -> None:
            if self.is_stopped:
                return
            self.last_protocol_rate = self.compute_protocol_rate()
            self.protocol_rate_timer = self.ringpop.clock.call_later(
                1000, on_rate_timer
            )

        self.protocol_rate_timer = self.ringpop.clock.call_later(1000, on_rate_timer)

    def stop(self) -> None:
        if self.is_stopped:
            self.ringpop.logger.warn(
                "gossip is already stopped", {"local": self.ringpop.whoami()}
            )
            return
        self.ringpop.clock.cancel(self.protocol_rate_timer)
        self.protocol_rate_timer = None
        self.ringpop.clock.cancel(self.protocol_period_timer)
        self.protocol_period_timer = None
        self.is_stopped = True
