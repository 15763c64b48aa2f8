"""Per-member suspect timers: suspect -> (timeout) -> faulty.

Reference: lib/swim/suspicion.js.  Timers run on the injected scheduler so
tests control time deterministically.

The port of ``ringpop_tpu/suspicion.py``.
"""

from __future__ import annotations

from typing import Any

DEFAULT_SUSPICION_TIMEOUT = 5000  # ms (suspicion.js:110-112)


class Suspicion:
    def __init__(self, ringpop: Any, suspicion_timeout: float | None = None):
        self.ringpop = ringpop
        self.period = suspicion_timeout or DEFAULT_SUSPICION_TIMEOUT
        self.is_stopped_all: bool | None = None
        self.timers: dict[str, Any] = {}

    def reenable(self) -> None:
        if self.is_stopped_all is not True:
            self.ringpop.logger.warn(
                "cannot reenable suspicion protocol because it was never disabled",
                {"local": self.ringpop.whoami()},
            )
            return
        self.is_stopped_all = None

    def start(self, member: Any) -> None:
        """member: Member or change dict with address/incarnationNumber."""
        address = getattr(member, "address", None) or member.get("address")
        incarnation = (
            getattr(member, "incarnation_number", None)
            if not isinstance(member, dict)
            else member.get("incarnationNumber")
        )

        if self.is_stopped_all is True:
            self.ringpop.logger.debug(
                "cannot start a suspect period because suspicion has not been reenabled",
                {"local": self.ringpop.whoami()},
            )
            return

        if address == self.ringpop.whoami():
            self.ringpop.logger.debug(
                "cannot start a suspect period for the local member",
                {"local": self.ringpop.whoami(), "suspect": address},
            )
            return

        if address in self.timers:
            self.stop_address(address)

        def on_expiry() -> None:
            self.ringpop.membership.make_faulty(address, incarnation)

        self.timers[address] = self.ringpop.clock.call_later(self.period, on_expiry)
        self.ringpop.logger.debug(
            "started suspect period",
            {"local": self.ringpop.whoami(), "suspect": address},
        )

    def stop(self, member: Any) -> None:
        address = getattr(member, "address", None) or member.get("address")
        self.stop_address(address)

    def stop_address(self, address: str) -> None:
        timer = self.timers.pop(address, None)
        if timer is not None:
            self.ringpop.clock.cancel(timer)

    def stop_all(self) -> None:
        self.is_stopped_all = True
        for address in list(self.timers):
            self.stop_address(address)
