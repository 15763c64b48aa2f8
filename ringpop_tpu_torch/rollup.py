"""Membership-update rollup: batches update logs, flushing after a quiet
interval (reference: lib/membership-update-rollup.js).

The port of ``ringpop_tpu/rollup.py``.
"""

from __future__ import annotations

from typing import Any

from ringpop_tpu_torch.utils.events import EventEmitter

MAX_NUM_UPDATES = 250


class MembershipUpdateRollup(EventEmitter):
    def __init__(self, ringpop: Any, flush_interval: float, max_num_updates: int = MAX_NUM_UPDATES):
        super().__init__()
        self.ringpop = ringpop
        self.flush_interval = flush_interval
        self.max_num_updates = max_num_updates
        self.buffer: dict[str, list[dict[str, Any]]] = {}
        self.first_update_time: float | None = None
        self.last_flush_time: float | None = None
        self.last_update_time: float | None = None
        self.flush_timer = None

    def add_updates(self, updates: list[dict[str, Any]]) -> None:
        ts = self.ringpop.clock.now()
        for update in updates:
            entry = dict(update)
            entry["ts"] = ts
            self.buffer.setdefault(update["address"], []).append(entry)

    def destroy(self) -> None:
        self.ringpop.clock.cancel(self.flush_timer)

    def flush_buffer(self) -> None:
        if not self.buffer:
            return
        now = self.ringpop.clock.now()
        num_updates = self.get_num_updates()
        self.ringpop.logger.debug(
            "ringpop flushed membership update buffer",
            {
                "local": self.ringpop.whoami(),
                "checksum": self.ringpop.membership.checksum,
                "numUpdates": num_updates,
                "updates": self.buffer if num_updates < self.max_num_updates else None,
            },
        )
        self.buffer = {}
        self.first_update_time = None
        self.last_update_time = None
        self.last_flush_time = now
        self.emit("flushed")

    def get_num_updates(self) -> int:
        return sum(len(v) for v in self.buffer.values())

    def renew_flush_timer(self) -> None:
        self.ringpop.clock.cancel(self.flush_timer)
        self.flush_timer = self.ringpop.clock.call_later(
            self.flush_interval, self.flush_buffer
        )

    def track_updates(self, updates: list[dict[str, Any]]) -> None:
        if not updates:
            return
        now = self.ringpop.clock.now()
        if (
            self.last_update_time is not None
            and now - self.last_update_time >= self.flush_interval
        ):
            self.flush_buffer()
        if self.first_update_time is None:
            self.first_update_time = now
        self.renew_flush_timer()
        self.add_updates(updates)
        self.last_update_time = now
