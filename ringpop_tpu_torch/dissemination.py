"""Piggyback rumor buffer with O(log n) dissemination budget.

Reference: lib/dissemination.js.  Each applied membership update is recorded
as a change keyed by member address; every issue (as ping sender or
receiver) bumps its piggyback count, and changes are evicted once issued
more than ``piggyback_factor * ceil(log10(server_count + 1))`` times.  When
a receiver has nothing to piggyback but checksums disagree, it falls back
to a full sync (entire membership as changes).

The port of ``ringpop_tpu/dissemination.py``.
"""

from __future__ import annotations

import math
from typing import Any, Callable

from ringpop_tpu_torch.utils.events import EventEmitter

DEFAULT_MAX_PIGGYBACK_COUNT = 1
DEFAULT_PIGGYBACK_FACTOR = 15  # lower factor => more full syncs


class Dissemination(EventEmitter):
    def __init__(self, ringpop: Any):
        super().__init__()
        self.ringpop = ringpop
        self.ringpop.on("ringChanged", self.on_ring_changed)
        self.changes: dict[str, dict[str, Any]] = {}
        self.max_piggyback_count = DEFAULT_MAX_PIGGYBACK_COUNT
        self.piggyback_factor = DEFAULT_PIGGYBACK_FACTOR

    def adjust_max_piggyback_count(self) -> None:
        server_count = self.ringpop.ring.get_server_count()
        prev = self.max_piggyback_count
        new = self.piggyback_factor * math.ceil(math.log10(server_count + 1))
        if prev != new:
            self.max_piggyback_count = new
            self.ringpop.stat("gauge", "max-piggyback", new)
            self.ringpop.logger.debug(
                "adjusted max piggyback count",
                {
                    "newPiggybackCount": new,
                    "oldPiggybackCount": prev,
                    "piggybackFactor": self.piggyback_factor,
                    "serverCount": server_count,
                },
            )
            self.emit("maxPiggybackCountAdjusted")

    def clear_changes(self) -> None:
        self.changes = {}

    def full_sync(self) -> list[dict[str, Any]]:
        return [
            {
                "source": self.ringpop.whoami(),
                "address": member.address,
                "status": member.status,
                "incarnationNumber": member.incarnation_number,
            }
            for member in self.ringpop.membership.members
        ]

    def issue_as_sender(self) -> list[dict[str, Any]]:
        return self._issue_as(None, lambda changes: changes)

    def issue_as_receiver(
        self,
        sender_addr: str,
        sender_incarnation_number: int,
        sender_checksum: int,
    ) -> list[dict[str, Any]]:
        def filter_change(change: dict[str, Any]) -> bool:
            # Anti-echo: drop changes the sender itself originated
            # (dissemination.js:91-98).
            return bool(
                sender_addr
                and sender_incarnation_number
                and change.get("source")
                and change.get("sourceIncarnationNumber")
                and sender_addr == change.get("source")
                and sender_incarnation_number == change.get("sourceIncarnationNumber")
            )

        def map_changes(changes: list[dict[str, Any]]) -> list[dict[str, Any]]:
            if changes:
                return changes
            if self.ringpop.membership.checksum != sender_checksum:
                self.ringpop.stat("increment", "full-sync")
                self.ringpop.logger.info(
                    "full sync",
                    {
                        "local": self.ringpop.whoami(),
                        "localChecksum": self.ringpop.membership.checksum,
                        "dest": sender_addr,
                        "destChecksum": sender_checksum,
                    },
                )
                return self.full_sync()
            return []

        return self._issue_as(filter_change, map_changes)

    def _issue_as(
        self,
        filter_change: Callable[[dict[str, Any]], bool] | None,
        map_changes: Callable[[list[dict[str, Any]]], list[dict[str, Any]]],
    ) -> list[dict[str, Any]]:
        issuable: list[dict[str, Any]] = []

        for address in list(self.changes.keys()):
            change = self.changes[address]

            if "piggybackCount" not in change:
                change["piggybackCount"] = 0

            if filter_change is not None and filter_change(change):
                self.ringpop.stat("increment", "filtered-change")
                continue

            # NOTE (as in the reference, dissemination.js:147-151): the count
            # is bumped whether or not delivery succeeds.
            change["piggybackCount"] += 1

            if change["piggybackCount"] > self.max_piggyback_count:
                del self.changes[address]
                continue

            issuable.append(
                {
                    "id": change.get("id"),
                    "source": change.get("source"),
                    "sourceIncarnationNumber": change.get("sourceIncarnationNumber"),
                    "address": change.get("address"),
                    "status": change.get("status"),
                    "incarnationNumber": change.get("incarnationNumber"),
                }
            )

        self.ringpop.stat("gauge", "changes.disseminate", len(issuable))
        return map_changes(issuable)

    def on_ring_changed(self) -> None:
        self.adjust_max_piggyback_count()

    def record_change(self, change: dict[str, Any]) -> None:
        self.changes[change["address"]] = dict(change)

    def reset_max_piggyback_count(self) -> None:
        self.max_piggyback_count = DEFAULT_MAX_PIGGYBACK_COUNT
