"""Member value record and status enum (reference: lib/member.js).

The port of ``ringpop_tpu/member.py``, without the documentation record
``MemberUpdate``, which nothing uses: the wire shape is the dict of
``Member.to_change`` plus the provenance fields of
``Membership._make_update``.
"""

from __future__ import annotations

from typing import Any


class Status:
    alive = "alive"
    faulty = "faulty"
    leave = "leave"
    suspect = "suspect"

    ALL = (alive, faulty, leave, suspect)


class Member:
    __slots__ = ("address", "status", "incarnation_number")

    def __init__(self, address: str, status: str, incarnation_number: int):
        self.address = address
        self.status = status
        self.incarnation_number = incarnation_number

    def to_change(self) -> dict[str, Any]:
        return {
            "address": self.address,
            "status": self.status,
            "incarnationNumber": self.incarnation_number,
        }

    def __repr__(self) -> str:  # pragma: no cover
        return f"Member({self.address!r}, {self.status!r}, {self.incarnation_number})"
