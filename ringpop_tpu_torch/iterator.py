"""Round-robin ping-target selection with per-round reshuffle
(reference: lib/membership-iterator.js).

The port of ``ringpop_tpu/iterator.py``.
"""

from __future__ import annotations

from typing import Any

from ringpop_tpu_torch.member import Member


class MembershipIterator:
    def __init__(self, ringpop: Any):
        self.ringpop = ringpop
        self.current_index = -1
        self.current_round = 0

    def next(self) -> Member | None:
        visited: set[str] = set()
        max_to_visit = self.ringpop.membership.get_member_count()

        while len(visited) < max_to_visit:
            self.current_index += 1

            if self.current_index >= self.ringpop.membership.get_member_count():
                self.current_index = 0
                self.current_round += 1
                self.ringpop.membership.shuffle()

            member = self.ringpop.membership.get_member_at(self.current_index)
            visited.add(member.address)

            if self.ringpop.membership.is_pingable(member):
                return member

        return None
