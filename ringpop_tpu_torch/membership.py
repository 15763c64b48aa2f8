"""Authoritative membership list + SWIM update evaluation.

Reference: lib/membership.js.  Checksum format parity is load-bearing:
farmhash32 of ``addr + status + incarnation`` per member, members sorted by
address, entries joined with ';' (membership.js:41-93).  The same format is
produced on-device by ops/checksum.py.

The port of ``ringpop_tpu/membership.py``.  The reference hashes the
packed members in native C (``ops/farmhash.membership_checksum_packed``);
the port keeps a copy of that packing and of its concatenation, and
hashes the one string on the host with its own ``ops/farmhash.farmhash32``
(one string a call, as ``HashRing`` hashes a key).
"""

from __future__ import annotations

import uuid
from typing import Any

from ringpop_tpu_torch.changeset_merge import merge_membership_changesets
from ringpop_tpu_torch.member import Member, Status
from ringpop_tpu_torch.ops.farmhash import farmhash32
from ringpop_tpu_torch import update_rules
from ringpop_tpu_torch.utils.events import EventEmitter


class Membership(EventEmitter):
    def __init__(self, ringpop: Any):
        super().__init__()
        self.ringpop = ringpop
        self.members: list[Member] = []
        self.members_by_address: dict[str, Member] = {}
        self.checksum: int | None = None
        self.stashed_updates: list[list[dict[str, Any]]] | None = []
        self.local_member: Member | None = None

    # -- checksum (membership.js:41-93) -------------------------------------

    def compute_checksum(self) -> int:
        start = self.ringpop.clock.now()
        self.checksum = membership_checksum_packed(
            self._packed_checksum_string(), len(self.members)
        )
        self.emit("checksumComputed")
        self.ringpop.stat("timing", "compute-checksum", self.ringpop.clock.now() - start)
        self.ringpop.stat("gauge", "checksum", self.checksum)
        return self.checksum

    def _packed_checksum_string(self) -> bytes:
        members = sorted(self.members, key=lambda m: m.address)
        return b"".join(
            f"{m.address}\x00{m.status}\x00{_format_incarnation(m.incarnation_number)}\x00".encode()
            for m in members
        )

    def generate_checksum_string(self) -> str:
        members = sorted(self.members, key=lambda m: m.address)
        return ";".join(
            f"{m.address}{m.status}{_format_incarnation(m.incarnation_number)}"
            for m in members
        )

    # -- accessors ----------------------------------------------------------

    def find_member_by_address(self, address: str) -> Member | None:
        return self.members_by_address.get(address)

    def get_incarnation_number(self) -> int | None:
        return self.local_member.incarnation_number if self.local_member else None

    def get_join_position(self) -> int:
        return int(self.ringpop.rng.random() * len(self.members))

    def get_member_at(self, index: int) -> Member:
        return self.members[index]

    def get_member_count(self) -> int:
        return len(self.members)

    def get_random_pingable_members(self, n: int, excluding: list[str]) -> list[Member]:
        candidates = [
            m
            for m in self.members
            if m.address not in excluding and self.is_pingable(m)
        ]
        self.ringpop.rng.shuffle(candidates)
        return candidates[:n]

    def get_stats(self) -> dict[str, Any]:
        return {
            "checksum": self.checksum,
            "members": [
                m.to_change() for m in sorted(self.members, key=lambda m: m.address)
            ],
        }

    def has_member(self, member: Member) -> bool:
        return self.find_member_by_address(member.address) is not None

    def is_pingable(self, member: Member) -> bool:
        return member.address != self.ringpop.whoami() and member.status in (
            Status.alive,
            Status.suspect,
        )

    # -- declarations (membership.js:141-156) -------------------------------

    def make_alive(self, address: str, incarnation_number: int) -> list[dict[str, Any]]:
        return self._make_update(
            address,
            incarnation_number,
            Status.alive,
            is_local=address == self.ringpop.whoami(),
        )

    def make_faulty(self, address: str, incarnation_number: int) -> list[dict[str, Any]]:
        return self._make_update(address, incarnation_number, Status.faulty)

    def make_leave(self, address: str, incarnation_number: int) -> list[dict[str, Any]]:
        return self._make_update(address, incarnation_number, Status.leave)

    def make_suspect(self, address: str, incarnation_number: int) -> list[dict[str, Any]]:
        return self._make_update(address, incarnation_number, Status.suspect)

    def _make_update(
        self, address: str, incarnation_number: int, status: str, is_local: bool = False
    ) -> list[dict[str, Any]]:
        local = self.local_member
        source = local.address if local else address
        source_inc = local.incarnation_number if local else incarnation_number
        update_id = str(uuid.uuid4())
        updates = self.update(
            {
                "id": update_id,
                "source": source,
                "sourceIncarnationNumber": source_inc,
                "address": address,
                "status": status,
                "incarnationNumber": incarnation_number,
                "timestamp": self.ringpop.clock.now(),
            },
            is_local=is_local,
        )
        if updates:
            self.ringpop.logger.debug(
                f"ringpop member declares other member {status}",
                {"local": self.ringpop.whoami(), status: address, "updateId": update_id},
            )
        return updates

    # -- bootstrap stash + atomic set (membership.js:162-206) ---------------

    def set(self) -> None:
        if self.ringpop.is_ready or self.stashed_updates is None:
            return
        if not self.stashed_updates:
            return

        updates = merge_membership_changesets(
            self.ringpop.whoami(), self.stashed_updates
        )

        for update in updates:
            member = Member(
                update["address"], update["status"], update["incarnationNumber"]
            )
            self.members.append(member)
            self.members_by_address[member.address] = member

        self.stashed_updates = None
        self.compute_checksum()
        self.emit("set", updates)

    # -- SWIM update evaluation (membership.js:208-313) ---------------------

    def update(
        self, changes: dict[str, Any] | list[dict[str, Any]], is_local: bool = False
    ) -> list[dict[str, Any]]:
        if isinstance(changes, dict):
            changes = [changes]

        self.ringpop.stat("gauge", "changes.apply", len(changes))

        if not changes:
            return []

        # Buffer updates until ready (applied atomically by set()).
        if not is_local and not self.ringpop.is_ready:
            if isinstance(self.stashed_updates, list):
                self.stashed_updates.append(changes)
            return []

        local_address = self.ringpop.whoami()
        updates: list[dict[str, Any]] = []

        for change in changes:
            member = self.find_member_by_address(change.get("address"))

            # First time seeing member: take change wholesale.
            if member is None:
                self._apply_update(change)
                updates.append(change)
                continue

            # Rumor about self being suspect/faulty: refute by re-asserting
            # alive with a newer incarnation (membership.js:243-254).  The
            # reference uses Date.now(); we additionally guarantee strict
            # monotonicity under sub-ms activity.
            if update_rules.is_local_suspect_override(
                local_address, member, change
            ) or update_rules.is_local_faulty_override(local_address, member, change):
                change = dict(change)
                change["status"] = Status.alive
                change["incarnationNumber"] = _next_incarnation(
                    self.ringpop.clock.now(), member.incarnation_number
                )
                self._apply_update(change)
                updates.append(change)
                continue

            if (
                update_rules.is_alive_override(member, change)
                or update_rules.is_suspect_override(member, change)
                or update_rules.is_faulty_override(member, change)
                or update_rules.is_leave_override(member, change)
            ):
                self._apply_update(change)
                updates.append(change)

        if updates:
            self.compute_checksum()
            self.emit("updated", updates)

        return updates

    def _apply_update(self, update: dict[str, Any]) -> Member | None:
        address = update.get("address")
        incarnation_number = update.get("incarnationNumber")
        if address is None or incarnation_number is None:
            return None

        member = self.find_member_by_address(address)
        if member is None:
            member = Member(address, update.get("status"), incarnation_number)
            if member.address == self.ringpop.whoami():
                self.local_member = member
            # Random join position (membership.js:99-101,296)
            self.members.insert(self.get_join_position(), member)
            self.members_by_address[member.address] = member

        member.status = update.get("status")
        member.incarnation_number = incarnation_number
        return member

    def shuffle(self) -> None:
        self.ringpop.rng.shuffle(self.members)

    def __str__(self) -> str:
        import json

        return json.dumps([m.address for m in self.members])


def membership_checksum_packed(packed: bytes, n_members: int) -> int:
    """Checksum of pre-sorted members packed as ``addr\\0status\\0inc\\0`` x n:
    FarmHash32 of the reference's checksum string (lib/membership.js:70-93),
    ``addr+status+inc`` joined by ``;``.  The concatenation is that of the
    reference's native path (``rp_membership_checksum`` of
    ``ringpop_tpu/ops/_farmhash.c``) for any input: each member takes the
    next three NUL-terminated fields (bytes after the last NUL make a
    last, partial member), at most ``n_members`` members are read, and a
    ``;`` follows each one but the ``n_members``-th."""
    fields = packed.split(b"\x00")
    if not fields[-1]:
        fields.pop()  # the empty tail after a final NUL (or of b"")
    count = min(n_members, (len(fields) + 2) // 3)
    out = b";".join(b"".join(fields[3 * i : 3 * i + 3]) for i in range(count))
    if 0 < count < n_members:
        out += b";"
    return farmhash32(out)


def _format_incarnation(inc: Any) -> str:
    """Decimal rendering matching JS number stringification for the
    integer-ms incarnation values the protocol uses."""
    if isinstance(inc, float) and inc.is_integer():
        inc = int(inc)
    return str(inc)


def _next_incarnation(now_ms: float, current_inc: int) -> int:
    return max(int(now_ms), int(current_inc) + 1)
