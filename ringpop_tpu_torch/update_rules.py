"""SWIM incarnation-precedence lattice (reference: lib/membership-update-rules.js).

Six pure predicates deciding whether a gossiped change overrides the local
view of a member.  These exact rules are also implemented as vectorized
boolean algebra in the TPU simulation kernel (models/swim_sim.py) — the two
must stay in lockstep (tested in tests/test_sim_parity.py).

The port of ``ringpop_tpu/update_rules.py``.
"""

from __future__ import annotations

from typing import Any

from ringpop_tpu_torch.member import Member, Status


def is_alive_override(member: Member, change: dict[str, Any]) -> bool:
    """Alive beats any status with a strictly newer incarnation (:25-29)."""
    return (
        change.get("status") == Status.alive
        and member.status in Status.ALL
        and change.get("incarnationNumber") > member.incarnation_number
    )


def is_faulty_override(member: Member, change: dict[str, Any]) -> bool:
    """Faulty beats suspect/alive at >= incarnation, faulty at > (:31-36)."""
    if change.get("status") != Status.faulty:
        return False
    inc = change.get("incarnationNumber")
    return (
        (member.status == Status.suspect and inc >= member.incarnation_number)
        or (member.status == Status.faulty and inc > member.incarnation_number)
        or (member.status == Status.alive and inc >= member.incarnation_number)
    )


def is_leave_override(member: Member, change: dict[str, Any]) -> bool:
    """Leave beats any non-leave at >= incarnation (:38-42)."""
    return (
        change.get("status") == Status.leave
        and member.status != Status.leave
        and change.get("incarnationNumber") >= member.incarnation_number
    )


def is_suspect_override(member: Member, change: dict[str, Any]) -> bool:
    """Suspect beats alive at >=, suspect/faulty at > (:54-59)."""
    if change.get("status") != Status.suspect:
        return False
    inc = change.get("incarnationNumber")
    return (
        (member.status == Status.suspect and inc > member.incarnation_number)
        or (member.status == Status.faulty and inc > member.incarnation_number)
        or (member.status == Status.alive and inc >= member.incarnation_number)
    )


def is_local_faulty_override(local_address: str, member: Member, change: dict[str, Any]) -> bool:
    """Any faulty rumor about self triggers refutation (:44-47)."""
    return local_address == member.address and change.get("status") == Status.faulty


def is_local_suspect_override(local_address: str, member: Member, change: dict[str, Any]) -> bool:
    """Any suspect rumor about self triggers refutation (:49-52)."""
    return local_address == member.address and change.get("status") == Status.suspect
