"""Membership-event glue: ring add/remove, suspicion start/stop, rumor
recording (reference: lib/membership-set-listener.js,
lib/membership-update-listener.js, lib/event-forwarder.js).

The port of ``ringpop_tpu/listeners.py``.
"""

from __future__ import annotations

from typing import Any

from ringpop_tpu_torch.member import Status


def create_membership_set_listener(ringpop: Any):
    """Bootstrap-time variant: alive -> ring add, suspect -> suspicion
    (membership-set-listener.js:24-48)."""

    def on_membership_set(updates: list[dict[str, Any]]) -> None:
        servers_to_add = []
        for update in updates:
            ringpop.stat(
                "increment", f"membership-set.{update.get('status', 'unknown')}"
            )
            if update.get("status") == Status.alive:
                servers_to_add.append(update["address"])
            elif update.get("status") == Status.suspect:
                ringpop.suspicion.start(update)
            ringpop.dissemination.record_change(update)
        if servers_to_add:
            ringpop.ring.add_remove_servers(servers_to_add, [])

    return on_membership_set


def create_membership_update_listener(ringpop: Any):
    """Steady-state variant (membership-update-listener.js:25-75)."""

    def on_membership_updated(updates: list[dict[str, Any]]) -> None:
        servers_to_add = []
        servers_to_remove = []
        for update in updates:
            status = update.get("status")
            ringpop.stat("increment", f"membership-update.{status or 'unknown'}")
            if status == Status.alive:
                servers_to_add.append(update["address"])
                ringpop.suspicion.stop(update)
            elif status == Status.suspect:
                ringpop.suspicion.start(update)
            elif status == Status.faulty:
                servers_to_remove.append(update["address"])
                ringpop.suspicion.stop(update)
            elif status == Status.leave:
                servers_to_remove.append(update["address"])
                ringpop.suspicion.stop(update)
            ringpop.dissemination.record_change(update)

        if ringpop.damping is not None:
            ringpop.damping.record_updates(updates)
            ringpop.damping.decay_tick()
            # damped members stay out of the ring until reinstated
            servers_to_add = [
                s for s in servers_to_add if not ringpop.damping.is_damped(s)
            ]

        if servers_to_add or servers_to_remove:
            ring_changed = ringpop.ring.add_remove_servers(
                servers_to_add, servers_to_remove
            )
            if ring_changed:
                ringpop.emit("ringChanged")

        ringpop.membership_update_rollup.track_updates(updates)
        ringpop.stat("gauge", "num-members", ringpop.membership.get_member_count())
        ringpop.stat("timing", "updates", len(updates))
        ringpop.emit("membershipChanged")
        ringpop.emit("changed")  # deprecated

    return on_membership_updated


def create_event_forwarder(ringpop: Any) -> None:
    """Re-emit internal membership/ring events publicly (event-forwarder.js)."""

    def on_membership_checksum_computed() -> None:
        ringpop.stat("increment", "membership.checksum-computed")
        ringpop.emit("membershipChecksumComputed")

    def on_ring_checksum_computed() -> None:
        ringpop.stat("increment", "ring.checksum-computed")
        ringpop.emit("ringChecksumComputed")

    def on_ring_server_added(_name: str = None) -> None:
        ringpop.stat("increment", "ring.server-added")
        ringpop.emit("ringServerAdded")

    def on_ring_server_removed(_name: str = None) -> None:
        ringpop.stat("increment", "ring.server-removed")
        ringpop.emit("ringServerRemoved")

    ringpop.membership.on("checksumComputed", on_membership_checksum_computed)
    ringpop.ring.on("added", on_ring_server_added)
    ringpop.ring.on("removed", on_ring_server_removed)
    ringpop.ring.on("checksumComputed", on_ring_checksum_computed)
