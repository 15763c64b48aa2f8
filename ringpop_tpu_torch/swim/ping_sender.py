"""One SWIM direct probe (reference: lib/swim/ping-sender.js).

Body: ``{checksum, changes, source, sourceIncarnationNumber}`` sent to
``/protocol/ping``; on OK the returned changes are applied to membership.

The port of ``ringpop_tpu/swim/ping_sender.py``.
"""

from __future__ import annotations

from typing import Any, Callable

from ringpop_tpu_torch.utils.misc import safe_parse, to_json


class PingSender:
    def __init__(self, ringpop: Any, member: Any, callback: Callable[..., None]):
        self.ringpop = ringpop
        self.address = getattr(member, "address", None) or member
        self.callback: Callable[..., None] | None = callback

    def send(self) -> None:
        changes = self.ringpop.dissemination.issue_as_sender()
        body = to_json(
            {
                "checksum": self.ringpop.membership.checksum,
                "changes": changes,
                "source": self.ringpop.whoami(),
                "sourceIncarnationNumber": self.ringpop.membership.get_incarnation_number(),
            }
        )
        self.ringpop.debug_log(
            f"ping send member={self.address} changes={to_json(changes)}", "p"
        )
        self.ringpop.channel.request(
            self.address,
            "/protocol/ping",
            None,
            body,
            self.ringpop.ping_timeout,
            self.on_ping,
        )

    def on_ping(self, err: Any, res1: Any = None, res2: Any = None) -> None:
        if err:
            self.ringpop.debug_log(
                f"ping failed member={self.address} err={err}", "p"
            )
            return self.do_callback(False)

        body_obj = safe_parse(res2)
        if body_obj and "changes" in body_obj:
            self.ringpop.membership.update(body_obj["changes"])
            return self.do_callback(True, body_obj)
        self.ringpop.logger.warn(
            f"ping failed member={self.address} bad response body={res2}"
        )
        return self.do_callback(False)

    def do_callback(self, is_ok: bool, body_obj: Any = None) -> None:
        """Single-fire guard (ping-sender.js:46-55)."""
        body_obj = body_obj or {}
        if self.callback is not None:
            cb = self.callback
            self.callback = None
            cb(is_ok, body_obj)


def send_ping(ringpop: Any, target: Any, callback: Callable[..., None]) -> None:
    ringpop.stat("increment", "ping.send")
    PingSender(ringpop, target, callback).send()
