"""SWIM indirect probe (reference: lib/swim/ping-req-sender.js).

Fans ``/protocol/ping-req`` out to k random pingable witnesses.  First
witness that reaches the target ends the probe; if every witness responds
but reports the target unreachable, the target is declared suspect; if the
witnesses themselves fail, the probe is inconclusive.

The port of ``ringpop_tpu/swim/ping_req_sender.py``.
"""

from __future__ import annotations

from typing import Any, Callable

from ringpop_tpu_torch import errors
from ringpop_tpu_torch.utils.misc import safe_parse, to_json


class PingReqSender:
    def __init__(self, ringpop: Any, member: Any, target: Any, callback: Callable[..., None]):
        self.ringpop = ringpop
        self.member = member
        self.target = target
        self.callback = callback

    def send(self) -> None:
        body = to_json(
            {
                "checksum": self.ringpop.membership.checksum,
                "changes": self.ringpop.dissemination.issue_as_sender(),
                "source": self.ringpop.whoami(),
                "sourceIncarnationNumber": self.ringpop.membership.get_incarnation_number(),
                "target": self.target.address,
            }
        )
        self.ringpop.channel.request(
            self.member.address,
            "/protocol/ping-req",
            None,
            body,
            self.ringpop.ping_req_timeout,
            self.on_ping_req,
        )

    def on_ping_req(self, err: Any, res1: Any = None, res2: Any = None) -> None:
        if err:
            self.ringpop.logger.warn(
                "bad response to ping-req",
                {"address": self.member.address, "error": str(err)},
            )
            self.callback(errors.PingReqPingError(str(err)))
            return

        body_obj = safe_parse(res2)
        if not body_obj or "changes" not in body_obj or "pingStatus" not in body_obj:
            self.ringpop.logger.warn(
                "bad response body in ping-req", {"address": self.member.address}
            )
            self.callback(
                errors.BadPingReqRespBodyError(
                    selected=self.member.address,
                    target=self.target.address,
                    body=res2,
                )
            )
            return

        self.ringpop.membership.update(body_obj["changes"])
        self.ringpop.debug_log(
            f"ping-req recv peer={self.member.address} "
            f"target={self.target.address} isOk={body_obj['pingStatus']}",
            "p",
        )

        if not body_obj["pingStatus"]:
            self.callback(
                errors.BadPingReqPingStatusError(
                    selected=self.member.address,
                    target=self.target.address,
                    ping_status=body_obj["pingStatus"],
                )
            )
            return

        self.callback(None)


def send_ping_req(
    ringpop: Any,
    unreachable_member: Any,
    ping_req_size: int,
    callback: Callable[..., None],
) -> None:
    ringpop.stat("increment", "ping-req.send")

    ping_req_members = ringpop.membership.get_random_pingable_members(
        ping_req_size, [unreachable_member.address]
    )
    ringpop.stat("timing", "ping-req.other-members", len(ping_req_members))

    if not ping_req_members:
        callback(errors.NoMembersError())
        return

    addrs = [m.address for m in ping_req_members]
    state = {"called_back": False}
    errs: list[Exception] = []

    def make_handler(ping_req_member: Any) -> Callable[..., None]:
        def on_ping_req(err: Any = None) -> None:
            if state["called_back"]:
                return

            # A reachable target is not explicitly marked alive here; that
            # happens through the piggybacked updates on the ping-req
            # exchange (ping-req-sender.js:201-215).
            if not err:
                state["called_back"] = True
                callback(
                    None,
                    {
                        "pingReqAddrs": addrs,
                        "pingReqSuccess": {"address": ping_req_member.address},
                    },
                )
                return

            errs.append(err)
            if len(errs) < len(ping_req_members):
                return  # keep waiting

            num_status_errs = sum(
                1
                for e in errs
                if getattr(e, "type", None) == "ringpop.ping-req.bad-ping-status"
            )
            if num_status_errs > 0:
                ringpop.logger.warn(
                    "ringpop ping-req determined member is unreachable",
                    {"local": ringpop.whoami(), "target": unreachable_member.address},
                )
                ringpop.membership.make_suspect(
                    unreachable_member.address,
                    unreachable_member.incarnation_number,
                )
                state["called_back"] = True
                callback(None, {"pingReqAddrs": addrs, "pingReqErrs": errs})
            else:
                ringpop.logger.warn(
                    "ringpop ping-req inconclusive due to errors",
                    {"local": ringpop.whoami(), "target": unreachable_member.address},
                )
                state["called_back"] = True
                callback(errors.PingReqInconclusiveError())

        return on_ping_req

    for member in ping_req_members:
        ringpop.debug_log(
            f"ping-req send peer={member.address} target={unreachable_member.address}",
            "p",
        )
        PingReqSender(
            ringpop, member, unreachable_member, make_handler(member)
        ).send()
