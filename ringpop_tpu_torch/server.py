"""Endpoint table + protocol/admin handlers.

Reference: server/index.js (14 endpoints) plus server/{join,ping,ping-req,
admin-join,admin-leave,admin-lookup,proxy-req}-handler.js.  Handlers take
``(head, body, host_info, respond)`` where respond(err, res1, res2) mirrors
sendNotOk/sendOk.

The port of ``ringpop_tpu/server.py``.
"""

from __future__ import annotations

from typing import Any, Callable

from ringpop_tpu_torch import errors
from ringpop_tpu_torch.swim.join_sender import join_cluster
from ringpop_tpu_torch.swim.ping_sender import send_ping
from ringpop_tpu_torch.utils.misc import safe_parse, to_json

Respond = Callable[..., None]


class RingpopServer:
    """Registers all endpoints on the node's channel (server/index.js:32-75)."""

    COMMANDS = {
        "/health": "health",
        "/admin/stats": "admin_stats",
        "/admin/ledger": "admin_ledger",
        "/admin/debugSet": "admin_debug_set",
        "/admin/debugClear": "admin_debug_clear",
        "/admin/gossip": "admin_gossip",
        "/admin/leave": "admin_leave",
        "/admin/lookup": "admin_lookup",
        "/admin/join": "admin_join",
        "/admin/reload": "admin_reload",
        "/admin/tick": "admin_tick",
        "/protocol/join": "protocol_join",
        "/protocol/ping": "protocol_ping",
        "/protocol/ping-req": "protocol_ping_req",
        "/proxy/req": "proxy_req",
    }

    def __init__(self, ringpop: Any, channel: Any):
        self.ringpop = ringpop
        self.channel = channel
        endpoints = {
            url: getattr(self, method) for url, method in self.COMMANDS.items()
        }
        channel.register(endpoints)

    # -- basic --------------------------------------------------------------

    def health(self, head: Any, body: Any, host_info: str, cb: Respond) -> None:
        cb(None, None, "ok")

    def admin_stats(self, head: Any, body: Any, host_info: str, cb: Respond) -> None:
        cb(None, None, to_json(self.ringpop.get_stats()))

    def admin_ledger(self, head: Any, body: Any, host_info: str, cb: Respond) -> None:
        """Dispatch-ledger summary of this process (the port's
        obs/ledger.py) — an extension endpoint: per-program cold/warm
        aggregates and peak bytes for any tensor work the node's process
        has dispatched (empty when the ledger is disabled or the process
        never dispatched)."""
        from ringpop_tpu_torch.obs.ledger import default_ledger

        ledger = default_ledger()
        cb(
            None,
            None,
            to_json(
                {
                    "enabled": ledger.enabled,
                    "path": ledger.path,
                    "dispatches": len(ledger.rows),
                    "summary": ledger.summary(),
                }
            ),
        )

    def admin_debug_set(self, head: Any, body: Any, host_info: str, cb: Respond) -> None:
        parsed = safe_parse(body)
        if parsed and parsed.get("debugFlag"):
            self.ringpop.set_debug_flag(parsed["debugFlag"])
        cb(None, None, "ok")

    def admin_debug_clear(self, head: Any, body: Any, host_info: str, cb: Respond) -> None:
        self.ringpop.clear_debug_flags()
        cb(None, None, "ok")

    def admin_gossip(self, head: Any, body: Any, host_info: str, cb: Respond) -> None:
        self.ringpop.gossip.start()
        cb(None, None, "ok")

    def admin_lookup(self, head: Any, body: Any, host_info: str, cb: Respond) -> None:
        key = body if isinstance(body, str) else (body or b"").decode()
        cb(None, None, to_json({"dest": self.ringpop.lookup(key)}))

    def admin_reload(self, head: Any, body: Any, host_info: str, cb: Respond) -> None:
        parsed = safe_parse(body)
        if parsed and parsed.get("file"):
            self.ringpop.reload(parsed["file"], lambda err=None: cb(err))
        else:
            cb(None)

    def admin_tick(self, head: Any, body: Any, host_info: str, cb: Respond) -> None:
        self.ringpop.handle_tick(lambda err, resp: cb(err, None, resp))

    # -- admin join/leave (server/admin-{join,leave}-handler.js) ------------

    def admin_join(self, head: Any, body: Any, host_info: str, cb: Respond) -> None:
        ringpop = self.ringpop
        if ringpop.membership.local_member is None:
            ringpop.clock.call_soon(lambda: cb(errors.InvalidLocalMemberError()))
            return
        if ringpop.membership.local_member.status == "leave":
            # Rejoin after leave: re-assert alive, restart gossip, reenable
            # suspicion (admin-join-handler.js:36-45).
            ringpop.membership.make_alive(ringpop.whoami(), int(ringpop.clock.now()))
            ringpop.gossip.start()
            ringpop.suspicion.reenable()
            cb(None, None, "rejoined")
            return

        def on_join(err: Any, candidate_hosts: Any = None) -> None:
            if err:
                return cb(err)
            cb(None, None, to_json({"candidateHosts": candidate_hosts}))

        join_cluster(
            ringpop,
            on_join,
            max_join_duration=ringpop.max_join_duration,
            join_size=ringpop.join_size,
        )

    def admin_leave(self, head: Any, body: Any, host_info: str, cb: Respond) -> None:
        ringpop = self.ringpop
        if ringpop.membership.local_member is None:
            ringpop.clock.call_soon(lambda: cb(errors.InvalidLocalMemberError()))
            return
        if ringpop.membership.local_member.status == "leave":
            ringpop.clock.call_soon(lambda: cb(errors.RedundantLeaveError()))
            return
        ringpop.membership.make_leave(
            ringpop.whoami(), ringpop.membership.local_member.incarnation_number
        )
        ringpop.gossip.stop()
        ringpop.suspicion.stop_all()
        ringpop.clock.call_soon(lambda: cb(None, None, "ok"))

    # -- protocol (server/{join,ping,ping-req}-handler.js) ------------------

    def protocol_join(self, head: Any, body: Any, host_info: str, cb: Respond) -> None:
        parsed = safe_parse(body)
        if parsed is None:
            return cb(Exception("need JSON req body with source and incarnationNumber"))
        app = parsed.get("app")
        source = parsed.get("source")
        incarnation_number = parsed.get("incarnationNumber")
        if app is None or source is None or incarnation_number is None:
            return cb(Exception("need req body with app, source and incarnationNumber"))

        ringpop = self.ringpop
        ringpop.stat("increment", "join.recv")
        # Validations (server/join-handler.js:44-74)
        if ringpop.is_denying_joins:
            return cb(errors.DenyJoinError())
        if source == ringpop.whoami():
            return cb(errors.InvalidJoinSourceError(actual=source))
        if app != ringpop.app:
            return cb(errors.InvalidJoinAppError(expected=ringpop.app, actual=app))

        ringpop.server_rate.mark()
        ringpop.total_rate.mark()
        ringpop.membership.make_alive(source, incarnation_number)
        cb(
            None,
            None,
            to_json(
                {
                    "app": ringpop.app,
                    "coordinator": ringpop.whoami(),
                    "membership": ringpop.dissemination.full_sync(),
                    "membershipChecksum": ringpop.membership.checksum,
                }
            ),
        )

    def protocol_ping(self, head: Any, body: Any, host_info: str, cb: Respond) -> None:
        parsed = safe_parse(body)
        if (
            parsed is None
            or not parsed.get("source")
            or parsed.get("changes") is None
            or not parsed.get("checksum")
        ):
            return cb(Exception("need req body with source, changes, and checksum"))

        ringpop = self.ringpop
        ringpop.stat("increment", "ping.recv")
        ringpop.server_rate.mark()
        ringpop.total_rate.mark()
        ringpop.membership.update(parsed["changes"])
        cb(
            None,
            None,
            to_json(
                {
                    "changes": ringpop.dissemination.issue_as_receiver(
                        parsed["source"],
                        parsed.get("sourceIncarnationNumber"),
                        parsed["checksum"],
                    )
                }
            ),
        )

    def protocol_ping_req(self, head: Any, body: Any, host_info: str, cb: Respond) -> None:
        parsed = safe_parse(body)
        if (
            parsed is None
            or not parsed.get("source")
            or not parsed.get("target")
            or parsed.get("changes") is None
            or not parsed.get("checksum")
        ):
            return cb(Exception("need req body with source, target, changes, and checksum"))

        ringpop = self.ringpop
        ringpop.stat("increment", "ping-req.recv")
        source = parsed["source"]
        source_inc = parsed.get("sourceIncarnationNumber")
        target = parsed["target"]
        ringpop.server_rate.mark()
        ringpop.total_rate.mark()
        ringpop.membership.update(parsed["changes"])
        ringpop.debug_log(f"ping-req send ping source={source} target={target}", "p")

        def on_ping(is_ok: bool, ping_body: Any) -> None:
            ringpop.debug_log(
                f"ping-req recv ping source={source} target={target} isOk={is_ok}", "p"
            )
            if is_ok:
                ringpop.membership.update(ping_body.get("changes", []))
            cb(
                None,
                None,
                to_json(
                    {
                        "changes": ringpop.dissemination.issue_as_receiver(
                            source, source_inc, parsed["checksum"]
                        ),
                        "pingStatus": is_ok,
                        "target": target,
                    }
                ),
            )

        send_ping(ringpop, target, on_ping)

    # -- forwarding (server/proxy-req-handler.js) ---------------------------

    def proxy_req(self, head: Any, body: Any, host_info: str, cb: Respond) -> None:
        header = safe_parse(head)
        if header is None:
            return cb(Exception("need header to exist"))
        self.ringpop.request_proxy.handle_request(header, body, cb)


def create_server(ringpop: Any, channel: Any) -> RingpopServer:
    return RingpopServer(ringpop, channel)
