"""The RingPop facade: full API parity with the reference's index.js.

Wires Membership + Dissemination + HashRing + SWIM engine + RequestProxy
behind one object (index.js:57-154), exposing bootstrap, lookup/lookupN,
handleOrProxy(All), proxyReq, getStats, whoami, admin ops and events.

Time, randomness and transport are injected (``clock``, ``rng``,
``channel``) so the same code runs deterministically under the in-process
harness and in real asyncio/TCP deployments — and so the TPU simulation
backend (models/swim_sim.py) can be validated against it.

The port of ``ringpop_tpu/ringpop.py``.  Its one addition is ``device``:
the device where the node's ``HashRing`` hashes each batch of replica
names (the FarmHash32 kernel on the card).  It is ``cuda`` unless the
caller names another, and with no card and no ``device`` the
constructor raises; a ring on the card never hashes a batch on the host.
"""

from __future__ import annotations

import collections
import os
import random
from typing import Any, Callable

from ringpop_tpu_torch import errors
from ringpop_tpu_torch.clock import SimScheduler
from ringpop_tpu_torch.dissemination import Dissemination
from ringpop_tpu_torch.gossip import Gossip
from ringpop_tpu_torch.hashring import HashRing
from ringpop_tpu_torch.iterator import MembershipIterator
from ringpop_tpu_torch.listeners import (
    create_event_forwarder,
    create_membership_set_listener,
    create_membership_update_listener,
)
from ringpop_tpu_torch.membership import Membership
from ringpop_tpu_torch.request_proxy.head import raw_head
from ringpop_tpu_torch.request_proxy.http import ProxyResponse
from ringpop_tpu_torch.request_proxy.proxy import RequestProxy
from ringpop_tpu_torch.rollup import MembershipUpdateRollup
from ringpop_tpu_torch.server import create_server
from ringpop_tpu_torch.stats import Histogram, Meter
from ringpop_tpu_torch.suspicion import Suspicion
from ringpop_tpu_torch.swim.join_sender import join_cluster
from ringpop_tpu_torch.swim.ping_req_sender import send_ping_req
from ringpop_tpu_torch.swim.ping_sender import send_ping
from ringpop_tpu_torch.utils.misc import safe_parse, to_json
from ringpop_tpu_torch.utils.nulls import NullLogger, NullStatsd
from ringpop_tpu_torch.utils.events import EventEmitter
from ringpop_tpu_torch import __version__, resolve_device

MAX_JOIN_DURATION = 300000  # index.js:53
MEMBERSHIP_UPDATE_FLUSH_INTERVAL = 5000  # index.js:54
PROXY_REQ_PROPS = ("keys", "dest", "req", "res")


class RingPop(EventEmitter):
    def __init__(
        self,
        app: str = None,
        host_port: str = None,
        channel: Any = None,
        clock: Any = None,
        rng: random.Random | None = None,
        logger: Any = None,
        statsd: Any = None,
        bootstrap_file: Any = None,
        join_size: int | None = None,
        ping_req_timeout: float | None = None,
        ping_timeout: float | None = None,
        join_timeout: float | None = None,
        proxy_req_timeout: float | None = None,
        max_join_duration: float | None = None,
        min_protocol_period: float | None = None,
        suspicion_timeout: float | None = None,
        membership_update_flush_interval: float | None = None,
        request_proxy_max_retries: int | None = None,
        request_proxy_retry_schedule: list[float] | None = None,
        enforce_consistency: bool | None = None,
        faulty_probe_period: int | None = 10,
        damping_enabled: bool = False,
        damping_options: dict[str, float] | None = None,
        device: Any = None,
    ):
        super().__init__()

        # Option validation (index.js:62-85)
        if not isinstance(app, str) or len(app) == 0:
            raise errors.AppRequiredError()
        parts = host_port.split(":") if isinstance(host_port, str) else None
        is_colon_separated = parts is not None and len(parts) == 2
        is_port = is_colon_separated and parts[1].isdigit()
        if not isinstance(host_port, str) or not is_colon_separated or not is_port:
            reason = (
                "a string"
                if not isinstance(host_port, str)
                else "a valid hostPort pattern"
                if not is_colon_separated
                else "a valid port"
            )
            raise errors.HostPortRequiredError(host_port=host_port, reason=reason)
        # before anything is opened: with no card and no device, raise
        self.device = resolve_device(device)

        self.app = app
        self.host_port = host_port
        self.channel = channel
        self.clock = clock or SimScheduler()
        self.rng = rng or random.Random()
        self.logger = logger or NullLogger()
        # Only an emitter WE build (from a spec string) is ours to close
        # on destroy(); a caller-injected object may be shared by other
        # nodes (the harness cluster passes one emitter to every node).
        self._owns_statsd = isinstance(statsd, str)
        if self._owns_statsd:
            # emitter spec string ("statsd://HOST:PORT", a .jsonl path,
            # "-", "capture") — the obs subsystem's sink forms
            from ringpop_tpu_torch.obs.emitters import make_emitter

            statsd = make_emitter(statsd)
        self.statsd = statsd or NullStatsd()
        self.bootstrap_file = bootstrap_file

        self.is_ready = False
        self.is_denying_joins = False

        self.debug_flags: dict[str, bool] = {}
        self.join_size = join_size
        self.ping_req_size = 3  # ping-req fanout (index.js:99)
        self.ping_req_timeout = ping_req_timeout or 5000
        self.ping_timeout = ping_timeout or 1500
        self.join_timeout = join_timeout or 1000
        self.proxy_req_timeout = proxy_req_timeout or 30000
        self.max_join_duration = max_join_duration or MAX_JOIN_DURATION
        self.membership_update_flush_interval = (
            membership_update_flush_interval or MEMBERSHIP_UPDATE_FLUSH_INTERVAL
        )

        self.damping = None  # set after wiring; listeners null-check it

        self.request_proxy = RequestProxy(
            self,
            max_retries=request_proxy_max_retries,
            retry_schedule=request_proxy_retry_schedule,
            enforce_consistency=enforce_consistency,
        )
        self.ring = HashRing(device=self.device)
        self.dissemination = Dissemination(self)
        self.membership = Membership(self)
        self.membership.on("set", create_membership_set_listener(self))
        self.membership.on("updated", create_membership_update_listener(self))
        self.member_iterator = MembershipIterator(self)
        self.gossip = Gossip(self, min_protocol_period=min_protocol_period)
        self.suspicion = Suspicion(self, suspicion_timeout=suspicion_timeout)
        self.membership_update_rollup = MembershipUpdateRollup(
            self, flush_interval=self.membership_update_flush_interval
        )
        create_event_forwarder(self)

        # EXTENSION: flap damping — documented by the reference
        # (docs/architecture_design.md:73-82) but never implemented there
        # (SURVEY §5.3).  Off by default for strict reference behavior.
        if damping_enabled:
            from ringpop_tpu_torch.damping import MemberDamping

            self.damping = MemberDamping(self, **(damping_options or {}))

        # rates tick on the injected clock so virtual-time runs stay
        # deterministic (Meter defaults to wall time otherwise)
        now_s = lambda: self.clock.now() / 1000.0  # noqa: E731
        self.client_rate = Meter(now_fn=now_s)
        self.server_rate = Meter(now_fn=now_s)
        self.total_rate = Meter(now_fn=now_s)

        # 10.30.8.26:20600 -> 10_30_8_26_20600 (index.js:141-145)
        self.stat_host_port = self.host_port.replace(".", "_").replace(":", "_")
        self.stat_prefix = f"ringpop.{self.stat_host_port}"
        self.stat_keys: dict[str, str] = {}
        self.stats_hooks: dict[str, Any] = {}
        # every timing stat also feeds a local reservoir so /admin/stats
        # can answer with p50/p95/p99 aggregates (the reference's
        # protocol timing percentiles, gossip.js:33) even when statsd is
        # a fire-and-forget UDP sink
        self.timing_histograms: dict[str, Histogram] = {}

        self.destroyed = False
        self.joiner = None
        self.is_pinging = False
        self.bootstrap_hosts: list[str] | None = None

        # EXTENSION over the reference: every Nth protocol period, probe a
        # random faulty member instead of the iterator's pick.  The
        # reference never pings faulty members (membership.js:135-139), so
        # a fully-partitioned cluster whose sides declared each other
        # faulty can never auto-merge after the split heals — its netsplit
        # test helper was left unfinished (test/lib/partition-cluster.js).
        # This is the standard SWIM gossip-to-dead anti-entropy fix; the
        # exchange triggers full syncs + refutation and the split merges.
        # Set faulty_probe_period=None to get strict reference behavior.
        self.faulty_probe_period = faulty_probe_period
        self._protocol_period_count = 0

        self.start_time = self.clock.now()

    # -- lifecycle ----------------------------------------------------------

    def setup_channel(self) -> None:
        create_server(self, self.channel)

    def destroy(self) -> None:
        self.destroyed = True
        if not self.gossip.is_stopped:
            self.gossip.stop()
        self.suspicion.stop_all()
        self.membership_update_rollup.destroy()
        self.request_proxy.destroy()
        if self.joiner is not None:
            self.joiner.destroy()
        if self.channel is not None and not self.channel.destroyed:
            self.channel.close()
        if self._owns_statsd:
            close = getattr(self.statsd, "close", None)
            if close is not None:
                close()  # flush file-backed emitters (obs.emitters)

    def whoami(self) -> str:
        return self.host_port

    # -- bootstrap (index.js:200-292) ---------------------------------------

    def bootstrap(self, opts: Any = None, callback: Callable[..., None] | None = None) -> None:
        bootstrap_file = None
        join_parallelism_factor = None
        if callable(opts):
            callback = opts
        elif isinstance(opts, dict):
            bootstrap_file = opts.get("bootstrapFile")
            join_parallelism_factor = opts.get("joinParallelismFactor")
        elif opts is not None:
            bootstrap_file = opts

        if self.is_ready:
            msg = "ringpop is already ready"
            self.logger.warn(msg, {"address": self.host_port})
            if callback:
                callback(Exception(msg))
            return

        bootstrap_time = self.clock.now()
        self.seed_bootstrap_hosts(bootstrap_file)

        if not isinstance(self.bootstrap_hosts, list) or not self.bootstrap_hosts:
            msg = (
                "ringpop cannot be bootstrapped without bootstrap hosts."
                " make sure you specify a valid bootstrap hosts file to the"
                " ringpop constructor or have a valid hosts.json file in the"
                " current working directory."
            )
            self.logger.warn(msg)
            if callback:
                callback(Exception(msg))
            return

        self.check_for_missing_bootstrap_host()

        # Add local member (stashed until set(), index.js:235).
        self.membership.make_alive(self.whoami(), int(self.clock.now()))

        def on_join(err: Any, nodes_joined: Any = None) -> None:
            if err:
                self.logger.error(
                    "ringpop bootstrap failed",
                    {"error": str(err), "address": self.host_port},
                )
                if callback:
                    callback(err)
                return
            if self.destroyed:
                msg2 = "ringpop was destroyed during bootstrap"
                self.logger.error(msg2, {"address": self.host_port})
                if callback:
                    callback(Exception(msg2))
                return

            # Atomic apply of stashed changes, then go live.
            self.membership.set()
            self.gossip.start()
            self.is_ready = True

            self.logger.debug(
                "ringpop is ready",
                {
                    "address": self.host_port,
                    "memberCount": self.membership.get_member_count(),
                    "bootstrapTime": self.clock.now() - bootstrap_time,
                },
            )
            self.emit("ready")
            if callback:
                callback(None, nodes_joined)

        self.joiner = join_cluster(
            self,
            on_join,
            max_join_duration=self.max_join_duration,
            join_size=self.join_size,
            parallelism_factor=join_parallelism_factor,
            join_timeout=self.join_timeout,
        )

    def check_for_missing_bootstrap_host(self) -> bool:
        if self.host_port not in self.bootstrap_hosts:
            self.logger.warn(
                "bootstrap hosts does not include the host/port of the local node",
                {"address": self.host_port},
            )
            return False
        return True

    def read_hosts_file(self, file: Any) -> Any:
        if not file:
            return False
        if not os.path.exists(file):
            self.logger.warn("bootstrap hosts file does not exist", {"file": file})
            return False
        try:
            with open(file) as f:
                return safe_parse(f.read())
        except OSError as e:
            self.logger.warn(
                "failed to read bootstrap hosts file", {"error": str(e), "file": file}
            )
            return False

    def seed_bootstrap_hosts(self, file: Any) -> None:
        if isinstance(file, list):
            self.bootstrap_hosts = file
        else:
            self.bootstrap_hosts = (
                self.read_hosts_file(file)
                or self.read_hosts_file(self.bootstrap_file)
                or self.read_hosts_file("./hosts.json")
                or None
            )

    def reload(self, file: Any, callback: Callable[..., None]) -> None:
        self.seed_bootstrap_hosts(file)
        callback()

    # -- SWIM round driver (index.js:458-515) -------------------------------

    def ping_member_now(self, callback: Callable[..., None] | None = None) -> None:
        callback = callback or (lambda *a: None)

        if self.damping is not None:
            # a quiet cluster must still reinstate decayed members
            self.damping.decay_tick()

        if self.is_pinging:
            self.logger.warn("aborting ping because one is in progress")
            return callback()
        if not self.is_ready:
            self.logger.warn("ping started before ring initialized")
            return callback()

        self._protocol_period_count += 1
        member = None
        if (
            self.faulty_probe_period
            and self._protocol_period_count % self.faulty_probe_period == 0
        ):
            faulty = [
                m
                for m in self.membership.members
                if m.status == "faulty" and m.address != self.whoami()
            ]
            if faulty:
                member = faulty[int(self.rng.random() * len(faulty))]
        if member is None:
            member = self.member_iterator.next()
        if member is None:
            self.logger.warn("no usable nodes at protocol period")
            return callback()

        self.is_pinging = True
        start = self.clock.now()

        def on_ping(is_ok: bool, body: Any) -> None:
            self.stat("timing", "ping", self.clock.now() - start)
            if is_ok:
                self.is_pinging = False
                self.membership.update(body.get("changes", []))
                return callback()

            if self.destroyed:
                return callback(Exception("destroyed whilst pinging"))

            ping_req_start = self.clock.now()

            def on_ping_req(*args: Any) -> None:
                self.stat("timing", "ping-req", self.clock.now() - ping_req_start)
                self.is_pinging = False
                callback(*args)

            send_ping_req(self, member, self.ping_req_size, on_ping_req)

        send_ping(self, member, on_ping)

    def handle_tick(self, cb: Callable[..., None]) -> None:
        def on_pinged(*_args: Any) -> None:
            cb(None, to_json({"checksum": self.membership.checksum}))

        self.ping_member_now(on_pinged)

    # -- lookup (index.js:409-446) ------------------------------------------

    def lookup(self, key: Any) -> str:
        start = self.clock.now()
        dest = self.ring.lookup(str(key))
        # timing stat + local histogram (same path as ping/ping-req), so
        # get_stats()["lookup"] answers p50/p95/p99 without a collector
        self.stat("timing", "lookup", self.clock.now() - start)
        self.emit("lookup", {"timing": self.clock.now() - start})
        if not dest:
            self.logger.debug("could not find destination for a key", {"key": key})
            return self.whoami()
        return dest

    def lookup_n(self, key: Any, n: int) -> list[str]:
        start = self.clock.now()
        dests = self.ring.lookup_n(str(key), n)
        self.stat("timing", "lookupn", self.clock.now() - start)
        self.emit("lookupN", {"timing": self.clock.now() - start})
        if not dests:
            self.logger.debug("could not find destinations for a key", {"key": key})
            return [self.whoami()]
        return dests

    # -- forwarding (index.js:577-694) --------------------------------------

    def proxy_req(self, opts: dict[str, Any]) -> None:
        if not opts:
            raise errors.OptionsRequiredError("proxyReq")
        self.validate_props(opts, PROXY_REQ_PROPS)
        self.request_proxy.proxy_req(opts)

    def handle_or_proxy(
        self, key: Any, req: Any, res: Any, opts: dict[str, Any] | None = None
    ) -> bool | None:
        dest = self.lookup(key)
        if self.whoami() == dest:
            return True
        merged = dict(opts or {})
        merged.update({"keys": [key], "dest": dest, "req": req, "res": res})
        self.proxy_req(merged)
        return None

    def handle_or_proxy_all(
        self, opts: dict[str, Any], cb: Callable[..., None] | None = None
    ) -> None:
        keys = opts["keys"]
        req = opts.get("req")
        whoami = self.whoami()

        keys_by_dest: dict[str, list[Any]] = collections.defaultdict(list)
        for key in keys:
            keys_by_dest[self.lookup(key)].append(key)

        dests = list(keys_by_dest.keys())
        state = {"pending": len(dests), "done": False}
        responses: list[dict[str, Any]] = []

        if state["pending"] == 0 and cb:
            return cb(None, responses)

        def on_response(err: Any, resp: Any, dest: str) -> None:
            responses.append(
                {"res": resp, "dest": dest, "keys": keys_by_dest[dest]}
            )
            state["pending"] -= 1
            if (state["pending"] == 0 or err) and cb and not state["done"]:
                state["done"] = True
                cb(err, responses)

        for dest in dests:
            dest_keys = keys_by_dest[dest]
            res = ProxyResponse(
                lambda err, resp, d=dest: on_response(err, resp, d)
            )
            if whoami == dest:
                head = raw_head(req, self.membership.checksum, dest_keys)
                self.emit("request", req, res, head)
            else:
                merged = dict(opts)
                merged.update(
                    {"keys": dest_keys, "req": req, "res": res, "dest": dest}
                )
                self.proxy_req(merged)

    # -- stats / debug (index.js:348-405,547-605) ---------------------------

    def get_stats(self) -> dict[str, Any]:
        timestamp = self.clock.now()
        stats = {
            "damping": self.damping.get_stats() if self.damping else None,
            "hooks": self.get_stats_hooks_stats(),
            "membership": self.membership.get_stats(),
            "process": {"pid": os.getpid()},
            "protocol": {
                "timing": self.gossip.protocol_timing.print_obj(),
                "protocolRate": self.gossip.compute_protocol_rate(),
                "clientRate": self.client_rate.print_obj()["m1"],
                "serverRate": self.server_rate.print_obj()["m1"],
                "totalRate": self.total_rate.print_obj()["m1"],
                # per-operation aggregates of the timing stats emitted at
                # ping_member_now (the reference ships these only to
                # statsd; /admin/stats answering locally means a cluster
                # with no collector still has its percentiles)
                "ping": self.timing_stats("ping"),
                "pingReq": self.timing_stats("ping-req"),
            },
            "ring": list(self.ring.servers.keys()),
            # serving-layer timing aggregates (the lookup/lookupn stats
            # emitted above; tick-cluster's `p` command prints them)
            "lookup": self.timing_stats("lookup"),
            "lookupN": self.timing_stats("lookupn"),
            "version": __version__,
            "timestamp": timestamp,
            "uptime": timestamp - self.start_time,
        }
        return stats

    def timing_stats(self, key: str) -> dict[str, Any]:
        """Histogram aggregate (count/min/max/median/p95/p99 ...) of a
        timing stat key, zeros-shaped before the first sample."""
        hist = self.timing_histograms.get(key)
        return (hist or Histogram()).print_obj()

    def get_stats_hooks_stats(self) -> dict[str, Any] | None:
        if not self.stats_hooks:
            return None
        return {name: hook.get_stats() for name, hook in self.stats_hooks.items()}

    def is_stats_hook_registered(self, name: str) -> bool:
        return name in self.stats_hooks

    def register_stats_hook(self, hook: Any) -> None:
        if not hook:
            raise errors.ArgumentRequiredError("hook")
        name = getattr(hook, "name", None) or (
            hook.get("name") if isinstance(hook, dict) else None
        )
        if not name:
            raise errors.FieldRequiredError("hook", "name")
        get_stats = getattr(hook, "get_stats", None) or (
            hook.get("get_stats") if isinstance(hook, dict) else None
        )
        if not callable(get_stats):
            raise errors.MethodRequiredError("hook", "getStats")
        if self.is_stats_hook_registered(name):
            raise errors.DuplicateHookError(name)
        if isinstance(hook, dict):
            hook = type("StatsHook", (), {"name": name, "get_stats": staticmethod(get_stats)})()
        self.stats_hooks[name] = hook

    def set_debug_flag(self, flag: str) -> None:
        self.debug_flags[flag] = True

    def clear_debug_flags(self) -> None:
        self.debug_flags = {}

    def debug_log(self, msg: str, flag: str = None) -> None:
        if self.debug_flags and self.debug_flags.get(flag):
            self.logger.info(msg)

    def stat(self, type_: str, key: str, value: Any = None) -> None:
        if key not in self.stat_keys:
            self.stat_keys[key] = f"{self.stat_prefix}.{key}"
        fq_key = self.stat_keys[key]
        if type_ == "increment":
            self.statsd.increment(fq_key, value)
        elif type_ == "gauge":
            self.statsd.gauge(fq_key, value)
        elif type_ == "timing":
            self.statsd.timing(fq_key, value)
            hist = self.timing_histograms.get(key)
            if hist is None:
                hist = self.timing_histograms[key] = Histogram(seed=0)
            if value is not None:
                hist.update(value)

    # -- test hooks (index.js:696-704) --------------------------------------

    def allow_joins(self) -> None:
        self.is_denying_joins = False

    def deny_joins(self) -> None:
        self.is_denying_joins = True

    def validate_props(self, opts: dict[str, Any], props: tuple) -> None:
        for prop in props:
            if not opts.get(prop):
                raise errors.PropertyRequiredError(prop)
