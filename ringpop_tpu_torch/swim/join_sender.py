"""Bootstrap join (reference: lib/swim/join-sender.js).

Selects random groups of bootstrap hosts (preferring other physical
hosts), sends ``/protocol/join``, retries rounds with backoff until
``join_size`` nodes have been joined, bounded by attempts and duration.
Responses are merged once at the end and applied to membership.

The port of ``ringpop_tpu/swim/join_sender.py``.
"""

from __future__ import annotations

from typing import Any, Callable

from ringpop_tpu_torch import errors
from ringpop_tpu_torch.swim.join_response_merge import merge_join_responses
from ringpop_tpu_torch.utils.misc import capture_host, is_empty_array, num_or_default, safe_parse, to_json

JOIN_RETRY_DELAY = 100
JOIN_SIZE = 3
JOIN_TIMEOUT = 1000
# The aim is for a join to take no more than 1s under normal conditions
# (join-sender.js:51-67).
MAX_JOIN_DURATION = 120000
MAX_JOIN_ATTEMPTS = 50
PARALLELISM_FACTOR = 2


def _is_single_node_cluster(ringpop: Any) -> bool:
    hosts = ringpop.bootstrap_hosts
    return isinstance(hosts, list) and len(hosts) == 1 and hosts[0] == ringpop.host_port


class JoinCluster:
    def __init__(
        self,
        ringpop: Any,
        join_size: int | None = None,
        parallelism_factor: float | None = None,
        join_timeout: float | None = None,
        max_join_duration: float | None = None,
        max_join_attempts: int | None = None,
        join_retry_delay: float | None = None,
    ):
        if ringpop is None:
            raise errors.OptionRequiredError("ringpop")
        if is_empty_array(ringpop.bootstrap_hosts) or ringpop.bootstrap_hosts is None:
            raise errors.InvalidOptionError(
                "ringpop", "`bootstrapHosts` is expected to be an array of size 1 or more"
            )

        self.ringpop = ringpop
        self.host = capture_host(ringpop.host_port)
        self.join_timeout = num_or_default(join_timeout, JOIN_TIMEOUT)
        self.parallelism_factor = num_or_default(parallelism_factor, PARALLELISM_FACTOR)
        self.max_join_duration = num_or_default(max_join_duration, MAX_JOIN_DURATION)
        self.max_join_attempts = num_or_default(max_join_attempts, MAX_JOIN_ATTEMPTS)
        self.join_retry_delay = num_or_default(join_retry_delay, JOIN_RETRY_DELAY)

        self.potential_nodes = self.collect_potential_nodes([])
        self.preferred_nodes: list[str] | None = None
        self.non_preferred_nodes: list[str] | None = None

        join_size = int(num_or_default(join_size, JOIN_SIZE))
        self.join_size = min(join_size, len(self.potential_nodes))

        self.round_preferred_nodes: list[str] | None = None
        self.round_non_preferred_nodes: list[str] | None = None

        self.join_responses: list[dict[str, Any]] | None = []
        self.destroyed = False

    def destroy(self) -> None:
        self.destroyed = True

    # -- node selection (join-sender.js:155-197,449-487) --------------------

    def collect_potential_nodes(self, nodes_joined: list[str]) -> list[str]:
        return [
            host
            for host in self.ringpop.bootstrap_hosts
            if host != self.ringpop.host_port and host not in nodes_joined
        ]

    def collect_preferred_nodes(self) -> list[str]:
        """Nodes on other physical hosts."""
        return [h for h in self.potential_nodes if capture_host(h) != self.host]

    def collect_non_preferred_nodes(self) -> list[str]:
        if is_empty_array(self.preferred_nodes):
            return self.potential_nodes
        return [h for h in self.potential_nodes if h not in self.preferred_nodes]

    def init(self, nodes_joined: list[str]) -> None:
        self.potential_nodes = self.collect_potential_nodes(nodes_joined)
        self.preferred_nodes = self.collect_preferred_nodes()
        self.non_preferred_nodes = self.collect_non_preferred_nodes()
        self.round_preferred_nodes = list(self.preferred_nodes)
        self.round_non_preferred_nodes = list(self.non_preferred_nodes)

    def select_group(self, nodes_joined: list[str]) -> list[str]:
        if is_empty_array(self.round_preferred_nodes) and is_empty_array(
            self.round_non_preferred_nodes
        ):
            self.init(nodes_joined)

        preferred = self.round_preferred_nodes
        non_preferred = self.round_non_preferred_nodes
        num_nodes_left = self.join_size - len(nodes_joined)
        group: list[str] = []

        def take_node(hosts: list[str]) -> str:
            index = int(self.ringpop.rng.random() * len(hosts))
            return hosts.pop(index)

        while (
            len(group) != num_nodes_left * self.parallelism_factor
            and len(preferred) + len(non_preferred) > 0
        ):
            if preferred:
                group.append(take_node(preferred))
            elif non_preferred:
                group.append(take_node(non_preferred))

        return group

    # -- join rounds (join-sender.js:199-388) -------------------------------

    def join(self, callback: Callable[..., None]) -> None:
        if self.ringpop.destroyed:
            self.ringpop.clock.call_soon(
                lambda: callback(errors.JoinAbortedError("joiner was destroyed"))
            )
            return

        if _is_single_node_cluster(self.ringpop):
            self.ringpop.logger.info(
                "ringpop received a single node cluster join",
                {"local": self.ringpop.whoami()},
            )
            self.ringpop.clock.call_soon(lambda: callback(None, []))
            return

        nodes_joined: list[str] = []
        state = {"num_joined": 0, "num_failed": 0, "num_groups": 0, "called_back": False}
        start_time = self.ringpop.clock.now()

        def on_join(err: Any, nodes: dict[str, list[str]] | None = None) -> None:
            if state["called_back"]:
                return
            if self.ringpop.destroyed or self.destroyed:
                state["called_back"] = True
                callback(errors.JoinAbortedError("joiner was destroyed"))
                return
            if err:
                state["called_back"] = True
                callback(err)
                return

            nodes_joined.extend(nodes["successes"])
            state["num_joined"] += len(nodes["successes"])
            state["num_failed"] += len(nodes["failures"])
            state["num_groups"] += 1

            if state["num_joined"] >= self.join_size:
                join_time = self.ringpop.clock.now() - start_time
                updates = merge_join_responses(
                    self.ringpop.whoami(), self.join_responses or []
                )
                # Update membership only once, when join completes.
                self.ringpop.membership.update(updates)
                self.join_responses = None
                self.ringpop.stat("timing", "join", join_time)
                self.ringpop.stat("increment", "join.complete")
                state["called_back"] = True
                callback(None, nodes_joined)
            elif state["num_failed"] >= self.max_join_attempts:
                self.ringpop.logger.warn(
                    "ringpop max join attempts exceeded",
                    {"local": self.ringpop.whoami(), "numFailed": state["num_failed"]},
                )
                state["called_back"] = True
                callback(
                    errors.JoinAttemptsExceededError(
                        state["num_failed"], int(self.max_join_attempts)
                    )
                )
            else:
                join_duration = self.ringpop.clock.now() - start_time
                if join_duration > self.max_join_duration:
                    self.ringpop.logger.warn(
                        "ringpop max join duration exceeded",
                        {"local": self.ringpop.whoami(), "joinDuration": join_duration},
                    )
                    state["called_back"] = True
                    callback(
                        errors.JoinDurationExceededError(
                            join_duration, self.max_join_duration
                        )
                    )
                    return
                self.ringpop.clock.call_later(
                    self.join_retry_delay,
                    lambda: self.join_group(nodes_joined, on_join),
                )

        self.join_group(nodes_joined, on_join)

    def join_group(
        self, total_nodes_joined: list[str], callback: Callable[..., None]
    ) -> None:
        group = self.select_group(total_nodes_joined)
        self.ringpop.logger.debug(
            "ringpop selected join group",
            {"local": self.ringpop.whoami(), "group": group},
        )

        nodes_joined: list[str] = []
        nodes_failed: list[str] = []
        num_nodes_left = self.join_size - len(total_nodes_joined)
        state = {"called_back": False}

        if not group:
            # Nothing available to try this round; report an empty group so
            # the round loop applies its duration/attempt limits.
            self.ringpop.clock.call_soon(
                lambda: callback(None, {"successes": [], "failures": []})
            )
            return

        def on_join(err: Any, node: str | None = None) -> None:
            if state["called_back"]:
                return
            if err:
                nodes_failed.append(node)
            else:
                nodes_joined.append(node)
            num_completed = len(nodes_joined) + len(nodes_failed)
            if len(nodes_joined) >= num_nodes_left or num_completed >= len(group):
                state["called_back"] = True
                callback(None, {"successes": nodes_joined, "failures": nodes_failed})

        for node in group:
            self.join_node(node, on_join)

    def join_node(self, node: str, callback: Callable[..., None]) -> None:
        join_body = to_json(
            {
                "app": self.ringpop.app,
                "source": self.ringpop.whoami(),
                "incarnationNumber": self.ringpop.membership.local_member.incarnation_number,
            }
        )

        def on_send(err: Any, res1: Any = None, res2: Any = None) -> None:
            if err:
                return callback(err, node)
            body_obj = safe_parse(res2)
            # join_responses is None once the join completed; late
            # responses are dropped (join-sender.js:432-441).
            if body_obj and self.join_responses is not None:
                self.join_responses.append(
                    {
                        "checksum": body_obj.get("membershipChecksum"),
                        "members": body_obj.get("membership"),
                    }
                )
            callback(None, node)

        self.ringpop.channel.request(
            node, "/protocol/join", None, join_body, self.join_timeout, on_send
        )


def create_joiner(ringpop: Any, **opts: Any) -> JoinCluster:
    return JoinCluster(ringpop, **opts)


def join_cluster(ringpop: Any, callback: Callable[..., None], **opts: Any) -> JoinCluster:
    joiner = create_joiner(ringpop, **opts)
    joiner.join(callback)
    return joiner
