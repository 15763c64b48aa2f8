"""In-process multi-node cluster harness.

Mirrors the reference's two harness shapes (SURVEY §4):
* ``test_ringpop`` — one real RingPop with no channel, forced ready
  (test/lib/test-ringpop.js:25-64);
* ``Cluster`` — N real RingPops in one process wired through the
  deterministic in-process transport, with a pre-bootstrap ``tap`` hook for
  sabotage (test/lib/test-ringpop-cluster.js:122-138) and tick-cluster's
  fault injection (kill/suspend/revive/partition) as first-class methods.

Because time is virtual, "wait for convergence" is ``run_until_converged``:
advance the shared scheduler until all nodes report one membership checksum.

The port of ``ringpop_tpu/harness.py``.  ``test_ringpop`` and ``Cluster``
take ``device``, where every node's ring hashes its replica names
(``cuda`` unless the caller names another; with no card and no
``device`` they raise).  ``Cluster.revive`` builds the new node without
the cluster's other node options, as the reference does, but on the
cluster's device.
"""

from __future__ import annotations

import random
from typing import Any, Callable

from ringpop_tpu_torch import resolve_device
from ringpop_tpu_torch.clock import SimScheduler
from ringpop_tpu_torch.ringpop import RingPop
from ringpop_tpu_torch.transport.inproc import InProcessChannel, InProcessNetwork


def test_ringpop(
    app: str = "test",
    host_port: str = "127.0.0.1:3000",
    make_alive: bool = True,
    clock: SimScheduler | None = None,
    seed: int = 1,
    device: Any = None,
    **opts: Any,
) -> RingPop:
    """A single ready RingPop with no channel (unit-test fixture)."""
    clock = clock or SimScheduler()
    rp = RingPop(
        app=app, host_port=host_port, clock=clock, rng=random.Random(seed),
        device=device, **opts
    )
    rp.is_ready = True
    if make_alive:
        rp.membership.make_alive(rp.whoami(), int(clock.now()))
    return rp


class Cluster:
    def __init__(
        self,
        size: int = 3,
        app: str = "test",
        base_port: int = 10000,
        host: str = "127.0.0.1",
        latency_ms: float = 1.0,
        seed: int = 1,
        tap: Callable[[list[RingPop]], None] | None = None,
        device: Any = None,
        **node_opts: Any,
    ):
        self.device = resolve_device(device)
        self.scheduler = SimScheduler()
        self.rng = random.Random(seed)
        self.network = InProcessNetwork(
            self.scheduler, latency_ms=latency_ms, rng=random.Random(seed + 1)
        )
        self.host_ports = [f"{host}:{base_port + i}" for i in range(size)]
        self.nodes: list[RingPop] = []
        for i, host_port in enumerate(self.host_ports):
            channel = InProcessChannel(self.network, host_port)
            node = RingPop(
                app=app,
                host_port=host_port,
                channel=channel,
                clock=self.scheduler,
                rng=random.Random(seed + 100 + i),
                device=self.device,
                **node_opts,
            )
            node.setup_channel()
            self.nodes.append(node)
        if tap is not None:
            tap(self.nodes)

    # -- lifecycle ----------------------------------------------------------

    def bootstrap_all(
        self, run: bool = True, max_ms: float = 60000
    ) -> list[Any]:
        results: list[Any] = [None] * len(self.nodes)

        for i, node in enumerate(self.nodes):
            def on_bootstrap(err: Any, nodes_joined: Any = None, i: int = i) -> None:
                results[i] = err or (nodes_joined if nodes_joined is not None else [])

            node.bootstrap(list(self.host_ports), on_bootstrap)

        if run:
            self.run(max_ms)
        return results

    def destroy_all(self) -> None:
        for node in self.nodes:
            if not node.destroyed:
                node.destroy()

    # -- time control --------------------------------------------------------

    def run(self, ms: float) -> None:
        self.scheduler.advance(ms)

    def run_until_converged(
        self, max_ms: float = 120000, step_ms: float = 200
    ) -> bool:
        elapsed = 0.0
        while elapsed < max_ms:
            if self.is_converged():
                return True
            self.run(step_ms)
            elapsed += step_ms
        return self.is_converged()

    # -- convergence (tick-cluster.js:88-115) --------------------------------

    def live_nodes(self) -> list[RingPop]:
        return [
            n
            for n in self.nodes
            if not n.destroyed
            and n.host_port not in self.network.killed
            and n.host_port not in self.network.paused
        ]

    def checksums(self) -> dict[str, int | None]:
        return {n.host_port: n.membership.checksum for n in self.live_nodes()}

    def checksum_groups(self) -> dict[int | None, list[str]]:
        groups: dict[int | None, list[str]] = {}
        for host, checksum in self.checksums().items():
            groups.setdefault(checksum, []).append(host)
        return groups

    def is_converged(self) -> bool:
        live = self.live_nodes()
        if not live:
            return True
        groups = self.checksum_groups()
        return len(groups) == 1 and None not in groups

    # -- fault injection (tick-cluster.js:418-471 analogs) -------------------

    def kill(self, index: int) -> None:
        """SIGKILL analog: the process dies — destroy the node AND refuse
        its connections (a killed process cannot keep gossiping)."""
        node = self.nodes[index]
        if not node.destroyed:
            node.destroy()
        self.network.kill(self.host_ports[index])

    def revive(self, index: int) -> None:
        """Bring a killed node back as a fresh process that re-joins."""
        host_port = self.host_ports[index]
        self.network.revive(host_port)
        channel = InProcessChannel(self.network, host_port)
        node = RingPop(
            app=self.nodes[index].app,
            host_port=host_port,
            channel=channel,
            clock=self.scheduler,
            rng=random.Random(self.rng.randrange(1 << 30)),
            device=self.device,
        )
        node.setup_channel()
        self.nodes[index] = node
        node.bootstrap(list(self.host_ports), lambda *a: None)

    def suspend(self, index: int) -> None:
        self.network.pause(self.host_ports[index])

    def resume(self, index: int) -> None:
        self.network.resume(self.host_ports[index])

    def partition(self, groups: list[list[int]]) -> None:
        mapping: dict[str, int] = {}
        for gid, members in enumerate(groups):
            for index in members:
                mapping[self.host_ports[index]] = gid
        self.network.partition(mapping)

    def heal_partition(self) -> None:
        self.network.heal_partition()

    # -- driving ticks (admin/tick analog) -----------------------------------

    def tick_all(self) -> dict[str, Any]:
        """Force one protocol round per node, return checksum per node."""
        out: dict[str, Any] = {}
        for node in self.live_nodes():
            def on_tick(err: Any, resp: Any = None, node=node) -> None:
                out[node.host_port] = resp

            node.handle_tick(on_tick)
        self.scheduler.advance(50)
        return out
