"""SimCluster: the host-side front end of the dense SWIM simulation.

The port of ``ringpop_tpu/models/cluster.py`` (``backend="dense"``):
drive protocol periods, group live nodes by membership checksum (the
convergence metric of ringpop's tick-cluster), and inject faults (kill,
suspend, revive, partitions, packet loss) as edits of ``NetState``.
The PRNG key schedule is the reference's: ``tick(1)`` splits the
cluster key and steps with the sub-key; ``tick(k > 1)`` hands the
sub-key to ``swim_run_impl``, which splits it into k keys.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ringpop_tpu_torch import prng, resolve_device
from ringpop_tpu_torch.models import checksum as cksum
from ringpop_tpu_torch.models import swim_sim as sim
from ringpop_tpu_torch.models.swim_sim import NetState, SwimParams
from ringpop_tpu_torch.ops import checksum_device as ckdev

DEFAULT_BASE_INC = 1_400_000_000_000  # host clock epoch (ms)


def groups_to_gid(groups: Sequence[Sequence[int]], n: int) -> np.ndarray:
    """int32[N] group-id vector (-1 = ungrouped) from member lists."""
    gid = np.full(n, -1, dtype=np.int32)
    for g, members in enumerate(groups):
        gid[np.asarray(list(members), dtype=np.int64)] = g
    return gid


class SimCluster:
    def __init__(
        self,
        n: int,
        params: SwimParams = SwimParams(),
        *,
        seed: int = 0,
        addresses: Sequence[str] | None = None,
        base_inc: int = DEFAULT_BASE_INC,
        inc: Sequence[int] | None = None,
        init: str = "converged",
        device: torch.device | str | None = None,
        damping: bool = False,
        backend: str = "dense",
    ):
        """A cluster of ``n`` simulated nodes on ``device`` (``cuda``
        unless the caller names another; raises when no card is visible
        and none was named).  Only the dense backend is ported."""
        if backend == "delta":
            raise NotImplementedError("the delta backend is not ported yet")
        if backend != "dense":
            raise ValueError(f"unknown backend: {backend!r}")
        if damping:
            raise NotImplementedError("damping tensors are not ported yet")
        self.device = resolve_device(device)
        self.backend = backend
        self.params = params
        self.book = cksum.AddressBook(addresses or cksum.default_addresses(n))
        if len(self.book) != n:
            raise ValueError("addresses must have length n")
        self.base_inc = base_inc
        rel = np.zeros(n, dtype=np.int32) if inc is None else (
            np.asarray(inc, dtype=np.int64) - base_inc
        ).astype(np.int32)
        self.state = sim.init_state(n, rel, mode=init, device=self.device)
        self.net: NetState = sim.make_net(n, device=self.device)
        self.key = prng.PRNGKey(seed)
        self.metrics_log: list[dict[str, int]] = []
        self._device_book: ckdev.DeviceBook | None = None

    @property
    def n(self) -> int:
        return len(self.book)

    # -- time ---------------------------------------------------------------

    def _split(self) -> torch.Tensor:
        self.key, sub = prng.split(self.key)
        return sub

    def tick(self, ticks: int = 1) -> dict[str, int]:
        """Advance every node ``ticks`` protocol periods; returns the last
        tick's counters (plus ``ticks``)."""
        if ticks == 1:
            self.state, metrics = sim.swim_step_impl(
                self.state, self.net, self._split(), self.params
            )
        else:
            self.state, metrics = sim.swim_run_impl(
                self.state, self.net, self._split(), self.params, ticks
            )
        values = torch.stack(list(metrics.values())).tolist()
        out = dict(zip(metrics.keys(), (int(v) for v in values)))
        out["ticks"] = int(ticks)
        self.metrics_log.append(out)
        return out

    def run_until_converged(self, max_ticks: int = 1000, check_every: int = 5) -> int:
        """Ticks until convergence (or -1)."""
        done = 0
        while done < max_ticks:
            step = min(check_every, max_ticks - done)
            self.tick(step)
            done += step
            if self.converged():
                return done
        return -1

    # -- convergence -----------------------------------------------------------

    def _view_rows(self, idx: np.ndarray) -> np.ndarray:
        """int32[len(idx), N] view rows (host copies)."""
        rows = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=self.device)
        return self.state.view_key.index_select(0, rows).cpu().numpy()

    def live_indices(self) -> np.ndarray:
        up = (self.net.up & self.net.responsive).cpu().numpy()
        own = torch.diagonal(self.state.view_key).cpu().numpy() & 7
        gossiping = up & ((own == sim.ALIVE) | (own == sim.SUSPECT))
        return np.flatnonzero(gossiping)

    def converged(self) -> bool:
        """Exact view agreement among live nodes (no hash involved)."""
        return bool(sim.converged_impl(self.state, self.net))

    def checksums(
        self, indices: Sequence[int] | None = None, backend: str | None = None
    ) -> dict[str, int]:
        """Reference-format membership checksum per (live) node address.

        ``backend='device'``: string assembly and FarmHash on the
        cluster's device (the FarmHash32 kernel on the card).
        ``backend='host'``: pure Python over pulled rows, the oracle for
        small clusters.  The default is ``'device'`` on a card and
        ``'host'`` on the CPU."""
        idx = self.live_indices() if indices is None else np.asarray(indices, dtype=np.int64)
        if backend is None:
            backend = "device" if self.device.type == "cuda" else "host"
        if backend == "device":
            if self._device_book is None:
                self._device_book = ckdev.DeviceBook(
                    self.book.addresses, self.base_inc, device=self.device
                )
            rows = self.state.view_key.index_select(
                0, torch.as_tensor(idx, dtype=torch.int64, device=self.device)
            )
            sums = ckdev.view_checksums_device(self._device_book, rows).cpu().numpy()
        elif backend == "host":
            sums = cksum.view_checksums_packed(self.book, self._view_rows(idx), self.base_inc)
        else:
            raise ValueError(f"unknown checksum backend: {backend!r}")
        return {self.book.addresses[i]: int(c) for i, c in zip(idx, sums)}

    def checksum_groups(self, backend: str | None = None) -> dict[int, list[str]]:
        groups: dict[int, list[str]] = {}
        for addr, c in self.checksums(backend=backend).items():
            groups.setdefault(c, []).append(addr)
        return groups

    def members(self, viewer: int) -> list[dict]:
        """The viewer's member list, in the reference's getStats shape."""
        row = self._view_rows(np.asarray([viewer]))[0]
        return cksum.row_members(self.book, row & 7, row >> 3, self.base_inc)

    def status_counts(self, viewer: int) -> dict[str, int]:
        vs = self._view_rows(np.asarray([viewer]))[0] & 7
        return {name: int((vs == code).sum()) for code, name in sim.STATUS_NAMES.items()}

    # -- fault injection ---------------------------------------------------------

    def _set_flag(self, field: str, i: int, value: bool) -> None:
        flag = getattr(self.net, field).clone()
        flag[i] = value
        self.net = self.net._replace(**{field: flag})

    def kill(self, i: int) -> None:
        self._set_flag("up", i, False)

    def suspend(self, i: int) -> None:
        self._set_flag("responsive", i, False)

    def resume(self, i: int) -> None:
        self._set_flag("responsive", i, True)

    def revive(self, i: int, inc: int | None = None, seed: int | None = None) -> None:
        """Restart a killed node as a fresh process and re-join it."""
        if inc is None:
            inc = int(self.state.view_key.max()) // 8 + 1000
        else:
            inc = inc - self.base_inc
        self.state = sim.revive(self.state, i, inc)
        self._set_flag("up", i, True)
        self._set_flag("responsive", i, True)
        if seed is None:
            live = [j for j in self.live_indices() if j != i]
            if not live:
                return
            seed = int(live[0])
        self.join(i, seed)

    def join(self, joiner: int, seed: int) -> None:
        self.state = sim.admin_join(self.state, joiner, seed)

    def leave(self, i: int) -> None:
        self.state = sim.admin_leave(self.state, i)

    def partition(self, groups: Sequence[Sequence[int]]) -> None:
        """Disconnect the given groups from each other.  A partition that
        covers every node takes the int32[N] group-id form; a partial one
        (ungrouped nodes reach everyone) the bool[N, N] mask.  A net that
        already carries a mask keeps the mask form."""
        gid = groups_to_gid(groups, self.n)
        keep_mask = self.net.adj is not None and self.net.adj.dim() == 2
        if (gid >= 0).all() and not keep_mask:
            self.net = self.net._replace(adj=torch.as_tensor(gid).to(self.device))
            return
        same = (gid[:, None] == gid[None, :]) | (gid[:, None] < 0) | (gid[None, :] < 0)
        self.net = self.net._replace(adj=torch.as_tensor(same).to(self.device))

    def heal_partition(self) -> None:
        """Reconnect everything, keeping the adjacency's form."""
        if self.net.adj is None:
            return
        if self.net.adj.dim() == 1:
            adj = torch.zeros(self.n, dtype=torch.int32, device=self.device)
        else:
            adj = torch.ones((self.n, self.n), dtype=torch.bool, device=self.device)
        self.net = self.net._replace(adj=adj)

    def set_loss(self, p: float) -> None:
        self.params = self.params._replace(loss=float(p))
