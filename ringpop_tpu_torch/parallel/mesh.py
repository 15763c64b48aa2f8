"""Row sharding of the SWIM simulation over a 1-D ring of shards.

The port of ``ringpop_tpu/parallel/mesh.py``.  The layout is the
reference's "viewer-row" sharding over the mesh axis ``nodes``: every
[N, *] view or table is cut along axis 0 into D contiguous blocks, so a
shard owns the complete views of a block of virtual nodes; per-node
vectors, the PRNG key and the tick counter are replicated.

In the reference, ``shard_map`` and XLA's partitioner make a sharded
step out of the unsharded step code, and cross-shard traffic appears
only in the ring primitives of ``ops/gossip_remote_copy.py``.  The port
has no partitioner, so it works at the same seams: the sharded entry
points run the unsharded step (``swim_step_impl``, ``delta_step_impl``)
inside an ambient ring context (``ring_mesh``), and exactly where the
reference's ``_receiver_merge``, ``_gather_rows``, ``_row_at``, ``_diag``
and ``_row_update`` take their ring branch, the port calls its ring
primitive, which moves blocks between shards only through the hop.

Two placements:

* across processes, the cross-device form: ``make_mesh(group=...)`` over
  a ``torch.distributed`` process group (``parallel.ranks`` starts one
  and its processes), one rank a shard.  Each rank holds rows
  ``[r * N/D, (r + 1) * N/D)`` of every row-split field and the
  replicated fields whole (``shard_cluster``, ``init_cluster``); the
  dense step runs on those rows, every read across rows an explicit
  collective of the ring (``models/swim_sim.py``), and each hop a peer
  write into the right neighbour's memory (``ops/peer_hop.py``).  The
  delta step runs so too (``shard_delta``, ``init_delta``: a rank's rows
  of the tables and the digest, the base and its rank structures whole;
  ``models/swim_delta.py``).  Each rank's device is ``cuda:{rank %
  device_count}`` unless the caller asks for the CPU; on one card all D
  ranks share it.  ``gather_cluster`` and ``gather_delta`` put the global
  state back together, for checks;
* in one process, ``make_mesh(devices=[dev] * D)``: the D shards live on
  one device (or, in the tests, on the CPU) as stacks, each hop one
  launch over all of them.  Sided mode and serving run here only.

Two distinct devices in one process are refused: the cross-device form
is one process a device.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Iterator

import torch
import torch.distributed as dist

from ringpop_tpu_torch.models import swim_delta as _sd
from ringpop_tpu_torch.models.swim_delta import DeltaState, delta_run_impl, delta_step_impl
from ringpop_tpu_torch.models import swim_sim as _sim
from ringpop_tpu_torch.models.swim_sim import (
    ClusterState,
    NetState,
    swim_run_impl,
    swim_step_impl,
)
from ringpop_tpu_torch.ops import gossip_remote_copy as _grc

AXIS = "nodes"

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of D shards along the member axis (the reference's
    one-axis ``jax.sharding.Mesh``); ``devices[i]`` holds shard i.  On a
    process group's mesh ``rank`` is this process's shard, ``group`` the
    group and ``peers`` its end of the ring (``ops.peer_hop.PeerRing``)."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = (AXIS,)
    rank: int | None = None
    group: Any = dataclasses.field(default=None, compare=False, repr=False)
    peers: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def on_ranks(self) -> bool:
        """One process a shard (``make_mesh(group=...)``)?"""
        return self.rank is not None

    @property
    def shape(self) -> dict[str, int]:
        return {AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """This process's device: the one every shard lives on, or on a
        process group's mesh this rank's."""
        return self.devices[self.rank or 0]

    def rows(self, n: int) -> tuple[int, int]:
        """(first row, row count) of this rank's block of an [n, ...] plane."""
        if not self.on_ranks:
            return 0, n
        return self.rank * (n // self.size), n // self.size

    def close(self) -> None:
        """Free this rank's receive buffers (a collective of the group)."""
        if self.peers is not None:
            self.peers.close()


def _canonical(device: Any) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return dev


def rank_device(rank: int, device: Any = None) -> torch.device:
    """A rank's device: ``cuda:{rank % device_count}``, or the CPU when
    the caller asks for it."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to run the ranks on "
                           "the host")
    return torch.device("cuda", rank % torch.cuda.device_count())


def make_mesh(
    n_devices: int | None = None, devices: Any = None, *, group: Any = None, device: Any = None
) -> Mesh:
    """A 1-D mesh of D shards.

    ``group=`` (a ``torch.distributed`` process group, e.g.
    ``torch.distributed.group.WORLD``): the cross-device form, one rank a
    shard, each on ``rank_device(rank, device)``.  Otherwise the
    one-process form over ``n_devices`` (default: all) of ``devices``
    (default: the visible cards); D shards on one device are asked for
    explicitly, ``devices=[torch.device("cuda")] * D``.  Raises when fewer
    devices are given than asked for, and ``NotImplementedError`` for
    distinct devices in one process."""
    if group is not None:
        from ringpop_tpu_torch.ops.peer_hop import PeerRing

        size, rank = dist.get_world_size(group), dist.get_rank(group)
        if n_devices is not None and n_devices != size:
            raise ValueError(f"requested {n_devices} shards on a group of {size} ranks")
        devs = tuple(rank_device(r, device) for r in range(size))
        return Mesh(devs, rank=rank, group=group,
                    peers=PeerRing(group, rank, size, devs[rank]))
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass devices=[torch.device('cpu')] * D "
                "to shard on the host"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_canonical(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested {n_devices} devices, only {len(devices)} available")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if len(set(devices)) > 1:
        raise NotImplementedError(
            f"one process holds the shards of one device, not {sorted(set(map(str, devices)))}: "
            "the Cross-card ring hop runs one process a shard, "
            "make_mesh(group=torch.distributed.group.WORLD) in each rank "
            "(parallel.ranks starts them); or put the D shards on one device: "
            "devices=[device] * D"
        )
    return Mesh(tuple(devices))


# ---------------------------------------------------------------------------
# Field -> layout maps.  Placement walks each state NamedTuple's
# ``_fields`` through these maps, so a field added to the models without
# a layout decision here raises at placement (and the tests pin the maps
# complete) instead of silently replicating.  The kinds are the
# reference's.
# ---------------------------------------------------------------------------

_ROW = "row"  # viewer-row sharded [N, *] plane
_ROW1 = "row1"  # per-viewer [N] vector that stays on its shard
_REP = "rep"  # replicated (O(N)/O(K) vectors, scalars)
_ADJ = "adj"  # group-id int32[N] replicated / bool[N, N] row-sharded
_PEND = "pend"  # [D, N(receiver), N] claim buffer, split on axis 1
_PEND_D = "pend_d"  # [D, S, N(receiver), W], split on axis 2
_PEND_D1 = "pend_d1"  # [D, S, N(receiver)], split on axis 2

CLUSTER_FIELD_SPECS: dict[str, str] = {
    "view_key": _ROW,
    "pb": _ROW,
    "suspect_left": _ROW,
    "tick": _REP,
    "damp": _ROW,
    "damped": _ROW,
    "pending": _PEND,
}

NET_FIELD_SPECS: dict[str, str] = {
    "up": _REP,
    "responsive": _REP,
    "adj": _ADJ,
    "link_src": _REP,
    "link_dst": _REP,
    "link_p": _REP,
    "link_d": _REP,
    "link_j": _REP,
    "period": _REP,
    "ov_cnt": _REP,
    "ov_gray": _REP,
    "po_press": _REP,
    "po_shed": _REP,
    "po_quar": _REP,
    "po_sends_w": _REP,
    "po_deliv_w": _REP,
    "po_retry_cap": _REP,
    # the provenance plane's report tensors, read on the host only: the
    # sharded step never updates them (the fold runs in the scenario
    # runner)
    "pv_slot": _REP,
    "pv_tickv": _REP,
    "pv_wits": _REP,
    "pv_first": _REP,
    "pv_parent": _REP,
    "pv_knows": _REP,
}

DELTA_FIELD_SPECS: dict[str, str] = {
    "base_key": _REP,
    "bp_mask": _REP,
    "bp_rank": _REP,
    "bp_list": _REP,
    "d_subj": _ROW,
    "d_key": _ROW,
    "d_pb": _ROW,
    "d_sl": _ROW,
    "tick": _REP,
    "overflow_drops": _REP,
    "side": _REP,
    "merge_to": _REP,
    "digest": _ROW1,
    "d_bpmask": _ROW,
    "d_bprank": _ROW,
    "pend_subj": _PEND_D,
    "pend_key": _PEND_D,
    "pend_recv": _PEND_D1,
}

# the member axis each kind splits (None: replicated)
_SPLIT_AXIS: dict[str, int | None] = {
    _ROW: 0,
    _ROW1: 0,
    _REP: None,
    _PEND: 1,
    _PEND_D: 2,
    _PEND_D1: 2,
}


def _field_split(specs: dict[str, str], field: str, value: Any) -> int | None:
    """The axis one state field is split along (None: replicated)."""
    if field not in specs:
        raise KeyError(
            f"no sharding layout declared for state field {field!r} — "
            "add it to the FIELD_SPECS map in parallel/mesh.py"
        )
    kind = specs[field]
    if kind == _ADJ:
        # group-id vector: O(N), replicate; bool mask: row-shard
        return None if value is None or value.dim() == 1 else 0
    return _SPLIT_AXIS[kind]


def _place(mesh: Mesh, specs: dict[str, str], value: Any) -> Any:
    """``value`` (a state NamedTuple, unsharded) on the mesh's device,
    every field checked against its layout: a split axis must divide
    into D.  On a process group's mesh only this rank's block of each
    split field is kept."""
    d = mesh.size
    fields = {}
    for f in type(value)._fields:
        v = getattr(value, f)
        axis = _field_split(specs, f, v)
        if v is None:
            fields[f] = None
            continue
        if axis is not None and v.shape[axis] % d != 0:
            raise ValueError(
                f"{f}: axis {axis} of length {v.shape[axis]} must be divisible by mesh size {d}"
            )
        if mesh.on_ranks and axis is not None:
            lo, rows = mesh.rows(v.shape[axis])
            v = v.narrow(axis, lo, rows).clone()
        fields[f] = v.to(mesh.device)
    return type(value)(**fields)


def _check_divisible(n: int, mesh: Mesh) -> None:
    if n % mesh.size != 0:
        raise ValueError(f"n={n} must be divisible by mesh size {mesh.size}")


def shard_cluster(state: ClusterState, net: NetState, mesh: Mesh) -> tuple[ClusterState, NetState]:
    """Place an (unsharded) dense simulation onto the mesh: on a process
    group's mesh, this rank's rows of it."""
    _check_divisible(state.n, mesh)
    return _place(mesh, CLUSTER_FIELD_SPECS, state), _place(mesh, NET_FIELD_SPECS, net)


def shard_delta(state: DeltaState, mesh: Mesh) -> DeltaState:
    """Place an (unsharded) delta state onto the mesh: on a process
    group's mesh, this rank's rows of the tables and the digest, with the
    base, its rank structures and the counters whole.  A sided state's
    [G, N] base rows and rank planes, its ``merge_to`` flip table and
    its ``side`` vector are replicated; its tables split by rows."""
    _check_divisible(state.n, mesh)
    return _place(mesh, DELTA_FIELD_SPECS, state)


# ---------------------------------------------------------------------------
# a process group's mesh: its rank's rows, built, checked and gathered
# ---------------------------------------------------------------------------

_QUEUE = "ROADMAP.md queue 1 item 11"


def _reject_ranks(mesh: Mesh, what: str) -> None:
    if mesh.on_ranks:
        raise NotImplementedError(
            f"{what} on a process group's mesh is not ported ({_QUEUE}); run it on the "
            "one-process mesh, make_mesh(devices=[device] * D)"
        )


def init_cluster(
    n: int, mesh: Mesh, inc: Any = None, *, mode: str = "converged"
) -> tuple[ClusterState, NetState]:
    """A fresh dense simulation on the mesh (``swim_sim.init_state`` and
    ``make_net``), built on a process group's mesh as this rank's rows
    only: no rank allocates the [N, N] planes."""
    _check_divisible(n, mesh)
    dev = mesh.device
    if not mesh.on_ranks:
        return shard_cluster(_sim.init_state(n, inc, mode=mode, device=dev),
                             _sim.make_net(n, device=dev), mesh)
    if inc is None:
        inc = torch.zeros(n, dtype=torch.int32, device=dev)
    inc = torch.as_tensor(inc, device=dev).to(torch.int32)
    _sim._check_inc(inc)
    lo, rows = mesh.rows(n)
    alive_key = inc * 8 + _sim.ALIVE
    if mode == "converged":
        view_key = alive_key[None, :].expand(rows, n).clone()
    elif mode == "self":
        own = torch.arange(lo, lo + rows, device=dev)[:, None] == torch.arange(n, device=dev)
        view_key = torch.where(own, alive_key[None, :], 0).to(torch.int32)
    else:
        raise ValueError(f"unknown init mode: {mode}")
    state = ClusterState(
        view_key=view_key,
        pb=torch.full((rows, n), -1, dtype=torch.int8, device=dev),
        suspect_left=torch.full((rows, n), -1, dtype=torch.int8, device=dev),
        tick=torch.zeros((), dtype=torch.int32, device=dev),
    )
    return state, _sim.make_net(n, device=dev)


def init_delta(
    n: int, mesh: Mesh, inc: Any = None, *, capacity: int = 256, mode: str = "converged"
) -> DeltaState:
    """A fresh delta state on the mesh (``swim_delta.init_delta``), built
    on a process group's mesh as this rank's rows of the tables only: no
    rank allocates the [N, C] tables."""
    _check_divisible(n, mesh)
    state = _sd.init_delta(n, inc, capacity=capacity, mode=mode, device=mesh.device,
                           rows=mesh.rows(n))
    return state if mesh.on_ranks else shard_delta(state, mesh)


def gather_delta(state: DeltaState, mesh: Mesh) -> DeltaState:
    """The global delta state back from every rank's rows (for checks and
    host operations: it allocates the [N, C] tables), on every rank, over
    the ring.  The one-process mesh holds it already."""
    if not mesh.on_ranks:
        return state
    fields = {}
    with _grc.ring_mesh(mesh):
        for f in DeltaState._fields:
            v = getattr(state, f)
            axis = None if v is None else _field_split(DELTA_FIELD_SPECS, f, v)
            if axis not in (None, 0):
                raise NotImplementedError(f"{f} on ranks ({_QUEUE})")
            fields[f] = v if axis is None else _grc.ring_allgather(v)
    return DeltaState(**fields)


def rebase(state: DeltaState, mesh: Mesh, anti_entropy: bool = False) -> DeltaState:
    """``swim_delta.rebase`` on the mesh: a host operation on the global
    tables, as the reference runs it before it places the state again.
    On a process group's mesh every rank gathers the state, folds it
    alike and keeps its rows."""
    if not mesh.on_ranks:
        return _sd.rebase(state, anti_entropy=anti_entropy)
    return shard_delta(_sd.rebase(gather_delta(state, mesh), anti_entropy=anti_entropy), mesh)


def _check_delta_rows(mesh: Mesh, state: DeltaState) -> None:
    """A process group's delta step takes this rank's rows: [N/D, C]
    tables."""
    n, c = state.n, state.capacity
    want = (n // mesh.size, c)
    if n % mesh.size or tuple(state.d_subj.shape) != want:
        raise ValueError(
            f"a rank of a {mesh.size}-rank mesh steps its own rows, {list(want)}, not "
            f"{list(state.d_subj.shape)}: place the state with shard_delta or init_delta"
        )


def _check_rows(mesh: Mesh, state: ClusterState, net: NetState) -> None:
    """A process group's step takes this rank's rows: [N/D, N] planes and
    a bool adjacency mask of [N/D, N]."""
    n = state.n
    want = (n // mesh.size, n)
    if n % mesh.size or tuple(state.view_key.shape) != want:
        raise ValueError(
            f"a rank of a {mesh.size}-rank mesh steps its own rows, {list(want)}, not "
            f"{list(state.view_key.shape)}: place the state with shard_cluster or init_cluster"
        )
    if net.adj is not None and net.adj.dim() == 2 and tuple(net.adj.shape) != want:
        raise ValueError(f"adj mask of {list(net.adj.shape)} is not this rank's rows "
                         f"{list(want)}: place the net with shard_cluster")


def gather_cluster(state: ClusterState, mesh: Mesh) -> ClusterState:
    """The global state back from every rank's rows (for checks and
    comparisons: it allocates the [N, N] planes), on every rank, over the
    ring.  The one-process mesh holds it already."""
    if not mesh.on_ranks:
        return state
    fields = {}
    with _grc.ring_mesh(mesh):
        for f in ClusterState._fields:
            v = getattr(state, f)
            axis = None if v is None else _field_split(CLUSTER_FIELD_SPECS, f, v)
            if axis not in (None, 0):
                raise NotImplementedError(f"{f} on ranks ({_QUEUE})")
            fields[f] = v if axis is None else _grc.ring_allgather(v)
    return ClusterState(**fields)


def revive(state: ClusterState, node: int, inc: int, mesh: Mesh) -> ClusterState:
    """``swim_sim.revive`` (or ``swim_delta.revive`` of a delta state) on
    the mesh: on a process group's mesh the rank that holds ``node``'s
    row wipes it; the others keep theirs."""
    if isinstance(state, DeltaState):
        return _revive_delta(state, node, inc, mesh)
    if not mesh.on_ranks:
        return _sim.revive(state, node, inc)
    if state.damp is not None:
        raise NotImplementedError(f"the damping planes on ranks ({_QUEUE})")
    # audit: allow=RPL005 a host int's range check
    _sim._check_inc(torch.tensor([int(inc)]))
    lo, rows = mesh.rows(state.n)
    if not lo <= node < lo + rows:
        return state
    r = node - lo
    n = state.n
    dev = state.view_key.device
    vk = state.view_key.clone()
    pb = state.pb.clone()
    sl = state.suspect_left.clone()
    vk[r] = torch.where(torch.arange(n, device=dev) == node, int(inc) * 8 + _sim.ALIVE, 0).to(
        torch.int32)
    pb[r] = -1
    sl[r] = -1
    return state._replace(view_key=vk, pb=pb, suspect_left=sl)


def _revive_delta(state: DeltaState, node: int, inc: int, mesh: Mesh) -> DeltaState:
    if not mesh.on_ranks:
        return _sd.revive(state, node, inc)
    # audit: allow=RPL005 a host int's range check
    _sim._check_inc(torch.tensor([int(inc)]))
    lo, rows = mesh.rows(state.n)
    if not lo <= node < lo + rows:
        return state
    # the row wiped to its one self slot (``swim_delta.revive`` at the
    # local row, the subject the global id)
    state = _sd._wipe_row(state, node - lo)
    state = _sd._set_entry(state, node - lo, node, int(inc) * 8 + _sim.ALIVE, -1, -1)
    return _sd.refresh_carried(state)


def converged(state: ClusterState | DeltaState, net: NetState, mesh: Mesh) -> bool:
    """``swim_sim.converged_impl`` (or ``swim_delta._converged_impl``) on
    the mesh, read on the host (every rank gets the same answer)."""
    with _grc.ring_mesh(mesh) if mesh.on_ranks else contextlib.nullcontext():
        if isinstance(state, DeltaState):
            return bool(_sd._converged_impl(state, net.up, net.responsive))
        return bool(_sim.converged_impl(state, net))


def checksums(
    state: ClusterState | DeltaState, net: NetState, book: Any, mesh: Mesh, sample: Any = None
) -> torch.Tensor:
    """The reference-format checksum of every live node's view, int64[L]
    (uint32 values) in node order: each rank hashes its own live rows
    with the FarmHash kernel (``ops.checksum_device``), and only the
    checksums go round the ring, never the rows.  ``book`` is a
    ``checksum_device.DeviceBook`` on this rank's device.  A delta state
    takes ``sample``, the viewers to hash (default: all), and gives the
    live ones' checksums in its order."""
    from ringpop_tpu_torch.ops import checksum_device as ckdev

    if isinstance(state, DeltaState):
        return _delta_checksums(state, net, book, mesh, sample)
    if sample is not None:
        raise ValueError("a dense state's checksums cover every node; sample= is for delta "
                         "states")
    lo, rows = mesh.rows(state.n)
    own = torch.diagonal(state.view_key, lo) & 7
    up = (net.up & net.responsive)[lo:lo + rows]
    live = up & ((own == _sim.ALIVE) | (own == _sim.SUSPECT))
    sums = ckdev.view_checksums_device(book, state.view_key)
    if mesh.on_ranks:
        with _grc.ring_mesh(mesh):
            sums, live = _grc.ring_allgather(sums, live)
    return sums[live]


_CHUNK_ELEMENTS = 1 << 26  # the view keys materialized at once for hashing


def _delta_checksums(
    state: DeltaState, net: NetState, book: Any, mesh: Mesh, sample: Any
) -> torch.Tensor:
    """``checksums`` of a delta state: each rank materializes and hashes
    the sampled viewers it holds; a [S] vector of checksums and one of
    live flags, zero at the others' viewers, are summed over the ranks."""
    from ringpop_tpu_torch.ops import checksum_device as ckdev

    n, dev = state.n, state.device
    lo, rows = mesh.rows(n)
    if sample is None:
        sample = torch.arange(n, dtype=torch.int64, device=dev)
    sample = torch.as_tensor(sample, device=dev).to(torch.int64)
    mine = (sample >= lo) & (sample < lo + rows)
    loc = torch.clamp(sample - lo, 0, rows - 1)
    own = _sd.view_lookup(state, torch.arange(lo, lo + rows, dtype=torch.int32, device=dev)) & 7
    up = (net.up & net.responsive)[lo:lo + rows]
    live = mine & (up & ((own == _sim.ALIVE) | (own == _sim.SUSPECT)))[loc]
    sums = torch.zeros(sample.shape, dtype=torch.int64, device=dev)
    # audit: allow=RPL001 the sample's rows held here, a host list to cut in chunks
    held = torch.nonzero(mine).flatten().tolist()
    chunk = max(1, _CHUNK_ELEMENTS // n)
    for i in range(0, len(held), chunk):
        at = torch.as_tensor(held[i:i + chunk], dtype=torch.int64, device=dev)
        r = loc[at]
        view = _sd._scatter_rows(_sd._base_rows(state, sample[at]), state.d_subj[r],
                                 state.d_key[r])
        sums[at] = ckdev.view_checksums_device(book, view).to(torch.int64)
    if mesh.on_ranks:
        with _grc.ring_mesh(mesh):
            sums, live = _grc.ring_sum(sums), _grc.ring_sum(live)
    return sums[live]


# ---------------------------------------------------------------------------
# gossip modes and guards
# ---------------------------------------------------------------------------


def gossip_mode(gossip: str | None = None) -> str:
    """The sharded gossip plane: ``ring`` (the default) routes
    cross-shard claims and row fetches as ring hops; ``gather`` is the
    single-device lowering (plain gathers, the receiver-merge kernel)."""
    mode = gossip or "ring"
    if mode not in ("ring", "gather"):
        raise ValueError(f"gossip={mode!r}: ring|gather")
    return mode


@contextlib.contextmanager
def mesh_gossip(mesh: Mesh, gossip: str | None = None) -> Iterator[None]:
    """The gossip plane for calls in this block: the ambient ring of
    ``mesh`` in ring mode, nothing in gather mode."""
    if gossip_mode(gossip) == "ring":
        with _grc.ring_mesh(mesh):
            yield
    else:
        yield


def _reject_adjacency(net: NetState) -> None:
    """The sharded delta step takes partitions as the int32[N] group-id
    adjacency only; a dense bool[N, N] mask needs the dense backend."""
    if net.adj is not None and net.adj.dim() != 1:
        raise NotImplementedError(
            "sharded delta partitions take the int32[N] group-id adjacency; "
            "dense bool[N, N] masks need the dense backend"
        )


def _adj_layout(net_like: NetState | None) -> int | None:
    """The adjacency layout a sharded step expects: None (no adj) or
    the adj ndim (1 = group-id vector, 2 = bool mask)."""
    if net_like is None or net_like.adj is None:
        return None
    return net_like.adj.dim()


def _check_adj_layout(net: NetState, expect: int | None) -> None:
    """Raise when the net's adjacency layout (presence and ndim)
    disagrees with the one the step was built for (``net_like``)."""
    have = _adj_layout(net)
    if have == expect:
        return
    names = {None: "no adjacency", 1: "a group-id vector (ndim 1)",
             2: "an adjacency mask (ndim 2)"}
    raise ValueError(
        f"net carries {names.get(have, f'adj ndim {have}')} but this "
        f"sharded step was built for {names.get(expect, f'adj ndim {expect}')}"
        " — rebuild with net_like=net"
    )


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _rank_entry(mesh: Mesh, gossip: str | None) -> None:
    """A process group's mesh runs the steps over the ring only."""
    if mesh.on_ranks and gossip_mode(gossip) != "ring":
        raise ValueError("a process group's mesh gossips over the ring; gossip='gather' needs "
                         "every row in one process")


def sharded_step(
    mesh: Mesh, net_like: NetState | None = None, gossip: str | None = None
) -> Callable:
    """``swim_step_impl`` over the mesh: (state, net, key, params) ->
    (state, metrics).  On the one-process mesh the inputs are placed on
    it first (``shard_cluster``), as the reference's ``in_shardings``
    place them; on a process group's mesh the state is this rank's rows
    (``shard_cluster``, ``init_cluster``) and stays so, and the metrics
    are the whole cluster's.  ``net_like=net`` fixes the adjacency layout
    the step accepts; ``gossip`` picks the plane (see ``gossip_mode``)."""
    gossip_mode(gossip)
    _rank_entry(mesh, gossip)
    expect_adj = _adj_layout(net_like)

    def step(state, net, key, params):
        _check_adj_layout(net, expect_adj)
        if mesh.on_ranks:
            _check_rows(mesh, state, net)
        else:
            state, net = shard_cluster(state, net, mesh)
        with mesh_gossip(mesh, gossip):
            return swim_step_impl(state, net, key, params)

    return step


def sharded_run(
    mesh: Mesh, net_like: NetState | None = None, gossip: str | None = None
) -> Callable:
    """``swim_run_impl`` (``ticks`` periods) over the mesh.  See
    ``sharded_step``."""
    gossip_mode(gossip)
    _rank_entry(mesh, gossip)
    expect_adj = _adj_layout(net_like)

    def run(state, net, key, params, ticks):
        _check_adj_layout(net, expect_adj)
        if mesh.on_ranks:
            _check_rows(mesh, state, net)
        else:
            state, net = shard_cluster(state, net, mesh)
        with mesh_gossip(mesh, gossip):
            return swim_run_impl(state, net, key, params, ticks)

    return run


def sharded_delta_step(
    mesh: Mesh, net_like: NetState | None = None, gossip: str | None = None
) -> Callable:
    """``delta_step_impl`` over the mesh.  The cross-shard traffic is the
    claim routing and the row fetches of the replies, full syncs and
    ping-req stages: in ring mode their payload rows hop the ring.  On a
    process group's mesh the state is this rank's rows (``shard_delta``,
    ``init_delta``) and stays so, and the metrics and ``overflow_drops``
    are the whole cluster's."""
    gossip_mode(gossip)
    _rank_entry(mesh, gossip)
    expect_adj = _adj_layout(net_like)

    def step(state, net, key, params, upto=7):
        _reject_adjacency(net)
        _check_adj_layout(net, expect_adj)
        state, net = _delta_inputs(mesh, state, net)
        with mesh_gossip(mesh, gossip):
            return delta_step_impl(state, net, key, params, upto)

    return step


def sharded_delta_run(
    mesh: Mesh, net_like: NetState | None = None, gossip: str | None = None
) -> Callable:
    """``delta_run_impl`` (``ticks`` periods) over the mesh.  See
    ``sharded_delta_step``."""
    gossip_mode(gossip)
    _rank_entry(mesh, gossip)
    expect_adj = _adj_layout(net_like)

    def run(state, net, key, params, ticks):
        _reject_adjacency(net)
        _check_adj_layout(net, expect_adj)
        state, net = _delta_inputs(mesh, state, net)
        with mesh_gossip(mesh, gossip):
            return delta_run_impl(state, net, key, params, ticks)

    return run


def _delta_inputs(mesh: Mesh, state: DeltaState, net: NetState) -> tuple[DeltaState, NetState]:
    """The delta step's inputs on the mesh: placed on the one-process
    mesh, as the reference's ``in_shardings`` place them; on a process
    group's mesh already this rank's rows (the net is replicated)."""
    if mesh.on_ranks:
        _check_delta_rows(mesh, state)
        return state, net
    return shard_delta(state, mesh), _place(mesh, NET_FIELD_SPECS, net)


# ---------------------------------------------------------------------------
# serving (traffic/engine.py) from sharded membership
# ---------------------------------------------------------------------------


def sharded_serve(mesh: Mesh, *, static: Any, gossip: str | None = None) -> Callable:
    """``traffic.engine.serve_tick`` over the mesh: (view_rows, up,
    responsive, tensors, t) -> counters.  The [N, N] view table stays
    row-sharded and each request's viewer row (and each hop's holder
    row) comes over the gossip ring (``ring_fetch_global``: ring-hop
    kernel launches) instead of a gather of the whole table; the
    self-in-ring diagonal is row-local.  The counters are
    ``serve_once``'s.  ``gossip`` as in ``gossip_mode``; in gather mode
    the rows are plain gathers."""
    from ringpop_tpu_torch.traffic import engine as _tengine

    _reject_ranks(mesh, "sharded serving")
    gossip_mode(gossip)

    def serve(view_rows, up, responsive, tensors, t):
        _check_divisible(view_rows.shape[0], mesh)
        with mesh_gossip(mesh, gossip):
            return _tengine.serve_tick(view_rows, up, responsive, tensors, int(t), static=static)

    return serve
