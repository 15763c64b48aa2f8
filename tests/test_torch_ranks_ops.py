"""The ring's pieces on a process group: one process a shard.

In each of 2 gloo ranks on the CPU (``parallel.ranks.launch``, spawned
once for the module), against the same inputs in this process, exactly
(the tolerance is zero):

- each of the five ring primitives (``ring_recv_merge``,
  ``ring_fetch_rows``, ``ring_fetch_global``, ``ring_take_per_row``,
  ``ring_update_per_row``) on the rank's own block, equal to its stacked
  form on the one-process mesh, and the ring's collectives
  (``ring_allgather``, ``ring_sum``, ``ring_take_at``,
  ``ring_fetch_many``) equal to the plain gather, sum and index;
- the peer hop's plain version (gloo ``isend``/``recv``): each rank gets
  its left neighbour's tensors, of every dtype and odd sizes;
- the device checksums of each rank's own rows (``parallel.checksums``)
  equal to the unsharded state's;
- the refusals of the arms not ported to ranks.

The peer hop's kernel runs only on a card: ``chip_smoke.py`` phase r
holds it against the plain version there, and the card-only test below
skips here.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

CPU = torch.device("cpu")
D = 2
N = 24
SEED = 4
HOP_DTYPES = ["int32", "int8", "bool", "int64", "float32"]
REFUSED = ["damping", "pending", "link_rules", "period", "phase_mod", "relay_full_sync",
           "sparse", "prov", "knobs", "delta_step", "delta_run", "serve", "gather_mode",
           "global_rows", "group_size"]


def _inputs(seed: int = SEED) -> dict[str, torch.Tensor]:
    """The primitives' global inputs, the same in every process."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    return {
        "t_safe": t(rng.integers(0, N, N)),
        "fwd_ok": t(rng.random(N) < 0.7),
        "claims": t(rng.integers(0, 1 << 20, (N, N)).astype(np.int32)),
        "plane": t(rng.integers(-(1 << 30), 1 << 30, (N, N)).astype(np.int32)),
        "idx3": t(rng.integers(0, N, (N, 3))),
        "bplane": t(rng.random((N, N)) < 0.5),
        "idx1": t(rng.integers(0, N, N)),
        "narrow": t(rng.integers(-100, 100, (N, 5)).astype(np.int8)),
        "gidx": t(rng.integers(0, N, 7)),
        "col": t(rng.integers(0, N, N)),
        "values": t(rng.integers(-(1 << 30), 1 << 30, N).astype(np.int32)),
        "vec": t(rng.integers(-1000, 1000, (N, 3)).astype(np.int32)),
        "cols3": t(rng.integers(0, N, (N, 3))),
    }


def _primitives(grc, x: dict, own) -> dict[str, torch.Tensor]:
    """Every primitive and collective on ``own(x)``, the rows this
    process holds (the whole on the one-process mesh)."""
    in_key, inbound = grc.ring_recv_merge(own(x["t_safe"]), own(x["fwd_ok"]), own(x["claims"]))
    gathered, gathered_b = grc.ring_allgather(own(x["vec"]), own(x["fwd_ok"]))
    return {
        "recv_merge_in_key": in_key,
        "recv_merge_inbound": inbound,
        "fetch_rows": grc.ring_fetch_rows(own(x["plane"]), own(x["idx3"])),
        "fetch_rows_bool": grc.ring_fetch_rows(own(x["bplane"]), own(x["idx1"])),
        "fetch_global": grc.ring_fetch_global(own(x["narrow"]), x["gidx"]),
        "take_per_row": grc.ring_take_per_row(own(x["plane"]), own(x["col"])),
        "update_set": grc.ring_update_per_row(own(x["plane"]), own(x["col"]), own(x["values"])),
        "update_max": grc.ring_update_per_row(own(x["plane"]), own(x["col"]), own(x["values"]),
                                              op="max"),
        "allgather": grc.ring_allgather(own(x["vec"])),
        "allgather_pair": torch.cat([gathered.reshape(-1), gathered_b.to(torch.int32)]),
        "sum": grc.ring_sum(own(x["vec"]).sum(dim=0, dtype=torch.int32)),
        "take_at": grc.ring_take_at(own(x["bplane"]), own(x["idx3"]), own(x["cols3"])),
        "fetch_many": torch.cat([p.reshape(p.shape[0], -1).to(torch.int32) for p in grc.ring_fetch_many(
            (own(x["plane"]), own(x["narrow"]), own(x["bplane"])), own(x["idx3"]))], dim=1),
        "fetch_many_cols": grc.ring_fetch_many((own(x["vec"]),), own(x["idx3"]),
                                               cols=own(x["cols3"]) % 3)[0],
    }


def _hop_tensor(rank: int, dtype: str) -> torch.Tensor:
    """Rank ``rank``'s tensor of a dtype, of an odd size."""
    g = torch.Generator().manual_seed(100 + rank)
    x = torch.randint(-(1 << 20), 1 << 20, (37, 3), generator=g)
    if dtype == "bool":
        return x % 2 == 0
    return x.to(getattr(torch, dtype))


def _refusal(name: str, mesh) -> None:
    """Call the arm ``name`` on a process group's mesh (it must raise)."""
    from ringpop_tpu_torch import parallel, prng
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.models import swim_sim as tsim
    from ringpop_tpu_torch.ops import gossip_remote_copy as grc

    n = 8
    state, net = parallel.init_cluster(n, mesh)
    key = prng.PRNGKey(0)
    params = tsim.SwimParams()
    step = parallel.sharded_step(mesh)
    if name == "damping":
        s, _ = parallel.shard_cluster(tsim.init_state(n, damping=True, device=CPU),
                                      tsim.make_net(n, device=CPU), mesh)
        step(s, net, key, params)
    elif name == "pending":
        step(state._replace(pending=torch.zeros((2, n // D, n), dtype=torch.int32)), net, key,
             params)
    elif name == "link_rules":
        k = torch.ones((1, n), dtype=torch.bool)
        step(state, net._replace(link_src=k, link_dst=k, link_p=torch.zeros(1),
                                 link_d=torch.zeros(1, dtype=torch.int32),
                                 link_j=torch.zeros(1, dtype=torch.int32)), key, params)
    elif name == "period":
        step(state, net._replace(period=torch.ones(n, dtype=torch.int32)), key, params)
    elif name == "phase_mod":
        step(state, net, key, tsim.SwimParams(phase_mod=2))
    elif name == "relay_full_sync":
        step(state, net, key, tsim.SwimParams(relay_full_sync=True))
    elif name == "sparse":
        step(state, net, key, tsim.SwimParams(sparse_cap=4))
    elif name == "prov":
        with grc.ring_mesh(mesh):
            tsim.swim_step_impl(state, net, key, params, prov=True)
    elif name == "knobs":
        with grc.ring_mesh(mesh):
            tsim.swim_step_impl(state, net, key, params, knobs=tsim.swim_knob_arrays(params))
    elif name == "delta_step":
        # the delta step runs on ranks; its delay lanes do not
        whole = tdelta.install_pending(tdelta.init_delta(n, capacity=4, device=CPU), 2, 2)
        parallel.sharded_delta_step(mesh)(parallel.shard_delta(whole, mesh), net, key,
                                          tdelta.DeltaParams())
    elif name == "delta_run":
        # nor its sided mode
        whole = tdelta.make_sides(tdelta.init_delta(n, capacity=4, device=CPU),
                                  (np.arange(n) >= n // 2).astype(np.int32))
        parallel.sharded_delta_run(mesh)(parallel.shard_delta(whole, mesh), net, key,
                                         tdelta.DeltaParams(), 2)
    elif name == "serve":
        parallel.sharded_serve(mesh, static=None)
    elif name == "gather_mode":
        parallel.sharded_step(mesh, gossip="gather")
    elif name == "global_rows":
        s, _ = tsim.init_state(n, device=CPU), None
        step(s, net, key, params)
    elif name == "group_size":
        import torch.distributed as dist

        parallel.make_mesh(3, group=dist.group.WORLD, device="cpu")


def _plain_history(n: int, victim: int, ticks: int, device=CPU):
    """The unsharded state and net after ``ticks`` steps with a kill."""
    from ringpop_tpu_torch import prng
    from ringpop_tpu_torch.models import swim_sim as tsim

    state, net = tsim.init_state(n, device=device), tsim.make_net(n, device=device)
    params = tsim.SwimParams(loss=0.1, suspicion_ticks=2)
    for t, k in enumerate(prng.split(prng.PRNGKey(9), ticks)):
        if t == 1:
            up = net.up.clone()
            up[victim] = False
            net = net._replace(up=up)
        state, _ = tsim.swim_step_impl(state, net, k, params)
    return state, net, params


def rank_ops(mesh) -> dict:
    """This rank's primitives, hops, checksums and refusals."""
    from ringpop_tpu_torch import parallel, prng
    from ringpop_tpu_torch.models import checksum as cksum
    from ringpop_tpu_torch.models import swim_sim as tsim
    from ringpop_tpu_torch.ops import checksum_device as ckdev
    from ringpop_tpu_torch.ops import gossip_remote_copy as grc
    from ringpop_tpu_torch.ops import peer_hop

    lo, rows = mesh.rows(N)
    x = _inputs()
    with grc.ring_mesh(mesh):
        prims = _primitives(grc, x, lambda v: v[lo:lo + rows])
    hops = peer_hop.peer_hop([_hop_tensor(mesh.rank, d) for d in HOP_DTYPES]
                             + [torch.tensor(mesh.rank, dtype=torch.int32)], mesh.peers)
    # the checksums of the same history on ranks
    state, net = parallel.init_cluster(16, mesh)
    params = tsim.SwimParams(loss=0.1, suspicion_ticks=2)
    step = parallel.sharded_step(mesh)
    for t, k in enumerate(prng.split(prng.PRNGKey(9), 6)):
        if t == 1:
            up = net.up.clone()
            up[3] = False
            net = net._replace(up=up)
        state, _ = step(state, net, k, params)
    book = ckdev.DeviceBook(cksum.default_addresses(16), 0, device=mesh.device)
    sums = parallel.checksums(state, net, book, mesh)
    refusals = {}
    for name in REFUSED:
        try:
            _refusal(name, mesh)
            refusals[name] = ""
        except Exception as exc:  # recorded for the test to judge
            refusals[name] = f"{type(exc).__name__}: {exc}"
    return {
        "prims": {k: v.tolist() for k, v in prims.items()},
        "hops": [h.tolist() for h in hops],
        "checksums": sums.tolist(),
        "refusals": refusals,
    }


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    from ringpop_tpu_torch.parallel import ranks

    return ranks.launch("test_torch_ranks_ops:rank_ops", D, workdir=str(
        tmp_path_factory.mktemp("ranks_ops")), device="cpu",
        paths=[os.path.dirname(os.path.abspath(__file__))], timeout=300)


@pytest.fixture(scope="module")
def stacked():
    """The stacked forms on the one-process mesh, on the whole inputs."""
    from ringpop_tpu_torch import parallel
    from ringpop_tpu_torch.ops import gossip_remote_copy as grc

    with grc.ring_mesh(parallel.make_mesh(devices=[CPU] * D)):
        return _primitives(grc, _inputs(), lambda v: v)


# the outputs split by rows (the rest are replicated: every rank holds all)
ROW_SPLIT = {"recv_merge_in_key", "recv_merge_inbound", "fetch_rows", "fetch_rows_bool",
             "take_per_row", "update_set", "update_max", "take_at", "fetch_many",
             "fetch_many_cols"}


@pytest.mark.parametrize("name", sorted(ROW_SPLIT | {"fetch_global", "allgather",
                                                      "allgather_pair", "sum"}))
def test_rank_primitive_equals_stacked(ranks_out, stacked, name):
    want = stacked[name]
    for r in range(D):
        got = torch.tensor(ranks_out[r]["prims"][name], dtype=want.dtype)
        if name in ROW_SPLIT:
            rows = N // D
            want_r = want[r * rows:(r + 1) * rows]
        elif name == "sum":
            want_r = stacked["allgather"].sum(dim=0, dtype=torch.int32)
        else:
            want_r = want
        assert got.shape == want_r.shape and torch.equal(got, want_r), (name, r)


def test_collectives_are_the_plain_gathers(stacked):
    """Outside a process group's ring the collectives are the identity and
    ``ring_take_at`` the plain index: the stacked outputs above are the
    plain gather, sum and index."""
    x = _inputs()
    assert torch.equal(stacked["allgather"], x["vec"])
    assert torch.equal(stacked["take_at"], x["bplane"][x["idx3"], x["cols3"]])
    assert torch.equal(stacked["fetch_rows"], x["plane"][x["idx3"]])
    assert torch.equal(stacked["fetch_global"], x["narrow"][x["gidx"]])


@pytest.mark.parametrize("dtype", HOP_DTYPES + ["scalar"])
def test_peer_hop_plain_brings_the_left_neighbours(ranks_out, dtype):
    i = HOP_DTYPES.index(dtype) if dtype != "scalar" else len(HOP_DTYPES)
    for r in range(D):
        left = (r - 1) % D
        want = (_hop_tensor(left, dtype) if dtype != "scalar"
                else torch.tensor(left, dtype=torch.int32))
        got = torch.tensor(ranks_out[r]["hops"][i], dtype=want.dtype)
        assert torch.equal(got, want), (dtype, r)


def test_rank_checksums_equal_the_unsharded(ranks_out):
    """Each rank hashes its own rows; the gathered checksums of the live
    nodes equal the unsharded state's, on every rank."""
    from ringpop_tpu_torch.models import checksum as cksum
    from ringpop_tpu_torch.models import swim_sim as tsim
    from ringpop_tpu_torch.ops import checksum_device as ckdev

    state, net, _ = _plain_history(16, 3, 6)
    own = torch.diagonal(state.view_key) & 7
    live = net.up & net.responsive & ((own == tsim.ALIVE) | (own == tsim.SUSPECT))
    book = ckdev.DeviceBook(cksum.default_addresses(16), 0, device=CPU)
    want = ckdev.view_checksums_device(book, state.view_key)[live].tolist()
    assert len(want) == 15
    for r in range(D):
        assert ranks_out[r]["checksums"] == want


@pytest.mark.parametrize("name", REFUSED)
def test_rank_refuses_unported_arms(ranks_out, name):
    """Arms not ported to ranks raise ``NotImplementedError`` naming the
    roadmap item; misplaced inputs raise ``ValueError``."""
    for r in range(D):
        msg = ranks_out[r]["refusals"][name]
        if name in ("gather_mode", "global_rows", "group_size"):
            assert msg.startswith("ValueError"), msg
        elif name == "sparse":
            assert msg.startswith("NotImplementedError") and "sparse step is not ported" in msg
        else:
            assert msg.startswith("NotImplementedError") and "queue 1 item 11" in msg, msg


def test_distinct_devices_in_one_process_point_to_the_group():
    from ringpop_tpu_torch import parallel

    with pytest.raises(NotImplementedError, match=r"make_mesh\(group="):
        parallel.make_mesh(devices=[torch.device("cuda", 0), torch.device("cuda", 1)])


def test_peer_hop_kernel_on_card(tmp_path):
    """On a card: the kernel's hop equals the plain version's, at an int32
    block and an odd-sized bool block (``chip_smoke.py`` phase r times it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the peer hop kernel has no CPU mode)")
    from ringpop_tpu_torch.parallel import ranks

    out = ranks.launch("test_torch_ranks_ops:rank_card_hop", D, workdir=str(tmp_path),
                       paths=[os.path.dirname(os.path.abspath(__file__))], timeout=300)
    for r in range(D):
        assert out[r]["equal"] and out[r]["launches"] == 2, out[r]


def rank_card_hop(mesh) -> dict:
    """One hop of each block through the kernel and through the plain
    version, on this rank."""
    from ringpop_tpu_torch.ops import peer_hop

    blocks = [_hop_tensor(mesh.rank, "int32"), _hop_tensor(mesh.rank, "bool")[:, :1]]
    before = peer_hop.peer_hop.launches
    equal = True
    for b in blocks:
        (got,) = peer_hop.peer_hop([b.to(mesh.device)], mesh.peers)
        (want,) = peer_hop.peer_hop_plain([b], mesh.peers)
        equal &= torch.equal(got.cpu(), want)
    return {"equal": bool(equal), "launches": peer_hop.peer_hop.launches - before}
