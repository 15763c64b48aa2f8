"""The port's sharded delta path and mesh API against the reference.

Mirrors the delta half of ``tests/test_parallel.py`` and
``tests/test_gossip_remote_copy.py`` for ``ringpop_tpu_torch/parallel/mesh.py``:

- the sharded delta step (n = 16 over 2 shards; n = 64 over 8 shards
  with a downed node, through the ping-req stages) and the sharded delta
  run, every ``DeltaState`` field and metric against the JAX package's
  sharded entry points on a virtual CPU mesh, and against the port's
  unsharded step;
- every reference ``_gather_rows`` site of the delta step routes through
  the ring, and no other gather does;
- the layout maps cover every state field and agree with the
  reference's; an unmapped field, an uneven shard, a dense adjacency in
  delta and two distinct devices are refused.

The JAX side runs in child processes (``run_sharded_references``), one
per case, side by side.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch

from test_torch_harness import DELTA_FIELDS, assert_same_field, run_sharded_references

CPU = torch.device("cpu")

DELTA_CASES = [
    {"name": "delta_step_n16_d2", "backend": "delta", "entry": "step", "n": 16, "d": 2,
     "params": {"loss": 0.05, "suspicion_ticks": 4}, "seed": 9, "ticks": 3, "down": [5],
     "caps": {"capacity": 8, "wire_cap": 4, "claim_grid": 8}},
    {"name": "delta_step_n64_d8", "backend": "delta", "entry": "step", "n": 64, "d": 8,
     "params": {"loss": 0.05, "suspicion_ticks": 6}, "seed": 4, "ticks": 12, "down": [9],
     "caps": {"capacity": 32, "wire_cap": 8, "claim_grid": 16}},
    {"name": "delta_run_n16_d2", "backend": "delta", "entry": "run", "n": 16, "d": 2,
     "params": {"loss": 0.02}, "seed": 5, "ticks": 6,
     "caps": {"capacity": 8, "wire_cap": 4, "claim_grid": 8}},
]


def _mesh(d: int):
    from ringpop_tpu_torch import parallel

    return parallel.make_mesh(devices=[CPU] * d)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_sharded_references(DELTA_CASES, str(tmp_path_factory.mktemp("parallel_ref")))


def _start(ref: dict, case: dict):
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.models import swim_sim as tsim

    name = case["name"]
    state = convert.delta_state_from_numpy(
        {f: ref.get(f"{name}/init/{f}") for f in DELTA_FIELDS}, device=CPU)
    net = tsim.make_net(case["n"], device=CPU)._replace(
        up=torch.as_tensor(ref[f"{name}/up"]), responsive=torch.as_tensor(ref[f"{name}/responsive"]))
    caps = case["caps"]
    params = tdelta.DeltaParams(swim=tsim.SwimParams(**case["params"]),
                                wire_cap=caps["wire_cap"], claim_grid=caps["claim_grid"])
    return state, net, params


def _assert_state(got, ref: dict, key: str) -> None:
    from ringpop_tpu_torch import convert

    arrays = convert.delta_state_to_numpy(got)
    for f in DELTA_FIELDS:
        assert_same_field(arrays[f], ref.get(f"{key}/{f}"), f"{key} {f}")


def _np(x):
    return None if x is None else x.numpy()


def _metrics(m: dict) -> dict[str, int]:
    return {k: int(v) for k, v in m.items()}


def _ref_metrics(ref: dict, key: str) -> dict[str, int]:
    return {k.rsplit("/", 1)[1]: int(v) for k, v in ref.items() if k.startswith(f"{key}/")}


@pytest.mark.parametrize("case", [c for c in DELTA_CASES if c["entry"] == "step"],
                         ids=lambda c: c["name"])
def test_sharded_delta_step_matches_reference(reference, case):
    """Every field and metric on every tick equals the JAX sharded delta
    step's, and the port's unsharded delta step's."""
    from ringpop_tpu_torch import convert, parallel
    from ringpop_tpu_torch.models import swim_delta as tdelta

    name = case["name"]
    state, net, params = _start(reference, case)
    mesh = _mesh(case["d"])
    sh = parallel.shard_delta(state, mesh)
    step = parallel.sharded_delta_step(mesh)
    plain = state
    for t, key in enumerate(reference[f"{name}/keys"]):
        k = convert.key_from_numpy(key)
        sh, m = step(sh, net, k, params)
        plain, m_plain = tdelta.delta_step_impl(plain, net, k, params)
        _assert_state(sh, reference, f"{name}/{t}")
        _assert_state(plain, reference, f"{name}/{t}")
        assert _metrics(m) == _ref_metrics(reference, f"{name}/m{t}") == _metrics(m_plain), t


def test_sharded_delta_run_matches_reference(reference):
    from ringpop_tpu_torch import convert, parallel

    case = DELTA_CASES[2]
    name = case["name"]
    state, net, params = _start(reference, case)
    mesh = _mesh(case["d"])
    run = parallel.sharded_delta_run(mesh)
    sh, m = run(parallel.shard_delta(state, mesh), net,
                convert.key_from_numpy(reference[f"{name}/key"]), params, case["ticks"])
    _assert_state(sh, reference, f"{name}/run")
    assert _metrics(m) == _ref_metrics(reference, f"{name}/mrun")


def test_delta_cases_reach_the_pingreq_stages(reference):
    """The 64-node case runs ping-reqs with changes in flight (stages 5b-5d)."""
    ticks = range(DELTA_CASES[1]["ticks"])
    assert sum(int(reference[f"delta_step_n64_d8/m{t}/ping_reqs"]) for t in ticks) > 0
    assert sum(int(reference[f"delta_step_n64_d8/m{t}/pingreq_changes_applied"])
               for t in ticks) > 0


# the port function of each reference ``_gather_rows`` site of the delta step
RING_SITES = {"delta_step_impl", "_ack_full_sync", "segs_b", "segs_c", "segs_d",
              "_route_claims_multi"}


def test_delta_ring_sites_route_through_the_ring(monkeypatch):
    """Under the ring, the row fetches come from the reference's
    ``_gather_rows`` sites only, and the ping-req stages 5c and 5d are
    among them; the ring state equals the unsharded one."""
    from ringpop_tpu_torch import parallel, prng
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.models import swim_sim as tsim
    from ringpop_tpu_torch.ops import gossip_remote_copy as grc

    callers = []
    real = grc.ring_fetch_rows

    def spy(plane, idx):
        callers.append(sys._getframe(2).f_code.co_name)  # the caller of _gather_rows
        return real(plane, idx)

    monkeypatch.setattr(grc, "ring_fetch_rows", spy)
    n = 64
    params = tdelta.DeltaParams(swim=tsim.SwimParams(loss=0.05, suspicion_ticks=6),
                                wire_cap=8, claim_grid=16)
    net = tsim.make_net(n, device=CPU)
    net = net._replace(up=net.up.clone().index_fill_(0, torch.tensor([9]), False))
    mesh = _mesh(8)
    step = parallel.sharded_delta_step(mesh)
    sh = plain = tdelta.init_delta(n, capacity=32, device=CPU)
    for key in prng.split(prng.PRNGKey(4), 12):
        sh, _ = step(sh, net, key, params)
        plain, _ = tdelta.delta_step_impl(plain, net, key, params)
    for f in DELTA_FIELDS:
        assert_same_field(_np(getattr(sh, f)), _np(getattr(plain, f)), f)
    assert set(callers) <= RING_SITES, set(callers) - RING_SITES
    assert {"delta_step_impl", "segs_b", "segs_c", "segs_d", "_route_claims_multi"} <= set(callers)
    # outside a ring nothing hops
    callers.clear()
    tdelta.delta_step_impl(plain, net, prng.PRNGKey(5), params)
    tdelta.materialize_rows(plain, torch.arange(4))
    assert callers == []


def test_delta_full_sync_site_routes_through_the_ring(monkeypatch):
    """The full-sync adoption (``_ack_full_sync``) fetches the provider's
    table over the ring, and equals the unsharded merge."""
    from ringpop_tpu_torch import parallel, prng
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.models import swim_sim as tsim
    from ringpop_tpu_torch.ops import gossip_remote_copy as grc

    callers = []
    real = grc.ring_fetch_rows
    monkeypatch.setattr(grc, "ring_fetch_rows", lambda p, i: (
        callers.append(sys._getframe(2).f_code.co_name) or real(p, i)))
    n = 16
    params = tdelta.DeltaParams(swim=tsim.SwimParams(), wire_cap=4, claim_grid=8)
    net = tsim.make_net(n, device=CPU)
    # every node has joined through node 0 and knows only itself and
    # node 0: the digests differ, and full syncs fire in the first tick
    start = tdelta.init_delta(n, capacity=16, mode="self", device=CPU)
    for j in range(1, n):
        start = tdelta.admin_join(start, j, 0)
    mesh = _mesh(4)
    sh, m = parallel.sharded_delta_step(mesh)(start, net, prng.PRNGKey(2), params)
    plain, m_plain = tdelta.delta_step_impl(start, net, prng.PRNGKey(2), params)
    assert int(m["full_syncs"]) > 0 and _metrics(m) == _metrics(m_plain)
    for f in DELTA_FIELDS:
        assert_same_field(_np(getattr(sh, f)), _np(getattr(plain, f)), f)
    assert "_ack_full_sync" in callers


# ---------------------------------------------------------------------------
# layout maps, placement and guards
# ---------------------------------------------------------------------------


def test_field_specs_cover_every_state_field(reference):
    """A field added to a state type without a layout fails here; every
    kind is the reference's for the same field."""
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.models import swim_sim as tsim
    from ringpop_tpu_torch.parallel import mesh as pmesh

    for name, cls in (("CLUSTER_FIELD_SPECS", tsim.ClusterState),
                      ("NET_FIELD_SPECS", tsim.NetState),
                      ("DELTA_FIELD_SPECS", tdelta.DeltaState)):
        ours = getattr(pmesh, name)
        assert set(ours) == set(cls._fields), name
        theirs = json.loads(str(reference[f"maps/{name}"]))
        assert {f: theirs[f] for f in ours} == ours, name
        for kind in ours.values():
            assert kind in pmesh._SPLIT_AXIS or kind == pmesh._ADJ, kind


def test_unmapped_field_fails_loudly():
    from ringpop_tpu_torch.parallel import mesh as pmesh

    with pytest.raises(KeyError, match="FIELD_SPECS"):
        pmesh._field_split({}, "brand_new_plane", torch.zeros((4, 4)))


def test_uneven_shard_rejected():
    from ringpop_tpu_torch import parallel
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.models import swim_sim as tsim

    mesh = _mesh(8)
    with pytest.raises(ValueError, match="divisible"):
        parallel.shard_cluster(tsim.init_state(12, device=CPU), tsim.make_net(12, device=CPU), mesh)
    with pytest.raises(ValueError, match="divisible"):
        parallel.shard_delta(tdelta.init_delta(12, capacity=4, device=CPU), mesh)
    with pytest.raises(ValueError, match="divisible"):
        parallel.sharded_step(mesh)(tsim.init_state(12, device=CPU), tsim.make_net(12, device=CPU),
                                    None, tsim.SwimParams())


def test_sharded_delta_rejects_dense_adjacency():
    from ringpop_tpu_torch import parallel, prng
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.models import swim_sim as tsim

    mesh = _mesh(8)
    net = tsim.make_net(64, partitioned=True, device=CPU)
    state = parallel.shard_delta(tdelta.init_delta(64, capacity=16, device=CPU), mesh)
    for build in (parallel.sharded_delta_step, parallel.sharded_delta_run):
        with pytest.raises(NotImplementedError, match="group-id"):
            build(mesh)(state, net, prng.PRNGKey(0), tdelta.DeltaParams(), 1)
    # a group-id vector is taken only by a step built for it
    gid = tsim.make_net(64, device=CPU)._replace(adj=(torch.arange(64) >= 32).to(torch.int32))
    with pytest.raises(ValueError, match="net_like"):
        parallel.sharded_delta_step(mesh)(state, gid, prng.PRNGKey(0), tdelta.DeltaParams())
    step = parallel.sharded_delta_step(mesh, net_like=gid)
    sh, _ = step(state, gid, prng.PRNGKey(0), tdelta.DeltaParams())
    plain, _ = tdelta.delta_step_impl(state, gid, prng.PRNGKey(0), tdelta.DeltaParams())
    assert torch.equal(sh.d_subj, plain.d_subj) and torch.equal(sh.d_key, plain.d_key)


def test_make_mesh_devices():
    """D shards on one device make a mesh; fewer devices than asked for,
    and two distinct devices, are refused."""
    from ringpop_tpu_torch import parallel

    mesh = parallel.make_mesh(devices=[CPU] * 4)
    assert mesh.shape == {"nodes": 4} and mesh.size == 4 and mesh.device == CPU
    assert parallel.make_mesh(2, devices=[CPU] * 4).size == 2
    with pytest.raises(ValueError, match="only 1 available"):
        parallel.make_mesh(2, devices=[CPU])
    with pytest.raises(NotImplementedError, match="Cross-card ring hop"):
        parallel.make_mesh(devices=[torch.device("cuda", 0), torch.device("cuda", 1)])
    with pytest.raises(NotImplementedError, match="Cross-card ring hop"):
        parallel.make_mesh(devices=[CPU, torch.device("cuda", 0)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            parallel.make_mesh(2)
