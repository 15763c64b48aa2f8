"""The delta sharded step on a process group: one process a shard.

``parallel.sharded_delta_step``/``sharded_delta_run`` on
``parallel.make_mesh(group=...)`` in each of 2 gloo ranks on the CPU
(``parallel.ranks.launch``, spawned once for the module), each rank holding
only its own rows of the tables and the digest, against:

- the JAX package's sharded delta step and run on its virtual CPU mesh of
  the same ring size (``run_sharded_references``, one child a case, run
  while the ranks do);
- the port's unsharded delta step;
- the port's one-process mesh, ``make_mesh(devices=[cpu] * 2)``.

Every field of the gathered state and every metric, on every tick,
exactly (the tolerance is zero).  The cases: n = 16 and n = 64 with loss,
a kill, a revive and a rebase; n = 64 with caps small enough that claims
drop and ``overflow_drops`` grows; ``sharded_delta_run`` at n = 32.  The
ranks also count the cluster predicates their own rows answered unlike
the other rank's, and the claims their senders addressed to the other
rank's receivers, so that the collectives of the rank step are shown to
run.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest
import torch

from test_torch_harness import DELTA_FIELDS, assert_same_field, run_sharded_references

CPU = torch.device("cpu")
D = 2
ROW_FIELDS = ("d_subj", "d_key", "d_pb", "d_sl", "digest")

CASES = [
    {"name": "rdelta_n16", "backend": "delta", "entry": "step", "n": 16, "d": D,
     "caps": {"capacity": 16, "wire_cap": 4, "claim_grid": 8},
     "params": {"loss": 0.1, "suspicion_ticks": 3}, "seed": 3, "ticks": 8,
     "events": {"2": [["kill", 5]], "5": [["revive", 5, 100]]}, "rebase_at": [6]},
    {"name": "rdelta_n64", "backend": "delta", "entry": "step", "n": 64, "d": D,
     "caps": {"capacity": 32, "wire_cap": 8, "claim_grid": 16},
     "params": {"loss": 0.05, "suspicion_ticks": 4}, "seed": 5, "ticks": 9,
     "events": {"2": [["kill", 40]], "6": [["revive", 40, 77]]}, "rebase_at": [7]},
    {"name": "rdelta_n64_drops", "backend": "delta", "entry": "step", "n": 64, "d": D,
     "caps": {"capacity": 4, "wire_cap": 2, "claim_grid": 2},
     "params": {"loss": 0.1, "suspicion_ticks": 3}, "seed": 3, "ticks": 8,
     "events": {"1": [["kill", 3], ["kill", 9], ["kill", 12]], "5": [["revive", 9, 60]]}},
    {"name": "rdelta_run_n32", "backend": "delta", "entry": "run", "n": 32, "d": D,
     "caps": {"capacity": 16, "wire_cap": 4, "claim_grid": 8},
     "params": {"loss": 0.05, "suspicion_ticks": 3}, "seed": 0, "ticks": 8, "down": [20]},
]
STEP_CASES = [c for c in CASES if c["entry"] == "step"]
# the arms of the delta step that a process group's ring still refuses
REFUSED = ["sided", "pending", "carried_planes", "link_rules", "period", "phase_mod", "knobs",
           "prov", "upto"]


# ---------------------------------------------------------------------------
# the ranks' side (run in each rank process by ``parallel.ranks``)
# ---------------------------------------------------------------------------


def _params(case: dict):
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.models import swim_sim as tsim

    caps = case["caps"]
    return tdelta.DeltaParams(swim=tsim.SwimParams(**case["params"]),
                              wire_cap=caps["wire_cap"], claim_grid=caps["claim_grid"])


def _flag(net, i: int, value: bool):
    up = net.up.clone()
    up[i] = value
    return net._replace(up=up)


def _gathered(state, mesh) -> dict:
    from ringpop_tpu_torch import convert, parallel

    g = convert.delta_state_to_numpy(parallel.gather_delta(state, mesh))
    return {f: None if v is None else v.tolist() for f, v in g.items()}


def _shapes(state) -> dict:
    return {f: list(getattr(state, f).shape) for f in ("base_key", "bp_rank", *ROW_FIELDS)}


def _refusal(name: str, mesh) -> None:
    """Call the delta step with the arm ``name`` on a process group's
    mesh (it must raise)."""
    from ringpop_tpu_torch import parallel, prng
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.models import swim_sim as tsim
    from ringpop_tpu_torch.ops import gossip_remote_copy as grc

    n = 8
    state = parallel.init_delta(n, mesh, capacity=4)
    net = tsim.make_net(n, device=CPU)
    key = prng.PRNGKey(0)
    params = tdelta.DeltaParams(wire_cap=2, claim_grid=4)
    step = parallel.sharded_delta_step(mesh)
    if name == "sided":
        whole = tdelta.make_sides(tdelta.init_delta(n, capacity=4, device=CPU),
                                  (np.arange(n) >= n // 2).astype(np.int32))
        step(parallel.shard_delta(whole, mesh), net, key, params)
    elif name == "pending":
        whole = tdelta.install_pending(tdelta.init_delta(n, capacity=4, device=CPU), 2, 2)
        step(parallel.shard_delta(whole, mesh), net, key, params)
    elif name == "carried_planes":
        step(tdelta._with_slot_base(state), net, key, params)
    elif name == "link_rules":
        k = torch.ones((1, n), dtype=torch.bool)
        step(state, net._replace(link_src=k, link_dst=k, link_p=torch.zeros(1)), key, params)
    elif name == "period":
        step(state, net._replace(period=torch.ones(n, dtype=torch.int32)), key, params)
    elif name == "phase_mod":
        step(state, net, key, params._replace(swim=tsim.SwimParams(phase_mod=2)))
    elif name == "knobs":
        with grc.ring_mesh(mesh):
            tdelta.delta_step_impl(state, net, key, params,
                                   knobs=tsim.swim_knob_arrays(params.swim))
    elif name == "prov":
        with grc.ring_mesh(mesh):
            tdelta.delta_step_impl(state, net, key, params, prov=True)
    elif name == "upto":
        step(state, net, key, params, upto=3)


def _count_crossings(tdelta, rank: int, crossed: list) -> None:
    """Wrap the claim routing so that it adds to ``crossed[0]`` the
    sender rows of this rank whose claims go to another rank's receiver."""
    real = tdelta._route_claims_multi

    def spy(n, segments, grid):
        for _, _, valid, recv in segments:
            other = torch.div(recv, valid.shape[0], rounding_mode="floor") != rank
            crossed[0] += int((valid.any(dim=1) & other).sum())
        return real(n, segments, grid)

    tdelta._route_claims_multi = spy


def rank_cases(mesh, cases: list) -> dict:
    """Each case on this rank: the gathered state and metrics after every
    step (or after the run), the shapes this rank held, the predicates it
    answered unlike the other rank and the claims its senders addressed to
    the other rank, each tick; then the sample's view rows, the checksums
    and the refusals."""
    from ringpop_tpu_torch import parallel, prng
    from ringpop_tpu_torch.models import checksum as cksum
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.models import swim_sim as tsim
    from ringpop_tpu_torch.ops import checksum_device as ckdev
    from ringpop_tpu_torch.ops import gossip_remote_copy as grc

    crossed = [0]
    _count_crossings(tdelta, mesh.rank, crossed)
    out = {}
    for case in cases:
        n = case["n"]
        params = _params(case)
        state = parallel.init_delta(n, mesh, capacity=case["caps"]["capacity"])
        net = tsim.make_net(n, device=CPU)
        for i in case.get("down", []):
            net = _flag(net, i, False)
        rec = {"shapes": _shapes(state), "init": _gathered(state, mesh)}
        key = prng.PRNGKey(case["seed"])
        if case["entry"] == "run":
            state, m = parallel.sharded_delta_run(mesh)(state, net, key, params, case["ticks"])
            rec["run"] = {"state": _gathered(state, mesh), "m": {k: int(v) for k, v in m.items()}}
        else:
            step = parallel.sharded_delta_step(mesh)
            ticks = []
            for t, k in enumerate(prng.split(key, case["ticks"])):
                if t in case.get("rebase_at", []):
                    state = parallel.rebase(state, mesh, anti_entropy=True)
                for ev in case.get("events", {}).get(str(t), []):
                    if ev[0] == "revive":
                        state = parallel.revive(state, ev[1], ev[2], mesh)
                    net = _flag(net, ev[1], ev[0] == "revive")
                one_sided, crossed0 = tdelta._cluster_any.one_sided, crossed[0]
                state, m = step(state, net, k, params)
                ticks.append({"state": _gathered(state, mesh),
                              "m": {k: int(v) for k, v in m.items()},
                              "converged": parallel.converged(state, net, mesh),
                              "one_sided": tdelta._cluster_any.one_sided - one_sided,
                              "crossed": crossed[0] - crossed0})
            rec["ticks"] = ticks
        rec["final_shapes"] = _shapes(state)
        with grc.ring_mesh(mesh):
            rec["rows"] = tdelta.materialize_rows(state, _sample(n)).tolist()
        book = ckdev.DeviceBook(cksum.default_addresses(n), 0, device=CPU)
        rec["checksums"] = parallel.checksums(state, net, book, mesh).tolist()
        rec["sample"] = parallel.checksums(state, net, book, mesh, sample=_sample(n)).tolist()
        out[case["name"]] = rec
    refusals = {}
    for name in REFUSED:
        try:
            _refusal(name, mesh)
            refusals[name] = ""
        except Exception as exc:  # recorded for the test to judge
            refusals[name] = f"{type(exc).__name__}: {exc}"
    out["refusals"] = refusals
    return out


def _sample(n: int) -> list:
    """Viewers on both ranks, out of order."""
    return [1, n - 2, n // 2 + 3, 3, n // 2 - 1]


# ---------------------------------------------------------------------------
# the module's runs: the ranks and the reference children at once
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from ringpop_tpu_torch.parallel import ranks

    tmp = tmp_path_factory.mktemp("ranks_delta")
    ref: dict = {}
    err: list = []

    def reference():
        try:
            ref.update(run_sharded_references(CASES, str(tmp)))
        except BaseException as exc:  # re-raised in the test's thread
            err.append(exc)

    th = threading.Thread(target=reference)
    th.start()
    try:
        got = ranks.launch("test_torch_ranks_delta:rank_cases", D, {"cases": CASES},
                           workdir=str(tmp / "ranks"), device="cpu",
                           paths=[os.path.dirname(os.path.abspath(__file__))], timeout=600)
    finally:
        th.join()
    if err:
        raise err[0]
    return ref, got


def _start(case: dict, ref: dict):
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models import swim_sim as tsim

    name = case["name"]
    state = convert.delta_state_from_numpy(
        {f: ref.get(f"{name}/init/{f}") for f in DELTA_FIELDS}, device=CPU)
    net = tsim.make_net(case["n"], device=CPU)._replace(
        up=torch.as_tensor(ref[f"{name}/up"]), responsive=torch.as_tensor(ref[f"{name}/responsive"]))
    return state, net, _params(case)


def _assert_state(got: dict, want, key: str) -> None:
    """``got`` (lists) equal to ``want`` (reference arrays by key, or a
    port state) in every field."""
    from ringpop_tpu_torch import convert

    if not isinstance(want, dict):
        want = {f"{key}/{f}": v for f, v in convert.delta_state_to_numpy(want).items()}
    for f in DELTA_FIELDS:
        w = want.get(f"{key}/{f}")
        g = None if got.get(f) is None else np.asarray(got[f], dtype=w.dtype if w is not None
                                                       else None)
        assert_same_field(g, w, f"{key} {f}")


def _ref_metrics(ref: dict, key: str) -> dict:
    return {k.rsplit("/", 1)[1]: int(v) for k, v in ref.items() if k.startswith(f"{key}/")}


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: c["name"])
def test_rank_delta_step_matches_reference(runs, case):
    """On every tick, each rank's gathered state and the cluster's
    metrics equal the JAX sharded delta step's, the port's unsharded delta
    step's and the one-process mesh's; both ranks agree."""
    from ringpop_tpu_torch import convert, parallel
    from ringpop_tpu_torch.models import swim_delta as tdelta

    ref, got = runs
    name = case["name"]
    state, net, params = _start(case, ref)
    for r in range(D):
        _assert_state(got[r][name]["init"], state, f"{name} rank {r} init")
    mesh = parallel.make_mesh(devices=[CPU] * D)
    one = parallel.sharded_delta_step(mesh)
    plain, stacked = state, state
    for t, key in enumerate(ref[f"{name}/keys"]):
        k = convert.key_from_numpy(key)
        if t in case.get("rebase_at", []):
            plain = tdelta.rebase(plain, anti_entropy=True)
            stacked = parallel.rebase(stacked, mesh, anti_entropy=True)
        for ev in case["events"].get(str(t), []):
            if ev[0] == "revive":
                plain = tdelta.revive(plain, ev[1], ev[2])
                stacked = parallel.revive(stacked, ev[1], ev[2], mesh)
            net = _flag(net, ev[1], ev[0] == "revive")
        plain, m_plain = tdelta.delta_step_impl(plain, net, k, params)
        stacked, m_one = one(stacked, net, k, params)
        want_m = _ref_metrics(ref, f"{name}/m{t}")
        for r in range(D):
            tick = got[r][name]["ticks"][t]
            _assert_state(tick["state"], ref, f"{name}/{t}")
            assert tick["m"] == want_m, (name, t, r)
            assert tick["converged"] == bool(tdelta._converged_impl(plain, net.up, net.responsive))
        _assert_state(got[0][name]["ticks"][t]["state"], plain, f"{name}/{t} unsharded")
        _assert_state(got[0][name]["ticks"][t]["state"], stacked, f"{name}/{t} one-process")
        assert {k: int(v) for k, v in m_plain.items()} == want_m
        assert {k: int(v) for k, v in m_one.items()} == want_m


def test_rank_delta_run_matches_reference(runs):
    """``sharded_delta_run`` on ranks: the final state and the last tick's
    metrics equal the JAX sharded run's and the port's unsharded run's."""
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models import swim_delta as tdelta

    ref, got = runs
    case = CASES[-1]
    name = case["name"]
    state, net, params = _start(case, ref)
    plain, m_plain = tdelta.delta_run_impl(
        state, net, convert.key_from_numpy(ref[f"{name}/key"]), params, case["ticks"])
    for r in range(D):
        _assert_state(got[r][name]["run"]["state"], ref, f"{name}/run")
        assert got[r][name]["run"]["m"] == _ref_metrics(ref, f"{name}/mrun")
    _assert_state(got[0][name]["run"]["state"], plain, f"{name} unsharded")
    assert {k: int(v) for k, v in m_plain.items()} == _ref_metrics(ref, f"{name}/mrun")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_rank_holds_its_rows_only(runs, case):
    """Every rank's tables are [N/D, C] and its digest [N/D], at the start
    and the end; the base and its rank structures are whole."""
    _, got = runs
    n, c = case["n"], case["caps"]["capacity"]
    want = {"base_key": [n], "bp_rank": [n], "d_subj": [n // D, c], "d_key": [n // D, c],
            "d_pb": [n // D, c], "d_sl": [n // D, c], "digest": [n // D]}
    for r in range(D):
        rec = got[r][case["name"]]
        assert rec["shapes"] == want and rec["final_shapes"] == want, r


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_rank_delta_checksums_equal_the_unsharded(runs, case):
    """Each rank hashes the sampled viewers it holds; the live ones'
    checksums, gathered, equal the unsharded final state's, on every rank,
    for every viewer and for a sample out of order."""
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models import checksum as cksum
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.models import swim_sim as tsim
    from ringpop_tpu_torch.ops import checksum_device as ckdev

    ref, got = runs
    name = case["name"]
    key = f"{name}/run" if case["entry"] == "run" else f"{name}/{case['ticks'] - 1}"
    state = convert.delta_state_from_numpy({f: ref.get(f"{key}/{f}") for f in DELTA_FIELDS},
                                           device=CPU)
    up = np.asarray(ref[f"{name}/up"]).copy()
    for evs in case.get("events", {}).values():
        for ev in evs:
            up[ev[1]] = ev[0] == "revive"
    own = tdelta.view_lookup(state, torch.arange(case["n"], dtype=torch.int32)) & 7
    live = torch.as_tensor(up) & ((own == tsim.ALIVE) | (own == tsim.SUSPECT))
    book = ckdev.DeviceBook(cksum.default_addresses(case["n"]), 0, device=CPU)
    sums = ckdev.view_checksums_device(book, tdelta.densify(state).view_key)
    want = sums[live].tolist()
    want_sample = [int(sums[i]) for i in _sample(case["n"]) if live[i]]
    assert len(want_sample) >= 2
    for r in range(D):
        assert got[r][name]["checksums"] == want
        assert got[r][name]["sample"] == want_sample


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_rank_materialize_rows_equal_the_unsharded(runs, case):
    """``materialize_rows`` on a rank, for a sample of viewers on both
    ranks, equals the unsharded final state's rows, on every rank."""
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models import swim_delta as tdelta

    ref, got = runs
    name = case["name"]
    key = f"{name}/run" if case["entry"] == "run" else f"{name}/{case['ticks'] - 1}"
    state = convert.delta_state_from_numpy({f: ref.get(f"{key}/{f}") for f in DELTA_FIELDS},
                                           device=CPU)
    want = tdelta.materialize_rows(state, _sample(case["n"])).tolist()
    for r in range(D):
        assert got[r][name]["rows"] == want, r


@pytest.mark.parametrize("name", REFUSED)
def test_rank_delta_refuses_unported_arms(runs, name):
    """The delta step's arms not ported to ranks raise
    ``NotImplementedError`` naming the roadmap item and the one-process
    mesh."""
    _, got = runs
    for r in range(D):
        msg = got[r]["refusals"][name]
        assert msg.startswith("NotImplementedError") and "queue 1 item 11" in msg, msg
        assert "make_mesh(devices=[device] * D)" in msg, msg


def test_cases_exercise_the_rank_collectives(runs):
    """The cases reach ticks where a cluster predicate is true on one
    rank's rows and false on the other's, and ticks where claims cross
    ranks, on both ranks; the lossy cases reach the ping-req exchange and
    declare suspects; the small caps drop claims and overflow tables."""
    ref, got = runs
    for case in STEP_CASES:
        name = case["name"]
        for r in range(D):
            ticks = got[r][name]["ticks"]
            # the small caps keep every rank busy: each predicate is true on both
            if name != "rdelta_n64_drops":
                assert any(t["one_sided"] > 0 for t in ticks), (name, r)
            assert any(t["crossed"] > 0 for t in ticks), (name, r)
        steps = range(case["ticks"])
        assert any(int(ref[f"{name}/m{t}/ping_reqs"]) > 0 for t in steps), name
        assert any(int(ref[f"{name}/m{t}/pingreq_changes_applied"]) > 0 for t in steps), name
        assert any(int(ref[f"{name}/m{t}/suspects_declared"]) > 0 for t in steps), name
    drops = "rdelta_n64_drops"
    last = CASES[2]["ticks"] - 1
    assert int(ref[f"{drops}/{last}/overflow_drops"]) > 0
    assert sum(int(ref[f"{drops}/m{t}/claims_dropped"]) for t in range(last + 1)) > 0
