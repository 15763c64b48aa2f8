"""The dense sharded step on a process group: one process a shard.

``parallel.make_mesh(group=...)`` in each of 2 gloo ranks on the CPU
(``parallel.ranks.launch``, spawned once for the module), each rank
holding only its own rows, against:

- the JAX package's sharded step and run on its virtual CPU mesh of the
  same ring size (``run_sharded_references``, one child a case, run
  while the ranks do);
- the port's unsharded step;
- the port's one-process mesh, ``make_mesh(devices=[cpu] * 2)``.

Every field of the gathered state and every metric, on every tick,
exactly (the tolerance is zero).  The cases: n = 16 and n = 64 with loss,
a kill and a revive, under the group-id adjacency and the bool mask.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from test_torch_harness import STATE_FIELDS, run_sharded_references

CPU = torch.device("cpu")
D = 2


def _mask(n: int, seed: int) -> list:
    """A seeded bool [n, n] adjacency: most links up, some down one way."""
    return (np.random.default_rng(seed).random((n, n)) > 0.15).tolist()


def _groups(n: int) -> list:
    return [int(i >= n // 2) for i in range(n)]


CASES = [
    {"name": "ranks_n16_groups", "backend": "dense", "entry": "step", "n": 16, "d": D,
     "params": {"loss": 0.1, "suspicion_ticks": 3}, "seed": 3, "ticks": 8,
     "adj": {"groups": _groups(16)},
     "events": {"2": [["kill", 5]], "5": [["revive", 5, 100]]}},
    {"name": "ranks_n16_mask", "backend": "dense", "entry": "step", "n": 16, "d": D,
     "params": {"loss": 0.05, "suspicion_ticks": 3}, "seed": 11, "ticks": 8,
     "adj": {"mask": _mask(16, 1)},
     "events": {"1": [["kill", 12]], "4": [["revive", 12, 50]]}},
    {"name": "ranks_n64_groups", "backend": "dense", "entry": "step", "n": 64, "d": D,
     "params": {"loss": 0.05, "suspicion_ticks": 4}, "seed": 5, "ticks": 9,
     "adj": {"groups": _groups(64)},
     "events": {"2": [["kill", 40]], "6": [["revive", 40, 77]]}},
    {"name": "ranks_n64_mask", "backend": "dense", "entry": "step", "n": 64, "d": D,
     "params": {"loss": 0.02, "suspicion_ticks": 4}, "seed": 7, "ticks": 9,
     "adj": {"mask": _mask(64, 2)},
     "events": {"1": [["kill", 9]], "5": [["revive", 9, 31]]}},
    {"name": "ranks_run_n32", "backend": "dense", "entry": "run", "n": 32, "d": D,
     "params": {"loss": 0.05, "suspicion_ticks": 3}, "seed": 0, "ticks": 8, "down": [20]},
]
STEP_CASES = [c for c in CASES if c["entry"] == "step"]


# ---------------------------------------------------------------------------
# the ranks' side (run in each rank process by ``parallel.ranks``)
# ---------------------------------------------------------------------------


def _rank_net(case: dict, net, mesh):
    """The case's adjacency on this rank: the group-id vector whole, the
    mask's own rows only."""
    adj = case.get("adj")
    if adj is None:
        return net
    if "groups" in adj:
        return net._replace(adj=torch.tensor(adj["groups"], dtype=torch.int32))
    lo, rows = mesh.rows(case["n"])
    return net._replace(adj=torch.tensor(adj["mask"][lo:lo + rows], dtype=torch.bool))


def _flag(net, i: int, value: bool):
    up = net.up.clone()
    up[i] = value
    return net._replace(up=up)


def _gathered(state, mesh) -> dict:
    from ringpop_tpu_torch import parallel

    g = parallel.gather_cluster(state, mesh)
    return {f: getattr(g, f).tolist() for f in STATE_FIELDS}


def rank_cases(mesh, cases: list) -> dict:
    """Each case on this rank: the gathered state and metrics after
    every step (or after the run), and the shapes this rank held."""
    from ringpop_tpu_torch import parallel, prng
    from ringpop_tpu_torch.models import swim_sim as tsim

    out = {}
    for case in cases:
        n = case["n"]
        params = tsim.SwimParams(**case["params"])
        state, net = parallel.init_cluster(n, mesh)
        for i in case.get("down", []):
            net = _flag(net, i, False)
        net = _rank_net(case, net, mesh)
        rec = {"shapes": {f: list(getattr(state, f).shape) for f in STATE_FIELDS},
               "net_shapes": {f: list(getattr(net, f).shape) for f in ("up", "adj")
                              if getattr(net, f) is not None},
               "init": _gathered(state, mesh)}
        key = prng.PRNGKey(case["seed"])
        if case["entry"] == "run":
            state, m = parallel.sharded_run(mesh, net_like=net)(state, net, key, params,
                                                                case["ticks"])
            rec["run"] = {"state": _gathered(state, mesh), "m": {k: int(v) for k, v in m.items()}}
        else:
            step = parallel.sharded_step(mesh, net_like=net)
            ticks = []
            for t, k in enumerate(prng.split(key, case["ticks"])):
                for ev in case.get("events", {}).get(str(t), []):
                    if ev[0] == "revive":
                        state = parallel.revive(state, ev[1], ev[2], mesh)
                    net = _flag(net, ev[1], ev[0] == "revive")
                state, m = step(state, net, k, params)
                ticks.append({"state": _gathered(state, mesh),
                              "m": {k: int(v) for k, v in m.items()},
                              "converged": parallel.converged(state, net, mesh)})
            rec["ticks"] = ticks
        rec["final_shapes"] = {f: list(getattr(state, f).shape) for f in STATE_FIELDS}
        out[case["name"]] = rec
    return out


# ---------------------------------------------------------------------------
# the module's runs: the ranks and the reference children at once
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import os

    from ringpop_tpu_torch.parallel import ranks

    tmp = tmp_path_factory.mktemp("ranks")
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
        got = ranks.launch("test_torch_ranks:rank_cases", D, {"cases": CASES},
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
    state = convert.state_from_numpy({f: ref[f"{name}/init/{f}"] for f in STATE_FIELDS},
                                     device=CPU)
    net = tsim.make_net(case["n"], device=CPU)._replace(
        up=torch.as_tensor(ref[f"{name}/up"]), responsive=torch.as_tensor(ref[f"{name}/responsive"]))
    adj = case.get("adj")
    if adj is not None:
        net = net._replace(adj=torch.tensor(adj["groups"], dtype=torch.int32) if "groups" in adj
                           else torch.tensor(adj["mask"], dtype=torch.bool))
    return state, net, tsim.SwimParams(**case["params"])


def _assert_state(got: dict, want, key: str) -> None:
    """``got`` (lists) equal to ``want`` (reference arrays by key, or a
    port state) in every field."""
    for f in STATE_FIELDS:
        w = want[f"{key}/{f}"] if isinstance(want, dict) else getattr(want, f).numpy()
        np.testing.assert_array_equal(np.asarray(got[f]), w, err_msg=f"{key} {f}")


def _ref_metrics(ref: dict, key: str) -> dict:
    return {k.rsplit("/", 1)[1]: int(v) for k, v in ref.items() if k.startswith(f"{key}/")}


@pytest.mark.parametrize("case", STEP_CASES, ids=lambda c: c["name"])
def test_rank_step_matches_reference(runs, case):
    """On every tick, each rank's gathered state and the cluster's
    metrics equal the JAX sharded step's, the port's unsharded step's and
    the one-process mesh's; both ranks agree."""
    from ringpop_tpu_torch import convert, parallel
    from ringpop_tpu_torch.models import swim_sim as tsim

    ref, got = runs
    name = case["name"]
    state, net, params = _start(case, ref)
    for r in range(D):
        _assert_state(got[r][name]["init"], state, f"{name} rank {r} init")
    mesh = parallel.make_mesh(devices=[CPU] * D)
    one = parallel.sharded_step(mesh, net_like=net)
    plain, stacked = state, state
    for t, key in enumerate(ref[f"{name}/keys"]):
        k = convert.key_from_numpy(key)
        for ev in case["events"].get(str(t), []):
            if ev[0] == "revive":
                plain = tsim.revive(plain, ev[1], ev[2])
                stacked = parallel.revive(stacked, ev[1], ev[2], mesh)
            net = _flag(net, ev[1], ev[0] == "revive")
        plain, m_plain = tsim.swim_step_impl(plain, net, k, params)
        stacked, m_one = one(stacked, net, k, params)
        want_m = _ref_metrics(ref, f"{name}/m{t}")
        for r in range(D):
            tick = got[r][name]["ticks"][t]
            _assert_state(tick["state"], ref, f"{name}/{t}")
            assert tick["m"] == want_m, (name, t, r)
            assert tick["converged"] == bool(tsim.converged_impl(plain, net))
        _assert_state(got[0][name]["ticks"][t]["state"], plain, f"{name}/{t} unsharded")
        _assert_state(got[0][name]["ticks"][t]["state"], stacked, f"{name}/{t} one-process")
        assert {k: int(v) for k, v in m_plain.items()} == want_m
        assert {k: int(v) for k, v in m_one.items()} == want_m


def test_rank_run_matches_reference(runs):
    """``sharded_run`` on ranks: the final state and the last tick's
    metrics equal the JAX sharded run's and the port's unsharded run's."""
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models import swim_sim as tsim

    ref, got = runs
    case = CASES[-1]
    name = case["name"]
    state, net, params = _start(case, ref)
    plain, m_plain = tsim.swim_run_impl(state, net, convert.key_from_numpy(ref[f"{name}/key"]),
                                        params, case["ticks"])
    for r in range(D):
        _assert_state(got[r][name]["run"]["state"], ref, f"{name}/run")
        assert got[r][name]["run"]["m"] == _ref_metrics(ref, f"{name}/mrun")
    _assert_state(got[0][name]["run"]["state"], plain, f"{name} unsharded")
    assert {k: int(v) for k, v in m_plain.items()} == _ref_metrics(ref, f"{name}/mrun")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_rank_holds_its_rows_only(runs, case):
    """Every rank's planes are [N/D, N], at the start and the end; the
    bool mask is its rows, the group-id vector and ``up`` whole."""
    _, got = runs
    n = case["n"]
    for r in range(D):
        rec = got[r][case["name"]]
        for shapes in (rec["shapes"], rec["final_shapes"]):
            assert shapes == {"view_key": [n // D, n], "pb": [n // D, n],
                              "suspect_left": [n // D, n], "tick": []}
        want_adj = {None: None, "groups": [n], "mask": [n // D, n]}[
            next(iter(case["adj"])) if case.get("adj") else None]
        assert rec["net_shapes"].get("adj") == want_adj
        assert rec["net_shapes"]["up"] == [n]


def test_cases_exercise_kill_revive_and_exchange(runs):
    """The lossy cases reach the ping-req exchange, declare the victim
    suspect, and the revived node's row starts fresh."""
    ref, got = runs
    for case in STEP_CASES:
        name = case["name"]
        ticks = range(case["ticks"])
        assert any(int(ref[f"{name}/m{t}/ping_reqs"]) > 0 for t in ticks), name
        assert any(int(ref[f"{name}/m{t}/suspects_declared"]) > 0 for t in ticks), name
        (t_rev, evs), = [(int(t), e) for t, e in case["events"].items() if e[0][0] == "revive"]
        node, inc = evs[0][1], evs[0][2]
        row = np.asarray(got[0][name]["ticks"][t_rev]["state"]["view_key"])[node]
        assert row[node] >> 3 >= inc
