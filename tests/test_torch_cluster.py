"""The port's ``SimCluster`` (dense) against the reference ``SimCluster``:
the same membership checksums, and so the same checksum groups, tick
for tick, with ``tick(1)`` and ``tick(5)`` mixed (the two key
schedules), a kill, 1% loss, and revive/leave churn."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_harness import port_cluster, run_port, run_reference, assert_same_trajectory

T1, T5 = ["tick", 1], ["tick", 5]


def _mixed(kill: int) -> list:
    return [T1, T1, ["kill", kill]] + [T1, T5, T1, T1, T5, T1, T5, T5, T1, T1, T5, T5, T1, T5]


CASES = [
    {"name": "c16", "n": 16, "params": {"loss": 0.01}, "seed": 0, "checksums": True,
     "ops": _mixed(5)},
    {"name": "c64", "n": 64, "params": {"loss": 0.01}, "seed": 0, "checksums": True,
     "ops": _mixed(40)},
    {"name": "churn16", "n": 16, "params": {"loss": 0.05, "suspicion_ticks": 4}, "seed": 7,
     "checksums": True,
     "ops": [T1, ["kill", 2], T5, T5, ["revive", 2], T1, T1, ["leave", 11], T5, T1,
             ["suspend", 4], T5, ["resume", 4], T5, T1, T5, T5]},
]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("cluster_ref")))


def _ref_checksums(ref, name, t) -> dict[str, int]:
    return dict(zip(ref[f"{name}/ck{t}_addr"].tolist(),
                    (int(v) for v in ref[f"{name}/ck{t}_val"])))


def _groups(sums: dict[str, int]) -> dict[int, list[str]]:
    out: dict[int, list[str]] = {}
    for addr, c in sums.items():
        out.setdefault(c, []).append(addr)
    return out


@pytest.mark.parametrize("name", list(BY_NAME))
def test_checksum_groups_tick_for_tick(reference, name):
    case = BY_NAME[name]
    seen = []

    def on_tick(t, c):
        want = _ref_checksums(reference, name, t)
        host = c.checksums(backend="host")
        assert host == want, (name, t)
        assert c.checksum_groups() == _groups(want), (name, t)
        seen.append(len(_groups(want)))

    recs = run_port(case, on_tick)
    assert_same_trajectory(reference, case, recs)
    assert len(seen) == sum(1 for op in case["ops"] if op[0] == "tick")
    assert sum(op[1] for op in case["ops"] if op[0] == "tick") >= 40
    assert max(seen) > 1  # the kill really split the cluster for a while


@pytest.mark.parametrize("name", ["c16", "churn16"])
def test_device_checksums_equal_host(reference, name):
    """``checksums(backend="device")`` (tensor string assembly + the
    FarmHash wrapper) equals the reference's host checksums."""
    case = BY_NAME[name]

    def on_tick(t, c):
        assert c.checksums(backend="device") == _ref_checksums(reference, name, t), (name, t)

    run_port(case, on_tick)


def test_cluster_surface():
    c = port_cluster({"name": "s", "n": 12, "params": {"suspicion_ticks": 3}, "seed": 1})
    assert c.device.type == "cpu" and c.n == 12
    assert c.converged() and c.live_indices().tolist() == list(range(12))
    c.kill(3)
    c.suspend(4)
    assert 3 not in c.live_indices() and 4 not in c.live_indices()
    c.resume(4)
    assert c.run_until_converged(max_ticks=200, check_every=5) > 0
    for _ in range(100):
        if c.converged() and c.status_counts(0)["faulty"] == 1:
            break
        c.tick()
    members = c.members(0)
    assert [m["address"] for m in members] == sorted(m["address"] for m in members)
    assert {m["status"] for m in members} == {"alive", "faulty"}
    assert c.status_counts(0) == {"alive": 11, "suspect": 0, "faulty": 1, "leave": 0}
    c.partition([[0, 1, 2], [3, 4]])
    assert c.net.adj.dtype == torch.bool and c.net.adj.shape == (12, 12)
    c.heal_partition()
    assert bool(c.net.adj.all())
    c.set_loss(0.2)
    assert c.params.loss == 0.2
    with pytest.raises(ValueError):
        c.checksums(backend="gpu")


def test_unported_backends_raise():
    from ringpop_tpu_torch.models.cluster import SimCluster

    delta = SimCluster(8, backend="delta", capacity=4, device="cpu")  # ported
    delta.enable_delay(3)  # the in-flight lanes are ported too
    assert tuple(delta.state.pend_subj.shape) == (3, 4, 8, 4)
    damped = SimCluster(8, damping=True, device="cpu")  # ported
    assert damped.state.damp.dtype == torch.float16 and damped.damped_pairs() == 0
    with pytest.raises(ValueError):
        SimCluster(8, backend="sparse", device="cpu")


@pytest.mark.parametrize("ticks", [1, 3])
def test_failed_tick_keeps_or_loses_state_explicitly(monkeypatch, ticks):
    """The dense tick hands the cluster's state to the step.  A refusal
    before the step takes it leaves the state in place; a failure after
    it raises that the state is lost, and so does every later tick."""
    from ringpop_tpu_torch.models import swim_sim as tsim

    c = port_cluster({"name": "f", "n": 8, "seed": 1})
    before = c.state
    c.params = tsim.SwimParams(suspicion_ticks=127)  # refused before the take
    with pytest.raises(ValueError):
        c.tick(ticks)
    assert c.state is before
    c.params = tsim.SwimParams()
    calls = []
    real = tsim._phase6_expiry

    def expiry(*args):
        calls.append(1)
        if len(calls) == ticks:
            raise FloatingPointError("failed inside the step")
        return real(*args)

    monkeypatch.setattr(tsim, "_phase6_expiry", expiry)
    with pytest.raises(RuntimeError, match="lost") as info:
        c.tick(ticks)
    assert isinstance(info.value.__cause__, FloatingPointError) and c.state is None
    monkeypatch.setattr(tsim, "_phase6_expiry", real)
    with pytest.raises(RuntimeError, match="lost"):
        c.tick()


def test_inc_and_addresses():
    from ringpop_tpu_torch.models.cluster import DEFAULT_BASE_INC, SimCluster

    addrs = [f"10.0.0.{i}:3000" for i in range(6)]
    c = SimCluster(6, seed=0, addresses=addrs, inc=[DEFAULT_BASE_INC + 5 * i for i in range(6)],
                   device="cpu")
    assert np.diagonal(c.state.view_key.numpy()).tolist() == [8 * 5 * i + 1 for i in range(6)]
    assert list(c.checksums()) == addrs
    with pytest.raises(ValueError):
        SimCluster(6, addresses=addrs[:5], device="cpu")
