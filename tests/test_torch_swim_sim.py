"""The port's dense SWIM step equals ``ringpop_tpu``'s ``swim_step_impl``
exactly: every state field and metric, on every tick.

The reference trajectories come from one child process
(``test_torch_harness.run_reference``); the port runs here on the CPU.
Cases: the ``entry()`` shape, kills, suspends, group-id and mask
partitions and heals under 30% loss (so the ping-req stages 5a-5d carry
claims) with a short suspicion timeout (so suspects turn faulty), a
self-mode bootstrap through ``admin_join``, and uniform probing.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_harness import STATE_FIELDS, assert_same_trajectory, run_port, run_reference

from ringpop_tpu_torch import convert, prng
from ringpop_tpu_torch.models import swim_sim as tsim

T1 = ["tick", 1]


def _faults(n: int, a: int, b: int) -> list:
    half = n // 2
    return (
        [T1] * 2 + [["kill", a]] + [T1] * 3 + [["suspend", b]] + [T1] * 2
        + [["partition", [list(range(half)), list(range(half, n))]]] + [T1] * 3
        + [["heal_partition"]] + [T1] * 2
        + [["partition", [[0, 1, 2, 3], [4, 5, 6]]]] + [T1] * 3
        + [["heal_partition"], ["resume", b]] + [T1] * 3
        + [["revive", a]] + [T1] * 4 + [["leave", 9]] + [T1] * 3
    )


CASES = [
    {"name": "entry", "n": 64, "params": {"loss": 0.01}, "seed": 0, "ops": [T1] * 10},
    {"name": "faults16", "n": 16, "params": {"loss": 0.3, "suspicion_ticks": 5},
     "seed": 3, "ops": _faults(16, 3, 5)},
    {"name": "faults130", "n": 130, "params": {"loss": 0.3, "suspicion_ticks": 5},
     "seed": 1, "ops": _faults(130, 7, 50)},
    {"name": "bootstrap16", "n": 16, "params": {"loss": 0.01}, "seed": 2, "init": "self",
     "ops": [["join", i, 0] for i in range(1, 16)] + [T1] * 8},
    {"name": "uniform64", "n": 64, "params": {"loss": 0.05, "probe": "uniform"}, "seed": 4,
     "ops": [T1] * 2 + [["kill", 10]] + [T1] * 10},
]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("swim_ref")))


@pytest.mark.parametrize("name", list(BY_NAME))
def test_trajectory_matches_reference(reference, name):
    case = BY_NAME[name]
    recs = run_port(case)
    assert_same_trajectory(reference, case, recs)


def test_fault_cases_reach_every_stage(reference):
    """The fault cases exercise what they are for: ping-req claims in
    stages 5a-5d, suspect declarations, expiry to faulty, full syncs."""
    for name in ("faults16", "faults130"):
        def total(key):
            return sum(int(v) for k, v in reference.items()
                       if k.startswith(f"{name}/m") and k.endswith("/" + key))

        assert total("pingreq_changes_applied") > 0
        assert total("suspects_declared") > 0
        assert total("faulty_declared") > 0
        assert total("full_syncs") > 0


@pytest.mark.parametrize("name", list(BY_NAME))
def test_single_steps_from_reference_state(reference, name):
    """One port step from each reference state (carried across with
    ``convert``), net and key equals the reference's next state."""
    case = BY_NAME[name]
    params = tsim.SwimParams(**case.get("params", {}))
    for t in range(sum(1 for op in case["ops"] if op[0] == "tick")):
        state = convert.state_from_numpy(
            {f: reference[f"{name}/pre{t}/{f}"] for f in STATE_FIELDS}, device="cpu"
        )
        net = convert.net_from_numpy(
            {
                "up": reference[f"{name}/up{t}"],
                "responsive": reference[f"{name}/responsive{t}"],
                "adj": reference.get(f"{name}/adj{t}"),
            },
            device="cpu",
        )
        _, sub = prng.split(convert.key_from_numpy(reference[f"{name}/key{t}"]))
        got, metrics = tsim.swim_step_impl(state, net, sub, params)
        for f in STATE_FIELDS:
            np.testing.assert_array_equal(
                getattr(got, f).numpy(), reference[f"{name}/{f}"][t + 1],
                err_msg=f"{name} tick {t} {f}",
            )
        for k, v in metrics.items():
            assert int(v) == int(reference[f"{name}/m{t}/{k}"]), (name, t, k)


# ---------------------------------------------------------------------------
# the step's arms and options: ported ones step, the rest raise
# ---------------------------------------------------------------------------


def _small():
    return tsim.init_state(8, device="cpu"), tsim.make_net(8, device="cpu"), prng.PRNGKey(0)


@pytest.mark.parametrize(
    "params",
    [
        tsim.SwimParams(sparse_cap=4),
        tsim.SwimParams(relay_full_sync=True),
        tsim.SwimParams(phase_mod=2),
    ],
    ids=["sparse_cap", "relay_full_sync", "phase_mod"],
)
def test_unported_params_raise(params):
    """These arms are ported: ``sparse_cap`` and ``relay_full_sync`` step
    (on a converged cluster with no change anywhere each equals the
    plain step, metric for metric), and ``phase_mod > 1`` gates probe
    initiation to each node's phase."""
    state, net, key = _small()
    if params.phase_mod > 1:
        _, m = tsim.swim_step_impl(state, net, key, params)
        assert 0 < int(m["pings_sent"]) < 8
        return
    got, m = tsim.swim_step_impl(state, net, key, params)
    want, m0 = tsim.swim_step_impl(state, net, key, tsim.SwimParams())
    assert {k: int(v) for k, v in m.items()} == {k: int(v) for k, v in m0.items()}
    assert torch.equal(got.view_key, want.view_key) and int(m["pings_sent"]) == 8


@pytest.mark.parametrize(
    "field", ["link_src", "link_dst", "link_p", "link_d", "link_j", "period"]
)
def test_unported_net_fields_raise(field):
    """The fault-model fields of the net are ported: a rule table with the
    field (and the rest of its rule) or a period row steps; a period row
    beside ``phase_mod > 1`` raises the reference's ValueError."""
    state, net, key = _small()
    if field == "period":
        net = net._replace(period=torch.full((8,), 2, dtype=torch.int32))
        _, m = tsim.swim_step_impl(state, net, key, tsim.SwimParams())
        assert 0 < int(m["pings_sent"]) < 8
        with pytest.raises(ValueError, match="phase_mod"):
            tsim.swim_step_impl(state, net, key, tsim.SwimParams(phase_mod=2))
        return
    every = torch.ones(1, 8, dtype=torch.bool)
    rules = {"link_src": every, "link_dst": every,
             "link_p": torch.full((1,), 0.9999, dtype=torch.float32)}
    if field in ("link_d", "link_j"):
        rules.update(link_d=torch.ones(1, dtype=torch.int32),
                     link_j=torch.ones(1, dtype=torch.int32))
    _, m = tsim.swim_step_impl(state, net._replace(**rules), key, tsim.SwimParams())
    assert int(m["acks"]) < int(m["pings_sent"])  # the rule drops nearly everything


def test_unported_state_and_options_raise():
    """The knobs (at ``params``' own values: the plain step's result),
    the in-flight buffer (``pending``), the damping planes and ``prov``
    (the plain step's state and metrics plus the evidence bundle) are
    ported; ``prov`` on the sparse step raises the reference's
    NotImplementedError."""
    state, net, key = _small()
    p = tsim.SwimParams()
    _, m = tsim.swim_step_impl(state._replace(pending=torch.zeros(2, 8, 8, dtype=torch.int32)),
                               net, key, p)
    assert int(m["delayed_claims"]) == 0 and int(m["matured_applied"]) == 0
    damped = tsim.init_state(8, damping=True, device="cpu")
    assert damped.damp.dtype == torch.float16 and damped.damped.dtype == torch.bool
    got, m = tsim.swim_step_impl(damped, net, key, p)
    assert int(m["damped_pairs"]) == 0 and not got.damp.any()
    want, wm = tsim.swim_step_impl(state, net, key, p)
    got, gm = tsim.swim_step_impl(state, net, key, p, knobs=tsim.swim_knob_arrays(p))
    assert all(x is None or torch.equal(x, getattr(got, f)) for f, x in want._asdict().items())
    assert {k: int(v) for k, v in wm.items()} == {k: int(v) for k, v in gm.items()}
    from ringpop_tpu_torch.obs.provenance import EVIDENCE_KEYS

    got, gm = tsim.swim_step_impl(state, net, key, p, prov=True)
    assert all(x is None or torch.equal(x, getattr(got, f)) for f, x in want._asdict().items())
    assert set(gm) == set(wm) | set(EVIDENCE_KEYS)
    assert all(torch.equal(wm[k], gm[k]) for k in wm)
    with pytest.raises(NotImplementedError, match="dense delivery evidence"):
        tsim.swim_step_impl(state, net, key, p._replace(sparse_cap=4), prov=True)


def test_block_prefix_size_raises():
    """n > 32768 is no longer refused: the step's guard is gone, and the
    selection takes the block-prefix branch at n = 32 769 (on an
    all-pingable, zero-strided mask each pick is its rank's column)."""
    n = 32769
    big = tsim.ClusterState(
        view_key=torch.zeros(1, 1, dtype=torch.int32).expand(n, n),
        pb=torch.zeros(1, 1, dtype=torch.int8).expand(n, n),
        suspect_left=torch.zeros(1, 1, dtype=torch.int8).expand(n, n),
        tick=torch.zeros((), dtype=torch.int32),
    )
    net = tsim.NetState(up=torch.ones(n, dtype=torch.bool), responsive=torch.ones(n, dtype=torch.bool))
    tsim._check_supported(big, net, tsim.SwimParams(), None, False)
    pingable = torch.ones(1, 1, dtype=torch.bool).expand(n, n)
    key = prng.PRNGKey(0)
    target, valid, wit, wit_valid = tsim._choose_targets_and_witnesses(pingable, 3, key)
    ranks, _ = tsim._distinct_ranks(torch.full((n,), n, dtype=torch.int32), 4, key)
    assert valid.all() and wit_valid.all()
    np.testing.assert_array_equal(target.numpy(), ranks[:, 0].numpy())
    np.testing.assert_array_equal(wit.numpy(), ranks[:, 1:].numpy())


def test_unknown_probe_raises():
    state, net, key = _small()
    with pytest.raises(ValueError):
        tsim.swim_step_impl(state, net, key, tsim.SwimParams(probe="zigzag"))


# ---------------------------------------------------------------------------
# torch pitfalls the port depends on
# ---------------------------------------------------------------------------


def test_int16_prefix_and_argmax_of_false_row():
    ping = torch.tensor([[False, True, True], [False, False, False]])
    csum = torch.cumsum(ping.to(torch.int16), dim=1, dtype=torch.int16)
    assert csum.dtype == torch.int16
    hit = ping & (csum == torch.tensor([2, 1], dtype=torch.int16)[:, None])
    assert torch.argmax(hit.to(torch.uint8), dim=1).tolist() == [2, 0]


def test_int8_piggyback_wraps_like_the_reference():
    pb = torch.tensor([120, -1, 5], dtype=torch.int8)
    ns8 = torch.tensor([100, 3, 1], dtype=torch.int8)
    out = pb + ns8
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(), (np.array([120, -1, 5], np.int8)
                                                + np.array([100, 3, 1], np.int8)))


def test_view_hash_matches_uint32_arithmetic():
    rng = np.random.default_rng(0)
    vk = rng.integers(0, 2**31 - 1, (7, 7)).astype(np.int32)
    vk[rng.random((7, 7)) < 0.3] = 0
    k = vk.astype(np.uint32)
    h = (k * np.uint32(0x85EBCA6B)) ^ (k >> np.uint32(7))
    h = (h ^ (h >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    idx = np.arange(7, dtype=np.uint32) * np.uint32(0x27D4EB2F)
    h = np.where(vk > 0, h ^ idx, np.uint32(0))
    want = h.sum(axis=1, dtype=np.uint32)
    got = tsim._view_hash(torch.as_tensor(vk)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_rank_draw_is_float32():
    """``(u * space).astype(int32)`` multiplies in float32 (the port casts
    ``space`` to float32); the draws are distinct, in range, and equal a
    numpy float32 replay of the same arithmetic."""
    count = np.array([3, 7, 1000, 30000], dtype=np.int32)
    key = prng.PRNGKey(9)
    ranks, valid = tsim._distinct_ranks(torch.as_tensor(count), 4, key)
    assert ranks.dtype == torch.int32
    u = prng.uniform(key, (4, 4)).numpy()
    taken = []
    for t in range(4):
        space = np.maximum(count - t, 1)
        r = np.minimum((u[:, t] * space.astype(np.float32)).astype(np.int32), space - 1)
        for prev in np.sort(np.stack(taken, 1), axis=1).T if taken else []:
            r = r + (r >= prev).astype(np.int32)
        taken.append(r)
        np.testing.assert_array_equal(ranks[:, t].numpy(), r)
        np.testing.assert_array_equal(valid[:, t].numpy(), count > t)
    for row, c in zip(ranks.tolist(), count.tolist()):
        k = min(4, c)
        assert len(set(row[:k])) == k and max(row[:k]) < c
