"""The port's delta backend against the JAX reference's, tick for tick.

Each case drives ``SimCluster(backend="delta")`` on both sides through
the same ops; every ``DeltaState`` field and every metric must be equal
after every tick op.  The reference runs in child processes (see
``test_torch_harness``) under both lowerings of its kernel sites: the
XLA defaults and the Pallas kernels in interpret mode, which the port's
CUDA kernels replace.  The port has one lowering, so it must equal both.

Besides the ``SimCluster`` trajectories, ``delta_step_impl`` is stepped
on its own from each reference pre-tick state (carried over by
``convert.delta_state_from_numpy``), and the membership checksums and
their groups are held against the reference's tick for tick at n = 64.

This file holds the lossy cases at n = 16 and 64 (1% loss, a kill);
``test_torch_delta_churn.py`` the fault-injection, maintenance and
production-cap cases, ``test_torch_delta_netsplit.py`` the partition
and bootstrap cases, ``test_torch_delta_sided*.py`` sided mode; each
file's reference run stays under a minute on the CPU.  The arms are
checked here too: the unported ones raise ``NotImplementedError``.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from test_torch_harness import (
    DELTA_LOWERINGS,
    REPO,
    assert_same_trajectory,
    assert_steps_from_reference,
    port_cluster,
    run_port,
    run_references,
)

T1, T5 = ["tick", 1], ["tick", 5]

CASES = [
    {"name": "d16", "n": 16, "backend": "delta", "params": {"loss": 0.01}, "seed": 0,
     "caps": {"capacity": 16, "wire_cap": 8, "claim_grid": 16},
     "ops": [T1, T1, ["kill", 5]] + [T1] * 9 + [T5]},
    {"name": "d64", "n": 64, "backend": "delta", "params": {"loss": 0.01}, "seed": 0,
     "caps": {"capacity": 32, "wire_cap": 8, "claim_grid": 16}, "checksums": True,
     "ops": [T1, T1, ["kill", 40]] + [T1] * 10},
]
BY_NAME = {c["name"]: c for c in CASES}
PAIRS = [(lw, c["name"]) for lw in DELTA_LOWERINGS for c in CASES]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_references(CASES, str(tmp_path_factory.mktemp("delta_ref")), DELTA_LOWERINGS)


@pytest.fixture(scope="module")
def port_runs():
    return {c["name"]: run_port(c) for c in CASES}


@pytest.mark.parametrize("lowering,name", PAIRS)
def test_cluster_trajectory(reference, port_runs, lowering, name):
    """Every DeltaState field and metric after every tick op."""
    assert_same_trajectory(reference[lowering], BY_NAME[name], port_runs[name])


@pytest.mark.parametrize("lowering,name", PAIRS)
def test_step_from_reference_states(reference, lowering, name):
    """``delta_step_impl`` alone, from the reference's state before each
    one-tick op, with the reference's key and net."""
    assert assert_steps_from_reference(reference[lowering], BY_NAME[name]) >= 10


def _ref_checksums(ref, name, t) -> dict[str, int]:
    return dict(zip(ref[f"{name}/ck{t}_addr"].tolist(),
                    (int(v) for v in ref[f"{name}/ck{t}_val"])))


def _groups(sums: dict[str, int]) -> dict[int, list[str]]:
    out: dict[int, list[str]] = {}
    for addr, c in sums.items():
        out.setdefault(c, []).append(addr)
    return out


def test_checksum_groups_tick_for_tick(reference):
    """Host and device checksums (rows materialized from the delta
    tables) and their groups equal the reference's after every tick."""
    ref = reference["default"]
    seen = []

    def on_tick(t, c):
        want = _ref_checksums(ref, "d64", t)
        assert c.checksums(backend="host") == want, t
        assert c.checksums(backend="device") == want, t
        assert c.checksum_groups() == _groups(want), t
        seen.append(len(_groups(want)))

    run_port(BY_NAME["d64"], on_tick)
    assert len(seen) == 12 and max(seen) > 1  # the kill split the cluster


def test_cases_exercise_their_paths(port_runs):
    """At 1% loss gossip applies changes, the kill is suspected and the
    last op runs five ticks through ``delta_run_impl``."""
    for name in ("d16", "d64"):
        ms = [r["metrics"] for r in port_runs[name]]
        assert sum(m["suspects_declared"] for m in ms) > 0, name
        assert sum(m["ping_changes_applied"] for m in ms) > 0, name
    assert port_runs["d16"][-1]["metrics"]["ticks"] == 5


# ---------------------------------------------------------------------------
# the arms this port does not carry raise; the reference's own refusals stay
# ---------------------------------------------------------------------------


def _small():
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.models import swim_sim as tsim
    from ringpop_tpu_torch import prng

    n = 8
    state = tdelta.init_delta(n, capacity=4, device="cpu")
    net = tsim.make_net(n, device="cpu")
    return tdelta, tsim, state, net, prng.PRNGKey(0), tdelta.DeltaParams()


def test_step_runs_on_small_state():
    tdelta, _, state, net, key, params = _small()
    st, m = tdelta.delta_step_impl(state, net, key, params)
    assert int(st.tick) == 1 and int(m["pings_sent"]) == 8


@pytest.mark.parametrize("arm", [
    "pend", "link_d", "knobs", "prov", "upto", "slot_base", "period", "phase_mod",
])
def test_unported_arms_raise(arm):
    """Every arm is ported: the knobs (at ``params``' own values: the
    plain step's result), ``prov`` (the plain step's state, its metrics
    plus the evidence bundle; with a truncated step the reference's
    ValueError), the in-flight lanes, a period row, ``phase_mod``, a
    truncated step (``upto``: partial metrics) and the carried slot-base
    planes step; a delay rule without lanes raises the reference's
    ValueError, and so do planes carried one without the other."""
    tdelta, tsim, state, net, key, params = _small()
    kwargs = {}
    n = state.n
    runs = False
    if arm == "pend":
        state = tdelta.install_pending(state, 2, params.wire_cap)
        runs = True
    elif arm == "link_d":
        net = net._replace(link_d=torch.zeros(1, dtype=torch.int32))
        with pytest.raises(ValueError, match="in-flight claim lanes"):
            tdelta.delta_step_impl(state, net, key, params)
        return
    elif arm == "knobs":
        kwargs["knobs"] = tsim.swim_knob_arrays(params.swim)
        want = tdelta.delta_step_impl(state, net, key, params)[0]
        got = tdelta.delta_step_impl(state, net, key, params, **kwargs)[0]
        assert all(x is None or torch.equal(x, getattr(got, f))
                   for f, x in want._asdict().items())
        runs = True
    elif arm == "prov":
        from ringpop_tpu_torch.obs.provenance import EVIDENCE_KEYS

        want, wm = tdelta.delta_step_impl(state, net, key, params)
        got, gm = tdelta.delta_step_impl(state, net, key, params, prov=True)
        assert all(x is None or torch.equal(x, getattr(got, f))
                   for f, x in want._asdict().items())
        assert set(gm) == set(wm) | set(EVIDENCE_KEYS)
        assert all(torch.equal(wm[k], gm[k]) for k in wm)
        with pytest.raises(ValueError, match="upto=7"):
            tdelta.delta_step_impl(state, net, key, params, upto=5, prov=True)
        return
    elif arm == "upto":
        _, m = tdelta.delta_step_impl(state, net, key, params, upto=3)
        assert set(m) == {"pings_sent", "_t"} and int(m["pings_sent"]) == 0
        return
    elif arm == "slot_base":
        bpm, bpr = tdelta.compute_slot_base(state)
        with pytest.raises(ValueError, match="together"):
            tdelta.delta_step_impl(state._replace(d_bprank=bpr), net, key, params)
        state = state._replace(d_bpmask=tdelta.bitpack.pack_bits(bpm), d_bprank=bpr)
        runs = True
    elif arm == "period":
        net = net._replace(period=torch.full((n,), 2, dtype=torch.int32))
        runs = True
    elif arm == "phase_mod":
        params = params._replace(swim=params.swim._replace(phase_mod=2))
        runs = True
    if runs:
        _, m = tdelta.delta_step_impl(state, net, key, params, **kwargs)
        assert 0 < int(m["pings_sent"]) <= n
        return
    with pytest.raises(NotImplementedError):
        tdelta.delta_step_impl(state, net, key, params, **kwargs)


def test_unported_arms_raise_outside_the_step():
    """``refresh_carried`` keeps planes a state carries (recomputing
    them) and drops them from none; partial groupings still need the
    dense mask."""
    from ringpop_tpu_torch.models.cluster import SimCluster

    tdelta, _, state, _, _, _ = _small()
    carried = state._replace(d_bpmask=torch.zeros((state.n, 1), dtype=torch.int64),
                             d_bprank=torch.zeros((state.n, 4), dtype=torch.int32))
    fresh = tdelta.refresh_carried(carried)
    bpm, bpr = tdelta.compute_slot_base(state)
    assert torch.equal(fresh.d_bpmask, tdelta.bitpack.pack_bits(bpm))
    assert torch.equal(fresh.d_bprank, bpr)
    c = SimCluster(8, backend="delta", capacity=4, device="cpu")
    c.enable_delay(3)  # the in-flight lanes are ported
    assert c.state.delay_depth == 3
    with pytest.raises(NotImplementedError):  # partial groupings need the dense mask
        c.partition([[0, 1], [2, 3]])


def test_reference_refusals_kept():
    tdelta, tsim, state, net, key, params = _small()
    with pytest.raises(NotImplementedError):  # bool[N, N] adjacency is dense-only
        tdelta.delta_step_impl(
            state, net._replace(adj=torch.ones((8, 8), dtype=torch.bool)), key, params
        )
    with pytest.raises(ValueError):
        tdelta.delta_step_impl(state._replace(digest=None), net, key, params)
    with pytest.raises(ValueError):
        tdelta.delta_step_impl(
            state, net, key, params._replace(swim=params.swim._replace(sparse_cap=4))
        )
    with pytest.raises(ValueError):
        tdelta.delta_step_impl(
            state, net, key, params._replace(swim=params.swim._replace(relay_full_sync=True))
        )
    with pytest.raises(ValueError):
        port_cluster({"name": "x", "n": 8, "backend": "delta",
                      "params": {"sparse_cap": 4}, "caps": {"capacity": 4}})


def test_port_reads_no_ringpop_environment():
    """The port has one lowering per kernel site: the ``RINGPOP_*``
    variables its source reads are the reference's own state-build switch
    ``RINGPOP_CARRY_SLOTBASE``, in ``swim_delta.refresh_carried`` only,
    and the dispatch ledger's switch ``RINGPOP_LEDGER`` (``obs/``: read
    by ``DispatchLedger._maybe_enable_from_env`` only)."""
    import re

    root = os.path.join(REPO, "ringpop_tpu_torch")
    hits = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cu")):
                with open(os.path.join(dirpath, f)) as fh:
                    for name in re.findall(r"RINGPOP_\w+", fh.read()):
                        hits.append((os.path.relpath(os.path.join(dirpath, f), root), name))
    assert set(hits) == {
        (os.path.join("models", "swim_delta.py"), "RINGPOP_CARRY_SLOTBASE"),
        (os.path.join("obs", "ledger.py"), "RINGPOP_LEDGER"),
        (os.path.join("obs", "__init__.py"), "RINGPOP_LEDGER"),
    }, hits
    import inspect

    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.obs import ledger

    src = inspect.getsource(tdelta)
    body = inspect.getsource(tdelta.refresh_carried)
    assert src.count('os.environ.get("RINGPOP_CARRY_SLOTBASE"') == 1
    assert 'os.environ.get("RINGPOP_CARRY_SLOTBASE"' in body
    assert ledger.ENV_VAR == "RINGPOP_LEDGER"
    lsrc = inspect.getsource(ledger)
    assert lsrc.count("os.environ") == 2  # .get and [] in one method
    assert "os.environ" in inspect.getsource(ledger.DispatchLedger._maybe_enable_from_env)


def test_sparsify_inverts_densify():
    """A stepped delta state densifies and sparsifies back to the same
    view, pb and countdown planes, with the digest refreshed."""
    from ringpop_tpu_torch import prng
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.models import swim_sim as tsim

    n = 16
    params = tdelta.DeltaParams(swim=tsim.SwimParams(loss=0.2), wire_cap=8, claim_grid=16)
    state = tdelta.init_delta(n, capacity=n, device="cpu")
    net = tsim.make_net(n, device="cpu")
    net = net._replace(up=torch.arange(n) != 3)
    state, _ = tdelta.delta_run_impl(state, net, prng.PRNGKey(3), params, 8)
    dense = tdelta.densify(state)
    back = tdelta.sparsify(dense, state.base_key, capacity=n)
    again = tdelta.densify(back)
    for f in ("view_key", "pb", "suspect_left", "tick"):
        assert torch.equal(getattr(again, f), getattr(dense, f)), f
    assert torch.equal(back.digest, tdelta.compute_digest(state))
    assert (dense.pb >= 0).any()  # records were in flight
    with pytest.raises(ValueError):
        tdelta.sparsify(dense, torch.zeros(n, dtype=torch.int32), capacity=2)


def test_convert_delta_round_trip():
    from ringpop_tpu_torch import convert

    tdelta, _, state, _, _, _ = _small()
    out = convert.delta_state_to_numpy(state)
    assert out["bp_mask"].dtype == np.uint32 and out["digest"].dtype == np.uint32
    assert out["side"] is None and out["d_bpmask"] is None
    # full 32-bit words survive both ways
    out["digest"][:] = np.array([0xFFFFFFFF, 0x80000000, 1, 0, 7, 9, 11, 13], np.uint32)
    back = convert.delta_state_from_numpy(out, device="cpu")
    assert back.digest.dtype == torch.int64 and int(back.digest[0]) == 0xFFFFFFFF
    again = convert.delta_state_to_numpy(back)
    for k, v in out.items():
        if v is None:
            assert again[k] is None
        else:
            assert again[k].dtype == v.dtype
            np.testing.assert_array_equal(again[k], v)
