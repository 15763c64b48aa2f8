"""The delta step truncated after each phase (``upto`` = 0..6, the
profiling prefixes) equals ``ringpop_tpu``'s: the state there and the
partial metrics (``pings_sent`` 0 and the ``_t`` digest), from one state
and key in the middle of a kill's detection, with changes in flight.
``upto`` = 6 and 7 are the full step; ``sharded_delta_step`` passes
``upto`` through unchanged.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_harness import flatten_outputs, run_reference_calls

from ringpop_tpu_torch import convert, parallel
from ringpop_tpu_torch.models import swim_delta as tdelta
from ringpop_tpu_torch.models import swim_sim as tsim

N = 32
SWIM = {"loss": 0.2, "suspicion_ticks": 5}
CAPS = {"wire_cap": 4, "claim_grid": 8}
UPTO = list(range(8))


def _start():
    from ringpop_tpu_torch.models.cluster import SimCluster

    c = SimCluster(N, tsim.SwimParams(**SWIM), seed=6, backend="delta", capacity=16,
                   device="cpu", **CAPS)
    c.tick(2)
    c.kill(5)
    c.tick(4)
    return c


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    c = _start()
    st = convert.delta_state_to_numpy(c.state)
    assert (st["d_pb"] >= 0).any()  # changes in flight
    key = convert.key_to_numpy(c.key)
    arrays = {f"s_{k}": v for k, v in st.items() if v is not None}
    arrays.update(up=c.net.up.numpy(), responsive=c.net.responsive.numpy(), key=key)
    calls = [
        {"name": f"u{u}", "module": "swim_delta", "fn": "delta_step_impl",
         "args": [["delta_state", {k: f"s_{k}" for k, v in st.items() if v is not None}],
                  ["net", {"up": "up", "responsive": "responsive"}], ["array", "key"],
                  ["delta_params", {"swim": SWIM, **CAPS}]],
         "kwargs": {"upto": u}}
        for u in UPTO
    ]
    want = run_reference_calls(calls, arrays, str(tmp_path_factory.mktemp("upto")))
    return st, key, c.net, want


def _port_step(st, key, net, upto, step=tdelta.delta_step_impl):
    params = tdelta.DeltaParams(swim=tsim.SwimParams(**SWIM), **CAPS)
    state = convert.delta_state_from_numpy(st, device="cpu")
    out, m = step(state, net, convert.key_from_numpy(key), params, upto)
    return flatten_outputs((convert.delta_state_to_numpy(out), m), "x", {})


@pytest.mark.parametrize("upto", UPTO)
def test_truncated_step_matches_reference(case, upto):
    st, key, net, want = case
    got = _port_step(st, key, net, upto)
    ref = {k.split("/", 1)[1]: v for k, v in want.items() if k.startswith(f"u{upto}/")}
    got = {k.split("/", 1)[1]: v for k, v in got.items()}
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=f"upto={upto} {k}")
        assert got[k].dtype == v.dtype, (upto, k)
    if upto < 6:  # the last truncation point is after phase 5
        assert set(k for k in ref if k.startswith("1/")) == {"1/pings_sent", "1/_t"}


def test_prefixes_differ(case):
    """Each phase does work here: consecutive prefixes leave different
    states or digests (the phases the profile attributes time to)."""
    st, key, net, want = case
    sig = []
    for u in UPTO[:-2]:
        sig.append(tuple(np.asarray(want[f"u{u}/1/_t"]).ravel().tolist())
                   + tuple(want[f"u{u}/0/d_pb"].ravel().tolist()))
    assert len(set(sig)) >= 4


@pytest.mark.parametrize("upto", [0, 3, 6])
def test_sharded_step_passes_upto(case, upto):
    """``sharded_delta_step(..., upto)`` over four shards on the CPU
    equals the unsharded truncated step."""
    st, key, net, _ = case
    mesh = parallel.make_mesh(devices=[torch.device("cpu")] * 4)
    step = parallel.sharded_delta_step(mesh)
    got = _port_step(st, key, net, upto, step=step)
    want = _port_step(st, key, net, upto)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
