"""The port's sparse dissemination step (``SwimParams.sparse_cap``) equals
``ringpop_tpu``'s exactly: every state field and metric, on every tick.

The four contracts of the reference's ``tests/test_sparse_step.py``, each
held against the reference's own trajectory: bit-identical to the dense
step under 5% loss and through a kill (no row past the cap), the
overflow regime of a self-mode bootstrap (cap 4) still converging, and
the dense-reply fallback repairing a stale view by a full sync.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_harness import (
    assert_same_trajectory,
    run_port,
    run_reference,
    run_reference_script,
)

from ringpop_tpu_torch import prng
from ringpop_tpu_torch.models import swim_sim as tsim

T1 = ["tick", 1]

CASES = [
    {"name": "loss24", "n": 24, "params": {"loss": 0.05, "sparse_cap": 24}, "seed": 42,
     "ops": [T1] * 30},
    {"name": "kill16", "n": 16, "params": {"suspicion_ticks": 5, "sparse_cap": 16}, "seed": 42,
     "ops": [["kill", 3]] + [T1] * 30},
    {"name": "overflow32", "n": 32, "params": {"sparse_cap": 4}, "seed": 0, "init": "self",
     "ops": [["join", j, 0] for j in range(1, 32)] + [T1] * 40 + [["tick", 160]]},
]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("sparse_ref")))


@pytest.mark.parametrize("name", list(BY_NAME))
def test_sparse_trajectory_matches_reference(reference, name):
    case = BY_NAME[name]
    assert_same_trajectory(reference, case, run_port(case))


@pytest.mark.parametrize("name", ["loss24", "kill16"])
def test_sparse_equals_dense_within_cap(name):
    """The contract itself, on the port: with no row past the cap the
    sparse step is the dense step, field by field, tick by tick."""
    case = BY_NAME[name]
    dense = dict(case, params={k: v for k, v in case["params"].items() if k != "sparse_cap"})
    for t, (a, b) in enumerate(zip(run_port(case), run_port(dense))):
        for f in ("view_key", "pb", "suspect_left"):
            np.testing.assert_array_equal(a[f], b[f], err_msg=f"{name} {f} tick {t}")
        assert {k: v for k, v in a["metrics"].items() if k != "ticks"} == {
            k: v for k, v in b["metrics"].items() if k != "ticks"
        }


def test_overflow_converges(reference):
    """cap 4 against a 31-join burst: messages truncate, the views still
    converge to all-alive (on both sides, the same final state)."""
    vk = reference["overflow32/view_key"][-1]
    assert (vk == vk[0]).all() and ((vk[0] & 7) == tsim.ALIVE).all()


_FULL_SYNC = r"""
import jax, jax.numpy as jnp
from ringpop_tpu.models import swim_sim as sim
n = 8
params = sim.SwimParams(loss=0.0, sparse_cap=8)
state = sim.init_state(n, jnp.zeros((n,), jnp.int32).at[5].set(50))
state = state._replace(view_key=state.view_key.at[1, 5].set(sim.ALIVE))
net = sim.make_net(n)
key = jax.random.PRNGKey(1)
out = {"view_key": [], "pb": [], "suspect_left": [], "metrics": []}
for _ in range(12):
    key, sub = jax.random.split(key)
    state, m = sim.swim_step_impl(state, net, sub, params)
    for f in ("view_key", "pb", "suspect_left"):
        out[f].append(np.asarray(getattr(state, f)).tolist())
    out["metrics"].append({k: int(v) for k, v in m.items()})
json.dump(out, open(sys.argv[1], "w"))
"""


def test_full_sync_dense_fallback(tmp_path):
    """Node 1 holds a stale view of node 5 and nothing is piggybacked:
    only a full sync can repair it, so the sparse step takes the dense
    reply; the port equals the reference tick for tick."""
    want = run_reference_script(_FULL_SYNC, str(tmp_path))
    n = 8
    inc = torch.zeros(n, dtype=torch.int32)
    inc[5] = 50
    state = tsim.init_state(n, inc, device="cpu")
    vk = state.view_key.clone()
    vk[1, 5] = tsim.ALIVE
    state = state._replace(view_key=vk)
    net = tsim.make_net(n, device="cpu")
    params = tsim.SwimParams(loss=0.0, sparse_cap=8)
    key = prng.PRNGKey(1)
    for t in range(12):
        key, sub = prng.split(key)
        state, m = tsim.swim_step_impl(state, net, sub, params)
        for f in ("view_key", "pb", "suspect_left"):
            np.testing.assert_array_equal(
                getattr(state, f).numpy(), np.array(want[f][t]), err_msg=f"{f} tick {t}"
            )
        assert {k: int(v) for k, v in m.items()} == want["metrics"][t], t
    assert sum(m["full_syncs"] for m in want["metrics"]) > 0
    assert int(state.view_key[1, 5]) == 50 * 8 + tsim.ALIVE


def test_sparse_refusals():
    """The reference's own refusals of the sparse program: traced knobs
    (ValueError), the in-flight buffer, ``prov`` and damping planes."""
    n = 8
    state, net, key = tsim.init_state(n, device="cpu"), tsim.make_net(n, device="cpu"), prng.PRNGKey(0)
    p = tsim.SwimParams(sparse_cap=4)
    with pytest.raises(ValueError, match="knob"):
        tsim.swim_step_impl(state, net, key, p, knobs=object())
    with pytest.raises(NotImplementedError, match="latency"):
        tsim.swim_step_impl(
            state._replace(pending=torch.zeros(2, n, n, dtype=torch.int32)), net, key, p
        )
    with pytest.raises(NotImplementedError, match="provenance"):
        tsim.swim_step_impl(state, net, key, p, prov=True)
    with pytest.raises(NotImplementedError, match="damping"):
        tsim.swim_step_impl(tsim.init_state(n, damping=True, device="cpu"), net, key, p)
