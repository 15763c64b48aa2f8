"""The fault model on the port's sharded steps against the reference's.

``parallel.sharded_step`` and ``sharded_delta_step`` run the unsharded
steps inside a gossip ring, so they carry the fault arms unchanged: K =
3 overlapping link rules with extra loss, delay and jitter, a period
row of mixed values, and the in-flight buffer (dense ``pending``, delta
``pend_*`` lanes), at n = 16 over D = 4 shards.  Every state field and
metric after every step must equal the JAX package's sharded step on
its virtual CPU mesh (``run_sharded_references``, one child process a
case) and the port's unsharded step.
"""

from __future__ import annotations

import numpy as np
import torch

from test_torch_harness import (
    CLUSTER_FIELDS,
    DELTA_FIELDS,
    assert_same_field,
    run_sharded_references,
)

import pytest

CPU = torch.device("cpu")
N = 16
_rng = np.random.default_rng(21)
_SRC = _rng.random((3, N)) < 0.5
_DST = _rng.random((3, N)) < 0.5
_SRC[:, :4] = True
_DST[:, 4:12] = True
FAULTS = {
    "rules": {"src": _SRC.tolist(), "dst": _DST.tolist(), "p": [0.3, 0.7, 0.2],
              "d": [1, 0, 2], "j": [1, 2, 0]},
    "depth": 5,
    "period": [1, 2, 3, 1] * 4,
}
CASES = [
    {"name": "dense_faults", "backend": "dense", "entry": "step", "n": N, "d": 4,
     "params": {"loss": 0.1, "suspicion_ticks": 4}, "seed": 6, "ticks": 10, "down": [13],
     "faults": FAULTS},
    {"name": "delta_faults", "backend": "delta", "entry": "step", "n": N, "d": 4,
     "params": {"loss": 0.1, "suspicion_ticks": 4}, "seed": 6, "ticks": 10, "down": [13],
     "caps": {"capacity": 8, "wire_cap": 4, "claim_grid": 8}, "faults": FAULTS},
]
_NET = ("link_src", "link_dst", "link_p", "link_d", "link_j", "period")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_sharded_references(CASES, str(tmp_path_factory.mktemp("faults_sharded")))


def _start(ref: dict, case: dict):
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.models import swim_sim as tsim

    name = case["name"]
    net = tsim.make_net(N, device=CPU)._replace(
        up=torch.as_tensor(ref[f"{name}/up"]),
        responsive=torch.as_tensor(ref[f"{name}/responsive"]),
        **{f: torch.as_tensor(ref[f"{name}/net/{f}"]) for f in _NET},
    )
    swim = tsim.SwimParams(**case["params"])
    if case["backend"] == "delta":
        state = convert.delta_state_from_numpy(
            {f: ref.get(f"{name}/init/{f}") for f in DELTA_FIELDS}, device=CPU)
        caps = case["caps"]
        return state, net, tdelta.DeltaParams(swim=swim, wire_cap=caps["wire_cap"],
                                              claim_grid=caps["claim_grid"])
    state = convert.state_from_numpy(
        {f: ref.get(f"{name}/init/{f}") for f in CLUSTER_FIELDS}, device=CPU)
    return state, net, swim


def _arrays(state, backend: str) -> dict:
    from ringpop_tpu_torch import convert

    if backend == "delta":
        return convert.delta_state_to_numpy(state)
    return convert.state_to_numpy(state)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_sharded_faults_match_reference(reference, case):
    from ringpop_tpu_torch import convert, parallel
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.models import swim_sim as tsim

    name, backend = case["name"], case["backend"]
    state, net, params = _start(reference, case)
    mesh = parallel.make_mesh(devices=[CPU] * case["d"])
    if backend == "delta":
        step = parallel.sharded_delta_step(mesh)
        sh = parallel.shard_delta(state, mesh)
        plain_step, fields = tdelta.delta_step_impl, DELTA_FIELDS
    else:
        step = parallel.sharded_step(mesh)
        sh, net = parallel.shard_cluster(state, net, mesh)
        plain_step, fields = tsim.swim_step_impl, CLUSTER_FIELDS
    plain = state
    delayed = 0
    for t, key in enumerate(reference[f"{name}/keys"]):
        k = convert.key_from_numpy(key)
        sh, m = step(sh, net, k, params)
        plain, m_plain = plain_step(plain, net, k, params)
        got, got_plain = _arrays(sh, backend), _arrays(plain, backend)
        for f in fields:
            assert_same_field(got[f], reference.get(f"{name}/{t}/{f}"), f"{name} {t} {f}")
            assert_same_field(got_plain[f], got[f], f"{name} {t} {f} unsharded")
        want = {k.rsplit("/", 1)[1]: int(v) for k, v in reference.items()
                if k.startswith(f"{name}/m{t}/")}
        assert {k: int(v) for k, v in m.items()} == want == {
            k: int(v) for k, v in m_plain.items()}, t
        delayed += want["delayed_claims"]
    assert delayed > 0
