"""Flap damping and the relay's full rows on the port's sharded dense
step against the reference's.

Both arms cross shards only through the ring seams (``_row_update`` in
its max form for the declared flaps, ``_gather_rows`` and the receiver
merge for the relay's full rows), so ``parallel.sharded_step`` carries
them unchanged: at n = 16 over D = 4 shards every state field (the
``damp``/``damped`` planes included) and metric after every step equals
the JAX package's sharded step on its virtual CPU mesh and the port's
unsharded step.  The sparse step is not ported to the ring and says so.
"""

from __future__ import annotations

import pytest
import torch

from test_torch_harness import CLUSTER_FIELDS, assert_same_field, run_sharded_references

CPU = torch.device("cpu")
N = 16
DAMP = {"damp_penalty": 1000.0, "damp_suppress": 2000.0, "damp_reuse": 400.0,
        "damp_decay_per_tick": 0.98}
CASES = [
    {"name": "damping", "backend": "dense", "entry": "step", "n": N, "d": 4,
     "params": {"loss": 0.3, "suspicion_ticks": 3, **DAMP}, "seed": 8, "ticks": 12,
     "down": [5, 13], "damping": True},
    {"name": "relay", "backend": "dense", "entry": "step", "n": N, "d": 4,
     "params": {"loss": 0.3, "suspicion_ticks": 4, "relay_full_sync": True}, "seed": 8,
     "ticks": 12, "down": [13]},
]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_sharded_references(CASES, str(tmp_path_factory.mktemp("arms_sharded")))


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_sharded_arm_matches_reference(reference, case):
    from ringpop_tpu_torch import convert, parallel
    from ringpop_tpu_torch.models import swim_sim as tsim

    name = case["name"]
    state = convert.state_from_numpy(
        {f: reference.get(f"{name}/init/{f}") for f in CLUSTER_FIELDS}, device=CPU)
    net = tsim.make_net(N, device=CPU)._replace(
        up=torch.as_tensor(reference[f"{name}/up"]),
        responsive=torch.as_tensor(reference[f"{name}/responsive"]))
    params = tsim.SwimParams(**case["params"])
    mesh = parallel.make_mesh(devices=[CPU] * case["d"])
    step = parallel.sharded_step(mesh)
    sh, net = parallel.shard_cluster(state, net, mesh)
    plain = state
    totals = {"damped_pairs": 0, "relay_full_syncs": 0, "pingreq_changes_applied": 0}
    for t, key in enumerate(reference[f"{name}/keys"]):
        k = convert.key_from_numpy(key)
        sh, m = step(sh, net, k, params)
        plain, m_plain = tsim.swim_step_impl(plain, net, k, params)
        got, got_plain = convert.state_to_numpy(sh), convert.state_to_numpy(plain)
        for f in CLUSTER_FIELDS:
            assert_same_field(got[f], reference.get(f"{name}/{t}/{f}"), f"{name} {t} {f}")
            assert_same_field(got_plain[f], got[f], f"{name} {t} {f} unsharded")
        want = {k.rsplit("/", 1)[1]: int(v) for k, v in reference.items()
                if k.startswith(f"{name}/m{t}/")}
        assert {k: int(v) for k, v in m.items()} == want == {
            k: int(v) for k, v in m_plain.items()}, t
        for k in totals:
            totals[k] += want[k]
    if name == "damping":
        assert got["damp"].any() and totals["damped_pairs"] > 0
    else:
        assert totals["relay_full_syncs"] > 0


def test_sharded_sparse_raises():
    from ringpop_tpu_torch import parallel, prng
    from ringpop_tpu_torch.models import swim_sim as tsim

    mesh = parallel.make_mesh(devices=[CPU] * 4)
    state, net = tsim.init_state(N, device=CPU), tsim.make_net(N, device=CPU)
    with pytest.raises(NotImplementedError, match="sharded sparse step is not ported"):
        parallel.sharded_step(mesh)(state, net, prng.PRNGKey(0), tsim.SwimParams(sparse_cap=4))
