"""The port's ring primitives and sharded dense step against the reference.

Mirrors ``tests/test_gossip_remote_copy.py`` and the dense half of
``tests/test_parallel.py`` for ``ringpop_tpu_torch/ops/gossip_remote_copy.py``
and ``ringpop_tpu_torch/parallel/mesh.py``:

- the hop schedule and ``block_origin`` invariants, and the plain hop
  (a block rotation);
- each primitive on seeded numpy inputs, exactly, against the JAX
  primitive on a virtual CPU mesh of the same ring size (its ``ppermute``
  hop) and against the plain gather or scatter;
- the sharded dense step and run against the JAX package's sharded
  entry points (every field and metric on every tick) and against the
  port's unsharded step.

The JAX side runs in child processes (``run_reference_calls`` with a
ring context, ``run_sharded_references``): the jax 0.9 patches never
load here.  On the CPU the port's hop is the plain version; the hop
kernel runs only on a card (``chip_smoke.py`` holds it against the
plain version there).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_harness import (
    STATE_FIELDS,
    flatten_outputs,
    run_reference_calls,
    run_sharded_references,
)

CPU = torch.device("cpu")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hop kernel has no CPU mode)")


def _mesh(d: int):
    from ringpop_tpu_torch import parallel

    return parallel.make_mesh(devices=[CPU] * d)


# ---------------------------------------------------------------------------
# hop schedule and the plain hop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [2, 3, 4, 8])
def test_hop_schedule_pairing_and_coverage(d):
    """Per hop every shard sends once and receives once, and over the
    D-1-hop schedule every shard has held every block."""
    from ringpop_tpu_torch.ops import gossip_remote_copy as grc

    sched = grc.hop_schedule(d)
    assert len(sched) == d - 1
    for perm in sched:
        assert sorted(s for s, _ in perm) == list(range(d))
        assert sorted(r for _, r in perm) == list(range(d))
    held = list(range(d))
    for h, perm in enumerate(sched, start=1):
        held = [held[dict((r, s) for s, r in perm)[me]] for me in range(d)]
        for me in range(d):
            assert held[me] == grc.block_origin(me, h, d)
    assert {grc.block_origin(0, h, d) for h in range(d)} == set(range(d))


@pytest.mark.parametrize(
    "shape,dtype",
    [((2, 5, 7), torch.int32), ((3, 1000, 17), torch.int8), ((8, 64, 3), torch.int64),
     ((4, 7, 9), torch.bool), ((4, 12), torch.int32)],
)
def test_plain_hop_is_a_block_rotation(shape, dtype):
    from ringpop_tpu_torch.ops import gossip_remote_copy as grc

    g = torch.Generator().manual_seed(shape[0])
    x = torch.randint(0, 100, shape, generator=g).to(dtype)
    want = torch.roll(x, 1, dims=0)
    got = grc.hop(x)
    assert torch.equal(grc.hop_plain(x), want) and torch.equal(got, want)
    assert got.data_ptr() != x.data_ptr()  # a fresh stack, never the input


def test_hop_kernel_on_card():
    _need_card()
    from ringpop_tpu_torch.ops import gossip_remote_copy as grc

    for shape, dtype in [((2, 5, 7), torch.int32), ((4, 7, 9), torch.bool),
                         ((4, 2500, 100), torch.int32)]:
        x = torch.randint(0, 100, shape, device="cuda").to(dtype)
        got = grc.hop(x)
        torch.cuda.synchronize()
        assert torch.equal(got, grc.hop_plain(x))


def test_ring_context_required_and_divisibility():
    from ringpop_tpu_torch.ops import gossip_remote_copy as grc

    with pytest.raises(RuntimeError, match="ring_mesh"):
        grc.ring_fetch_rows(torch.zeros((8, 4)), torch.arange(8))
    with grc.ring_mesh(_mesh(4)):
        assert grc.ring_devices() == 4
        with pytest.raises(ValueError, match="not divisible"):
            grc.ring_fetch_rows(torch.zeros((6, 4)), torch.arange(6))
        with pytest.raises(ValueError, match="not divisible"):
            grc.ring_recv_merge(torch.zeros(6, dtype=torch.int64), torch.ones(6, dtype=torch.bool),
                                torch.zeros((6, 6), dtype=torch.int32))
    assert grc.active_ring() is None and grc.ring_devices() == 0


# ---------------------------------------------------------------------------
# the primitives against the JAX primitives (one child process)
# ---------------------------------------------------------------------------

FETCH = [(2, 48), (4, 48), (8, 64)]
GLOBAL = [2, 4]
MERGE = [2, 4, 8]
PER_ROW_D = 4


def _build():
    """Reference calls, their numpy inputs, and the port's twins."""
    from ringpop_tpu_torch.ops import gossip_remote_copy as grc

    calls, arrays, port = [], {}, {}

    def put(key, value):
        arrays[key] = value
        return ["array", key]

    def call(name, fn, args, d, twin, kwargs=None):
        calls.append({"name": name, "module": "gossip_remote_copy", "fn": fn, "args": args,
                      "ring": d, **({"kwargs": kwargs} if kwargs else {})})
        port[name] = (d, twin)

    def t(key):
        return torch.as_tensor(arrays[key])

    for d, n in FETCH:
        rng = np.random.default_rng(d * 100 + n)
        tag = f"fetch_d{d}_n{n}"
        plane = put(f"{tag}/plane", rng.integers(0, 1 << 20, (n, 7), dtype=np.int32))
        for k, shape in (("1", (n,)), ("2", (n, 3))):
            idx = put(f"{tag}/idx{k}", rng.integers(0, n, shape, dtype=np.int32))
            call(f"{tag}/{k}", "ring_fetch_rows", [plane, idx], d,
                 lambda tag=tag, k=k: grc.ring_fetch_rows(t(f"{tag}/plane"), t(f"{tag}/idx{k}")))
    for d in GLOBAL:
        rng = np.random.default_rng(d)
        tag = f"global_d{d}"
        plane = put(f"{tag}/plane", rng.integers(0, 2, (64, 64), dtype=np.int32) > 0)
        idx = put(f"{tag}/idx", rng.integers(0, 64, (23,), dtype=np.int32))
        call(tag, "ring_fetch_global", [plane, idx], d,
             lambda tag=tag: grc.ring_fetch_global(t(f"{tag}/plane"), t(f"{tag}/idx")))
    for d in MERGE:
        rng = np.random.default_rng(d + 7)
        tag = f"merge_d{d}"
        n = 64
        a = [put(f"{tag}/t", rng.integers(0, n, (n,), dtype=np.int32)),
             put(f"{tag}/ok", rng.integers(0, 2, (n,), dtype=np.int32) > 0),
             put(f"{tag}/rows", rng.integers(0, 1 << 16, (n, n), dtype=np.int32))]
        call(tag, "ring_recv_merge", a, d,
             lambda tag=tag: grc.ring_recv_merge(t(f"{tag}/t").long(), t(f"{tag}/ok"),
                                                 t(f"{tag}/rows")))
    rng = np.random.default_rng(11)
    n = 64
    a = [put("per_row/plane", rng.integers(0, 1 << 20, (n, n), dtype=np.int32)),
         put("per_row/col", rng.integers(0, n, (n,), dtype=np.int32)),
         put("per_row/vals", rng.integers(0, 1 << 20, (n,), dtype=np.int32))]
    call("take", "ring_take_per_row", a[:2], PER_ROW_D,
         lambda: grc.ring_take_per_row(t("per_row/plane"), t("per_row/col")))
    for op in ("set", "max"):
        call(f"update_{op}", "ring_update_per_row", a, PER_ROW_D,
             lambda op=op: grc.ring_update_per_row(t("per_row/plane"), t("per_row/col"),
                                                   t("per_row/vals"), op=op),
             kwargs={"op": op})
    return calls, arrays, port


_CALLS, _ARRAYS, _PORT = _build()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference_calls(_CALLS, _ARRAYS, str(tmp_path_factory.mktemp("ring_ref")))


@pytest.mark.parametrize("name", [c["name"] for c in _CALLS])
def test_primitive_matches_reference(reference, name):
    from ringpop_tpu_torch.ops import gossip_remote_copy as grc

    d, twin = _PORT[name]
    with grc.ring_mesh(_mesh(d)):
        got = twin()
    flat = flatten_outputs(got, name, {})
    want = {k: v for k, v in reference.items() if k == name or k.startswith(name + "/")}
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


def test_primitives_match_plain_gathers_and_scatters():
    """The same inputs through the unsharded forms: gathers, the
    receiver merge's plain version, and index_put / maximum."""
    from ringpop_tpu_torch.ops import gossip_remote_copy as grc
    from ringpop_tpu_torch.ops.recv_merge import recv_merge_plain

    def t(key):
        return torch.as_tensor(_ARRAYS[key])

    for d, n in FETCH:
        tag = f"fetch_d{d}_n{n}"
        plane = t(f"{tag}/plane")
        with grc.ring_mesh(_mesh(d)):
            for k in ("1", "2"):
                idx = t(f"{tag}/idx{k}").long()
                assert torch.equal(grc.ring_fetch_rows(plane, idx), plane[idx])
    for d in GLOBAL:
        plane, idx = t(f"global_d{d}/plane"), t(f"global_d{d}/idx").long()
        with grc.ring_mesh(_mesh(d)):
            assert torch.equal(grc.ring_fetch_global(plane, idx), plane[idx])
    for d in MERGE:
        ts, ok, rows = t(f"merge_d{d}/t").long(), t(f"merge_d{d}/ok"), t(f"merge_d{d}/rows")
        want = recv_merge_plain(ts, ok, torch.where(ok[:, None], rows, 0))
        with grc.ring_mesh(_mesh(d)):
            got = grc.ring_recv_merge(ts, ok, rows)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    plane, col, vals = t("per_row/plane"), t("per_row/col").long(), t("per_row/vals")
    ids = torch.arange(plane.shape[0])
    with grc.ring_mesh(_mesh(PER_ROW_D)):
        assert torch.equal(grc.ring_take_per_row(plane, col), plane[ids, col])
        assert torch.equal(grc.ring_update_per_row(plane, col, vals),
                           plane.index_put((ids, col), vals))
        assert torch.equal(grc.ring_update_per_row(plane, col, vals, op="max"),
                           plane.index_put((ids, col), torch.maximum(plane[ids, col], vals)))
        with pytest.raises(ValueError, match="set|max"):
            grc.ring_update_per_row(plane, col, vals, op="mean")


def test_primitive_cases_hit_their_corners():
    """The merge inputs hold undelivered senders and receivers with
    several senders; the fetches cross every shard boundary."""
    for d in MERGE:
        ts, ok = _ARRAYS[f"merge_d{d}/t"], _ARRAYS[f"merge_d{d}/ok"]
        assert (~ok).any() and np.bincount(ts[ok], minlength=64).max() > 1
    for d, n in FETCH:
        idx = _ARRAYS[f"fetch_d{d}_n{n}/idx2"]
        own = np.arange(n)[:, None] // (n // d)
        assert ((idx // (n // d)) != own).any()


# ---------------------------------------------------------------------------
# the sharded dense step and run against the reference's
# ---------------------------------------------------------------------------

DENSE_CASES = [
    {"name": "step_n16_d2", "backend": "dense", "entry": "step", "n": 16, "d": 2,
     "params": {"loss": 0.05}, "seed": 3, "ticks": 3, "down": [5]},
    {"name": "step_n64_d8", "backend": "dense", "entry": "step", "n": 64, "d": 8,
     "params": {"loss": 0.0}, "seed": 7, "ticks": 2, "init": "self", "joins": True},
    {"name": "run_n32_d4", "backend": "dense", "entry": "run", "n": 32, "d": 4,
     "params": {"loss": 0.02, "suspicion_ticks": 4}, "seed": 0, "ticks": 8, "down": [9]},
]


@pytest.fixture(scope="module")
def sharded_reference(tmp_path_factory):
    return run_sharded_references(DENSE_CASES, str(tmp_path_factory.mktemp("ring_sharded")))


def _start(ref: dict, case: dict):
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models import swim_sim as tsim

    name = case["name"]
    state = convert.state_from_numpy(
        {f: ref[f"{name}/init/{f}"] for f in STATE_FIELDS}, device=CPU)
    net = tsim.make_net(case["n"], device=CPU)._replace(
        up=torch.as_tensor(ref[f"{name}/up"]), responsive=torch.as_tensor(ref[f"{name}/responsive"]))
    return state, net, tsim.SwimParams(**case["params"])


def _assert_state(got, ref: dict, key: str, fields) -> None:
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), ref[f"{key}/{f}"], err_msg=f"{key} {f}")


def _assert_metrics(got: dict, ref: dict, key: str) -> None:
    want = {k.rsplit("/", 1)[1]: int(v) for k, v in ref.items() if k.startswith(f"{key}/")}
    assert {k: int(v) for k, v in got.items()} == want, key


@pytest.mark.parametrize("case", [c for c in DENSE_CASES if c["entry"] == "step"],
                         ids=lambda c: c["name"])
def test_sharded_step_matches_reference(sharded_reference, case):
    """Every field and metric on every tick equals the JAX sharded step's,
    and the port's unsharded step's."""
    from ringpop_tpu_torch import convert, parallel
    from ringpop_tpu_torch.models import swim_sim as tsim

    ref = sharded_reference
    name = case["name"]
    state, net, params = _start(ref, case)
    mesh = _mesh(case["d"])
    sh, net = parallel.shard_cluster(state, net, mesh)
    step = parallel.sharded_step(mesh)
    plain = state
    for t, key in enumerate(ref[f"{name}/keys"]):
        k = convert.key_from_numpy(key)
        sh, m = step(sh, net, k, params)
        plain, m_plain = tsim.swim_step_impl(plain, net, k, params)
        _assert_state(sh, ref, f"{name}/{t}", STATE_FIELDS)
        _assert_metrics(m, ref, f"{name}/m{t}")
        _assert_state(plain, ref, f"{name}/{t}", STATE_FIELDS)
        assert {k: int(v) for k, v in m_plain.items()} == {k: int(v) for k, v in m.items()}


def test_sharded_run_matches_reference(sharded_reference):
    from ringpop_tpu_torch import convert, parallel

    ref = sharded_reference
    case = DENSE_CASES[2]
    name = case["name"]
    state, net, params = _start(ref, case)
    mesh = _mesh(case["d"])
    sh, net = parallel.shard_cluster(state, net, mesh)
    run = parallel.sharded_run(mesh)
    sh, m = run(sh, net, convert.key_from_numpy(ref[f"{name}/key"]), params, case["ticks"])
    _assert_state(sh, ref, f"{name}/run", STATE_FIELDS)
    _assert_metrics(m, ref, f"{name}/mrun")


def test_dense_cases_exercise_the_exchange(sharded_reference):
    """The lossy step case reaches the ping-req exchange (failed probes),
    and the joined case spreads membership."""
    ref = sharded_reference
    assert any(int(ref[f"step_n16_d2/m{t}/ping_reqs"]) > 0 for t in range(3))
    assert int(ref["step_n64_d8/m1/ping_changes_applied"]) > 0


def test_gather_mode_equals_ring_mode(monkeypatch):
    """``gossip="gather"`` (the single-device lowering) and the ring give
    the same state and metrics."""
    from ringpop_tpu_torch import parallel, prng
    from ringpop_tpu_torch.models import swim_sim as tsim
    from ringpop_tpu_torch.ops import gossip_remote_copy as grc

    n = 16
    params = tsim.SwimParams(loss=0.1)
    mesh = _mesh(2)
    net = tsim.make_net(n, device=CPU)
    outs = {}
    for mode in ("ring", "gather"):
        st, nt = parallel.shard_cluster(tsim.init_state(n, device=CPU), net, mesh)
        step = parallel.sharded_step(mesh, gossip=mode)
        seen = []
        monkeypatch.setattr(grc, "ring_recv_merge", lambda *a, real=grc.ring_recv_merge: (
            seen.append(1) or real(*a)))
        for key in prng.split(prng.PRNGKey(1), 3):
            st, m = step(st, nt, key, params)
        monkeypatch.undo()
        outs[mode] = (st, {k: int(v) for k, v in m.items()}, len(seen))
    for f in STATE_FIELDS:
        assert torch.equal(getattr(outs["ring"][0], f), getattr(outs["gather"][0], f)), f
    assert outs["ring"][1] == outs["gather"][1]
    assert outs["ring"][2] > 0 and outs["gather"][2] == 0
    with pytest.raises(ValueError, match="ring|gather"):
        parallel.mesh.gossip_mode("carrier-pigeon")
