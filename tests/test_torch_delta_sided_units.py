"""Single functions of the port's sided delta mode against the reference's,
and the sharded sided step.

Each unit test holds one function of ``ringpop_tpu_torch`` against its
twin in ``ringpop_tpu`` on the same seeded numpy inputs, exactly:

- entering and leaving sided mode: ``make_sides`` (self slots written
  into the first free column, a viewer that already holds one) and
  ``fold_to_single`` (compensating slots, and the over-capacity
  ``ValueError``);
- ``_lmerge_np`` over every pair of statuses (leave included) at lower,
  equal and higher incarnations;
- the sided ``rebase``, anti-entropy and view-preserving, whose merge
  row is lifted to the lattice merge of its source rows;
- the readers of [G, N] bases: ``_base_rank_structs``,
  ``compute_digest``, ``densify``, ``materialize_rows``,
  ``view_lookup``, ``_converged_impl`` (a converged sided cluster, one
  missing cover slot, one wrong slot value), and ``bit_gather`` with
  rows.

The sharded sided step (n = 64 over 8 shards, n = 16 over 2) runs split
and then healed, every field and metric on every tick against the JAX
package's sharded step and the port's unsharded one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_harness import (
    DELTA_FIELDS,
    assert_same_field,
    flatten_outputs,
    run_reference_calls,
    run_sharded_references,
)

SENTINEL = np.iinfo(np.int32).max
N, C = 48, 12
SUSPECT, LEAVE = 2, 4
CPU = torch.device("cpu")


def _keys(rng, shape, statuses=(1, 1, 2, 3, 4), hi=1 << 8):
    return (rng.integers(1, hi, shape) * 8 + rng.choice(statuses, shape)).astype(np.int32)


def _fields(base, side, merge_to, d_subj, d_key, d_pb, d_sl) -> dict:
    """A sided (or, with ``side`` None, single-base) state as numpy arrays
    under the reference's field names and dtypes, its rank structures
    and digest from the port."""
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models import swim_delta as tdelta

    st = tdelta.DeltaState(
        base_key=torch.as_tensor(base), bp_mask=None, bp_rank=None, bp_list=None,
        d_subj=torch.as_tensor(d_subj), d_key=torch.as_tensor(d_key),
        d_pb=torch.as_tensor(d_pb), d_sl=torch.as_tensor(d_sl),
        tick=torch.tensor(5, dtype=torch.int32), overflow_drops=torch.tensor(0, dtype=torch.int32),
        side=None if side is None else torch.as_tensor(side),
        merge_to=None if merge_to is None else torch.as_tensor(merge_to),
    )
    bp_mask, bp_rank, bp_list = tdelta._base_rank_structs(st.base_key)
    st = tdelta.refresh_carried(st._replace(bp_mask=bp_mask, bp_rank=bp_rank, bp_list=bp_list))
    return {k: v for k, v in convert.delta_state_to_numpy(st).items() if v is not None}


def _tables(rng, n, c, fill, self_slots=True):
    """Sorted rows of distinct subjects (the viewer's own among them
    where ``self_slots``), at most ``fill`` live; keys, pb and countdowns
    on live slots only."""
    d_subj = np.full((n, c), SENTINEL, np.int32)
    for i in range(n):
        m = int(rng.integers(1, fill + 1))
        others = rng.choice(np.delete(np.arange(n), i), size=m - 1, replace=False)
        subs = np.append(others, i) if self_slots else rng.choice(n, size=m, replace=False)
        d_subj[i, :m] = np.sort(subs)
    live = d_subj < SENTINEL
    d_key = np.where(live, _keys(rng, (n, c)), 0).astype(np.int32)
    d_pb = np.where(live & (rng.random((n, c)) < 0.3), rng.integers(0, 5, (n, c)), -1)
    d_sl = np.where(live & ((d_key & 7) == SUSPECT), rng.integers(0, 5, (n, c)), -1)
    return d_subj, d_key, d_pb.astype(np.int8), d_sl.astype(np.int8)


def _merge_table(g: int) -> np.ndarray:
    mt = np.full((g + 1, g + 1), g, np.int32)
    np.fill_diagonal(mt, np.arange(g + 1))
    return mt


def _converged(rng, n, c):
    """A converged sided state: every view equals the merge row's base;
    each viewer holds a slot wherever its side's base differs from it,
    and its self slot."""
    base = _keys(rng, n, (1, 1, 2, 3))[None, :].repeat(3, axis=0)
    for g, cols in ((0, rng.choice(n, 3, replace=False)), (1, rng.choice(n, 3, replace=False))):
        base[g, cols] = _keys(rng, cols.size)
    view = base[2].copy()
    side = rng.choice(3, n).astype(np.int32)
    d_subj = np.full((n, c), SENTINEL, np.int32)
    d_key = np.zeros((n, c), np.int32)
    for i in range(n):
        subs = np.union1d(np.flatnonzero(base[side[i]] != view), [i])
        d_subj[i, : subs.size] = subs
        d_key[i, : subs.size] = view[subs]
    neg = np.full((n, c), -1, np.int8)
    return _fields(base, side, _merge_table(2), d_subj, d_key, neg, neg)


def _build():
    """(calls, arrays, port thunks): each call's reference spec and the
    port function on the same arrays."""
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.ops import bitpack

    rng = np.random.default_rng(77)
    arrays: dict[str, np.ndarray] = {}
    calls: list[dict] = []
    port: dict[str, object] = {}

    def put(name, value):
        arrays[name] = value
        return ["array", name]

    def put_state(name, fields):
        for f, v in fields.items():
            arrays[f"{name}/{f}"] = v
        return ["delta_state", {f: f"{name}/{f}" for f in fields}]

    def t(name):
        return torch.as_tensor(arrays[name])

    def tstate(name):
        return convert.delta_state_from_numpy(
            {f: arrays[f"{name}/{f}"] for f in DELTA_FIELDS if f"{name}/{f}" in arrays},
            device="cpu")

    def call(name, fn, args, thunk, kwargs=None, module="swim_delta", raises=False):
        calls.append({"name": name, "module": module, "fn": fn, "args": args,
                      "kwargs": kwargs or {}, "raises": raises})
        port[name] = thunk

    # a sided state in churn: three base rows (two sides, the merge row)
    # that differ, viewers on all three, busy and suspect slots
    base = _keys(rng, (3, N))
    base[:, rng.random(N) < 0.05] = 0
    side = rng.choice(3, N).astype(np.int32)
    sided = _fields(base, side, _merge_table(2), *_tables(rng, N, C, C - 2))
    st = put_state("sided", sided)

    call("base_rank_structs", "_base_rank_structs", [put("brs/base", base)],
         lambda: tdelta._base_rank_structs(t("brs/base")))
    call("compute_digest", "compute_digest", [st],
         lambda: tdelta.compute_digest(tstate("sided")).numpy().astype(np.uint32))
    call("densify", "densify", [st], lambda: tdelta.densify(tstate("sided")))
    idx = np.array([0, 5, 5, 17, N - 1], np.int32)
    call("materialize_rows", "materialize_rows", [st, put("mat/idx", idx)],
         lambda: tdelta.materialize_rows(tstate("sided"), t("mat/idx")))
    q = rng.integers(0, N, (N, 7)).astype(np.int32)
    call("view_lookup", "view_lookup", [st, put("vl/q", q)],
         lambda: tdelta.view_lookup(tstate("sided"), t("vl/q")))
    for ae in (True, False):
        call(f"rebase/{ae}", "rebase", [st, ["py", ae]],
             lambda ae=ae: tdelta.rebase(tstate("sided"), ae))

    # an unsided state in churn: make_sides adds self slots where missing
    d_tabs = _tables(rng, N, C, C - 1, self_slots=False)
    single = _fields(base[0], None, None, *d_tabs)
    st1 = put_state("single", single)
    gid = (np.arange(N) >= N // 3).astype(np.int32)
    call("make_sides", "make_sides", [st1, put("ms/gid", gid)],
         lambda: tdelta.make_sides(tstate("single"), t("ms/gid")))

    # _converged_impl: a converged sided cluster; a viewer missing one
    # cover slot; a slot with another value
    conv = _converged(rng, N, C)
    put_state("conv", conv)
    i = int(np.flatnonzero((conv["d_subj"] < SENTINEL).sum(axis=1) > 1)[0])
    row = conv["d_subj"][i]
    j = int(np.flatnonzero((row < SENTINEL) & (row != i))[0])
    miss_subj, miss_key = conv["d_subj"].copy(), conv["d_key"].copy()
    miss_subj[i, j:] = np.append(row[j + 1:], SENTINEL)  # drop one cover slot
    miss_key[i, j:] = np.append(conv["d_key"][i, j + 1:], 0)
    wrong_key = conv["d_key"].copy()
    wrong_key[i, 0] += 8
    sided_of = (conv["base_key"], conv["side"], conv["merge_to"])
    put_state("miss", _fields(*sided_of, miss_subj, miss_key, conv["d_pb"], conv["d_sl"]))
    put_state("wrong", _fields(*sided_of, conv["d_subj"], wrong_key, conv["d_pb"], conv["d_sl"]))
    everyone = np.ones(N, bool)
    put("conv/up", everyone)
    for name in ("conv", "miss", "wrong"):
        call(f"converged/{name}", "_converged_impl",
             [["delta_state", {f: f"{name}/{f}" for f in conv}], ["array", "conv/up"],
              ["array", "conv/up"]],
             lambda name=name: tdelta._converged_impl(tstate(name), t("conv/up"), t("conv/up")))

    # fold_to_single: the converged cluster folds (compensating slots on
    # the side rows' viewers); at capacity 3 it raises
    call("fold_to_single", "fold_to_single", [["delta_state", {f: f"conv/{f}" for f in conv}]],
         lambda: tdelta.fold_to_single(tstate("conv")))
    tight = _fields(conv["base_key"], conv["side"], conv["merge_to"],
                    *(conv[k][:, :3] for k in ("d_subj", "d_key", "d_pb", "d_sl")))
    put_state("tight", tight)

    def port_raises():
        try:
            tdelta.fold_to_single(tstate("tight"))
        except ValueError as e:
            return np.array(type(e).__name__)
        return np.array("")

    call("fold_tight", "fold_to_single", [["delta_state", {f: f"tight/{f}" for f in tight}]],
         port_raises, raises=True)

    # the lattice merge over every status pair at lower, equal and higher
    # incarnations (and the empty key)
    st_a, st_b = np.meshgrid(np.arange(5), np.arange(5), indexing="ij")
    incs = [(3, 2), (3, 3), (3, 4)]
    a = np.concatenate([st_a.ravel() + 8 * ia for ia, _ in incs]).astype(np.int32)
    b = np.concatenate([st_b.ravel() + 8 * ib for _, ib in incs]).astype(np.int32)
    a[0] = 0  # the empty key
    call("lmerge", "_lmerge_np", [put("lm/a", a), put("lm/b", b)],
         lambda: tdelta._lmerge_np(arrays["lm/a"], arrays["lm/b"]))

    # bit_gather with rows: a [3, W] plane, viewers' rows against
    # subjects
    plane = rng.random((3, N)) < 0.5
    packed = bitpack.pack_bits(torch.as_tensor(plane))
    put("bg/packed", packed.numpy().astype(np.uint32))
    bg_q = rng.integers(0, N, (N, 5)).astype(np.int32)
    call("bit_gather", "bit_gather",
         [["array", "bg/packed"], put("bg/q", bg_q), put("bg/row", side[:, None])],
         lambda: bitpack.bit_gather(packed, t("bg/q"), t("bg/row")), module="bitpack")
    return calls, arrays, port


_CALLS, _ARRAYS, _PORT = _build()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference_calls(_CALLS, _ARRAYS, str(tmp_path_factory.mktemp("sided_units_ref")))


@pytest.mark.parametrize("name", [c["name"] for c in _CALLS])
def test_function_matches_reference(reference, name):
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models import swim_delta as tdelta

    got = _PORT[name]()
    if isinstance(got, tdelta.DeltaState):
        got = tdelta.DeltaState(**convert.delta_state_to_numpy(got))
    elif isinstance(got, tuple) and name == "base_rank_structs":
        got = (got[0].numpy().astype(np.uint32), *got[1:])
    flat = flatten_outputs(got, name + ("/raises" if name == "fold_tight" else ""), {})
    want = {k: v for k, v in reference.items() if k == name or k.startswith(name + "/")}
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        if v.dtype.kind == "U":
            assert str(flat[k]) == str(v), k
        else:
            assert flat[k].dtype == v.dtype, k
            np.testing.assert_array_equal(flat[k], v, err_msg=k)


def test_cases_hit_their_corners(reference):
    """The inputs reach what they are for: the rebases fold and lift the
    merge row, make_sides wrote self slots, the converged cluster is
    converged and its two breaks are not, fold_to_single wrote
    compensating slots and the tight one raised."""
    before = _ARRAYS["sided/base_key"]
    for ae in ("True", "False"):
        assert (reference[f"rebase/{ae}/base_key"] != before).any(), ae
    after = reference["rebase/True/base_key"]
    from ringpop_tpu_torch.models import swim_delta as tdelta
    lifted = tdelta._lmerge_np(after[2], tdelta._lmerge_np(after[0], after[1]))
    assert (after[2] == lifted).all() and (lifted != before[2]).any()
    had_self = (_ARRAYS["single/d_subj"] == np.arange(N)[:, None]).any(axis=1)
    assert not had_self.all() and had_self.any()
    assert (reference["make_sides/d_subj"] == np.arange(N)[:, None]).any(axis=1).all()
    assert bool(reference["converged/conv"])
    assert not bool(reference["converged/miss"]) and not bool(reference["converged/wrong"])
    occ = (reference["fold_to_single/d_subj"] < SENTINEL).sum()
    assert occ > (_ARRAYS["conv/d_subj"] < SENTINEL).sum()
    assert str(reference["fold_tight/raises"]) == "ValueError"
    assert (_ARRAYS["lm/a"] & 7 == LEAVE).any() and (_ARRAYS["lm/b"] & 7 == LEAVE).any()


# ---------------------------------------------------------------------------
# the sharded sided step
# ---------------------------------------------------------------------------

SHARDED = [
    {"name": "sided_step_n64_d8", "backend": "delta", "entry": "step", "n": 64, "d": 8,
     "sides": True, "heal_at": 8, "rebase_at": [4, 8],
     "params": {"loss": 0.05, "suspicion_ticks": 5}, "seed": 3, "ticks": 14,
     "caps": {"capacity": 16, "wire_cap": 8, "claim_grid": 64}},
    {"name": "sided_step_n16_d2", "backend": "delta", "entry": "step", "n": 16, "d": 2,
     "sides": True, "heal_at": 8, "rebase_at": [4, 8],
     "params": {"loss": 0.05, "suspicion_ticks": 6}, "seed": 3, "ticks": 12,
     "caps": {"capacity": 8, "wire_cap": 4, "claim_grid": 16}},
]


@pytest.fixture(scope="module")
def sharded_reference(tmp_path_factory):
    return run_sharded_references(SHARDED, str(tmp_path_factory.mktemp("sided_sharded_ref")))


def _np(x):
    return None if x is None else x.numpy()


@pytest.mark.parametrize("case", SHARDED, ids=lambda c: c["name"])
def test_sharded_sided_step_matches_reference(sharded_reference, case):
    """Every field (the replicated [G, N] bases, flip table and side
    vector included) and metric on every tick equals the JAX sharded
    step's and the port's unsharded step's, through the split, two
    anti-entropy rebases and the heal; viewers flip onto the merge row."""
    from ringpop_tpu_torch import convert, parallel
    from ringpop_tpu_torch.models import swim_delta as tdelta
    from ringpop_tpu_torch.models import swim_sim as tsim

    ref, name, n = sharded_reference, case["name"], case["n"]
    state = convert.delta_state_from_numpy(
        {f: ref.get(f"{name}/init/{f}") for f in DELTA_FIELDS}, device=CPU)
    assert state.side is not None and state.base_key.shape == (3, n)
    gid = (torch.arange(n) >= n // 2).to(torch.int32)
    net = tsim.make_net(n, device=CPU)._replace(adj=gid)
    caps = case["caps"]
    params = tdelta.DeltaParams(swim=tsim.SwimParams(**case["params"]),
                                wire_cap=caps["wire_cap"], claim_grid=caps["claim_grid"])
    mesh = parallel.make_mesh(devices=[CPU] * case["d"])
    step = parallel.sharded_delta_step(mesh, net_like=net)
    sh = parallel.shard_delta(state, mesh)
    plain = state
    for t, key in enumerate(ref[f"{name}/keys"]):
        if t == case["heal_at"]:
            net = net._replace(adj=torch.zeros(n, dtype=torch.int32))
        if t in case["rebase_at"]:
            sh = parallel.shard_delta(tdelta.rebase(sh, anti_entropy=True), mesh)
            plain = tdelta.rebase(plain, anti_entropy=True)
        k = convert.key_from_numpy(key)
        sh, m = step(sh, net, k, params)
        plain, m_plain = tdelta.delta_step_impl(plain, net, k, params)
        got, got_plain = convert.delta_state_to_numpy(sh), convert.delta_state_to_numpy(plain)
        for f in DELTA_FIELDS:
            assert_same_field(got[f], ref.get(f"{name}/{t}/{f}"), f"{name} {t} {f}")
            assert_same_field(got_plain[f], got[f], f"{name} {t} {f} unsharded")
        want_m = {k.rsplit("/", 1)[1]: int(v) for k, v in ref.items()
                  if k.startswith(f"{name}/m{t}/")}
        assert {k: int(v) for k, v in m.items()} == want_m == {
            k: int(v) for k, v in m_plain.items()}, t
    assert (sh.side == 2).any()


def test_convert_round_trips_a_sided_state():
    """A sided reference state ([G, N] bases and packed planes, int32
    ``side`` and ``merge_to``) comes over and goes back bit for bit,
    dtypes included."""
    from ringpop_tpu_torch import convert

    fields = {f[len("sided/"):]: v for f, v in _ARRAYS.items() if f.startswith("sided/")}
    st = convert.delta_state_from_numpy(fields, device="cpu")
    assert st.base_key.shape == (3, N) and st.bp_mask.shape == (3, 2)
    assert st.side.dtype == torch.int32 and st.merge_to.shape == (3, 3)
    back = convert.delta_state_to_numpy(st)
    for f, v in fields.items():
        assert back[f].dtype == v.dtype, f
        np.testing.assert_array_equal(back[f], v, err_msg=f)
