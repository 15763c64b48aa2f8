"""Single functions of the port's delta backend against the reference's.

Each test holds one function of ``ringpop_tpu_torch/models/swim_delta.py``
against its twin in ``ringpop_tpu/models/swim_delta.py`` on the same
numpy inputs (seeded), exactly, at the corners where PyTorch and JAX
differ by default:

- stable sorts with ties (``_sort_claim_rows``, ``_route_claims``,
  ``_compact_true``);
- ``_row_searchsorted`` on both sides of its four-query threshold (a
  compare-count at K <= 4, the row-searchsorted kernel's wrapper above);
- scatters whose dropped column repeats (``materialize_rows``,
  ``_converged_impl``) and the argmax of an all-False bool row;
- uint32 wraparound of the digest terms (``_hash1``, ``compute_digest``)
  and of the wire window's start (``_rotating_window``);
- int8 wraparound of the piggyback counters (``_stage_issue_delta``).

The reference functions run in one child process
(``run_reference_calls``: the jax 0.9 patches never load here).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_harness import flatten_outputs, run_reference_calls

SENTINEL = np.iinfo(np.int32).max
N, C = 24, 12


def _sorted_table(rng, n, c, span):
    """Sorted int32 rows of distinct subjects with SENTINEL tails."""
    rows = np.full((n, c), SENTINEL, np.int32)
    for i in range(n):
        m = int(rng.integers(0, c + 1))
        rows[i, :m] = np.sort(rng.choice(span, size=m, replace=False))
    return rows


def _state(rng, n, c, *, agree=False, big=False):
    """A delta state as numpy arrays under the reference's field names
    and dtypes.  ``agree``: every row holds the same slots (converged);
    ``big``: incarnations near the top of the int32 key range."""
    from ringpop_tpu_torch.models import swim_delta as tdelta

    hi = (1 << 28) - 1 if big else 1 << 12
    lo = hi - (1 << 10) if big else 1
    base = (rng.integers(lo, hi, n) * 8 + rng.choice([1, 1, 1, 2, 3, 4], n)).astype(np.int32)
    base[rng.random(n) < 0.1] = 0
    d_subj = _sorted_table(rng, n, c, n)
    if agree:
        d_subj[:] = d_subj[0]
    live = d_subj < SENTINEL
    key = (rng.integers(lo, hi, (n, c)) * 8 + rng.choice([1, 2, 3, 4], (n, c))).astype(np.int32)
    if agree:
        key[:] = key[0]
    d_key = np.where(live, key, 0).astype(np.int32)
    d_pb = np.where(live, rng.integers(-1, 127, (n, c)), -1).astype(np.int8)
    d_sl = np.where(live, rng.integers(-1, 26, (n, c)), -1).astype(np.int8)
    bp_mask, bp_rank, bp_list = tdelta._base_rank_structs(torch.as_tensor(base))
    return {
        "base_key": base,
        "bp_mask": bp_mask.numpy().astype(np.uint32),
        "bp_rank": bp_rank.numpy(),
        "bp_list": bp_list.numpy(),
        "d_subj": d_subj,
        "d_key": d_key,
        "d_pb": d_pb,
        "d_sl": d_sl,
        "tick": np.array((1 << 31) - 3 if big else 7, np.int32),
        "overflow_drops": np.array(0, np.int32),
    }


def _build():
    """(calls, arrays, port thunks): each call's reference spec and the
    port function evaluated on the same arrays."""
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models import swim_delta as tdelta

    rng = np.random.default_rng(2024)
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

    def tstate(name, fields):
        return convert.delta_state_from_numpy(
            {f: arrays[f"{name}/{f}"] for f in fields}, device="cpu")

    def call(name, fn, args, thunk, kwargs=None):
        calls.append({"name": name, "module": "swim_delta", "fn": fn, "args": args,
                      "kwargs": kwargs or {}})
        port[name] = thunk

    # stable sorts with ties: few subjects, repeated keys, invalid slots
    subj = rng.integers(0, 5, (N, 20)).astype(np.int32)
    key = (rng.integers(0, 3, (N, 20)) * 8 + 1).astype(np.int32)
    valid = rng.random((N, 20)) < 0.7
    a = [put("sort/subj", subj), put("sort/key", key), put("sort/valid", valid)]
    call("sort_claim_rows", "_sort_claim_rows", a,
         lambda: tdelta._sort_claim_rows(t("sort/subj"), t("sort/key"), t("sort/valid")))

    # routing: most senders aim at three receivers, so runs tie and the
    # grid overflows (late drops)
    w = 4
    s_subj = np.sort(rng.integers(0, 8, (N, w)), axis=1).astype(np.int32)
    s_key = (rng.integers(1, 4, (N, w)) * 8 + rng.choice([1, 2, 3], (N, w))).astype(np.int32)
    s_valid = rng.random((N, w)) < 0.8
    recv = rng.choice([0, 5, 9, 11], N).astype(np.int32)
    a = [["py", N], put("route/subj", s_subj), put("route/key", s_key),
         put("route/valid", s_valid), put("route/recv", recv), ["py", 6]]
    call("route_claims", "_route_claims", a,
         lambda: tdelta._route_claims(N, t("route/subj"), t("route/key"), t("route/valid"),
                                      t("route/recv"), 6))

    mask = rng.random((N, C)) < 0.4
    call("compact_true", "_compact_true", [put("ct/mask", mask), ["py", 5]],
         lambda: tdelta._compact_true(t("ct/mask"), 5))

    # row searchsorted on both sides of the four-query threshold
    table = np.sort(rng.integers(0, 10, (N, C)), axis=1).astype(np.int32)
    table[:, -3:] = SENTINEL
    put("rs/table", table)
    for k in (1, 3, 4, 5, 9):
        q = rng.integers(-1, 12, (N, k)).astype(np.int32)
        q[:, 0] = SENTINEL
        for side in ("left", "right"):
            name = f"row_searchsorted/k{k}/{side}"
            call(name, "_row_searchsorted", [["array", "rs/table"], put(f"rs/q{k}{side}", q)],
                 lambda k=k, side=side: tdelta._row_searchsorted(
                     t("rs/table"), t(f"rs/q{k}{side}"), side=side),
                 kwargs={"side": side})

    # materialize_rows: rows with several free slots (the dropped column
    # repeats) and repeated viewers
    fields = _state(rng, N, C)
    st = put_state("mat", fields)
    idx = np.array([0, 3, 3, 7, N - 1], np.int32)
    call("materialize_rows", "materialize_rows", [st, put("mat/idx", idx)],
         lambda: tdelta.materialize_rows(tstate("mat", fields), t("mat/idx")))

    # _converged_impl: nobody live (the argmax of an all-False row), one
    # live viewer, viewer 0 down in an agreeing cluster, and a cluster
    # that disagrees
    agree = _state(rng, N, C, agree=True)
    differ = _state(rng, N, C)
    put_state("agree", agree)
    put_state("differ", differ)
    everyone = np.ones(N, bool)
    ups = {
        "none_live": (agree, np.zeros(N, bool)),
        "one_live": (differ, np.eye(N, dtype=bool)[5]),
        "first_down": (agree, np.concatenate([[False], np.ones(N - 1, bool)])),
        "differ": (differ, everyone),
    }
    for case, (fields_c, up) in ups.items():
        sname = "agree" if fields_c is agree else "differ"
        a = [["delta_state", {f: f"{sname}/{f}" for f in fields_c}],
             put(f"conv/{case}/up", up), put(f"conv/{case}/resp", everyone)]
        call(f"converged/{case}", "_converged_impl", a,
             lambda sname=sname, fields_c=fields_c, case=case: tdelta._converged_impl(
                 tstate(sname, fields_c), t(f"conv/{case}/up"), t(f"conv/{case}/resp")))

    # uint32 wraparound of the digest, at keys near the top of the range
    big = _state(rng, N, C, big=True)
    st_big = put_state("big", big)
    call("compute_digest", "compute_digest", [st_big],
         lambda: tdelta.compute_digest(tstate("big", big)))
    keys = np.concatenate([[0, 1, 7], rng.integers(1, SENTINEL, 61)]).astype(np.int32)
    call("hash1", "_hash1", [put("h/key", keys), put("h/idx", np.arange(64, dtype=np.int32))],
         lambda: tdelta._hash1(t("h/key"), t("h/idx")))

    # int8 wraparound of the piggyback counters (d_pb up to 126, up to
    # 300 requests served) and the uint32 rotation start at a tick near
    # 2**31
    nserve = rng.integers(0, 300, N).astype(np.int32)
    maxpb = rng.integers(0, 127, N).astype(np.int8)
    a = [st_big, put("stage/nserve", nserve), put("stage/maxpb", maxpb), ["py", 3]]
    call("stage_issue_delta", "_stage_issue_delta", a,
         lambda: tdelta._stage_issue_delta(tstate("big", big), t("stage/nserve"),
                                           t("stage/maxpb"), 3))
    issuable = rng.random((N, C)) < 0.6
    a = [put("rw/issuable", issuable), ["py", 5], ["array", "big/tick"]]
    call("rotating_window", "_rotating_window", a,
         lambda: tdelta._rotating_window(t("rw/issuable"), 5, t("big/tick")))
    return calls, arrays, port


_CALLS, _ARRAYS, _PORT = _build()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference_calls(_CALLS, _ARRAYS, str(tmp_path_factory.mktemp("units_ref")))


@pytest.mark.parametrize("name", [c["name"] for c in _CALLS])
def test_function_matches_reference(reference, name):
    from ringpop_tpu_torch import convert
    from ringpop_tpu_torch.models import swim_delta as tdelta

    got = _PORT[name]()
    if isinstance(got, tdelta.DeltaState):
        got = convert.delta_state_to_numpy(got)
        got = tdelta.DeltaState(**{k: v for k, v in got.items()})
    elif isinstance(got, tuple) and got and isinstance(got[0], tdelta.DeltaState):
        st = convert.delta_state_to_numpy(got[0])
        got = (tdelta.DeltaState(**st), *got[1:])
    flat = flatten_outputs(got, name, {})
    want = {k: v for k, v in reference.items() if k == name or k.startswith(name + "/")}
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)


def test_wide_lookups_go_through_the_kernel_wrapper(monkeypatch):
    """K <= 4 queries per row are a compare-count; K > 4 is the kernel
    site (its wrapper runs the plain version for CPU tensors)."""
    from ringpop_tpu_torch.models import swim_delta as tdelta

    seen = []
    real = tdelta.row_searchsorted
    monkeypatch.setattr(tdelta, "row_searchsorted",
                        lambda a, v, side="left": seen.append(v.shape[1]) or real(a, v, side))
    table = torch.as_tensor(np.sort(np.random.default_rng(1).integers(0, 9, (4, 8)), axis=1)
                            .astype(np.int32))
    for k in (1, 4, 5, 8):
        tdelta._row_searchsorted(table, table[:, :k].contiguous())
    assert seen == [5, 8]


def test_cases_hit_their_corners(reference):
    """The inputs reach what they are for: ties dropped at routing, a
    wrapped int8 counter, a row with a repeated dropped column."""
    assert int(reference["route_claims/3"]) > 0  # late drops
    free = (_ARRAYS["mat/d_subj"][_ARRAYS["mat/idx"]] == SENTINEL).sum(axis=1)
    assert (free >= 2).any()  # the dropped column repeats in a row
    d_pb = _ARRAYS["big/d_pb"].astype(np.int64)
    served = d_pb + np.minimum(_ARRAYS["stage/nserve"], 127)[:, None]
    assert (served > 127).any()  # the int8 sum wraps somewhere
    assert bool(reference["converged/none_live"]) and bool(reference["converged/one_live"])
    assert bool(reference["converged/first_down"]) and not bool(reference["converged/differ"])
