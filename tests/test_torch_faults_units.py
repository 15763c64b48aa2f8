"""The fault model's single functions against the JAX reference's.

Each reference function runs in one child process
(``run_reference_calls``) on the same arrays and keys as the port's:

- ``_link_hit_p`` and ``_drop_net`` with K = 3 overlapping rules at
  p = 0.3, 0.7 and 0.9 and loss 0.01, over 64 keys: the composed drop
  probability is a float32 product whose order decides its rounding;
- ``_stagger_send_gate`` at n = 65 536 with a period row of mixed
  values, where ``i * 0x9E37`` wraps in int32 (from i = 53 022 on), and
  with the static ``phase_mod``;
- ``_message_delay`` at jitter bounds 0-3;
- the delta backend's ``_pend_write``, on lanes that already hold claims
  (cells the rows that are not delayed must leave alone).

And two no-reference checks of the places where the port runs a
branch the reference skips: the dense buffer's scatter-max
(``swim_sim._park``) against a plain drop-mode scatter on a filled
buffer, and a maturation of an empty slot.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_harness import run_reference_calls

from ringpop_tpu_torch import convert, prng
from ringpop_tpu_torch.models import swim_delta as tdelta
from ringpop_tpu_torch.models import swim_sim as tsim

N = 40
K = 3
KEYS = 64
N_GATE = 65_536
SENTINEL = (1 << 31) - 1


def _keys(seed: int, count: int) -> np.ndarray:
    return prng.split(prng.PRNGKey(seed), count).numpy().astype(np.uint32)


def _rules() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(9)
    src = rng.random((K, N)) < 0.5
    dst = rng.random((K, N)) < 0.5
    src[:, :12] = True  # every pair from 0..11 to 12..23 hits all three rules
    dst[:, 12:24] = True
    return {
        "link_src": src, "link_dst": dst,
        "link_p": np.array([0.3, 0.7, 0.9], np.float32),
        "link_d": np.array([1, 0, 2], np.int32),
        "link_j": np.array([0, 3, 1], np.int32),
    }


def _net_ref(fields) -> list:
    return ["net", {"up": "up", "responsive": "up", **{f: f for f in fields}}]


def _port_net(arrays: dict, fields) -> tsim.NetState:
    up = torch.ones(N, dtype=torch.bool)
    return tsim.NetState(up=up, responsive=up,
                         **{f: torch.from_numpy(arrays[f]) for f in fields})


def _pend_state() -> tuple[tdelta.DeltaState, dict[str, np.ndarray]]:
    """A delta state at tick 5 with depth-4 lanes already holding claims."""
    n, w = 12, 4
    st = tdelta.install_pending(tdelta.init_delta(n, capacity=8, device="cpu"), 4, w)
    rng = np.random.default_rng(4)
    shape = tuple(st.pend_subj.shape)
    subj = np.sort(rng.integers(0, n, shape), axis=-1).astype(np.int32)
    st = st._replace(
        pend_subj=torch.from_numpy(np.where(rng.random(shape) < 0.7, subj, SENTINEL)),
        pend_key=torch.from_numpy(rng.integers(0, 999, shape).astype(np.int32)),
        pend_recv=torch.from_numpy(rng.integers(0, n + 1, shape[:3]).astype(np.int32)),
        tick=torch.tensor(5, dtype=torch.int32),
    )
    fields = {f: v for f, v in convert.delta_state_to_numpy(st).items() if v is not None}
    return st, fields


def _pend_args(kind: int, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    n, w = 12, 4
    d = rng.integers(0, 4, n).astype(np.int32)
    dly = (d > 0) & (rng.random(n) < 0.8)
    subj = np.sort(rng.integers(0, n, (n, w)), axis=1).astype(np.int32)
    valid = rng.random((n, w)) < 0.6
    return {"d": d, "dly": dly, "subj": np.where(valid, subj, SENTINEL),
            "key": rng.integers(8, 800, (n, w)).astype(np.int32), "valid": valid,
            "recv": rng.integers(0, n, n).astype(np.int32)}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    rules = _rules()
    rng = np.random.default_rng(11)
    arrays = {**rules, "up": np.ones(N, bool),
              "ids": np.arange(N, dtype=np.int32),
              "ids_col": np.arange(N, dtype=np.int32)[:, None],
              "t_safe": rng.integers(0, N, N).astype(np.int32),
              "wit": rng.integers(0, N, (N, 3)).astype(np.int32)}
    keys = _keys(3, KEYS)
    calls = []
    loss_net = _net_ref(("link_src", "link_dst", "link_p"))
    delay_net = _net_ref(tuple(rules))
    for i in range(KEYS):
        arrays[f"key{i}"] = keys[i]
        for form, rows, cols, shape in (("p3", "ids", "t_safe", [N]),
                                        ("p5", "ids_col", "wit", [N, 3])):
            calls.append({"name": f"drop{i}{form}", "module": "swim_sim", "fn": "_drop_net",
                          "args": [["array", f"key{i}"], ["tuple", shape], ["py", 0.01],
                                   loss_net, ["array", rows], ["array", cols]]})
        if i < 16:
            calls.append({"name": f"delay{i}", "module": "swim_sim", "fn": "_message_delay",
                          "args": [delay_net, ["array", f"key{i}"], ["array", "ids_col"],
                                   ["array", "wit"], ["tuple", [N, 3]]]})
    # a second rule set whose composed probability rounds differently in
    # another order: 1 - ((1-.04)(1-.2))(1-.19) != 1 - (1-.04)((1-.2)(1-.19))
    # in float32
    arrays["link_p_order"] = np.array([0.04, 0.2, 0.19], np.float32)
    order_net = ["net", {**loss_net[1], "link_p": "link_p_order"}]
    for form, rows, cols in (("p3", "ids", "t_safe"), ("p5", "ids_col", "wit")):
        calls.append({"name": f"hit{form}", "module": "swim_sim", "fn": "_link_hit_p",
                      "args": [loss_net, ["array", rows], ["array", cols]]})
        calls.append({"name": f"hit_order{form}", "module": "swim_sim", "fn": "_link_hit_p",
                      "args": [order_net, ["array", rows], ["array", cols]]})

    # the stagger gate at n = 65 536: a period row of mixed values, and
    # the static phase_mod
    arrays["sends"] = np.ones(N_GATE, bool)
    arrays["per"] = rng.integers(1, 8, N_GATE).astype(np.int32)
    for tick in range(14):
        arrays[f"tick{tick}"] = np.array(tick, np.int32)
        calls.append({"name": f"gate{tick}", "module": "swim_sim", "fn": "_stagger_send_gate",
                      "args": [["array", "sends"], ["array", f"tick{tick}"], ["py", N_GATE],
                               ["py", 1], ["array", "per"]]})
        calls.append({"name": f"gatepm{tick}", "module": "swim_sim",
                      "fn": "_stagger_send_gate",
                      "args": [["array", "sends"], ["array", f"tick{tick}"], ["py", N_GATE],
                               ["py", 5], ["py", None]]})

    _, st_fields = _pend_state()
    for f, v in st_fields.items():
        arrays[f"st_{f}"] = v
    for kind, seed in ((0, 1), (1, 2), (0, 3)):
        pa = _pend_args(kind, seed)
        for f, v in pa.items():
            arrays[f"pw{seed}_{f}"] = v
        calls.append({"name": f"pend{seed}", "module": "swim_delta", "fn": "_pend_write",
                      "args": [["delta_state", {f: f"st_{f}" for f in st_fields}],
                               ["py", kind]]
                      + [["array", f"pw{seed}_{f}"]
                         for f in ("d", "dly", "subj", "key", "valid", "recv")]})
    ref = run_reference_calls(calls, arrays, str(tmp_path_factory.mktemp("fault_units")))
    return arrays, ref


def test_link_hit_p(cases):
    """The composed drop probability, float32 for float32, at the
    phase-3 ([N]) and ping-req ([N, k]) index forms."""
    arrays, ref = cases
    net = _port_net(arrays, ("link_src", "link_dst", "link_p"))
    order = net._replace(link_p=torch.from_numpy(arrays["link_p_order"]))
    for form, rows, cols in (("p3", "ids", "t_safe"), ("p5", "ids_col", "wit")):
        r, c = torch.from_numpy(arrays[rows]), torch.from_numpy(arrays[cols])
        for label, nt in (("hit", net), ("hit_order", order)):
            got = tsim._link_hit_p(nt, r, c).numpy()
            want = ref[f"{label}{form}"]
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want, err_msg=f"{label}{form}")
        assert (ref[f"hit{form}"] > 0.97).any()  # pairs hit by all three rules
    # at the pairs hit thrice the reference takes the rule-order product,
    # which the right-to-left one would miss by an ulp
    a = [np.float32(1) - v for v in arrays["link_p_order"]]
    hits = set(ref["hit_orderp5"].ravel().tolist())
    assert float(np.float32(1) - (a[0] * a[1]) * a[2]) in hits
    assert float(np.float32(1) - a[0] * (a[1] * a[2])) not in hits


def test_drop_net(cases):
    """One draw a message against ``loss + (1 - loss) * p_link``, over
    64 keys."""
    arrays, ref = cases
    net = _port_net(arrays, ("link_src", "link_dst", "link_p"))
    drops = 0
    for i in range(KEYS):
        key = convert.key_from_numpy(arrays[f"key{i}"])
        for form, rows, cols, shape in (("p3", "ids", "t_safe", (N,)),
                                        ("p5", "ids_col", "wit", (N, 3))):
            got = tsim._drop_net(key, shape, 0.01, net, torch.from_numpy(arrays[rows]),
                                 torch.from_numpy(arrays[cols])).numpy()
            np.testing.assert_array_equal(got, ref[f"drop{i}{form}"], err_msg=f"key {i} {form}")
            drops += int(got.sum())
    assert 0 < drops < KEYS * N * 4


def test_message_delay(cases):
    """Rule base plus a uniform draw in {0..jitter}, jitter bounds 0-3."""
    arrays, ref = cases
    net = _port_net(arrays, tuple(_rules()))
    seen = set()
    for i in range(16):
        got = tsim._message_delay(net, convert.key_from_numpy(arrays[f"key{i}"]),
                                  torch.from_numpy(arrays["ids_col"]),
                                  torch.from_numpy(arrays["wit"]), (N, 3)).numpy()
        np.testing.assert_array_equal(got, ref[f"delay{i}"], err_msg=f"key {i}")
        seen.update(got.ravel().tolist())
    assert len(seen) >= 5  # bases and jitters of several sizes turn up


def test_stagger_send_gate_wraps(cases):
    """At n = 65 536 the phase product wraps in int32 for ids >= 53 022;
    the port wraps it alike, for a period row and for phase_mod."""
    arrays, ref = cases
    sends = torch.from_numpy(arrays["sends"])
    per = torch.from_numpy(arrays["per"])
    for tick in range(14):
        t = torch.tensor(tick, dtype=torch.int32)
        got = tsim._stagger_send_gate(sends, t, N_GATE, 1, per).numpy()
        np.testing.assert_array_equal(got, ref[f"gate{tick}"], err_msg=f"tick {tick}")
        got = tsim._stagger_send_gate(sends, t, N_GATE, 5, None).numpy()
        np.testing.assert_array_equal(got, ref[f"gatepm{tick}"], err_msg=f"pm tick {tick}")
    # the wrapped ids gate differently from an unwrapped (int64) product
    ids = np.arange(N_GATE, dtype=np.int64)
    unwrapped = ((ids * 0x9E37) % 5 == 0)
    assert (unwrapped[53_022:] != ref["gatepm0"][53_022:]).any()


def test_pend_write(cases):
    """Delayed rows park in their (slot, lane, sender) cells; rows that
    are not delayed leave the lanes' claims where they are."""
    arrays, ref = cases
    for kind, seed in ((0, 1), (1, 2), (0, 3)):
        st, _ = _pend_state()
        pa = {f: torch.from_numpy(arrays[f"pw{seed}_{f}"])
              for f in ("d", "dly", "subj", "key", "valid", "recv")}
        out = tdelta._pend_write(st, kind, pa["d"], pa["dly"], pa["subj"], pa["key"],
                                 pa["valid"], pa["recv"])
        for f in ("pend_subj", "pend_key", "pend_recv"):
            np.testing.assert_array_equal(getattr(out, f).numpy(), ref[f"pend{seed}/{f}"],
                                          err_msg=f"{f}, kind {kind}")


def test_dense_park_drops_rows_not_delayed():
    """``_park`` aims rows that are not delayed at slot D - 1 where the
    reference drops them: on a filled buffer the result equals a drop-
    mode scatter-max, since those rows are zero and keys are >= 0."""
    rng = np.random.default_rng(6)
    dd, n = 4, 16
    buf = rng.integers(0, 1000, (dd, n, n)).astype(np.int32)
    tick = 7
    d = rng.integers(0, dd, n).astype(np.int32)
    dly = d > 0
    recv = rng.integers(0, n, n)
    rows = np.where(dly[:, None], rng.integers(0, 2000, (n, n)), 0).astype(np.int32)
    want = buf.copy()
    for s in range(n):
        if dly[s]:
            slot = (tick + d[s]) % dd
            want[slot, recv[s]] = np.maximum(want[slot, recv[s]], rows[s])
    got = torch.from_numpy(buf.copy())
    tsim._park(got, torch.tensor(tick, dtype=torch.int32), torch.from_numpy(d),
               torch.from_numpy(dly), torch.from_numpy(recv), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)


def test_empty_slot_matures_to_nothing():
    """The dense maturation runs every tick; on an empty slot it changes
    no view, budget or timer and applies nothing."""
    n = 12
    st = tsim.init_state(n, device="cpu")._replace(
        pending=torch.zeros((3, n, n), dtype=torch.int32))
    vk = st.view_key.clone()
    vk[2, 5] = 8 * 3 + tsim.SUSPECT
    st = st._replace(view_key=vk, suspect_left=torch.where(vk == 26, 4, -1).to(torch.int8))
    net = tsim.make_net(n, device="cpu")
    out, applied, flapped = tsim._mature(st, net, 9)
    assert int(applied) == 0 and flapped is None  # no damping planes, no flap mask
    for f in ("view_key", "pb", "suspect_left", "tick"):
        assert torch.equal(getattr(out, f), getattr(st, f)), f
    assert not out.pending.any() and out.pending is not st.pending


def test_convert_carries_the_fault_fields():
    """The buffers, link rules, period row, overload state, policy carry
    and provenance planes cross to the port and back unchanged (the
    packed knows words as uint32); a field no NetState has raises."""
    rng = np.random.default_rng(2)
    n = 6
    net = {"up": np.ones(n, bool), "responsive": np.ones(n, bool), "adj": None,
           "link_src": rng.random((2, n)) < 0.5, "link_dst": rng.random((2, n)) < 0.5,
           "link_p": np.array([0.3, 0.7], np.float32), "link_d": np.array([1, 0], np.int32),
           "link_j": np.array([0, 2], np.int32), "period": np.array([1, 2, 3, 1, 1, 6], np.int32),
           "ov_cnt": np.arange(n, dtype=np.int32), "ov_gray": np.arange(n) % 2 == 0,
           "po_press": np.arange(n, dtype=np.int32), "po_shed": np.arange(n) % 3 == 0,
           "po_quar": np.arange(n) % 2 == 1, "po_sends_w": np.arange(8, dtype=np.int32),
           "po_deliv_w": np.ones(8, np.int32), "po_retry_cap": np.array(1, np.int32),
           "pv_slot": np.array([[2, 18, 0, 1]], np.int32), "pv_tickv": np.array([[1, 4]], np.int16),
           "pv_wits": np.array([[3, -1]], np.int32),
           "pv_first": np.array([[-1, 2, 1, 3, 2, 2]], np.int16),
           "pv_parent": np.array([[-3, -1, 1, 2, -2, 1]], np.int32),
           "pv_knows": np.array([[0b111110]], np.uint32)}
    back = convert.net_to_numpy(convert.net_from_numpy(net, device="cpu"))
    for f, v in net.items():
        if v is None:
            assert back[f] is None
        else:
            assert back[f].dtype == v.dtype and (back[f] == v).all(), f
    dense = convert.state_to_numpy(tsim.init_state(n, device="cpu"))
    dense["pending"] = rng.integers(0, 99, (3, n, n)).astype(np.int32)
    got = convert.state_to_numpy(convert.state_from_numpy(dense, device="cpu"))
    assert (got["pending"] == dense["pending"]).all()
    delta = convert.delta_state_to_numpy(
        tdelta.install_pending(tdelta.init_delta(n, capacity=4, device="cpu"), 3, 2))
    got = convert.delta_state_to_numpy(convert.delta_state_from_numpy(delta, device="cpu"))
    for f in ("pend_subj", "pend_key", "pend_recv"):
        assert got[f].shape == delta[f].shape and (got[f] == delta[f]).all(), f
    with pytest.raises(NotImplementedError):
        convert.net_from_numpy({**net, "pv_bogus": np.zeros((1, 4), np.int32)}, device="cpu")
