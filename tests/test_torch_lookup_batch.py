"""The port's masked ring lookups (``traffic/engine.py``) and
``SimCluster``'s lookup surface (``ring_for``, ``lookup``,
``traffic_ring``, ``lookup_batch``) against the reference, on both
backends.  The reference's ``traffic`` and ``models`` packages import
only in a patched child process (``test_torch_harness``): the engine's
functions run there through ``run_reference_calls``, the cluster's
through ``run_reference`` cases with ``"lookups"``.  Exact equality."""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from test_torch_harness import port_cluster, run_reference, run_reference_calls
from ringpop_tpu.ops import ring_ops as ref_ops
from ringpop_tpu.ops.farmhash import farmhash32 as ref_farmhash32
from ringpop_tpu_torch.ops import ring_ops
from ringpop_tpu_torch.ops.farmhash import farmhash32_batch
from ringpop_tpu_torch.traffic import engine

KEYS = [f"user:{i}" for i in range(50)]
_rng = random.Random(8)
WIDE_KEYS = [f"key-{_rng.randrange(10 ** 12)}" for _ in range(200)]
T1 = ["tick", 1]


def _case(name, n, backend, ops, viewers, keys=KEYS, **kw):
    return {"name": name, "n": n, "backend": backend, "ops": ops,
            "lookups": {"keys": keys, "viewers": viewers}, **kw}


CASES = []
for _b in ("dense", "delta"):
    CASES += [
        # tests/test_traffic.py's cases: a kill and 4 ticks, viewers 0
        # and 7; and a bootstrap view holding only the viewer
        _case(f"{_b}_kill", 10, _b, [["kill", 3], ["tick", 4]], [0, 7], seed=4),
        _case(f"{_b}_self", 10, _b, [], [2], seed=0, init="self"),
        # at n = 200 the viewer holds 1/200 of the replicas, so the
        # 256-wide walk misses for about a quarter of the keys and the
        # host ring resolves them
        _case(f"{_b}_self200", 200, _b, [], [2, 150], seed=0, init="self"),
        # suspects in the views: loss and a short suspicion window
        _case(f"{_b}_suspects", 48, _b,
              [T1, ["kill", 5], ["kill", 30], T1, T1, T1],
              [0, 5, 21], keys=WIDE_KEYS, seed=2,
              params={"loss": 0.2, "suspicion_ticks": 6}),
    ]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("lookup_ref")))


@pytest.fixture(scope="module")
def port():
    out = {}
    for case in CASES:
        c = port_cluster(case)
        for op in case["ops"]:
            if op[0] == "tick":
                c.tick(op[1])
            else:
                getattr(c, op[0])(*op[1:])
        out[case["name"]] = c
    return out


def _names(arr) -> list[str | None]:
    return [s or None for s in arr.tolist()]


@pytest.mark.parametrize("name", list(BY_NAME))
def test_traffic_ring_matches_reference(reference, port, name):
    ring = port[name].traffic_ring()
    assert ring is port[name].traffic_ring()  # built once
    np.testing.assert_array_equal(ring.hashes.numpy(), reference[f"{name}/traffic/hashes"])
    np.testing.assert_array_equal(ring.owners.numpy(), reference[f"{name}/traffic/owners"])


@pytest.mark.parametrize("name", list(BY_NAME))
def test_ring_for_matches_reference(reference, port, name):
    for v in BY_NAME[name]["lookups"]["viewers"]:
        ring = port[name].ring_for(v)
        assert [h for h, _ in ring._entries] == reference[f"{name}/ring{v}/hash"].tolist()
        assert [s for _, s in ring._entries] == reference[f"{name}/ring{v}/server"].tolist()
        assert ring.checksum == int(reference[f"{name}/ring{v}/checksum"]), (name, v)


@pytest.mark.parametrize("name", list(BY_NAME))
def test_lookup_and_lookup_batch_match_reference(reference, port, name):
    case = BY_NAME[name]
    keys = case["lookups"]["keys"]
    c = port[name]
    for v in case["lookups"]["viewers"]:
        want = _names(reference[f"{name}/lookup{v}"])
        assert [c.lookup(k, viewer=v) for k in keys] == want, (name, v)
        assert c.lookup_batch(keys, viewer=v) == want, (name, v)
        assert _names(reference[f"{name}/batch{v}"]) == want, (name, v)
    assert c.lookup_batch([], viewer=0) == []


@pytest.mark.parametrize("backend", ["dense", "delta"])
def test_self_view_falls_back_to_the_host_ring(port, backend):
    """With 1/200 of the replicas in the viewer's mask, some keys miss the
    256-wide walk; the host fallback keeps them equal to ``lookup``."""
    c = port[f"{backend}_self200"]
    ring = c.traffic_ring()
    in_ring = engine.in_ring_from_rows(c._device_rows(np.asarray([2]))[0])
    bufs, lens = ring_ops.encode_strings(KEYS)
    _, found = engine.lookup_masked_idx(
        ring.hashes, ring.owners, farmhash32_batch(torch.as_tensor(bufs), torch.as_tensor(lens)),
        in_ring, window=256)
    assert 0 < int((~found).sum()) < len(KEYS)
    assert set(c.lookup_batch(KEYS, viewer=2)) == {c.book.addresses[2]}


# ---------------------------------------------------------------------------
# the engine's functions, one call each, against the reference's
# ---------------------------------------------------------------------------

SERVERS = [f"10.0.0.{i}:{3000 + i}" for i in range(20)]
M = 300


def _engine_inputs() -> dict[str, np.ndarray]:
    ring = ref_ops.build_ring(SERVERS)
    rng = np.random.default_rng(12)
    hashes = np.array([ref_farmhash32(k) for k in WIDE_KEYS + KEYS + ["x"] * 50],
                      dtype=np.uint32)[:M]
    top = int(np.asarray(ring.hashes)[-1])
    hashes[:3] = [top + 1, top, int(np.asarray(ring.hashes)[0])]  # wrap and exact hits
    out = {"ring_hashes": np.asarray(ring.hashes), "ring_owners": np.asarray(ring.owners),
           "keys": hashes,
           "rows": rng.integers(0, 5, (6, 64)).astype(np.int32)
           + 8 * rng.integers(0, 1 << 20, (6, 64)).astype(np.int32)}
    for density in (0.0, 0.05, 0.3, 1.0):
        mask = rng.random((M, len(SERVERS))) < density
        mask[5] = False  # a key with an empty ring
        out[f"mask{density}"] = mask
    out["row_mask"] = rng.random(len(SERVERS)) < 0.2
    return out


ENGINE_CALLS = (
    [{"name": "in_ring", "module": "engine", "fn": "in_ring_from_rows",
      "args": [["array", "rows"]]}]
    + [{"name": f"masked/{d}/{w}", "module": "engine", "fn": "lookup_masked_idx",
        "args": [["array", "ring_hashes"], ["array", "ring_owners"], ["array", "keys"],
                 ["array", f"mask{d}"]], "kwargs": {"window": w}}
       for d in (0.0, 0.05, 0.3, 1.0) for w in (1, 4, 16, 256, 5000)]
    + [{"name": f"masked_n/{d}/{n}/{w}", "module": "engine", "fn": "lookup_n_masked_idx",
        "args": [["array", "ring_hashes"], ["array", "ring_owners"], ["array", "keys"],
                 ["array", f"mask{d}"], ["py", n]], "kwargs": {"window": w}}
       for d in (0.05, 0.3, 1.0) for n in (1, 3) for w in (8, 64)]
)


@pytest.fixture(scope="module")
def engine_reference(tmp_path_factory):
    arrays = _engine_inputs()
    return arrays, run_reference_calls(ENGINE_CALLS, arrays,
                                       str(tmp_path_factory.mktemp("engine_ref")))


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.tensor(x.astype(np.int64) if x.dtype == np.uint32 else x)


@pytest.mark.parametrize("call", ENGINE_CALLS, ids=[c["name"] for c in ENGINE_CALLS])
def test_engine_matches_reference(engine_reference, call):
    arrays, ref = engine_reference
    args = [_t(arrays[v]) if kind == "array" else v for kind, v in call["args"]]
    got = getattr(engine, call["fn"])(*args, **call.get("kwargs", {}))
    if call["fn"] == "in_ring_from_rows":
        np.testing.assert_array_equal(got.numpy(), ref[call["name"]])
        return
    for i, g in enumerate(got):
        want = ref[f"{call['name']}/{i}"]
        assert g.dtype == (torch.bool if want.dtype == bool else torch.int32)
        np.testing.assert_array_equal(g.numpy(), want, err_msg=f"{call['name']}/{i}")


def test_masked_lookup_by_one_row_equals_the_broadcast_mask(engine_reference):
    """A bool[S] mask (one viewer's row, as ``lookup_batch`` passes it)
    resolves as its [M, S] broadcast does in the reference's form."""
    arrays, _ = engine_reference
    row = torch.as_tensor(arrays["row_mask"])
    args = (_t(arrays["ring_hashes"]), _t(arrays["ring_owners"]), _t(arrays["keys"]))
    for w in (4, 256):
        one = engine.lookup_masked_idx(*args, row, window=w)
        full = engine.lookup_masked_idx(*args, row[None].expand(M, -1), window=w)
        assert torch.equal(one[0], full[0]) and torch.equal(one[1], full[1])
