"""The block-prefix lowerings that the dense and sparse steps take for
rows longer than ``_SPARSE_SMALL_N`` equal ``ringpop_tpu``'s exactly.

Both sides lower ``_SPARSE_SMALL_N`` to 1, which forces every large-row
branch at a small n, as the reference's ``tests/test_sparse_step.py``
does: the reference in its child process only (``"sparse_small_n"`` of
``test_torch_harness``), the port here with ``monkeypatch``.  Units:
``_block_prefix``, ``_capped_within``, ``_compact_rows`` and
``_choose_targets_and_witnesses``; then a sparse and a dense trajectory
through a kill at n = 24.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_harness import (
    assert_same_trajectory,
    flatten_outputs,
    run_port,
    run_reference,
    run_reference_calls,
)

from ringpop_tpu_torch import convert
from ringpop_tpu_torch.models import swim_sim as tsim

T1 = ["tick", 1]
FORCED = 1


def _mask(seed: int, rows: int = 20, cols: int = 150, p: float = 0.3) -> np.ndarray:
    return np.random.default_rng(seed).random((rows, cols)) < p


def _pingable() -> np.ndarray:
    m = _mask(3, rows=50, cols=50, p=0.4)
    np.fill_diagonal(m, False)
    return m


CAPS = [1, 4, 64]
SEEDS = [0, 1]


def _calls() -> tuple[list[dict], dict[str, np.ndarray]]:
    arrays = {"pingable": _pingable(), "key": np.array([0, 9], dtype=np.uint32)}
    calls = [{"name": "prefix", "module": "swim_sim", "fn": "_block_prefix",
              "args": [["array", "mask0"]], "sparse_small_n": FORCED}]
    for seed in SEEDS:
        arrays[f"mask{seed}"] = _mask(seed)
        for cap in CAPS:
            for fn in ("_capped_within", "_compact_rows"):
                calls.append({"name": f"{fn}/{seed}/{cap}", "module": "swim_sim", "fn": fn,
                              "args": [["array", f"mask{seed}"], ["py", cap]],
                              "sparse_small_n": FORCED})
    calls.append({"name": "choose", "module": "swim_sim", "fn": "_choose_targets_and_witnesses",
                  "args": [["array", "pingable"], ["py", 3], ["array", "key"]],
                  "sparse_small_n": FORCED})
    return calls, arrays


@pytest.fixture(scope="module")
def unit_reference(tmp_path_factory):
    calls, arrays = _calls()
    return run_reference_calls(calls, arrays, str(tmp_path_factory.mktemp("large_units")))


@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setattr(tsim, "_SPARSE_SMALL_N", FORCED)


def test_block_prefix(unit_reference, forced):
    got = flatten_outputs(tsim._block_prefix(torch.as_tensor(_mask(0))), "prefix", {})
    assert set(got) == {k for k in unit_reference if k.startswith("prefix/")}
    for k, v in got.items():
        np.testing.assert_array_equal(v, unit_reference[k], err_msg=k)
        assert v.dtype == unit_reference[k].dtype, k


@pytest.mark.parametrize("fn", ["_capped_within", "_compact_rows"])
@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("seed", SEEDS)
def test_large_row_passes(unit_reference, monkeypatch, fn, cap, seed):
    """Each pass equals the reference's large branch, and the port's own
    small branch too."""
    mask = torch.as_tensor(_mask(seed))
    small = getattr(tsim, fn)(mask, cap).numpy()
    monkeypatch.setattr(tsim, "_SPARSE_SMALL_N", FORCED)
    got = getattr(tsim, fn)(mask, cap).numpy()
    want = unit_reference[f"{fn}/{seed}/{cap}"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, small)


def test_choose_targets_large_branch(unit_reference, monkeypatch):
    """The block search picks what the reference's picks, and the valid
    picks equal the port's int16-prefix branch."""
    pingable = torch.as_tensor(_pingable())
    key = convert.key_from_numpy(np.array([0, 9], dtype=np.uint32))
    t0, v0, w0, wv0 = tsim._choose_targets_and_witnesses(pingable, 3, key)
    monkeypatch.setattr(tsim, "_SPARSE_SMALL_N", FORCED)
    t1, v1, w1, wv1 = tsim._choose_targets_and_witnesses(pingable, 3, key)
    for i, x in enumerate((t1, v1, w1, wv1)):
        np.testing.assert_array_equal(x.numpy(), unit_reference[f"choose/{i}"])
    np.testing.assert_array_equal(v0.numpy(), v1.numpy())
    np.testing.assert_array_equal(t0.numpy(), t1.numpy())
    wv = wv0.numpy()
    np.testing.assert_array_equal(w0.numpy()[wv], w1.numpy()[wv])


CASES = [
    {"name": "sparse24", "n": 24, "params": {"loss": 0.05, "suspicion_ticks": 5, "sparse_cap": 8},
     "seed": 5, "sparse_small_n": FORCED, "ops": [T1] * 3 + [["kill", 7]] + [T1] * 20},
    {"name": "dense24", "n": 24, "params": {"loss": 0.05, "suspicion_ticks": 5},
     "seed": 5, "sparse_small_n": FORCED, "ops": [T1] * 3 + [["kill", 7]] + [T1] * 20},
]
BY_NAME = {c["name"]: c for c in CASES}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(CASES, str(tmp_path_factory.mktemp("large_ref")))


@pytest.mark.parametrize("name", list(BY_NAME))
def test_forced_lowering_trajectory(reference, forced, name):
    case = BY_NAME[name]
    assert_same_trajectory(reference, case, run_port(case))
    # the kill was detected: someone declared node 7 faulty
    assert sum(int(v) for k, v in reference.items()
               if k.startswith(f"{name}/m") and k.endswith("/faulty_declared")) > 0

