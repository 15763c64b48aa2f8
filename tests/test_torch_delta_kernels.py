"""The delta backend's kernel modules against the JAX package's.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the Pallas kernels in interpret mode with exact equality (int32
positions, int32/int8 tables), on sorted, SENTINEL-padded rows with
duplicates, at the shapes the delta step gives them.  The bit-packing
helpers are held against ``ringpop_tpu/ops/bitpack.py``.  The CUDA
kernels are held against the plain versions by the card-only tests at
the end, which skip unless a card is visible, and by ``chip_smoke.py``.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ringpop_tpu.ops import bitpack as ref_bitpack
from ringpop_tpu.ops.delta_merge_pallas import merge_insert_pallas
from ringpop_tpu.ops.searchsorted_pallas import row_searchsorted_pallas
from ringpop_tpu_torch.ops import bitpack
from ringpop_tpu_torch.ops.delta_merge import SENTINEL, merge_insert, merge_insert_plain
from ringpop_tpu_torch.ops.searchsorted import row_searchsorted, row_searchsorted_plain
from test_torch_harness import REPO

SUSPECT = 2
SL_START = 26


def _sorted_rows(rng, n: int, c: int, span: int) -> np.ndarray:
    """Sorted int32 rows with duplicates and a SENTINEL tail of random
    length (a delta table's shape)."""
    rows = np.sort(rng.integers(0, span, (n, c)), axis=1).astype(np.int32)
    live = rng.integers(0, c + 1, n)
    rows[np.arange(c)[None, :] >= live[:, None]] = SENTINEL
    return rows


def _queries(rng, n: int, k: int, span: int) -> np.ndarray:
    q = rng.integers(-2, span + 2, (n, k)).astype(np.int32)
    q[rng.random((n, k)) < 0.1] = SENTINEL
    return q


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("n", [16, 64, 130])
@pytest.mark.parametrize("c", [1, 3, 8, 33, 64, 256])
@pytest.mark.parametrize("k", [5, 31, 33, 65, 256])
def test_row_searchsorted_plain_matches_pallas(side, n, c, k):
    rng = np.random.default_rng(1000 * n + 10 * c + k)
    table = _sorted_rows(rng, n, c, span=max(4, c // 2))
    q = _queries(rng, n, k, span=max(4, c // 2))
    want = np.asarray(row_searchsorted_pallas(table, q, side=side, interpret=True))
    got = row_searchsorted(torch.as_tensor(table), torch.as_tensor(q), side=side)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        row_searchsorted_plain(torch.as_tensor(table), torch.as_tensor(q), side=side).numpy(),
        want,
    )


def test_row_searchsorted_k_equals_c():
    """The converged check's shape: C queries per row of a C-wide table."""
    rng = np.random.default_rng(7)
    table = _sorted_rows(rng, 130, 130, span=200)
    q = np.broadcast_to(table[3], (130, 130)).copy()
    for side in ("left", "right"):
        want = np.asarray(row_searchsorted_pallas(table, q, side=side, interpret=True))
        got = row_searchsorted(torch.as_tensor(table), torch.as_tensor(q), side=side)
        np.testing.assert_array_equal(got.numpy(), want)


def test_row_searchsorted_checks_inputs():
    t = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        row_searchsorted(t.to(torch.int64), torch.zeros((4, 5), dtype=torch.int32))
    with pytest.raises(TypeError):
        row_searchsorted(t, torch.zeros((3, 5), dtype=torch.int32))
    with pytest.raises(ValueError):
        row_searchsorted(t, torch.zeros((4, 5), dtype=torch.int32), side="middle")


def _merge_case(rng, n: int, c: int, ki: int, full: bool = False):
    """Sorted tables with free slots, and sorted insert lists whose live
    subjects are absent from their row and fit its free slots: alive,
    suspect and faulty keys, SENTINEL padding, full rows (every row with
    ``full``)."""
    d_subj = np.full((n, c), SENTINEL, np.int32)
    d_key = np.zeros((n, c), np.int32)
    d_pb = np.full((n, c), -1, np.int8)
    d_sl = np.full((n, c), -1, np.int8)
    ins_subj = np.full((n, ki), SENTINEL, np.int32)
    ins_key = np.zeros((n, ki), np.int32)
    span = 4 * (c + ki)
    for i in range(n):
        occ = int(rng.integers(0, c + 1))
        if full or i % 7 == 0:
            occ = c  # a full row: nothing fits
        subj = np.sort(rng.choice(span, size=occ + min(ki, c - occ), replace=False))
        pick = np.zeros(subj.size, bool)
        pick[rng.choice(subj.size, size=subj.size - occ, replace=False)] = True
        have, new = subj[~pick], subj[pick]
        d_subj[i, :occ] = have
        d_key[i, :occ] = rng.integers(1, 1 << 20, occ) * 8 + rng.integers(1, 5, occ)
        d_pb[i, :occ] = rng.integers(-1, 30, occ)
        d_sl[i, :occ] = rng.integers(-1, 26, occ)
        m = new.size
        ins_subj[i, :m] = new
        ins_key[i, :m] = rng.integers(1, 1 << 20, m) * 8 + rng.choice([1, 2, 2, 3], m)
    return d_subj, d_key, d_pb, d_sl, ins_subj, ins_key


@pytest.mark.parametrize("n,c", [(16, 8), (64, 33), (130, 64)])
@pytest.mark.parametrize("ki_of", ["2", "17", "c+1"])
def test_merge_insert_plain_matches_pallas(n, c, ki_of):
    ki = c + 1 if ki_of == "c+1" else int(ki_of)
    rng = np.random.default_rng(n * 31 + c + ki)
    args = _merge_case(rng, n, c, ki)
    want = merge_insert_pallas(*args, sl_start=SL_START, suspect=SUSPECT, interpret=True)
    t_args = [torch.as_tensor(a) for a in args]
    got = merge_insert(*t_args, sl_start=SL_START, suspect=SUSPECT)
    plain = merge_insert_plain(*t_args, sl_start=SL_START, suspect=SUSPECT)
    for g, p, w, dtype in zip(got, plain, want, (torch.int32, torch.int32, torch.int8, torch.int8)):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))
    # the case has what it is for: suspect inserts (a countdown starts)
    # and SENTINEL inserts landing in rows with free slots
    assert (got[3].numpy() == SL_START).any()
    assert (args[4] == SENTINEL).any()


# where the kernel's design is likely to break: one slot, one insert, int8
# rows that start off a 16-byte boundary (C % 16 in {1, 15}), more inserts
# than slots, and every row full
_MERGE_EDGES = {
    "c1_ki1": (16, 1, 1, False), "c1": (16, 1, 5, False), "ki1": (16, 40, 1, False),
    "c17": (16, 17, 6, False), "c15": (16, 15, 9, False), "c31": (16, 31, 33, False),
    "full": (16, 33, 8, True),
}


@pytest.mark.parametrize("case", list(_MERGE_EDGES))
def test_merge_insert_edges_match_pallas(case):
    n, c, ki, full = _MERGE_EDGES[case]
    args = _merge_case(np.random.default_rng(c * 100 + ki), n, c, ki, full)
    want = merge_insert_pallas(*args, sl_start=SL_START, suspect=SUSPECT, interpret=True)
    got = merge_insert(*[torch.as_tensor(a) for a in args], sl_start=SL_START, suspect=SUSPECT)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if full:
        np.testing.assert_array_equal(got[0].numpy(), args[0])


def test_merge_insert_checks_inputs():
    args = [torch.as_tensor(a) for a in _merge_case(np.random.default_rng(0), 4, 8, 3)]
    with pytest.raises(TypeError):
        merge_insert(args[0], args[1], args[2].to(torch.int32), *args[3:],
                     sl_start=SL_START, suspect=SUSPECT)
    with pytest.raises(TypeError):
        merge_insert(*args[:4], args[4][:, :0], args[5][:, :0], sl_start=SL_START, suspect=SUSPECT)


def test_reference_kernel_modules_import_unpatched():
    """The Pallas kernels and the bit-packing helpers import in a plain
    process (no jax 0.9 patch), without loading ``ringpop_tpu.models``."""
    code = (
        "import sys\n"
        "import ringpop_tpu.ops.searchsorted_pallas, ringpop_tpu.ops.delta_merge_pallas\n"
        "import ringpop_tpu.ops.bitpack\n"
        "sys.exit(1 if any(m.startswith('ringpop_tpu.models') for m in sys.modules) else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO), timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("source", ["row_searchsorted", "delta_merge"])
def test_kernels_refuse_without_their_build(monkeypatch, source):
    """With no nvcc the delta kernels' build raises: a CUDA tensor never
    falls back to the plain version."""
    from ringpop_tpu_torch import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", os.path.join(REPO, "no-such-toolkit"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load(source)


@pytest.mark.parametrize("length", [1, 31, 32, 33, 100, 130])
def test_bitpack_matches_reference(length):
    rng = np.random.default_rng(length)
    mask = rng.random((3, length)) < 0.4
    want = np.asarray(ref_bitpack.pack_bits(mask))
    got = bitpack.pack_bits(torch.as_tensor(mask))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert bitpack.packed_width(length) == ref_bitpack.packed_width(length)
    np.testing.assert_array_equal(bitpack.unpack_bits(got, length).numpy(), mask)
    idx = rng.integers(0, length, (3, 7))
    np.testing.assert_array_equal(
        bitpack.bit_gather(got[1], torch.as_tensor(idx)).numpy(),
        np.asarray(ref_bitpack.bit_gather(want[1], idx)),
    )
    np.testing.assert_array_equal(
        bitpack.popcount_bits(got, dim=1).numpy(),
        np.asarray(ref_bitpack.popcount_bits(want, axis=1)),
    )
    assert int(bitpack.popcount_bits(got)) == int(mask.sum())


def test_popcount_of_full_words():
    words = torch.tensor([0, 1, 0xFFFFFFFF, 0x80000000, 0x55555555], dtype=torch.int64)
    assert bitpack.popcount_bits(words, dim=0).item() == 0 + 1 + 32 + 1 + 16


# ---------------------------------------------------------------------------
# card-only: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


@pytest.mark.parametrize("c", [1, 3, 33, 64, 256, 20000])
def test_row_searchsorted_kernel_on_card(c):
    """Rows that are not 16-byte aligned (C not a multiple of 4), K not a
    multiple of 4 or 32, K at and past the widths that share a warp
    between rows (8, 16), K > C, a row count that is not a multiple of
    the rows per block, and tables that start off a 16-byte boundary."""
    _need_card()
    rng = np.random.default_rng(c)
    rows = 257 if c == 20000 else 9001
    for k in (5, 8, 9, 16, 17, 31, 33, 64, 65, 256):
        table = torch.as_tensor(_sorted_rows(rng, rows, c, span=max(4, c // 2)), device="cuda")
        q = torch.as_tensor(_queries(rng, rows, k, span=max(4, c // 2)), device="cuda")
        shifted = torch.cat([table.reshape(-1)[:1], table.reshape(-1)])[1:].view(rows, c)
        for side in ("left", "right"):
            want = row_searchsorted_plain(table, q, side=side)
            for t in (table, shifted):
                got = row_searchsorted(t, q, side=side)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (c, k, side, t.data_ptr() % 16)


@pytest.mark.parametrize("ki", [2, 65, 20000])
def test_merge_insert_kernel_on_card(ki):
    _need_card()
    args = [torch.as_tensor(a, device="cuda")
            for a in _merge_case(np.random.default_rng(ki), 32, 64, ki)]
    got = merge_insert(*args, sl_start=SL_START, suspect=SUSPECT)
    torch.cuda.synchronize()
    for g, w in zip(got, merge_insert_plain(*args, sl_start=SL_START, suspect=SUSPECT)):
        assert torch.equal(g, w)


def _shifted(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` whose storage starts one element past ``t``'s."""
    flat = torch.cat([t.reshape(-1)[:1], t.reshape(-1)])
    return flat[1:].view(t.shape)


@pytest.mark.parametrize("case", list(_MERGE_EDGES) + ["wide"])
def test_merge_insert_edges_on_card(case):
    """The CPU edges over 4099 rows (not a multiple of the rows a block
    takes), rows too wide to stage (C = 5000), and each case again with
    every input starting one element past an aligned address."""
    _need_card()
    _, c, ki, full = _MERGE_EDGES.get(case, (0, 5000, 65, False))
    args = [torch.as_tensor(a, device="cuda")
            for a in _merge_case(np.random.default_rng(c + ki), 4099, c, ki, full)]
    want = merge_insert_plain(*args, sl_start=SL_START, suspect=SUSPECT)
    for inputs in (args, [_shifted(a) for a in args]):
        got = merge_insert(*inputs, sl_start=SL_START, suspect=SUSPECT)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w), (case, inputs[2].data_ptr() % 16)
