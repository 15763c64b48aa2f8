"""The port's kernel modules against the JAX package's TPU kernels.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the Pallas kernels in interpret mode and the host FarmHash,
with exact equality (integer lattice keys and uint32 hashes).  The
CUDA kernels themselves are held against the plain versions by the
tests marked below, which skip unless a card is visible, and by
``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ringpop_tpu.ops.farmhash import farmhash32 as ref_farmhash32
from ringpop_tpu.ops.farmhash_pallas import farmhash32_batch_pallas
from ringpop_tpu.ops.recv_merge_pallas import recv_merge_pallas
from ringpop_tpu_torch.models import checksum as tck
from ringpop_tpu_torch.ops import checksum_device as tckdev
from ringpop_tpu_torch.ops import farmhash as tfh
from ringpop_tpu_torch.ops.recv_merge import recv_merge, recv_merge_plain


def _merge_case(n: int, deliver: float, seed: int):
    rng = np.random.default_rng(seed)
    fwd_ok = rng.random(n) < deliver
    t_safe = np.where(fwd_ok, rng.integers(0, n, n), 0).astype(np.int32)
    claims = (rng.integers(0, 1 << 20, (n, n)) * (rng.random((n, n)) < 0.4)).astype(np.int32)
    return t_safe, fwd_ok, np.where(fwd_ok[:, None], claims, 0)


def _torch_args(t_safe, fwd_ok, claims, device="cpu"):
    return (
        torch.as_tensor(t_safe, dtype=torch.int64, device=device),
        torch.as_tensor(fwd_ok, device=device),
        torch.as_tensor(claims, device=device),
    )


@pytest.mark.parametrize("n", [16, 64, 130])
@pytest.mark.parametrize("deliver", [0.0, 0.5, 1.0])
def test_recv_merge_plain_matches_pallas(n, deliver):
    t_safe, fwd_ok, claims = _merge_case(n, deliver, 100 * n + int(10 * deliver))
    want_k, want_i = recv_merge_pallas(t_safe, fwd_ok, claims, interpret=True)
    got_k, got_i = recv_merge_plain(*_torch_args(t_safe, fwd_ok, claims))
    assert got_k.dtype == torch.int32 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_recv_merge_all_to_one():
    n = 40
    rng = np.random.default_rng(5)
    t_safe = np.full(n, 3, np.int32)
    fwd_ok = np.ones(n, bool)
    claims = rng.integers(0, 1 << 20, (n, n)).astype(np.int32)
    want_k, want_i = recv_merge_pallas(t_safe, fwd_ok, claims, interpret=True)
    got_k, got_i = recv_merge(*_torch_args(t_safe, fwd_ok, claims))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert int(got_i[3]) == n and int(got_i.sum()) == n


def _edge_case(case: str):
    """Where the kernels' designs are likely to break: one, four and five
    senders (rows narrower than a 16-byte vector, or not a multiple of
    it), every sender silent, and every sender to one receiver (one run
    of length n).  Silent senders' claim rows are not zero, so a merge
    that reads them shows."""
    rng = np.random.default_rng(len(case))
    n = {"n1": 1, "n4": 4, "n5": 5, "silent": 37, "all_to_one": 33}[case]
    claims = rng.integers(0, 1 << 20, (n, n)).astype(np.int32)
    t_safe = rng.integers(0, n, n).astype(np.int32)
    fwd_ok = rng.random(n) < 0.8
    if case == "n1":
        fwd_ok[:] = True
    elif case == "silent":
        fwd_ok[:] = False
    elif case == "all_to_one":
        t_safe[:] = n - 1
        fwd_ok[:] = True
    return t_safe, fwd_ok, claims


_EDGES = ["n1", "n4", "n5", "silent", "all_to_one"]


@pytest.mark.parametrize("case", _EDGES)
def test_recv_merge_edges_match_pallas(case):
    t_safe, fwd_ok, claims = _edge_case(case)
    want_k, want_i = recv_merge_pallas(t_safe, fwd_ok, claims, interpret=True)
    got_k, got_i = recv_merge(*_torch_args(t_safe, fwd_ok, claims))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert int(got_i.sum()) == int(fwd_ok.sum())


def test_recv_merge_wrapper_checks_inputs():
    t, f, c = _torch_args(*_merge_case(8, 0.5, 1))
    with pytest.raises(TypeError):
        recv_merge(t.to(torch.int32), f, c)
    with pytest.raises(TypeError):
        recv_merge(t, f, c.to(torch.int64))
    with pytest.raises(TypeError):
        recv_merge(t, f, c[:, :4])


def _hash_batch(lengths, width, seed):
    rng = np.random.default_rng(seed)
    bufs = np.zeros((len(lengths), width), np.uint8)
    for i, n in enumerate(lengths):
        bufs[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    return bufs, np.asarray(lengths, np.int32)


@pytest.mark.parametrize(
    "lengths",
    [list(range(0, 5)), list(range(5, 13)), list(range(13, 25)), list(range(25, 200, 7)),
     list(range(20, 66))],
    ids=["0-4", "5-12", "13-24", "long", "20-65"],
)
def test_farmhash_plain_matches_host_and_pallas(lengths):
    width = max(max(lengths), 25)
    bufs, lens = _hash_batch(lengths, width, seed=len(lengths))
    got = tfh.farmhash32_batch(torch.as_tensor(bufs), torch.as_tensor(lens)).numpy()
    pallas = np.asarray(farmhash32_batch_pallas(bufs, lens, interpret=True)).astype(np.int64)
    host = np.array([ref_farmhash32(bufs[i, :n].tobytes()) for i, n in enumerate(lens)])
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, pallas)
    own = np.array([tfh.farmhash32(bufs[i, :n].tobytes()) for i, n in enumerate(lens)])
    np.testing.assert_array_equal(own, host)


@pytest.mark.parametrize("width", [47, 333, 4097])
def test_farmhash_row_strided_batch(width):
    """Rows cut from a [R, W + 1] buffer (odd W, so the row stride W + 1
    is not W) hash as their contiguous copy and as the host oracle."""
    rng = np.random.default_rng(width)
    wide = rng.integers(0, 256, (9, width + 1), dtype=np.uint8)
    lens = np.array([0, 4, 24, 25, 44, 45, width - 1, width, width // 2], np.int32)
    cut = torch.as_tensor(wide)[:, :width]
    assert cut.stride(0) == width + 1
    got = tfh.farmhash32_batch(cut, torch.as_tensor(lens)).numpy()
    flat = tfh.farmhash32_batch(cut.contiguous(), torch.as_tensor(lens)).numpy()
    host = np.array([ref_farmhash32(wide[i, :n].tobytes()) for i, n in enumerate(lens)])
    np.testing.assert_array_equal(got, flat)
    np.testing.assert_array_equal(got, host)


def test_farmhash_known_vector():
    assert tfh.farmhash32(b"test") == 1633095781 == ref_farmhash32(b"test")


def test_farmhash_random_lengths_long_rows():
    rng = np.random.default_rng(11)
    lengths = rng.integers(0, 2000, 64).tolist()
    bufs, lens = _hash_batch(lengths, 2000, seed=3)
    got = tfh.farmhash32_plain(torch.as_tensor(bufs), torch.as_tensor(lens)).numpy()
    host = np.array([ref_farmhash32(bufs[i, :n].tobytes()) for i, n in enumerate(lens)])
    np.testing.assert_array_equal(got, host)


def test_mul32_wraps_like_uint32():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32)
    for c in (0xCC9E2D51, 0x1B873593, 0x85EBCA6B, 0xC2B2AE35, 5):
        want = (a * np.uint32(c)).astype(np.int64)
        got = tfh.mul32(torch.as_tensor(a.astype(np.int64)), c).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [5, 64])
def test_device_checksums_match_host(n):
    """String assembly on tensors + the FarmHash wrapper == the host
    oracle built in Python, over rows with every status and absent
    members, and across row chunks."""
    rng = np.random.default_rng(n)
    status = rng.choice([0, 1, 2, 3, 4], size=(n, n))
    inc = rng.integers(0, (1 << 27) - 1, (n, n))
    keys = np.where(status > 0, inc * 8 + status, 0).astype(np.int32)
    book = tck.AddressBook(tck.default_addresses(n))
    base = 1_400_000_000_000
    host = tck.view_checksums_packed(book, keys, base)
    dbook = tckdev.DeviceBook(book.addresses, base, device="cpu")
    got = tckdev.view_checksums_device(dbook, torch.as_tensor(keys))
    np.testing.assert_array_equal(got.numpy(), host.astype(np.int64))
    chunked = tckdev.view_checksums_device(
        dbook, torch.as_tensor(keys), max_elements=2 * n * dbook.entry_width
    )
    np.testing.assert_array_equal(chunked.numpy(), host.astype(np.int64))
    # the host oracle itself is the reference string format
    row = keys[0]
    parts = [
        f"{book.addresses[j]}{tck.STATUS_NAMES[row[j] & 7]}{base + int(row[j] >> 3)}"
        for j in book.sorted_order if row[j] & 7
    ]
    assert host[0] == ref_farmhash32(";".join(parts).encode())


def test_row_strings_are_the_reference_strings():
    n = 12
    keys = np.full((2, n), 8 * 3 + 1, np.int32)
    keys[1, 4] = 0
    keys[1, 7] = 8 * 5000 + 2
    dbook = tckdev.DeviceBook(tck.default_addresses(n), 1_400_000_000_000, device="cpu")
    bufs, lens = tckdev.row_strings(dbook, torch.as_tensor(keys))
    book = tck.AddressBook(tck.default_addresses(n))
    for r in range(2):
        parts = [
            f"{book.addresses[j]}{tck.STATUS_NAMES[keys[r, j] & 7]}"
            f"{1_400_000_000_000 + int(keys[r, j] >> 3)}"
            for j in book.sorted_order if keys[r, j]
        ]
        want = ";".join(parts).encode()
        assert bytes(bufs[r, : int(lens[r])].numpy()) == want


# ---------------------------------------------------------------------------
# card-only: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


@pytest.mark.parametrize("n", [16, 64, 130, 1000])
def test_recv_merge_kernel_on_card(n):
    _need_card()
    args = _torch_args(*_merge_case(n, 0.7, n), device="cuda")
    got = recv_merge(*args)
    want = recv_merge_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("case", _EDGES + ["unaligned", "n32768", "n32769"])
def test_recv_merge_edges_on_card(case):
    """The CPU edges, claim rows from a view that starts 4 bytes past a
    16-byte boundary (the scalar path), and n at and past the receivers
    one pass of the counting sort holds (32768)."""
    _need_card()
    if case.startswith("n3"):
        n = int(case[1:])
        gen = torch.Generator(device="cuda").manual_seed(n)
        fwd_ok = torch.rand(n, generator=gen, device="cuda") < 0.05
        t_safe = torch.randint(0, n, (n,), generator=gen, device="cuda")
        t_safe[:64] = n - 1  # one long run at the last receiver
        fwd_ok[:64] = True
        claims = torch.zeros((n, n), dtype=torch.int32, device="cuda")
        rows = fwd_ok.nonzero()[:, 0]
        claims[rows] = torch.randint(0, 1 << 20, (rows.numel(), n), generator=gen,
                                     device="cuda", dtype=torch.int32)
        args = (t_safe, fwd_ok, claims)
    elif case == "unaligned":
        t, f, c = _torch_args(*_merge_case(1001, 0.7, 3), device="cuda")
        flat = torch.zeros(c.numel() + 1, dtype=torch.int32, device="cuda")
        flat[1:] = c.reshape(-1)
        args = (t, f, flat[1:].view(c.shape))
        assert args[2].data_ptr() % 16 == 4
    else:
        args = _torch_args(*_edge_case(case), device="cuda")
    got = recv_merge(*args)
    want = recv_merge_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), case


def test_farmhash_kernel_on_card():
    """Every length arm; then odd row strides (rows cut from [R, W + 1]
    buffers and contiguous odd widths, so row starts take every byte
    phase) at lengths on the arm, block and shared-memory tile edges (a
    tile is ``TILE_BLOCKS`` 20-byte blocks), 0 and the full width."""
    _need_card()
    bufs, lens = _hash_batch(list(range(0, 300)), 300, seed=9)
    b, l_ = torch.as_tensor(bufs, device="cuda"), torch.as_tensor(lens, device="cuda")
    got = tfh.farmhash32_batch(b, l_)
    torch.cuda.synchronize()
    assert torch.equal(got, tfh.farmhash32_plain(b, l_))
    rng = np.random.default_rng(10)
    tile = 20 * tfh.TILE_BLOCKS
    edges = [0, 1, 4, 5, 12, 13, 24, 25, 44, 45, 64, 65,
             tile - 1, tile, tile + 1, tile + 20, tile + 21, 2 * tile + 1]
    for width in (4097, 4 * tile + 1):
        lens = np.array([x for x in edges if x <= width] + [width - 1, width], np.int32)
        wide = torch.as_tensor(
            rng.integers(0, 256, (lens.size, width + 1), dtype=np.uint8), device="cuda"
        )
        l_ = torch.as_tensor(lens, device="cuda")
        for rows in (wide[:, :width], wide[:, :width].contiguous()):
            got = tfh.farmhash32_batch(rows, l_)
            torch.cuda.synchronize()
            assert torch.equal(got, tfh.farmhash32_plain(rows, l_)), (width, rows.stride(0))
            host = rows.cpu().numpy()
            assert got.tolist() == [ref_farmhash32(host[i, :n].tobytes())
                                    for i, n in enumerate(lens)]


def test_farmhash_short_path_on_card():
    """The short-row kernel (every row at most 24 bytes) against the plain
    version: every length 0-24, rows cut at an odd stride, rows starting
    one byte past alignment, a replica-name batch [1000, 25]; a batch
    that mixes in one 25-byte row takes the warp kernel."""
    _need_card()
    rng = np.random.default_rng(24)
    lens = torch.as_tensor(np.tile(np.arange(25, dtype=np.int32), 40), device="cuda")
    wide = torch.as_tensor(rng.integers(0, 256, (lens.numel(), 32), dtype=np.uint8),
                           device="cuda")
    flat = torch.as_tensor(rng.integers(0, 256, lens.numel() * 27 + 1, dtype=np.uint8),
                           device="cuda")
    shifted = flat[1:].view(lens.numel(), 27)
    assert shifted.data_ptr() % 16 == 1
    names = [f"127.0.0.1:{10000 + i // 100}{i % 100}".encode() for i in range(1000)]
    nb = torch.as_tensor(np.array([list(b.ljust(25, b"\0")) for b in names], np.uint8),
                         device="cuda")
    nl = torch.as_tensor([len(b) for b in names], dtype=torch.int32, device="cuda")
    for what, rows, l_ in (("contiguous", wide[:, :25].contiguous(), lens),
                           ("odd stride", wide[:, :25], lens), ("unaligned", shifted, lens),
                           ("names", nb, nl)):
        short, warp = tfh.farmhash32_batch.short_launches, tfh.farmhash32_batch.launches
        got = tfh.farmhash32_batch(rows, l_)
        torch.cuda.synchronize()
        assert tfh.farmhash32_batch.short_launches == short + 1, what
        assert tfh.farmhash32_batch.launches == warp, what
        assert torch.equal(got, tfh.farmhash32_plain(rows, l_)), what
    mixed = lens.clone()
    mixed[7] = 25
    warp = tfh.farmhash32_batch.launches
    got = tfh.farmhash32_batch(wide[:, :25], mixed)
    torch.cuda.synchronize()
    assert tfh.farmhash32_batch.launches == warp + 1
    assert torch.equal(got, tfh.farmhash32_plain(wide[:, :25], mixed))


class _StubLib:
    """A kernel library whose entry points record their calls and launch
    nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append(name) or 0


@pytest.mark.parametrize("longest,entry", [(0, "rp_farmhash32_short"),
                                           (24, "rp_farmhash32_short"),
                                           (25, "rp_farmhash32"), (300, "rp_farmhash32")])
def test_farmhash_wrapper_picks_the_path_by_the_longest_row(monkeypatch, longest, entry):
    """The launch step of ``farmhash32_batch`` (run here on CPU tensors
    with the C entry points stubbed): the short-row kernel when no row is
    longer than 24 bytes, the warp kernel otherwise, each counted apart;
    out-of-range lengths raise before any launch."""
    stub = _StubLib()
    monkeypatch.setattr(tfh, "_kernel", lambda: stub)
    bufs = torch.zeros((6, 300), dtype=torch.uint8)
    lens = torch.tensor([3, 0, 24, 17, 5, longest], dtype=torch.int32)
    short, warp = tfh.farmhash32_batch.short_launches, tfh.farmhash32_batch.launches
    out = tfh._launch(bufs, lens, 0)
    assert stub.calls == [entry]
    assert out.shape == (6,) and out.dtype == torch.int64
    short_now = entry == "rp_farmhash32_short"
    assert tfh.farmhash32_batch.short_launches == short + short_now
    assert tfh.farmhash32_batch.launches == warp + (not short_now)
    with pytest.raises(ValueError):
        tfh._launch(bufs, torch.tensor([0, 0, 0, 0, 0, 301], dtype=torch.int32), 0)
    assert tfh._launch(bufs[:0], lens[:0], 0).shape == (0,)
    assert stub.calls == [entry]
