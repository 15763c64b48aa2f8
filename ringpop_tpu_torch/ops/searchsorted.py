"""Row-wise searchsorted: insertion positions of K queries per sorted row.

The delta backend's wide lookups (``models/swim_delta._row_searchsorted``
at more than four queries per row): for each row ``n`` and query ``k``,
the count of ``table[n, c] < queries[n, k]`` (side "left") or ``<=``
(side "right").  Every caller passes rows sorted ascending, so the count
is the insertion position.

``row_searchsorted`` launches the CUDA kernel ``csrc/row_searchsorted.cu``
for CUDA tensors (the port of the TPU kernel
``ringpop_tpu/ops/searchsorted_pallas.py``) and runs
``row_searchsorted_plain`` for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from ringpop_tpu_torch import _build

# Compare-cube elements per chunk of the plain version (int64 counts of
# [rows, K, C] booleans), so it never builds a 65536 x 64 x 256 cube.
_PLAIN_CHUNK = 1 << 24


def _check(table: torch.Tensor, queries: torch.Tensor, side: str) -> None:
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    if table.dtype != torch.int32 or table.dim() != 2:
        raise TypeError(f"table must be int32[N, C], got {table.dtype}{list(table.shape)}")
    if queries.dtype != torch.int32 or queries.dim() != 2 or queries.shape[0] != table.shape[0]:
        raise TypeError(
            f"queries must be int32[{table.shape[0]}, K], got "
            f"{queries.dtype}{list(queries.shape)}"
        )
    if table.device != queries.device:
        raise ValueError("table and queries must share a device")


def row_searchsorted_plain(
    table: torch.Tensor, queries: torch.Tensor, side: str = "left"
) -> torch.Tensor:
    """Plain PyTorch version: the TPU kernel's broadcast compare-count,
    in row chunks."""
    _check(table, queries, side)
    n, c = table.shape
    k = queries.shape[1]
    rows = max(1, _PLAIN_CHUNK // max(1, k * c))
    out = []
    for lo in range(0, n, rows):
        t = table[lo : lo + rows, None, :]
        q = queries[lo : lo + rows, :, None]
        cmp = (t <= q) if side == "right" else (t < q)
        out.append(cmp.sum(dim=-1, dtype=torch.int32))
    if not out:
        return torch.zeros((0, k), dtype=torch.int32, device=table.device)
    return torch.cat(out)


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("row_searchsorted")
        lib.rp_row_searchsorted.restype = ctypes.c_int
        lib.rp_row_searchsorted.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p
        ]
        _lib = lib
    return _lib


def _launch(t, q, out, right: bool, index: int) -> None:
    n, c = t.shape
    rc = _kernel().rp_row_searchsorted(
        t.data_ptr(), q.data_ptr(), out.data_ptr(), n, c, q.shape[1], right,
        torch._C._cuda_getCurrentRawStream(index),
    )
    _build.check(rc, "row_searchsorted")


def row_searchsorted(
    table: torch.Tensor, queries: torch.Tensor, side: str = "left"
) -> torch.Tensor:
    """int32[N, K] insertion positions of ``queries`` in the sorted rows
    of ``table`` (int32[N, C]).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (and count the launch in
    ``row_searchsorted.launches``, and by ``(C, K)`` in
    ``row_searchsorted.shapes``) or raise."""
    _check(table, queries, side)
    if not table.is_cuda:
        if table.device.type == "cpu":
            return row_searchsorted_plain(table, queries, side)
        raise ValueError(f"row_searchsorted runs on cpu or cuda tensors, not {table.device}")
    t = table if table.is_contiguous() else table.contiguous()
    q = queries if queries.is_contiguous() else queries.contiguous()
    out = torch.empty_like(q)
    # The delta step calls this ~26 times a tick, mostly at device times
    # of tens of microseconds, so the host work before the launch counts:
    # a raw stream handle and a device check stand in for a device guard
    # and a Stream object, which take more host time than the launch
    # itself, unless the tensors lie on another card than the current one.
    index = t.get_device()
    if index == torch._C._cuda_getDevice():
        _launch(t, q, out, side == "right", index)
    else:
        with torch.cuda.device(index):
            _launch(t, q, out, side == "right", index)
    row_searchsorted.launches += 1
    shape = (t.shape[1], q.shape[1])
    row_searchsorted.shapes[shape] = row_searchsorted.shapes.get(shape, 0) + 1
    return out


row_searchsorted.launches = 0
row_searchsorted.shapes = {}
