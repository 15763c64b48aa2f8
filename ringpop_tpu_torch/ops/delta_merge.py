"""Sorted-insert merge of the delta tables (the ``_merge_claims`` insert).

Each viewer row of the delta state is a sorted, SENTINEL-padded table of
C slots in four channels (subject, key, piggyback count, suspicion
countdown).  ``merge_insert`` folds a sorted, SENTINEL-padded list of
``ki`` (subject, key) inserts into each row; live insert subjects are
absent from the row and fit its free slots.  Inserted slots get
piggyback 0 and countdown ``sl_start`` when the key's status is
``suspect`` (else -1); SENTINEL inserts that land in the table get -1
in both.

``merge_insert`` launches the CUDA kernel ``csrc/delta_merge.cu`` for
CUDA tensors (the port of the TPU kernel
``ringpop_tpu/ops/delta_merge_pallas.py``) and runs
``merge_insert_plain`` for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from ringpop_tpu_torch import _build
from ringpop_tpu_torch.obs import annotate

SENTINEL = (1 << 31) - 1


def _check(d_subj, d_key, d_pb, d_sl, ins_subj, ins_key) -> None:
    if d_subj.dim() != 2:
        raise TypeError(f"d_subj must be int32[N, C], got {list(d_subj.shape)}")
    n, c = d_subj.shape
    for name, t, dtype in (
        ("d_subj", d_subj, torch.int32),
        ("d_key", d_key, torch.int32),
        ("d_pb", d_pb, torch.int8),
        ("d_sl", d_sl, torch.int8),
    ):
        if t.dtype != dtype or t.shape != (n, c):
            raise TypeError(f"{name} must be {dtype}[{n}, {c}], got {t.dtype}{list(t.shape)}")
    if ins_subj.dim() != 2 or ins_subj.shape[0] != n or ins_subj.shape[1] < 1:
        raise TypeError(f"ins_subj must be int32[{n}, ki >= 1], got {list(ins_subj.shape)}")
    for name, t in (("ins_subj", ins_subj), ("ins_key", ins_key)):
        if t.dtype != torch.int32 or t.shape != ins_subj.shape:
            raise TypeError(
                f"{name} must be int32{list(ins_subj.shape)}, got {t.dtype}{list(t.shape)}"
            )
    if len({t.device for t in (d_subj, d_key, d_pb, d_sl, ins_subj, ins_key)}) != 1:
        raise ValueError("merge_insert's tensors must share a device")


def merge_insert_plain(
    d_subj: torch.Tensor,
    d_key: torch.Tensor,
    d_pb: torch.Tensor,
    d_sl: torch.Tensor,
    ins_subj: torch.Tensor,
    ins_key: torch.Tensor,
    *,
    sl_start: int,
    suspect: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the reference's sorted lowering (merged
    insert positions by searchsorted, then the merge inverted per output
    slot with two gathers)."""
    _check(d_subj, d_key, d_pb, d_sl, ins_subj, ins_key)
    n, cap = d_subj.shape
    ki = ins_subj.shape[1]
    dev = d_subj.device
    pos_ins = torch.searchsorted(d_subj, ins_subj).to(torch.int32) + torch.arange(
        ki, dtype=torch.int32, device=dev
    )
    out_j = torch.arange(cap, dtype=torch.int32, device=dev).expand(n, cap).contiguous()
    e = torch.searchsorted(pos_ins, out_j).to(torch.int64)  # inserts before slot j
    e_c = torch.clamp(e, max=ki - 1)
    is_ins = torch.gather(pos_ins, 1, e_c) == out_j
    x = torch.clamp(out_j.to(torch.int64) - e, max=cap - 1)  # existing slot feeding j
    m_subj = torch.where(is_ins, torch.gather(ins_subj, 1, e_c), torch.gather(d_subj, 1, x))
    m_key = torch.where(is_ins, torch.gather(ins_key, 1, e_c), torch.gather(d_key, 1, x))
    ins_at_j = is_ins & (m_subj < SENTINEL)
    neg = torch.tensor(-1, dtype=torch.int8, device=dev)
    m_pb = torch.where(
        is_ins,
        torch.where(ins_at_j, torch.tensor(0, dtype=torch.int8, device=dev), neg),
        torch.gather(d_pb, 1, x),
    )
    m_sl = torch.where(
        is_ins,
        torch.where(
            ins_at_j & ((m_key & 7) == suspect),
            torch.tensor(sl_start, dtype=torch.int8, device=dev),
            neg,
        ),
        torch.gather(d_sl, 1, x),
    )
    return m_subj, m_key, m_pb, m_sl


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("delta_merge")
        lib.rp_merge_insert.restype = ctypes.c_int
        lib.rp_merge_insert.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p
        ]
        lib.rp_merge_insert_needs_scratch.restype = ctypes.c_int
        lib.rp_merge_insert_needs_scratch.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def merge_insert(
    d_subj: torch.Tensor,
    d_key: torch.Tensor,
    d_pb: torch.Tensor,
    d_sl: torch.Tensor,
    ins_subj: torch.Tensor,
    ins_key: torch.Tensor,
    *,
    sl_start: int,
    suspect: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merged (subj, key, pb, sl) [N, C] tables.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (and count the launch
    in ``merge_insert.launches``, and by ``(C, ki)`` in
    ``merge_insert.shapes``) or raise."""
    _check(d_subj, d_key, d_pb, d_sl, ins_subj, ins_key)
    if not d_subj.is_cuda:
        if d_subj.device.type == "cpu":
            return merge_insert_plain(
                d_subj, d_key, d_pb, d_sl, ins_subj, ins_key, sl_start=sl_start, suspect=suspect
            )
        raise ValueError(f"merge_insert runs on cpu or cuda tensors, not {d_subj.device}")
    n, cap = d_subj.shape
    ki = ins_subj.shape[1]
    ins = [t if t.is_contiguous() else t.contiguous()
           for t in (d_subj, d_key, d_pb, d_sl, ins_subj, ins_key)]
    outs = [torch.empty_like(t) for t in ins[:4]]
    lib = _kernel()
    scratch = ins[4].new_empty((n, ki)) if lib.rp_merge_insert_needs_scratch(ki) else None
    args = (
        *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
        None if scratch is None else scratch.data_ptr(), n, cap, ki, int(sl_start), int(suspect),
    )
    # the raw stream handle and a device check stand in for a device guard
    # and a Stream object, unless the tensors lie on another card than the
    # current one
    index = ins[0].get_device()
    with annotate.scope("delta.merge_insert_pallas"):
        if index == torch._C._cuda_getDevice():
            rc = lib.rp_merge_insert(*args, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                rc = lib.rp_merge_insert(*args, torch._C._cuda_getCurrentRawStream(index))
    _build.check(rc, "merge_insert")
    merge_insert.launches += 1
    merge_insert.shapes[(cap, ki)] = merge_insert.shapes.get((cap, ki), 0) + 1
    return tuple(outs)


merge_insert.launches = 0
merge_insert.shapes = {}
