"""Receiver merge: per-receiver lattice max of the delivered claim rows.

The dense step's hottest primitive (``models/swim_sim._receiver_merge``):
at phase 3 and in each ping-req slot of stages 5a-5c, every delivering
sender ``s`` contributes its claim row ``claim_rows[s]`` to receiver
``t_safe[s]``, and each receiver folds its inbound rows with an
elementwise int32 max.  Rows with no inbound ping are 0.

``recv_merge`` launches the CUDA kernels of ``csrc/recv_merge.cu`` for
CUDA tensors (the port of the TPU kernel
``ringpop_tpu/ops/recv_merge_pallas.py``): a counting sort of the senders
by receiver, then the merge.  It runs ``recv_merge_plain`` for CPU
tensors only.  ``recv_merge_pallas`` is the host-level entry under the
reference's name: the same merge, recorded as one row of the dispatch
ledger (``obs/ledger.py``) while the ledger is on; the steps call
``recv_merge`` itself, as the reference's steps inline its kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ringpop_tpu_torch import _build
from ringpop_tpu_torch.obs import annotate
from ringpop_tpu_torch.obs.ledger import default_ledger


def _check(t_safe: torch.Tensor, fwd_ok: torch.Tensor, claim_rows: torch.Tensor) -> int:
    n = t_safe.shape[0]
    if t_safe.dtype != torch.int64 or t_safe.dim() != 1:
        raise TypeError(f"t_safe must be int64[N], got {t_safe.dtype}{list(t_safe.shape)}")
    if fwd_ok.dtype != torch.bool or fwd_ok.shape != (n,):
        raise TypeError(f"fwd_ok must be bool[{n}], got {fwd_ok.dtype}{list(fwd_ok.shape)}")
    if claim_rows.dtype != torch.int32 or claim_rows.shape != (n, n):
        raise TypeError(
            f"claim_rows must be int32[{n}, {n}], got "
            f"{claim_rows.dtype}{list(claim_rows.shape)}"
        )
    if not (t_safe.device == fwd_ok.device == claim_rows.device):
        raise ValueError("t_safe, fwd_ok and claim_rows must share a device")
    return n


def recv_merge_plain(
    t_safe: torch.Tensor, fwd_ok: torch.Tensor, claim_rows: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: a scatter-max of the delivered rows (exact
    for ints, claim rows are >= 0) plus a count.  Silent senders go to a
    spare row ``n`` that is dropped."""
    n = _check(t_safe, fwd_ok, claim_rows)
    recv = torch.where(fwd_ok, t_safe, n)
    in_key = torch.zeros((n + 1, n), dtype=torch.int32, device=claim_rows.device)
    in_key = in_key.scatter_reduce(
        0, recv[:, None].expand(n, n), claim_rows, reduce="amax", include_self=True
    )
    inbound = torch.bincount(recv, minlength=n + 1)[:n].to(torch.int32)
    return in_key[:n], inbound


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("recv_merge")
        lib.rp_recv_merge_sort.restype = ctypes.c_int
        lib.rp_recv_merge_sort.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
        lib.rp_recv_merge.restype = ctypes.c_int
        lib.rp_recv_merge.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    return _lib


def _launch(t_safe, fwd_ok, claims, meta, out, n: int, index: int) -> None:
    lib = _kernel()
    stream = torch._C._cuda_getCurrentRawStream(index)
    order = meta.data_ptr()
    starts = order + 4 * n
    rc = lib.rp_recv_merge_sort(
        t_safe.data_ptr(), fwd_ok.data_ptr(), order, starts, starts + 4 * (n + 1), n, stream
    )
    _build.check(rc, "recv_merge (sort)")
    rc = lib.rp_recv_merge(order, starts, claims.data_ptr(), out.data_ptr(), n, stream)
    _build.check(rc, "recv_merge")


def recv_merge(
    t_safe: torch.Tensor, fwd_ok: torch.Tensor, claim_rows: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(in_key int32[N, N], inbound int32[N]).

    ``t_safe[s]`` (int64) is sender s's receiver, ``fwd_ok[s]`` whether
    its ping was delivered, ``claim_rows[s]`` its claims (int32, >= 0).
    CPU tensors take the plain version; CUDA tensors launch the kernels
    (and count the call in ``recv_merge.launches``) or raise.  While
    ``recv_merge.delivered`` is a list, each launch appends its count of
    delivering senders to it as a one-element device tensor (no host
    sync)."""
    n = _check(t_safe, fwd_ok, claim_rows)
    if not claim_rows.is_cuda:
        if claim_rows.device.type == "cpu":
            return recv_merge_plain(t_safe, fwd_ok, claim_rows)
        raise ValueError(f"recv_merge runs on cpu or cuda tensors, not {claim_rows.device}")
    t = t_safe if t_safe.is_contiguous() else t_safe.contiguous()
    ok = fwd_ok if fwd_ok.is_contiguous() else fwd_ok.contiguous()
    claims = claim_rows if claim_rows.is_contiguous() else claim_rows.contiguous()
    out = torch.empty_like(claims)
    # order [n], starts [n + 1] and inbound [n] in one int32 buffer
    meta = claims.new_empty(3 * n + 1)
    # the dense step calls this ~8 times a tick, so the host work before
    # the launches counts: a raw stream handle and a device check stand in
    # for a device guard and a Stream object, unless the tensors lie on
    # another card than the current one
    index = claims.get_device()
    with annotate.scope("swim.recv_merge_pallas"):
        if index == torch._C._cuda_getDevice():
            _launch(t, ok, claims, meta, out, n, index)
        else:
            with torch.cuda.device(index):
                _launch(t, ok, claims, meta, out, n, index)
    recv_merge.launches += 1
    if recv_merge.delivered is not None:
        recv_merge.delivered.append(meta[2 * n : 2 * n + 1])
    return out, meta[2 * n + 1 :]


recv_merge.launches = 0
recv_merge.delivered = None


def recv_merge_pallas(
    t_safe: torch.Tensor, fwd_ok: torch.Tensor, claim_rows: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``recv_merge`` called from the host: with the dispatch ledger on,
    one row under the reference's program name ``recv_merge_pallas``
    (meta: backend ``dense`` and ``n``); off, a plain call."""
    return default_ledger().dispatch(
        "recv_merge_pallas", recv_merge, t_safe, fwd_ok, claim_rows,
        _meta={"backend": "dense", "n": int(t_safe.shape[0])})
