"""Receiver merge: per-receiver lattice max of the delivered claim rows.

The dense step's hottest primitive (``models/swim_sim._receiver_merge``):
at phase 3 and in each ping-req slot of stages 5a-5c, every delivering
sender ``s`` contributes its claim row ``claim_rows[s]`` to receiver
``t_safe[s]``, and each receiver folds its inbound rows with an
elementwise int32 max.  Rows with no inbound ping are 0.

``recv_merge`` launches the CUDA kernel ``csrc/recv_merge.cu`` for CUDA
tensors (the port of the TPU kernel ``ringpop_tpu/ops/recv_merge_pallas.py``)
and runs ``recv_merge_plain`` for CPU tensors only.  The flat prefix
(sort senders by receiver, run bounds by ``searchsorted``) stays in
torch, as the TPU kernel kept it outside ``pallas_call``.
"""

from __future__ import annotations

import ctypes

import torch

from ringpop_tpu_torch import _build


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
        lib.rp_recv_merge.restype = ctypes.c_int
        lib.rp_recv_merge.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    return _lib


def recv_merge(
    t_safe: torch.Tensor, fwd_ok: torch.Tensor, claim_rows: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(in_key int32[N, N], inbound int32[N]).

    ``t_safe[s]`` (int64) is sender s's receiver, ``fwd_ok[s]`` whether
    its ping was delivered, ``claim_rows[s]`` its claims (int32, >= 0).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and count the launch in ``recv_merge.launches``) or raise."""
    n = _check(t_safe, fwd_ok, claim_rows)
    dev = claim_rows.device
    if dev.type == "cpu":
        return recv_merge_plain(t_safe, fwd_ok, claim_rows)
    if dev.type != "cuda":
        raise ValueError(f"recv_merge runs on cpu or cuda tensors, not {dev}")
    claims = claim_rows.contiguous()
    if claims.data_ptr() % 16:  # the kernel's int4 loads need 16-byte rows
        claims = claims.clone()
    recv =torch.where(fwd_ok, t_safe, n)
    order = torch.argsort(recv, stable=True)
    starts = torch.searchsorted(
        recv[order], torch.arange(n + 1, dtype=torch.int64, device=dev)
    )
    inbound = (starts[1:] - starts[:-1]).to(torch.int32)
    order32 = order.to(torch.int32)
    starts32 = starts.to(torch.int32)
    out = torch.empty((n, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel().rp_recv_merge(
            order32.data_ptr(), starts32.data_ptr(), claims.data_ptr(),
            out.data_ptr(), n, stream,
        )
    _build.check(rc, "recv_merge")
    recv_merge.launches += 1
    return out, inbound


recv_merge.launches = 0
