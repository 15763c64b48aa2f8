"""ringpop_tpu_torch: the SWIM membership simulator in PyTorch and CUDA.

A port of ``ringpop_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper card.  It imports torch, numpy and the standard library only:
nothing of JAX and nothing of ``ringpop_tpu``.  Module names mirror the
JAX package (``models/swim_sim.py``, ``models/cluster.py``,
``ops/recv_merge.py``, ...), so each function's reference is found
under the same path there.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card visible and no device given they raise rather than fall
back.  Each hand-written kernel (``csrc/*.cu``) has a plain PyTorch
version beside it, which runs only for tensors that lie on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names one; raises when no card is visible and none was named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the port "
            "on the host"
        )
    return torch.device("cuda")
