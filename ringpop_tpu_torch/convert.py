"""Carry simulation state between the JAX package and the port.

The JAX package's ``ClusterState``/``DeltaState``/``NetState`` and a
``PRNGKey``, given as numpy arrays (e.g. ``{k: np.asarray(v) for k, v
in state._asdict().items()}``), become the port's tensors on a device, and
back.  The state is this system's "weights": with it, both sides run
from identical inputs.  The fault model's fields cross too: the
in-flight buffers (``pending``, ``pend_*``), the link rules
(``link_*``), the period row, the overload state (``ov_*``), the
policy carry (``po_*``) and the provenance plane (``pv_*``).  Packed
words, uint32 in the reference, are int64 holding the same bits in the
port.  A field that neither side's state type has raises.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ringpop_tpu_torch import resolve_device
from ringpop_tpu_torch.models.swim_delta import DeltaState
from ringpop_tpu_torch.models.swim_sim import ClusterState, NetState

# DeltaState planes that are uint32 in the reference and int64 holding
# the same 32-bit values in the port
_UINT32_FIELDS = ("bp_mask", "digest", "d_bpmask")
# and the NetState plane that is
_UINT32_NET_FIELDS = ("pv_knows",)


def _to_tensors(
    cls: type, fields: Mapping[str, Any], device: torch.device | str | None
) -> Any:
    dev = resolve_device(device)
    extra = sorted(k for k, v in fields.items() if k not in cls._fields and v is not None)
    if extra:
        raise NotImplementedError(f"{cls.__name__} has no fields {extra}")
    return cls(
        **{
            name: None if fields.get(name) is None
            else torch.as_tensor(np.array(fields[name])).to(dev)
            for name in cls._fields
        }
    )


def _to_numpy(obj: Any) -> dict[str, np.ndarray | None]:
    return {
        name: None if v is None else v.detach().cpu().numpy()
        for name, v in obj._asdict().items()
    }


def state_from_numpy(
    fields: Mapping[str, Any], device: torch.device | str | None = None
) -> ClusterState:
    """A JAX ``ClusterState`` (as a mapping of numpy arrays) on ``device``."""
    return _to_tensors(ClusterState, fields, device)


def _widen(fields: Mapping[str, Any], names: tuple[str, ...]) -> dict[str, Any]:
    """``fields`` with the uint32 planes ``names`` as int64 (same bits)."""
    return {
        k: np.asarray(v).astype(np.int64) if k in names and v is not None else v
        for k, v in fields.items()
    }


def _narrow(out: dict[str, np.ndarray | None], names: tuple[str, ...]) -> dict:
    """``out`` with the int64 planes ``names`` as the reference's uint32."""
    for k in names:
        if out[k] is not None:
            out[k] = out[k].astype(np.uint32)
    return out


def net_from_numpy(
    fields: Mapping[str, Any], device: torch.device | str | None = None
) -> NetState:
    """A JAX ``NetState`` (as a mapping of numpy arrays) on ``device``."""
    return _to_tensors(NetState, _widen(fields, _UINT32_NET_FIELDS), device)


def state_to_numpy(state: ClusterState) -> dict[str, np.ndarray | None]:
    """The port's state as numpy arrays under the reference's field names."""
    return _to_numpy(state)


def net_to_numpy(net: NetState) -> dict[str, np.ndarray | None]:
    """The port's net as numpy arrays under the reference's field names
    and dtypes."""
    return _narrow(_to_numpy(net), _UINT32_NET_FIELDS)


def delta_state_from_numpy(
    fields: Mapping[str, Any], device: torch.device | str | None = None
) -> DeltaState:
    """A JAX ``DeltaState`` (as a mapping of numpy arrays) on ``device``;
    None fields stay None and uint32 planes become int64 holding the
    same bits."""
    return _to_tensors(DeltaState, _widen(fields, _UINT32_FIELDS), device)


def delta_state_to_numpy(state: DeltaState) -> dict[str, np.ndarray | None]:
    """The port's delta state as numpy arrays under the reference's field
    names and dtypes (uint32 planes as uint32)."""
    return _narrow(_to_numpy(state), _UINT32_FIELDS)


def key_from_numpy(key: Any) -> torch.Tensor:
    """A raw ``uint32[2]`` PRNG key as the port's int64[2] key."""
    k = np.asarray(key)
    if k.shape != (2,):
        raise ValueError(f"a raw PRNG key has shape (2,), got {k.shape}")
    return torch.as_tensor(k.astype(np.int64))


def key_to_numpy(key: torch.Tensor) -> np.ndarray:
    return key.cpu().numpy().astype(np.uint32)
