"""Simulation checkpoints: save and resume a ``SimCluster``.

The port of ``ringpop_tpu/checkpoint.py``, format v5, reading versions
2-5.  One ``.npz`` holds every ``ClusterState``/``DeltaState`` and
``NetState`` field (``state.{name}``, ``net.{name}``) under the
reference's names and dtypes (the delta backend's packed planes as
uint32), the PRNG key as uint32[2], the address book as strings, the
params, caps and base incarnation, the telemetry (``metrics_log`` and
each scenario trace as ``trace{i}.*``) and, mid-stream, the cursor of a
streamed run.  Either package loads the other's files.

``save -> load -> tick(k)`` continues bit-identically: the key is part
of the checkpoint and ``SimCluster`` splits it as before.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from ringpop_tpu_torch import convert, resolve_device
from ringpop_tpu_torch.models import swim_delta as sdelta
from ringpop_tpu_torch.models.cluster import SimCluster
from ringpop_tpu_torch.models.swim_delta import DeltaState
from ringpop_tpu_torch.models.swim_sim import ClusterState, NetState, SwimParams
from ringpop_tpu_torch.ops import bitpack
from ringpop_tpu_torch.scenarios.trace import Trace

# v2: packed view_key/pb/suspect_left state layout
# v3: + delta backend (DeltaState fields, resource caps in meta)
# v4: + telemetry (metrics_log in meta, scenario traces as trace{i}.*)
# v5: + streaming cursor ("stream" in meta, scenarios/stream.py)
FORMAT_VERSION = 5
_READABLE_VERSIONS = (2, 3, 4, 5)


def save(
    cluster: SimCluster,
    path: str,
    *,
    stream: dict[str, Any] | None = None,
    state: Any | None = None,
    net: NetState | None = None,
) -> None:
    """Write a self-contained checkpoint of ``cluster``, atomically
    (through ``path + ".tmp"``).  ``stream`` (a JSON-able cursor) marks a
    streamed run's segment boundary; ``state``/``net`` stand in for the
    cluster's own (the streamed runner checkpoints the copy it took at
    the boundary)."""
    state = cluster.state if state is None else state
    net = cluster.net if net is None else net
    delta = cluster.backend == "delta"
    meta = {
        "version": FORMAT_VERSION,
        "params": cluster.params._asdict(),
        "base_inc": cluster.base_inc,
        "n": cluster.n,
        "backend": cluster.backend,
        "caps": {
            "capacity": state.capacity if delta else 0,
            "wire_cap": cluster.dparams.wire_cap,
            "claim_grid": cluster.dparams.claim_grid,
        },
        "metrics_log": cluster.metrics_log,
        "traces": [t.meta() for t in cluster.traces],
    }
    if stream is not None:
        meta["stream"] = stream
    arrays: dict[str, np.ndarray] = {
        "meta": np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        "key": convert.key_to_numpy(cluster.key),
        "addresses": np.asarray(cluster.book.addresses, dtype=np.str_),
    }
    for i, trace in enumerate(cluster.traces):
        arrays.update(trace.to_arrays(prefix=f"trace{i}."))
    fields = convert.delta_state_to_numpy(state) if delta else convert.state_to_numpy(state)
    arrays.update({f"state.{k}": v for k, v in fields.items() if v is not None})
    arrays.update({f"net.{k}": v for k, v in convert.net_to_numpy(net).items() if v is not None})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    os.replace(tmp, path)  # atomic: never a torn checkpoint


def _fields(data: Any, cls: type, prefix: str) -> dict[str, np.ndarray | None]:
    """The ``prefix.*`` arrays of ``cls``'s fields; an absent field with
    a None default is None, and any other field that is absent raises."""
    optional = {name for name, d in cls._field_defaults.items() if d is None}
    out: dict[str, np.ndarray | None] = {}
    for name in cls._fields:
        key = f"{prefix}.{name}"
        if key in data:
            out[name] = data[key]
        elif name in optional:
            out[name] = None
        else:
            raise KeyError(f"checkpoint missing required array {key}")
    # a field neither package's state type has reaches the converter,
    # which refuses it
    for key in data.files:
        if key.startswith(prefix + ".") and key[len(prefix) + 1:] not in out:
            out[key[len(prefix) + 1:]] = data[key]
    return out


def _packed(plane: np.ndarray | None) -> np.ndarray | None:
    """A bool plane of a checkpoint written before the planes were packed,
    as its uint32 words (packed planes pass through)."""
    if plane is None or plane.dtype != np.bool_:
        return plane
    return bitpack.pack_bits(torch.from_numpy(plane)).numpy().astype(np.uint32)


def load(path: str, device: torch.device | str | None = None) -> SimCluster:
    """A ``SimCluster`` on ``device`` (``cuda`` unless named) that
    continues the checkpointed run exactly."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        if meta["version"] not in _READABLE_VERSIONS:
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        param_dict = dict(meta["params"])
        if meta["version"] == 2:
            # fields added after v2 resume with the defaults in force when
            # the checkpoint ran (probe was "uniform" then)
            param_dict.setdefault("probe", "uniform")
        params = SwimParams(**param_dict)
        backend = meta.get("backend", "dense")  # v2 checkpoints are dense
        caps = meta.get("caps", {})
        kw = {}
        if backend == "delta":
            kw = {k: caps[k] for k in ("capacity", "wire_cap", "claim_grid")}
        cluster = SimCluster(
            meta["n"], params, addresses=[str(a) for a in data["addresses"]],
            base_inc=meta["base_inc"], backend=backend, device=dev, **kw,
        )
        if backend == "delta":
            fields = _fields(data, DeltaState, "state")
            fields["bp_mask"] = _packed(fields["bp_mask"])
            fields["d_bpmask"] = _packed(fields["d_bpmask"])
            state = convert.delta_state_from_numpy(fields, device=dev)
            if state.digest is None:
                # a checkpoint from before the carried derivatives
                state = sdelta.refresh_carried(state)
            elif state.d_bpmask is None:
                # the digest is carried; the slot-base planes come where
                # the reference's state-build switch asks for them
                state = sdelta.refresh_carried(state, digest=False)
        else:
            state = convert.state_from_numpy(_fields(data, ClusterState, "state"), device=dev)
        cluster.state = state
        cluster.net = convert.net_from_numpy(_fields(data, NetState, "net"), device=dev)
        cluster.key = convert.key_from_numpy(data["key"])
        cluster.metrics_log = [
            {k: int(v) for k, v in entry.items()} for entry in meta.get("metrics_log", [])
        ]
        cluster.traces = [
            Trace.from_arrays(data, tmeta, prefix=f"trace{i}.")
            for i, tmeta in enumerate(meta.get("traces", []))
        ]
        cluster.stream_cursor = meta.get("stream")
    return cluster
