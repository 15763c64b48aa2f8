"""Fixed-shape key workloads: seeded, replayable, pre-hashed.

The port of ``ringpop_tpu/traffic/workloads.py``.  A workload is a
distribution over a fixed pool of K distinct keys plus an arrival policy
(which node each request lands on).  The pool is hashed once on the
device (one ``farmhash32_batch`` call over the encoded key strings,
equal to the host ring's farmhash32, so host-ring oracles resolve the
same keys), and each traffic tick samples M pool indices and M arrival
viewers from ``fold_in(workload_key, tick)``: a stream of its own, so
adding traffic to a scenario never perturbs the protocol.

Three kinds:

* ``uniform``: every pool key equally likely;
* ``zipf``: pool rank r with p proportional to (r + 1)^-s (``zipf_s``);
* ``tenant``: keys belong round-robin to T tenants, tenant t weighted
  by (t + 1)^-s, uniform within a tenant.
"""

from __future__ import annotations

import json
import os
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from ringpop_tpu_torch import prng
from ringpop_tpu_torch.ops import ring_ops
from ringpop_tpu_torch.ops.farmhash import farmhash32_batch
from ringpop_tpu_torch.traffic.engine import TrafficStatic, TrafficTensors
from ringpop_tpu_torch.traffic.latency import MAX_BUCKETS

# forward chain cap: the request proxy's default retry budget
DEFAULT_MAX_RETRIES = 3

# masked-walk width when the spec leaves it unset: the chance that W
# consecutive global replicas ALL belong to out-of-ring servers decays
# geometrically (dead_fraction^W); 256 puts even a 90%-dead cluster at
# ~2e-12 per key, and the engine still reports the residue (unresolved)
DEFAULT_WINDOW = 256


class WorkloadSpec(NamedTuple):
    """Declarative traffic workload (the serving twin of ScenarioSpec)."""

    kind: str = "uniform"  # uniform | zipf | tenant
    keys_per_tick: int = 256  # M requests per traffic tick
    pool: int = 4096  # K distinct keys ("key-0" .. f"key-{K-1}")
    seed: int = 0  # workload PRNG stream (independent of protocol)
    zipf_s: float = 1.1  # skew exponent (zipf ranks / tenant weights)
    tenants: int = 16  # tenant count (kind="tenant")
    viewers: tuple[int, ...] | None = None  # arrival nodes; None = all
    lookup_n: int = 0  # >0: also resolve n-wide preference lists
    max_retries: int = DEFAULT_MAX_RETRIES  # forward-chain retry cap
    window: int | None = None  # masked-walk width; None = DEFAULT_WINDOW
    every: int = 1  # serve on ticks where tick % every == 0
    latency_buckets: int = 0  # SLO latency plane's log2 buckets; 0 = off
    period_ms: int = 200  # protocol period ms (tick -> ms for the plane)

    @classmethod
    def from_spec(cls, spec: Any) -> "WorkloadSpec":
        """A ``WorkloadSpec`` from itself, a dict, a JSON file path, or
        the shorthand ``kind:M[:pool]`` (e.g. ``zipf:512``)."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            if os.path.exists(spec) or spec.endswith(".json"):
                with open(spec) as f:
                    spec = json.load(f)
            else:
                parts = spec.split(":")
                out = {"kind": parts[0]}
                if len(parts) > 1:
                    out["keys_per_tick"] = int(parts[1])
                if len(parts) > 2:
                    out["pool"] = int(parts[2])
                spec = out
        if isinstance(spec, dict):
            if "viewers" in spec and spec["viewers"] is not None:
                spec = {**spec, "viewers": tuple(spec["viewers"])}
            return cls(**spec)
        raise TypeError(f"cannot build a WorkloadSpec from {type(spec)}")

    def to_dict(self) -> dict[str, Any]:
        d = self._asdict()
        if d["viewers"] is not None:
            d["viewers"] = list(d["viewers"])
        return d

    def validate(self, n: int) -> "WorkloadSpec":
        if self.kind not in ("uniform", "zipf", "tenant"):
            raise ValueError(f"unknown workload kind {self.kind!r}")
        if self.keys_per_tick < 1:
            raise ValueError("keys_per_tick must be >= 1")
        if self.pool < 1:
            raise ValueError("pool must be >= 1")
        if self.kind == "tenant" and not (1 <= self.tenants <= self.pool):
            raise ValueError("tenants must be in [1, pool]")
        if self.lookup_n < 0 or self.max_retries < 0:
            raise ValueError("lookup_n and max_retries must be >= 0")
        if self.every < 1:
            raise ValueError("every must be >= 1")
        if self.viewers is not None:
            if not self.viewers:
                raise ValueError("viewers must be non-empty when given")
            if any(not (0 <= v < n) for v in self.viewers):
                raise ValueError(f"viewers out of range for n={n}")
        if self.window is not None and self.window < 1:
            raise ValueError("window must be >= 1 when given")
        if not 0 <= self.latency_buckets <= MAX_BUCKETS:
            raise ValueError(
                f"latency_buckets must be in [0, {MAX_BUCKETS}] "
                f"(got {self.latency_buckets})"
            )
        if self.latency_buckets and self.latency_buckets < 2:
            raise ValueError("latency_buckets needs >= 2 buckets when on")
        if self.period_ms < 1:
            raise ValueError(f"period_ms must be >= 1 (got {self.period_ms})")
        return self

    def pool_keys(self) -> list[str]:
        """The K distinct key strings; ``pool[i]`` is their farmhash32."""
        return [f"key-{i}" for i in range(self.pool)]

    def logits(self) -> np.ndarray:
        """float32[K] unnormalized log-probabilities per pool key."""
        k = self.pool
        if self.kind == "uniform":
            return np.zeros(k, dtype=np.float32)
        if self.kind == "zipf":
            return (-self.zipf_s * np.log(np.arange(1, k + 1))).astype(np.float32)
        # tenant: key i belongs to tenant i % T; a tenant's zipf weight is
        # split uniformly across its keys
        t = np.arange(k) % self.tenants
        per_tenant = np.bincount(t, minlength=self.tenants).astype(np.float64)
        w = (np.arange(1, self.tenants + 1) ** -self.zipf_s) / per_tenant
        return np.log(w[t]).astype(np.float32)


class CompiledTraffic(NamedTuple):
    """A workload lowered against one cluster's address book: the fixed
    facts, the device tensors, the spec, and the cluster size it was
    lowered for (viewer ids and ring owners mean nothing elsewhere)."""

    static: TrafficStatic
    tensors: TrafficTensors
    spec: WorkloadSpec
    n: int


def compile_traffic(
    spec: Any,
    n: int,
    addresses: Sequence[str],
    *,
    ring: ring_ops.DeviceRing | None = None,
    device: torch.device | str | None = None,
) -> CompiledTraffic:
    """Lower a workload spec against a cluster of ``n`` nodes, on
    ``ring``'s device (or ``device``).  The global ring is built once
    (pass a cached ``ring`` to skip it); the key pool is hashed on the
    device in one ``farmhash32_batch`` call."""
    spec = WorkloadSpec.from_spec(spec).validate(n)
    if len(addresses) != n:
        raise ValueError("addresses must have length n")
    if ring is None:
        ring = ring_ops.build_ring(addresses, device=device)
    dev = ring.hashes.device
    bufs, lens = ring_ops.encode_strings(spec.pool_keys())
    pool_hashes = farmhash32_batch(torch.from_numpy(bufs).to(dev), torch.from_numpy(lens).to(dev))
    viewers = (np.arange(n, dtype=np.int32) if spec.viewers is None
               else np.asarray(spec.viewers, dtype=np.int32))
    window = spec.window if spec.window is not None else DEFAULT_WINDOW
    static = TrafficStatic(
        m=spec.keys_per_tick,
        max_retries=spec.max_retries,
        window=min(window, ring.size),
        every=spec.every,
        lookup_n=spec.lookup_n,
        latency_buckets=spec.latency_buckets,
        period_ms=spec.period_ms,
    )
    tensors = TrafficTensors(
        pool=pool_hashes,
        logits=torch.from_numpy(spec.logits()).to(dev),
        viewers=torch.from_numpy(viewers).to(dev),
        ring_hashes=ring.hashes,
        ring_owners=ring.owners,
        key=prng.PRNGKey(spec.seed),
    )
    return CompiledTraffic(static=static, tensors=tensors, spec=spec, n=n)
