"""The SLO latency model: request latency, retry backoff, log2 buckets.

The port of ``ringpop_tpu/traffic/latency.py``.  The serving engine
(``traffic/engine.py``) answers where requests went; this module says how
long they took.  A request's latency is summed inside the serve chain
from the only sources the simulation models:

* **per-link one-way delays** of the fault model's delay rules
  (``NetState.link_d``/``link_j``): each send attempt from a to b adds
  ``period_ms * (base(a, b) + U{0..jitter(a, b)})`` ms, and a delivered
  proxied request one return leg from its final handler to the arrival
  viewer;
* **retry backoff** by the request proxy's ``RETRY_SCHEDULE`` (0, 1,
  3.5 s; retries past it reuse its last slot): each consumed retry adds
  its slot in ms and moves the request's effective tick on by the
  backoff, so a retry against a gray holder lands on a later duty phase.

Latencies are exact int32 ms counted in a fixed [B] log2-bucket row
(bucket 0 holds exactly zero, bucket b >= 1 holds ``2^(b-1) <= ms <
2^b``, the last one is open-ended): integer compares against
power-of-two edges, a one-hot sum, no host lists.  The jitter draws
come from their own stream of the workload key (``latency_key``), so
the plane never perturbs the protocol or the sampler.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ringpop_tpu_torch import prng

# the request proxy's retry backoff schedule, seconds (request_proxy/send.py)
RETRY_SCHEDULE = [0, 1, 3.5]

# domain-separation tag of the latency stream (folded into the workload
# key before the tick, so it never meets the sampler's fold of the tick)
_LATENCY_STREAM_TAG = 0x5A10

# the open-ended top bucket must fit int32 millisecond values
MAX_BUCKETS = 32


def backoff_ms_schedule(max_retries: int) -> np.ndarray:
    """int32[max(max_retries, 1)]: the backoff (ms) retry i charges, the
    schedule's last slot repeated past its end."""
    slots = max(int(max_retries), 1)
    sched = [int(RETRY_SCHEDULE[min(i, len(RETRY_SCHEDULE) - 1)] * 1000) for i in range(slots)]
    return np.asarray(sched, dtype=np.int32)


def backoff_tick_offsets(max_retries: int, period_ms: int) -> np.ndarray:
    """int32[max_retries + 1]: the effective-tick offset after r retries,
    the cumulative backoff floored to protocol ticks (entry 0 is 0)."""
    ms = backoff_ms_schedule(max_retries)
    cum = np.concatenate([[0], np.cumsum(ms)]).astype(np.int64)
    return (cum[: max(int(max_retries), 0) + 1] // max(int(period_ms), 1)).astype(np.int32)


def bucket_edges_ms(buckets: int) -> np.ndarray:
    """int64[buckets - 1] lower edges of buckets 1..: 1, 2, 4, ... 2^(B-2)."""
    return 2 ** np.arange(int(buckets) - 1, dtype=np.int64)


def bucket_index(ms: Any, buckets: int) -> Any:
    """Bucket per value: 0 for ms <= 0, else ``floor(log2(ms)) + 1``
    clamped to ``buckets - 1``, as integer compares against the edges."""
    if torch.is_tensor(ms):
        # the edges made on the device (a host copy would wait for it)
        k = torch.arange(int(buckets) - 1, dtype=torch.int32, device=ms.device)
        e = torch.ones_like(k) << k
        return (ms[..., None] >= e).sum(dim=-1, dtype=torch.int32)
    edges = bucket_edges_ms(buckets).astype(np.int32)
    ms = np.asarray(ms, dtype=np.int64)
    return np.sum(ms[..., None] >= edges, axis=-1).astype(np.int32)


def bucket_counts(ms: torch.Tensor, valid: torch.Tensor, buckets: int) -> torch.Tensor:
    """int32[buckets]: histogram of the valid entries (a one-hot sum, so
    its size never has to be read back from the device)."""
    idx = bucket_index(ms, buckets)
    lanes = torch.arange(int(buckets), dtype=torch.int32, device=ms.device)
    onehot = (idx[:, None] == lanes[None, :]) & valid[:, None]
    return onehot.sum(dim=0, dtype=torch.int32)


def latency_key(workload_key: torch.Tensor, t: int) -> torch.Tensor:
    """The tick's latency key: ``fold_in(fold_in(key, tag), t)``, a stream
    apart from the sampler's ``fold_in(key, t)``."""
    return prng.fold_in(prng.fold_in(workload_key, _LATENCY_STREAM_TAG), t)


def jitter_ms(u: torch.Tensor, base: torch.Tensor, bound: torch.Tensor,
              period_ms: int) -> torch.Tensor:
    """int32 one-way latency in ms from a uniform draw and the (base,
    jitter bound) tick maxima of the active delay rules:
    ``swim_sim._message_delay``'s arithmetic, scaled to ms."""
    extra = torch.minimum((u * (bound + 1).to(torch.float32)).to(torch.int32), bound)
    return (base + extra) * int(period_ms)


def duty_on(holder: torch.Tensor, tick: torch.Tensor | int,
            period: torch.Tensor | None) -> torch.Tensor:
    """Whether the holder is on duty at (effective) ``tick``: gray nodes
    (period > 1) serve only on their duty phase, the affine phase of
    ``swim_sim._stagger_send_gate`` (the product wrapping in int32, the
    modulo floored); ``None`` means everyone serves every tick."""
    if period is None:
        return torch.ones(holder.shape, dtype=torch.bool, device=holder.device)
    h = holder.to(torch.int64)
    per = torch.clamp(period.index_select(0, h), min=1).to(torch.int64)
    prod = h * (0x9E37 | 1)
    prod = ((prod + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return tick % per == prod % per


# ---------------------------------------------------------------------------
# host-side histogram readouts (percentiles from log2 buckets)
# ---------------------------------------------------------------------------


# audit: allow=RPL001 host numpy on histogram counts
def hist_stats(counts: np.ndarray) -> dict[str, float]:
    """Percentile and summary estimates of a [B] log2-bucket histogram
    (``stats.Histogram.print_obj`` keys).  A bucket stands for its lower
    edge (0 for bucket 0, else 2^(b-1)): a floor estimate in ms."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    reps = np.concatenate([[0], bucket_edges_ms(len(counts))])
    if total == 0:
        return {"count": 0, "min": 0.0, "max": 0.0, "sum": 0.0, "mean": 0.0,
                "median": 0.0, "p75": 0.0, "p95": 0.0, "p99": 0.0}
    cum = np.cumsum(counts)

    def pct(p: float) -> float:
        rank = int(np.ceil(p * total))
        return float(reps[int(np.searchsorted(cum, max(rank, 1)))])

    nz = np.flatnonzero(counts)
    est_sum = float((counts * reps).sum())
    return {
        "count": total,
        "min": float(reps[nz[0]]),
        "max": float(reps[nz[-1]]),
        "sum": est_sum,
        "mean": est_sum / total,
        "median": pct(0.5),
        "p75": pct(0.75),
        "p95": pct(0.95),
        "p99": pct(0.99),
    }


def plane_stats(trace: Any, name: str = "lat_hist_ms") -> dict[str, float] | None:
    """``hist_stats`` of a trace plane summed over every tick (and every
    replica of a ``SweepTrace``), or None when absent."""
    planes = getattr(trace, "planes", None) or {}
    if name not in planes:
        return None
    arr = np.asarray(planes[name], dtype=np.int64)
    return hist_stats(arr.reshape(-1, arr.shape[-1]).sum(axis=0))
