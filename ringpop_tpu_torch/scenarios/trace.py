"""Per-tick telemetry of a scenario run: the ``Trace``.

A copy of ``ringpop_tpu/scenarios/trace.py``: one row per tick of every
protocol counter, plus the converged flag, the live-node count and the
loss in force.  The ``.npz`` layout is the reference's, so either
package reads the other's trace files; ``summary`` speaks the
``stats.Histogram.print_obj`` key shape.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from ringpop_tpu_torch.stats import Histogram

FORMAT_VERSION = 1

# arrays every trace must carry (schema_valid contract)
_REQUIRED = ("converged", "live", "loss")


class Trace:
    """Stacked per-tick telemetry of one scenario run."""

    def __init__(
        self,
        *,
        metrics: dict[str, np.ndarray],
        converged: np.ndarray,
        live: np.ndarray,
        loss: np.ndarray,
        n: int,
        backend: str,
        start_tick: int = 0,
        spec: dict[str, Any] | None = None,
        planes: dict[str, np.ndarray] | None = None,
    ):
        self.metrics = {k: np.asarray(v) for k, v in metrics.items()}
        # histogram planes: [ticks, B] per-tick counter ROWS (the SLO
        # latency plane's log2 buckets, traffic/latency.py) — vector
        # series next to the scalar metrics, same tick axis
        self.planes = {
            k: np.asarray(v) for k, v in (planes or {}).items()
        }
        self.converged = np.asarray(converged, dtype=bool)
        self.live = np.asarray(live, dtype=np.int32)
        self.loss = np.asarray(loss, dtype=np.float32)
        self.n = int(n)
        self.backend = str(backend)
        self.start_tick = int(start_tick)
        self.spec = spec

    @property
    def ticks(self) -> int:
        return int(self.converged.shape[0])

    def first_converged_tick(self) -> int:
        """0-based tick index of the first converged sample, or -1."""
        hits = np.flatnonzero(self.converged)
        return int(hits[0]) if hits.size else -1

    def validate(self) -> "Trace":
        """Schema check: every series is 1-D with one row per tick."""
        t = self.ticks
        if t < 1:
            raise ValueError("trace has no ticks")
        for name in _REQUIRED:
            arr = getattr(self, name)
            if arr.ndim != 1 or arr.shape[0] != t:
                raise ValueError(f"trace series {name!r} is not [{t}]-shaped")
        for name, arr in self.metrics.items():
            if arr.ndim != 1 or arr.shape[0] != t:
                raise ValueError(f"trace metric {name!r} is not [{t}]-shaped")
        for name, arr in self.planes.items():
            if arr.ndim != 2 or arr.shape[0] != t:
                raise ValueError(
                    f"trace plane {name!r} is not [{t}, B]-shaped"
                )
        if not np.all((self.live >= 0) & (self.live <= self.n)):
            raise ValueError("trace live counts outside [0, n]")
        return self

    # audit: allow=RPL001 host numpy on a finished Trace
    def summary(self) -> dict[str, dict[str, float]]:
        """Per-series stats in ``stats.Histogram.print_obj`` key shape."""
        out: dict[str, dict[str, float]] = {}
        series: dict[str, np.ndarray] = {
            **self.metrics,
            "live": self.live,
            "loss": self.loss,
        }
        for name, arr in series.items():
            # sample_size >= ticks: the reservoir holds every value, so
            # the percentiles are exact, not sampled
            hist = Histogram(sample_size=max(len(arr), 1))
            for v in arr:
                hist.update(float(v))
            out[name] = hist.print_obj()
        out["converged"] = {
            "count": self.ticks,
            "sum": int(self.converged.sum()),
            "final": bool(self.converged[-1]),
            "first_tick": self.first_converged_tick(),
        }
        if self.planes:
            # histogram planes summarize as percentile estimates of
            # their whole-run bucket aggregate (bucket-floor values);
            # provenance planes (pv_*) are per-slot counters, not
            # bucket rows — their stats come from the host report
            # (obs.provenance.build_report), not a bucket aggregate
            for name, arr in self.planes.items():
                if name.startswith("pv_"):
                    continue
                out[name] = _hist_stats(arr.sum(axis=0))
        return out

    @classmethod
    def concat(cls, slabs, *, spec: dict[str, Any] | None = None) -> "Trace":
        """Reassemble contiguous per-segment slabs (a streamed run's
        segment-store content, scenarios/stream.py) into one
        full-series trace — bit-identical to the trace the unsegmented
        scan would have stacked.  Slabs must be tick-contiguous
        (``start_tick`` ordering) and agree on n/backend/series."""
        slabs = list(slabs)
        if not slabs:
            raise ValueError("no slabs to concatenate")
        first = slabs[0]
        expect = first.start_tick
        for s in slabs:
            if s.n != first.n or s.backend != first.backend:
                raise ValueError("slabs disagree on n/backend")
            if set(s.metrics) != set(first.metrics):
                raise ValueError("slabs disagree on metric series")
            if set(s.planes) != set(first.planes):
                raise ValueError("slabs disagree on histogram planes")
            if s.start_tick != expect:
                raise ValueError(
                    f"slab at start_tick {s.start_tick} is not contiguous "
                    f"(expected {expect})"
                )
            expect += s.ticks
        return cls(
            metrics={
                k: np.concatenate([s.metrics[k] for s in slabs])
                for k in first.metrics
            },
            planes={
                k: np.concatenate([s.planes[k] for s in slabs])
                for k in first.planes
            },
            converged=np.concatenate([s.converged for s in slabs]),
            live=np.concatenate([s.live for s in slabs]),
            loss=np.concatenate([s.loss for s in slabs]),
            n=first.n,
            backend=first.backend,
            start_tick=first.start_tick,
            spec=spec if spec is not None else first.spec,
        )

    # -- npz round trip (shared with checkpoint.py via the dict forms) ------

    def to_arrays(self, prefix: str = "") -> dict[str, np.ndarray]:
        arrays = {
            f"{prefix}converged": self.converged,
            f"{prefix}live": self.live,
            f"{prefix}loss": self.loss,
        }
        for name, arr in self.metrics.items():
            arrays[f"{prefix}m.{name}"] = arr
        for name, arr in self.planes.items():
            arrays[f"{prefix}p.{name}"] = arr
        return arrays

    def meta(self) -> dict[str, Any]:
        return {
            "version": FORMAT_VERSION,
            "n": self.n,
            "backend": self.backend,
            "start_tick": self.start_tick,
            "spec": self.spec,
        }

    @classmethod
    def from_arrays(
        cls, data: Any, meta: dict[str, Any], prefix: str = ""
    ) -> "Trace":
        keys = list(getattr(data, "files", data.keys()))
        metrics = {
            key[len(prefix) + 2:]: np.asarray(data[key])
            for key in keys
            if key.startswith(f"{prefix}m.")
        }
        planes = {
            key[len(prefix) + 2:]: np.asarray(data[key])
            for key in keys
            if key.startswith(f"{prefix}p.")
        }
        return cls(
            metrics=metrics,
            planes=planes,
            converged=np.asarray(data[f"{prefix}converged"]),
            live=np.asarray(data[f"{prefix}live"]),
            loss=np.asarray(data[f"{prefix}loss"]),
            n=meta["n"],
            backend=meta["backend"],
            start_tick=meta.get("start_tick", 0),
            spec=meta.get("spec"),
        )

    def save(self, path: str) -> None:
        arrays = self.to_arrays()
        arrays["meta"] = np.frombuffer(
            json.dumps(self.meta()).encode(), dtype=np.uint8
        )
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)  # atomic, like checkpoint.save

    @classmethod
    def load(cls, path: str) -> "Trace":
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(bytes(data["meta"]).decode())
            if meta["version"] != FORMAT_VERSION:
                raise ValueError(f"unsupported trace version {meta['version']}")
            return cls.from_arrays(data, meta)


# audit: allow=RPL001 host numpy on a finished Trace
def _hist_stats(counts: np.ndarray) -> dict[str, float]:
    """Estimates of an aggregated [B] log2-bucket histogram in
    ``Histogram.print_obj`` key shape (the reference's
    ``traffic.latency.hist_stats``): bucket 0 stands for 0 and bucket b
    for its lower edge 2^(b-1) ms."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    reps = np.concatenate([[0], 2 ** np.arange(len(counts) - 1, dtype=np.int64)])
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
