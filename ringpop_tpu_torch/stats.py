"""Histograms (the reference's ``metrics`` npm dependency).

The port of ``Histogram`` of ``ringpop_tpu/stats.py``: a uniform
reservoir with exact percentiles while it holds every value, which is
how ``scenarios.trace.Trace.summary`` reads a run's series.
"""

from __future__ import annotations

import random


class Histogram:
    """Uniform-reservoir histogram with percentiles (metrics.Histogram)."""

    def __init__(self, sample_size: int = 1028, seed: int | None = None):
        self._sample_size = sample_size
        self._values: list[float] = []
        self._count = 0
        self._min: float | None = None
        self._max: float | None = None
        self._sum = 0.0
        self._rng = random.Random(seed)

    def update(self, value: float) -> None:
        self._count += 1
        self._sum += value
        self._min = value if self._min is None else min(self._min, value)
        self._max = value if self._max is None else max(self._max, value)
        if len(self._values) < self._sample_size:
            self._values.append(value)
        else:
            idx = self._rng.randrange(self._count)
            if idx < self._sample_size:
                self._values[idx] = value

    def percentiles(self, ps: list[float]) -> dict:
        values = sorted(self._values)
        out: dict = {}
        for p in ps:
            if not values:
                out[str(p)] = 0.0
                continue
            pos = p * (len(values) + 1)
            if pos < 1:
                out[str(p)] = values[0]
            elif pos >= len(values):
                out[str(p)] = values[-1]
            else:
                lower = values[int(pos) - 1]
                upper = values[int(pos)]
                out[str(p)] = lower + (pos - int(pos)) * (upper - lower)
        return out

    def print_obj(self) -> dict:
        pct = self.percentiles([0.5, 0.75, 0.95, 0.99])
        return {
            "count": self._count,
            "min": self._min,
            "max": self._max,
            "sum": self._sum,
            "mean": self._sum / self._count if self._count else 0.0,
            "median": pct["0.5"],
            "p75": pct["0.75"],
            "p95": pct["0.95"],
            "p99": pct["0.99"],
        }
