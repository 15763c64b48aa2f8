"""Meters and histograms (the reference's ``metrics`` npm dependency).

The port of ``ringpop_tpu/stats.py``: ``Meter``, the exponentially
weighted rates the host library's ``RingPop`` keeps on its clock, and
``Histogram``, a uniform reservoir with exact percentiles while it holds
every value, which is how ``scenarios.trace.Trace.summary`` reads a
run's series and ``RingPop`` its timing stats.
"""

from __future__ import annotations

import math
import random
import time
from typing import Callable


class Meter:
    """Exponentially-weighted 1/5/15-minute rates, metrics-library style."""

    _INTERVAL = 5.0  # seconds per tick bucket

    def __init__(self, now_fn: Callable[[], float] | None = None):
        self._now = now_fn or time.time
        self._count = 0
        self._uncounted = 0
        self._start = self._now()
        self._last_tick = self._start
        self._m1 = 0.0
        self._m5 = 0.0
        self._m15 = 0.0
        self._initialized = False

    def mark(self, n: int = 1) -> None:
        self._tick_if_needed()
        self._count += n
        self._uncounted += n

    def _tick_if_needed(self) -> None:
        now = self._now()
        elapsed = now - self._last_tick
        ticks = int(elapsed / self._INTERVAL)
        for _ in range(ticks):
            self._tick()
        if ticks:
            self._last_tick += ticks * self._INTERVAL

    def _tick(self) -> None:
        rate = self._uncounted / self._INTERVAL
        self._uncounted = 0
        a1 = 1 - math.exp(-self._INTERVAL / 60.0)
        a5 = 1 - math.exp(-self._INTERVAL / 300.0)
        a15 = 1 - math.exp(-self._INTERVAL / 900.0)
        if not self._initialized:
            self._m1 = self._m5 = self._m15 = rate
            self._initialized = True
        else:
            self._m1 += a1 * (rate - self._m1)
            self._m5 += a5 * (rate - self._m5)
            self._m15 += a15 * (rate - self._m15)

    def print_obj(self) -> dict:
        self._tick_if_needed()
        elapsed = max(self._now() - self._start, 1e-9)
        return {
            "count": self._count,
            "m1": self._m1,
            "m5": self._m5,
            "m15": self._m15,
            "mean": self._count / elapsed,
        }

    def stop(self) -> None:  # parity with metrics.Meter.mNRate.stop()
        pass




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
