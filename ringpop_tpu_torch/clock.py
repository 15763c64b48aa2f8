"""Deterministic scheduler / virtual clock.

The reference is built on Node's event loop with wall-clock timers
(``setTimeout`` injectable for tests, index.js:93; fake timers in
test/lib/alloc-ringpop.js:47-58).  This rebuild goes further: the whole
host library is written against a ``Scheduler`` so that

* unit and cluster tests run on a fully deterministic virtual clock
  (``SimScheduler`` — a discrete-event loop with millisecond time), and
* real deployments drive the same code from asyncio wall-clock timers
  (``AsyncioScheduler``).

This is the host-side mirror of the simulation core's tick-synchronous
time model (models/swim_sim.py).

The port of ``ringpop_tpu/clock.py``.
"""

from __future__ import annotations

import heapq
import itertools
import time
from typing import Any, Callable


class Timer:
    __slots__ = ("when", "seq", "fn", "cancelled")

    def __init__(self, when: float, seq: int, fn: Callable[[], Any]):
        self.when = when
        self.seq = seq
        self.fn = fn
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def __lt__(self, other: "Timer") -> bool:
        return (self.when, self.seq) < (other.when, other.seq)


class SimScheduler:
    """Single-threaded discrete-event scheduler with virtual ms time."""

    def __init__(self, start_ms: float = 1_400_000_000_000.0):
        # Default epoch mirrors the reference's Date.now() incarnation
        # numbers (ms since epoch), so checksum strings look alike.
        self._now = float(start_ms)
        self._heap: list[Timer] = []
        self._seq = itertools.count()

    def now(self) -> float:
        """Current virtual time in ms."""
        return self._now

    def call_later(self, delay_ms: float, fn: Callable[[], Any]) -> Timer:
        timer = Timer(self._now + max(0.0, delay_ms), next(self._seq), fn)
        heapq.heappush(self._heap, timer)
        return timer

    def call_soon(self, fn: Callable[[], Any]) -> Timer:
        """Mirror of process.nextTick: runs before any delayed timer."""
        return self.call_later(0.0, fn)

    def cancel(self, timer: Timer | None) -> None:
        if timer is not None:
            timer.cancel()

    # -- test/driver controls ------------------------------------------------

    def advance(self, ms: float) -> int:
        """Run all timers due within the next ``ms`` virtual milliseconds."""
        deadline = self._now + ms
        fired = 0
        while self._heap and self._heap[0].when <= deadline:
            timer = heapq.heappop(self._heap)
            if timer.cancelled:
                continue
            self._now = max(self._now, timer.when)
            timer.fn()
            fired += 1
        self._now = deadline
        return fired

    def run_until_idle(self, max_timers: int = 1_000_000) -> int:
        """Run until no timers remain (or the safety cap trips)."""
        fired = 0
        while self._heap and fired < max_timers:
            timer = heapq.heappop(self._heap)
            if timer.cancelled:
                continue
            self._now = max(self._now, timer.when)
            timer.fn()
            fired += 1
        return fired

    def pending(self) -> int:
        return sum(1 for t in self._heap if not t.cancelled)


class AsyncioScheduler:
    """Wall-clock scheduler on top of an asyncio loop (real deployments)."""

    def __init__(self, loop=None):
        import asyncio

        self._loop = loop or asyncio.get_event_loop()

    def now(self) -> float:
        return time.time() * 1000.0

    def call_later(self, delay_ms: float, fn: Callable[[], Any]):
        # asyncio handles already expose .cancel(), the only method used
        return self._loop.call_later(max(0.0, delay_ms) / 1000.0, fn)

    def call_soon(self, fn: Callable[[], Any]):
        return self._loop.call_soon(fn)

    def cancel(self, timer) -> None:
        if timer is not None:
            timer.cancel()
