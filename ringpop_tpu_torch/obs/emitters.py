"""Stat sinks behind the statsd interface (``increment/gauge/timing``).

A copy of ``ringpop_tpu/obs/emitters.py``, which imports nothing of
jax; the port keeps its own.  The reference's statsd client is an
injected object with three methods; these emitters implement it, so they
drop into ``SimCluster(stats_emitter=...)`` and the Trace->stats bridge
(``obs.bridge``):

* ``StatsdEmitter`` — UDP statsd line protocol (``key:v|c`` / ``|g`` /
  ``|ms``), fire-and-forget, one datagram per stat;
* ``CaptureEmitter`` — in-memory record with aggregation helpers (the
  test double, and the backing store for key-namespace assertions);
* ``JsonlEmitter`` — one JSON object per stat appended to a file (or
  stdout);
* ``MultiEmitter`` — fan-out to several sinks.

``make_emitter(spec)`` parses the string forms:
``statsd://HOST:PORT`` (or ``udp://``), ``capture``, ``-`` (stdout
JSON lines), anything else = a JSON-lines file path.
"""

from __future__ import annotations

import json
import socket
import sys
import time
from collections import Counter
from typing import Any, IO


def _num(value: Any, default: float = 1) -> float:
    """Statsd line values must be numeric; None means 'count one'."""
    if value is None:
        return default
    return float(value)


def _fmt(value: float) -> str:
    """Integral values print as ints (``3`` not ``3.0``): the wire form
    the reference's node-statsd client produces."""
    return str(int(value)) if float(value).is_integer() else repr(float(value))


class StatsdEmitter:
    """UDP statsd line-protocol sink (fire-and-forget, never raises
    after construction — a dead collector must not take gossip down)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8125):
        self.host = host
        self.port = int(port)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sent = 0
        self.dropped = 0

    def _send(self, line: str) -> None:
        try:
            self._sock.sendto(line.encode(), (self.host, self.port))
            self.sent += 1
        except OSError:
            self.dropped += 1

    def increment(self, key: str, value: Any = None) -> None:
        self._send(f"{key}:{_fmt(_num(value))}|c")

    def gauge(self, key: str, value: Any = None) -> None:
        self._send(f"{key}:{_fmt(_num(value, 0))}|g")

    def timing(self, key: str, value: Any = None) -> None:
        self._send(f"{key}:{_fmt(_num(value, 0))}|ms")

    def close(self) -> None:
        self._sock.close()


class CaptureEmitter:
    """In-memory sink with the aggregations tests and CLIs read back:
    raw calls, per-key increment totals, last gauge, timing lists."""

    def __init__(self) -> None:
        self.calls: list[tuple[str, str, Any]] = []
        self.counters: Counter[str] = Counter()
        self.gauges: dict[str, float] = {}
        self.timings: dict[str, list[float]] = {}

    def increment(self, key: str, value: Any = None) -> None:
        self.calls.append(("increment", key, value))
        self.counters[key] += int(_num(value))

    def gauge(self, key: str, value: Any = None) -> None:
        self.calls.append(("gauge", key, value))
        self.gauges[key] = _num(value, 0)

    def timing(self, key: str, value: Any = None) -> None:
        self.calls.append(("timing", key, value))
        self.timings.setdefault(key, []).append(_num(value, 0))

    def keys(self) -> set[str]:
        return {key for _, key, _ in self.calls}

    def suffixes(self, prefix: str) -> set[str]:
        """Emitted keys with ``prefix.`` stripped (the reference's
        ``ringpop.<host_port>.`` namespace), for parity assertions."""
        dot = prefix + "."
        return {
            key[len(dot):] if key.startswith(dot) else key
            for key in self.keys()
        }

    def close(self) -> None:
        pass


class JsonlEmitter:
    """One JSON object per stat, appended to a file or stream — the
    greppable form ``tick-cluster --stats-out`` writes by default."""

    def __init__(self, path_or_stream: str | IO[str]):
        if isinstance(path_or_stream, str):
            self.path: str | None = path_or_stream
            self._f: IO[str] = open(path_or_stream, "a")
            self._owned = True
        else:
            self.path = None
            self._f = path_or_stream
            self._owned = False
        self.emitted = 0

    def _write(self, type_: str, key: str, value: Any) -> None:
        row = {"ts": round(time.time(), 3), "type": type_, "key": key}
        if value is not None:
            row["value"] = value
        self._f.write(json.dumps(row) + "\n")
        # flush per stat: this emitter exists for forensics, so a
        # SIGKILLed worker must not take its buffered lines with it,
        # and `tail -f` on a --stats-out file must stream live
        self._f.flush()
        self.emitted += 1

    def increment(self, key: str, value: Any = None) -> None:
        self._write("increment", key, value)

    def gauge(self, key: str, value: Any = None) -> None:
        self._write("gauge", key, value)

    def timing(self, key: str, value: Any = None) -> None:
        self._write("timing", key, value)

    def close(self) -> None:
        # idempotent: one emitter is commonly shared by every node of a
        # harness cluster, and each node's destroy() closes it
        if self._f.closed:
            return
        self._f.flush()
        if self._owned:
            self._f.close()


class MultiEmitter:
    """Fan one stat stream out to several sinks."""

    def __init__(self, *emitters: Any):
        self.emitters = list(emitters)

    def increment(self, key: str, value: Any = None) -> None:
        for e in self.emitters:
            e.increment(key, value)

    def gauge(self, key: str, value: Any = None) -> None:
        for e in self.emitters:
            e.gauge(key, value)

    def timing(self, key: str, value: Any = None) -> None:
        for e in self.emitters:
            e.timing(key, value)

    def close(self) -> None:
        for e in self.emitters:
            close = getattr(e, "close", None)
            if close:
                close()


def make_emitter(spec: str) -> Any:
    """Build an emitter from a CLI spec string (see module docstring)."""
    if spec == "capture":
        return CaptureEmitter()
    if spec == "-":
        return JsonlEmitter(sys.stdout)
    for scheme in ("statsd://", "udp://"):
        if spec.startswith(scheme):
            hostport = spec[len(scheme):]
            host, _, port = hostport.rpartition(":")
            if not host or not port.isdigit():
                raise ValueError(
                    f"statsd emitter spec needs HOST:PORT, got {hostport!r}"
                )
            return StatsdEmitter(host, int(port))
    return JsonlEmitter(spec)
