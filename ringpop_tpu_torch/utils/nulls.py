"""No-op logger and stats sink defaults (reference: lib/nulls.js).

The port of ``ringpop_tpu/utils/nulls.py``, without ``CapturingStatsd``,
which nothing calls (``obs.emitters.CaptureEmitter`` records stat calls).
"""

from __future__ import annotations

from typing import Any


class NullLogger:
    def debug(self, msg: str, extra: Any = None) -> None: ...

    def info(self, msg: str, extra: Any = None) -> None: ...

    def warn(self, msg: str, extra: Any = None) -> None: ...

    def error(self, msg: str, extra: Any = None) -> None: ...

    def trace(self, msg: str, extra: Any = None) -> None: ...


class NullStatsd:
    def increment(self, key: str, value: Any = None) -> None: ...

    def gauge(self, key: str, value: Any = None) -> None: ...

    def timing(self, key: str, value: Any = None) -> None: ...
