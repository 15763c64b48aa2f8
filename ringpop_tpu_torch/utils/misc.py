"""Small helpers (reference: lib/util.js).

The port of ``ringpop_tpu/utils/misc.py``, without its JAX helpers
(``pin_cpu_if_requested``, ``enable_compilation_cache`` and
``provision_virtual_devices`` set JAX's platform, compilation cache and
virtual CPU devices, which have no meaning for torch) and without
``parse_arg`` and ``map_uniq``, which nothing calls.
"""

from __future__ import annotations

import json
import re
from typing import Any

_HOST_CAPTURE = re.compile(r"(\d+\.\d+\.\d+\.\d+):\d+")


def capture_host(host_port: str) -> str | None:
    """IP portion of an ip:port identity (lib/util.js:27-30)."""
    m = _HOST_CAPTURE.search(host_port or "")
    return m.group(1) if m else None


def num_or_default(value: Any, default: float) -> float:
    return value if isinstance(value, (int, float)) and not isinstance(value, bool) else default


def safe_parse(text: Any) -> Any:
    """JSON parse returning None on failure (lib/util.js:74-80)."""
    if text is None:
        return None
    if isinstance(text, (bytes, bytearray)):
        try:
            text = text.decode("utf-8")
        except UnicodeDecodeError:
            return None
    try:
        return json.loads(text)
    except (ValueError, TypeError):
        return None


def is_empty_array(value: Any) -> bool:
    """True when not a list or an empty list (lib/util.js isEmptyArray)."""
    return not isinstance(value, list) or len(value) == 0


def to_json(obj: Any) -> str:
    """Compact JSON like JS JSON.stringify."""
    return json.dumps(obj, separators=(",", ":"))
