"""Forwarded-request envelope codec (reference: lib/request-proxy/util.js).

The port of ``ringpop_tpu/request_proxy/head.py``.
"""

from __future__ import annotations

from typing import Any

from ringpop_tpu_torch.utils.misc import to_json


def raw_head(req: Any, checksum: int | None, keys: list[str]) -> dict[str, Any]:
    return {
        "url": getattr(req, "url", None),
        "headers": getattr(req, "headers", None),
        "method": getattr(req, "method", None),
        "httpVersion": getattr(req, "http_version", "1.1"),
        "ringpopChecksum": checksum,
        "ringpopKeys": keys,
    }


def str_head(req: Any, checksum: int | None, keys: list[str]) -> str:
    return to_json(raw_head(req, checksum, keys))
