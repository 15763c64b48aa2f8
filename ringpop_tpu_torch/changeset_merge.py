"""Merge multiple changesets, max-incarnation-wins, excluding self
(reference: lib/membership-changeset-merge.js).

The port of ``ringpop_tpu/changeset_merge.py``.
"""

from __future__ import annotations

from typing import Any


def merge_membership_changesets(
    local_address: str, changesets: list[list[dict[str, Any]]]
) -> list[dict[str, Any]]:
    merge_index: dict[str, dict[str, Any]] = {}

    for changes in changesets:
        for change in changes:
            address = change.get("address")
            if address == local_address:
                continue
            existing = merge_index.get(address)
            if existing is None or existing.get("incarnationNumber") < change.get(
                "incarnationNumber"
            ):
                merge_index[address] = change

    return list(merge_index.values())
