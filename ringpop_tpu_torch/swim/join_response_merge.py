"""Merge join responses (reference: lib/swim/join-response-merge.js).

If all responses carry the same checksum, take the first member list
verbatim; otherwise fall back to the max-incarnation changeset merge.

The port of ``ringpop_tpu/swim/join_response_merge.py``.
"""

from __future__ import annotations

from typing import Any

from ringpop_tpu_torch.changeset_merge import merge_membership_changesets


def _has_same_checksums(join_responses: list[dict[str, Any]]) -> bool:
    last = None
    for response in join_responses:
        checksum = response.get("checksum")
        if not checksum or (last is not None and last != checksum):
            return False
        last = checksum
    return True


def merge_join_responses(
    local_address: str, join_responses: list[dict[str, Any]]
) -> list[dict[str, Any]]:
    if not join_responses:
        return []
    if _has_same_checksums(join_responses):
        return join_responses[0]["members"]
    return merge_membership_changesets(
        local_address, [r["members"] for r in join_responses]
    )
