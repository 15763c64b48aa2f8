"""Audit findings: one violation (or note) per instance, severity-ranked.

The port's copy of ``ringpop_tpu/analysis/findings.py``.  A ``Finding``
is flat and JSON-trivial: the audit CLI's ``--json`` mode must be
diffable, and the tests assert on ``contract`` + ``entry`` pairs without
parsing prose.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

# Severity gates (cli --fail-on): an "error" is a broken contract; a
# "warning" is a contract the auditor could not positively prove (e.g.
# an unpinned budget row); "info" is report material.
SEVERITY_RANK = {"info": 0, "warning": 1, "error": 2}


@dataclasses.dataclass
class Finding:
    contract: str  # e.g. "host-read", "handoff", "carry-dtype",
    #                "prng-lineage", "census", "member-gather",
    #                "byte-budget", "hop-budget", "lint:RPL001"
    severity: str  # "error" | "warning" | "info"
    entry: str  # entry-point name, or file path for lint findings
    message: str
    where: str = ""  # "file:line", or the part of the entry

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        loc = f" @ {self.where}" if self.where else ""
        return f"[{self.severity}] {self.entry}: {self.contract}{loc} — {self.message}"


def max_severity(findings: Iterable[Finding]) -> str | None:
    """The highest severity present, or None for an empty list."""
    best: str | None = None
    for f in findings:
        if best is None or SEVERITY_RANK[f.severity] > SEVERITY_RANK[best]:
            best = f.severity
    return best


def at_least(findings: Iterable[Finding], severity: str) -> list[Finding]:
    """Findings at or above ``severity``."""
    floor = SEVERITY_RANK[severity]
    return [f for f in findings if SEVERITY_RANK[f.severity] >= floor]
