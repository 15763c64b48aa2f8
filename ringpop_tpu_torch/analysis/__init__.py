"""Trace-contract auditor: the port's contracts, checked on its entry points.

The port of ``ringpop_tpu/analysis/``.  Every guarantee the port's speed
rests on — few host syncs a tick, an entry state freed when replaced,
narrow carried dtypes, independent PRNG streams, O(N * C) memory on the
delta backend, every cross-shard transfer a hop — is machine-checked by
running each entry point once on a small fixture with instruments on:

* ``registry``  — the audited entry points (swim_run, delta_run,
  run_scenario and its traffic, incident, policy and provenance shapes,
  run_sweep, the kernels' host-level calls, the sharded steps), each
  with a small fixture on ``device``;
* ``contracts`` — the checks (host reads, handoff, carry dtypes, key
  lineage, tensor census; peak bytes and hop launches on the card);
* ``budgets``   — the pinned tables (carry dtypes and their differences
  from the reference's, syncs, bytes, hops);
* ``planted``   — the faults the audit must find, for its own tests and
  the card's check;
* ``lint``      — the AST lint of the port's hazards (host reads, numpy
  in a step, 0-dim tensor indices, wall-clock reads, host-made tensors,
  reference imports);
* ``cli``       — ``python -m ringpop_tpu_torch audit`` with ``--fail-on``.

The package imports torch, numpy and the standard library only.
"""

from ringpop_tpu_torch.analysis.findings import (  # noqa: F401
    SEVERITY_RANK,
    Finding,
    at_least,
    max_severity,
)
from ringpop_tpu_torch.analysis.lint import lint_paths, lint_source  # noqa: F401

__all__ = [
    "Finding",
    "SEVERITY_RANK",
    "at_least",
    "max_severity",
    "lint_paths",
    "lint_source",
]
