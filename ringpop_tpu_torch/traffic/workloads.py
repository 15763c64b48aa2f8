"""Traffic workloads: the part of ``ringpop_tpu/traffic/workloads.py``
that the batched lookups need.  The workload specs, their compilation
and the serving plane are not ported yet."""

from __future__ import annotations

# masked-walk width when the spec leaves it unset: the chance that W
# consecutive global replicas ALL belong to out-of-ring servers decays
# geometrically (dead_fraction^W); 256 puts even a 90%-dead cluster at
# ~2e-12 per key, and the engine still reports the residue (unresolved)
DEFAULT_WINDOW = 256
