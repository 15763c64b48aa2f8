"""The 14 bare incident goldens of ``tests/golden/incidents/`` against the
port, with no reference run.

The files were pinned under jax 0.4.37, whose threefry mode was the
non-partitionable one, so the port replays them under
``prng.partitionable_mode(False)``: ``run_golden`` at the golden
configuration (n = 16, seed 3, segments of 32), on the CPU, must give
each file's summary exactly.  The files are read, never written.  The
policy-armed goldens are in ``test_torch_incidents_pinned_policies.py``.
"""

from __future__ import annotations

import json
import os

import pytest

from test_torch_harness import REPO, one_thread  # noqa: F401 - a fixture

from ringpop_tpu_torch import prng
from ringpop_tpu_torch.scenarios import library as lib

GOLDEN_DIR = os.path.join(REPO, "tests", "golden", "incidents")

PAIRS = [(name, backend) for name in lib.incident_names()
         for backend in lib.INCIDENTS[name].backends]


def pinned(name: str, backend: str, policy: str | None) -> dict:
    with open(lib.golden_path(name, backend, GOLDEN_DIR, policy)) as f:
        return json.load(f)


def run_pinned_mode(name: str, backend: str, policy: str | None) -> dict:
    with prng.partitionable_mode(False):
        return lib.run_golden(name, backend, policy=policy, device="cpu")


def test_pairs_cover_the_bare_files():
    bare = sorted(f for f in os.listdir(GOLDEN_DIR) if "+" not in f)
    assert bare == sorted(f"{n}.{b}.json" for n, b in PAIRS)
    assert len(PAIRS) == 14


@pytest.mark.parametrize("name,backend", PAIRS)
def test_bare_golden(one_thread, name, backend):  # noqa: F811
    assert run_pinned_mode(name, backend, None) == pinned(name, backend, None)
