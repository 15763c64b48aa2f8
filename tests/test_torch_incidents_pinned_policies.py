"""The 15 policy-armed incident goldens of ``tests/golden/incidents/``
(``library.policy_golden_grid``: cascading_overload under every policy
on both backends, every other incident under ``combined`` on the dense
one) against the port, in the non-partitionable threefry mode they were
pinned in (see ``test_torch_incidents_pinned.py``).  No reference run:
the live comparison of these triples would compile 8 more reference
programs, so they are held against the pinned files alone.
"""

from __future__ import annotations

import os

import pytest

from test_torch_harness import one_thread  # noqa: F401 - a fixture
from test_torch_incidents_pinned import GOLDEN_DIR, pinned, run_pinned_mode

from ringpop_tpu_torch.scenarios import library as lib

TRIPLES = lib.policy_golden_grid()


def test_grid_covers_the_policy_files():
    armed = sorted(f for f in os.listdir(GOLDEN_DIR) if "+" in f)
    assert armed == sorted(f"{n}+{p}.{b}.json" for n, p, b in TRIPLES)
    assert len(TRIPLES) == 15


@pytest.mark.parametrize("name,policy,backend", TRIPLES)
def test_policy_golden(one_thread, name, policy, backend):  # noqa: F811
    assert run_pinned_mode(name, backend, policy) == pinned(name, backend, policy)
