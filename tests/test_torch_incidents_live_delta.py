"""The 6 delta bare incident pairs at the golden configuration against the
live reference, in jax 0.9's threefry mode (see
``test_torch_incidents_live.py``).  A delta program takes the reference
~45 s to compile, so its runs are split over two child processes.
"""

from __future__ import annotations

import pytest

from test_torch_harness import one_thread  # noqa: F401 - a fixture
from test_torch_incidents_live import live_summaries, pairs


@pytest.fixture(scope="module")
def summaries(tmp_path_factory, one_thread):  # noqa: F811
    return live_summaries(pairs("delta"), str(tmp_path_factory.mktemp("live")), children=2)


@pytest.mark.parametrize("name,backend", pairs("delta"))
def test_live_delta(summaries, name, backend):
    port, ref = summaries
    key = f"{name}|{backend}|"
    assert port[key] == ref[key]
