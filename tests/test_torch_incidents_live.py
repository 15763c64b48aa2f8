"""The 8 dense bare incident pairs at the golden configuration against the
live reference, in jax 0.9's threefry mode (the partitionable one, the
port's default).

The reference's ``library.run_golden`` runs in a child process (it
compiles one scenario-and-traffic program per segment shape), started
before the port's runs so that the two overlap; both summaries must be
equal exactly.  The delta pairs are in ``test_torch_incidents_live_delta.py``.
"""

from __future__ import annotations

import pytest

from test_torch_harness import ReferenceScript, one_thread  # noqa: F401 - a fixture

from ringpop_tpu_torch import prng
from ringpop_tpu_torch.scenarios import library as lib

_CHILD = r"""
from ringpop_tpu.scenarios import library as lib
out = {}
for name, backend, policy in CASES:
    out["|".join([name, backend, policy or ""])] = lib.run_golden(name, backend, policy)
json.dump(out, open(sys.argv[1], "w"))
"""


def pairs(backend: str) -> list[tuple[str, str]]:
    return [(name, backend) for name in lib.incident_names()
            if backend in lib.INCIDENTS[name].backends]


def live_summaries(cases: list[tuple[str, str]], tmp_dir: str, children: int = 1):
    """(port, reference) summaries of bare ``cases`` keyed
    ``name|backend|``: the reference's in ``children`` child processes,
    the port's on the CPU while they run."""
    chunks = [cases[i::children] for i in range(children)]
    procs = [ReferenceScript(f"CASES = {[[n, b, None] for n, b in chunk]!r}\n"
                             + _CHILD, tmp_dir, f"live{i}")
             for i, chunk in enumerate(chunks)]
    try:
        assert prng.get_partitionable()
        port = {f"{n}|{b}|": lib.run_golden(n, b, device="cpu") for n, b in cases}
        ref: dict = {}
        for p in procs:
            ref.update(p.result())
    finally:
        for p in procs:
            p.close()
    return port, ref


@pytest.fixture(scope="module")
def summaries(tmp_path_factory, one_thread):  # noqa: F811
    return live_summaries(pairs("dense"), str(tmp_path_factory.mktemp("live")))


@pytest.mark.parametrize("name,backend", pairs("dense"))
def test_live_dense(summaries, name, backend):
    port, ref = summaries
    key = f"{name}|{backend}|"
    assert port[key] == ref[key]
