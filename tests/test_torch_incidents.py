"""The incident library's host side against the reference's.

Every incident's ``(ScenarioSpec, WorkloadSpec)`` at n in {8, 16, 64,
100}, also with the ticks override, its refusals, ``format_catalog``,
the spec documents (and the port's copies of ``scenarios/specs/``), the
policy golden grid, and ``incident_summary``/``format_summary`` on the
same synthetic traces: the reference's in one child process, compared
exactly.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from test_torch_harness import run_reference_script

from ringpop_tpu_torch.scenarios import library as lib
from ringpop_tpu_torch.scenarios.trace import Trace

SIZES = (8, 16, 64, 100)

# Synthetic traces, built alike on both sides from a seed: every
# summary key the serving, overload, policy and provenance planes add.
_SYNTH = r'''
def synth(seed, ticks=12, n=10, traffic=True, policy=True, prov=True, never=False):
    rng = np.random.default_rng(seed)
    conv = np.zeros(ticks, bool) if never else rng.random(ticks) < 0.7
    if not never:
        conv[ticks // 2:] = True
    m = {
        "faulty_declared": rng.integers(0, 3, ticks).astype(np.int32) * (0 if never else 1),
        "suspects_declared": rng.integers(0, 4, ticks).astype(np.int32),
    }
    planes = {}
    if traffic:
        for k in ("lookups", "delivered", "dropped", "misroutes", "proxy_failed",
                  "handled_local", "proxy_sends", "proxy_retries", "send_errors",
                  "gray_timeouts", "retry_succeeded", "ov_gray_nodes", "ov_pressure_max"):
            m[k] = rng.integers(0, 50, ticks).astype(np.int32)
        m["lookups"] += 60
        planes["lat_hist_ms"] = rng.integers(0, 9, (ticks, 8)).astype(np.int32)
    if policy:
        for k in ("policy_shed", "policy_quarantined", "policy_shed_nodes",
                  "policy_retry_cap", "policy_amp_x16"):
            m[k] = rng.integers(0, 20, ticks).astype(np.int32)
    trace = Trace(metrics=m, converged=conv, live=rng.integers(5, n + 1, ticks).astype(np.int32),
                  loss=np.zeros(ticks, np.float32), n=n, backend="dense", planes=planes)
    report = None
    if prov:
        rumors = [dict(slot=i, subject=int(rng.integers(0, n)), resolution=int(rng.integers(0, 3)),
                       infected=int(rng.integers(0, n)), depth_max=int(rng.integers(0, 5)),
                       infection_p50=int(rng.integers(0, 9)), infection_p95=int(rng.integers(0, 9)),
                       infection_p99=int(rng.integers(0, 9)), stragglers=int(rng.integers(0, 3)),
                       unattributed=int(rng.integers(0, 2)))
                  for i in range(int(rng.integers(0, 4)))]
        report = {"n": n, "log2_n": 4, "rumors": rumors}
    return trace, report

SYNTH_CASES = [dict(seed=s, **kw) for s, kw in enumerate([
    {}, {"traffic": False, "policy": False, "prov": False}, {"policy": False},
    {"prov": False}, {"never": True}, {"traffic": False}, {"ticks": 40, "n": 33},
])]
'''

_REFERENCE = r"""
import numpy as np
from ringpop_tpu.scenarios import library as lib
from ringpop_tpu.scenarios.trace import Trace
""" + _SYNTH + r"""
def catch(fn):
    try:
        fn()
        return ""
    except Exception as e:
        return f"{type(e).__name__}: {e}"

out = {"names": lib.incident_names(), "catalog": lib.format_catalog(),
       "grid": [list(t) for t in lib.policy_golden_grid()], "specs": {}, "docs": {},
       "summaries": [], "errors": {}}
for name in lib.incident_names():
    inc = lib.INCIDENTS[name]
    out["docs"][name] = lib.spec_document(name)
    out["errors"][name] = [catch(lambda: lib.build_incident(name, 4)),
                           catch(lambda: lib.build_incident(name, 16, backend="delta")),
                           catch(lambda: lib.build_incident(name, 16, backend="sided"))]
    for n in (8, 16, 64, 100):
        for ticks in (None, inc.default_ticks + 60):
            for overload in (True, False):
                spec, wl = lib.build_incident(name, n, ticks=ticks, overload=overload)
                out["specs"][f"{name}/{n}/{ticks}/{overload}"] = [spec.to_dict(), wl.to_dict()]
out["errors"]["unknown"] = [catch(lambda: lib.build_incident("no_such_incident", 16))]
for case in SYNTH_CASES:
    trace, report = synth(**case)
    s = lib.incident_summary(trace, prov=report)
    out["summaries"].append([s, lib.format_summary("x", s)])
json.dump(out, open(sys.argv[1], "w"))
"""

exec(_SYNTH)  # noqa: S102 - the same generator on the port's side


def _catch(fn) -> str:
    try:
        fn()
        return ""
    except Exception as e:  # noqa: BLE001 - compared with the reference's
        return f"{type(e).__name__}: {e}"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference_script(_REFERENCE, str(tmp_path_factory.mktemp("incidents")))


def test_catalog_and_grid(ref):
    assert lib.incident_names() == ref["names"]
    assert lib.format_catalog() == ref["catalog"]
    assert [list(t) for t in lib.policy_golden_grid()] == ref["grid"]


@pytest.mark.parametrize("name", lib.incident_names())
def test_incident_specs_equal_reference(ref, name):
    inc = lib.INCIDENTS[name]
    for n in SIZES:
        for ticks in (None, inc.default_ticks + 60):
            for overload in (True, False):
                spec, wl = lib.build_incident(name, n, ticks=ticks, overload=overload)
                got = json.loads(json.dumps([spec.to_dict(), wl.to_dict()]))
                assert got == ref["specs"][f"{name}/{n}/{ticks}/{overload}"], (n, ticks)
    errors = [_catch(lambda: lib.build_incident(name, 4)),
              _catch(lambda: lib.build_incident(name, 16, backend="delta")),
              _catch(lambda: lib.build_incident(name, 16, backend="sided"))]
    assert errors == ref["errors"][name]
    assert json.loads(json.dumps(lib.spec_document(name))) == ref["docs"][name]
    assert _catch(lambda: lib.build_incident("no_such_incident", 16)) == ref["errors"]["unknown"][0]


def test_spec_files_are_the_reference_rendering(ref, tmp_path):
    """The port's ``scenarios/specs/*.json`` are the library's rendering
    (``write_specs``) and the reference's own files, byte for byte."""
    written = lib.write_specs(str(tmp_path))
    ref_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "ringpop_tpu", "scenarios", "specs")
    assert sorted(os.listdir(lib.SPEC_DIR)) == sorted(os.listdir(ref_dir))
    for path in written:
        base = os.path.basename(path)
        with open(path) as f, open(os.path.join(lib.SPEC_DIR, base)) as g, \
                open(os.path.join(ref_dir, base)) as h:
            text = f.read()
            assert text == g.read() == h.read(), base
        assert json.loads(text) == ref["docs"][base[:-5]]


@pytest.mark.parametrize("i", range(7))
def test_summary_equals_reference(ref, i):
    trace, report = synth(**SYNTH_CASES[i])
    s = lib.incident_summary(trace, prov=report)
    assert all(isinstance(v, int) for v in s.values())
    assert [s, lib.format_summary("x", s)] == ref["summaries"][i]
