"""``tick-cluster --backend tpu-sim`` against the reference's.

The reference's ``cli.tick_cluster.main`` runs each case's arguments in
a child process on the CPU, the port's ``main`` runs the same arguments
with ``--device cpu``; the printed lines must be equal once the
elapsed-ms field is taken out, and so must the files the run writes
(the ``--trace-out`` trace, the ``--stats-out`` stat lines without their
wall-clock stamps, the ``--spans-out`` trace events and the
``--script-to-scenario`` spec).  The delta incident is in
``test_torch_cli_delta.py``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from test_torch_harness import ReferenceScript, one_thread  # noqa: F401 - a fixture

from ringpop_tpu_torch.cli import tick_cluster as tc
from ringpop_tpu_torch.scenarios.spec import Event, ScenarioSpec

TPU_SIM = ["--backend", "tpu-sim"]
# (name, argv): "{dir}" is each side's own output directory
CASES = [
    ("script", TPU_SIM + ["-n", "24", "--seed", "5", "--loss", "0.02", "--script",
                          "j,g,t,k,w6000,t,s,K,w8000,t,l,w2000,t,L,w2000,t,p,d,D,q"]),
    ("list_incidents", ["--list-incidents"]),
    ("list_policies", ["--list-policies", "-n", "16"]),
    ("incident_dense", TPU_SIM + ["-n", "16", "--seed", "3", "--incident",
                                  "cascading_overload", "--policy", "combined"]),
    ("traced", TPU_SIM + ["-n", "16", "--seed", "3", "--incident", "hot_tenant_blackhole",
                          "--trace-rumors", "4", "--trace-out", "{dir}/trace.npz",
                          "--stats-out", "{dir}/stats.jsonl", "--spans-out",
                          "{dir}/spans.json"]),
    ("checkpoint", TPU_SIM + ["-n", "16", "--seed", "3", "--scenario", "{dir}/spec.json",
                              "--traffic", "uniform:32", "--latency-buckets", "8",
                              "--segment-ticks", "8", "--checkpoint", "{dir}/ck.npz",
                              "--checkpoint-every", "2"]),
    ("resume", ["--resume", "{dir}/ck.npz", "--trace-out", "{dir}/resumed.npz"]),
    ("sweep", TPU_SIM + ["-n", "16", "--seed", "3", "--scenario", "{dir}/spec.json",
                         "--sweep", "2", "--sweep-loss-scales", "1,2"]),
    ("script_to_scenario", ["-n", "8", "--script", "j,t,k,w1000,t,K,w400,t",
                            "--script-to-scenario", "{dir}/s2s.json"]),
    ("refused", ["-n", "16", "--incident", "cascading_overload"]),
]
SPEC = ScenarioSpec(ticks=20, events=(Event(at=4, op="kill", node=3),
                                      Event(at=12, op="revive", node=3)))

_CHILD = r"""
import contextlib, io
from ringpop_tpu.cli import tick_cluster as tc
out = {}
for name, argv in CASES:
    argv = [a.replace("{dir}", DIR) for a in argv]
    buf = io.StringIO()
    code = ""
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            tc.main(argv)
    except SystemExit as e:
        code = f"SystemExit: {e.code}"
    out[name] = [buf.getvalue(), code]
json.dump(out, open(sys.argv[1], "w"))
"""


def _write_spec(directory: str) -> None:
    os.makedirs(directory, exist_ok=True)
    SPEC.save(os.path.join(directory, "spec.json"))


def run_port_cases(cases, directory: str) -> dict[str, list[str]]:
    out = {}
    for name, argv in cases:
        argv = [a.replace("{dir}", directory) for a in argv] + ["--device", "cpu"]
        buf = io.StringIO()
        code = ""
        try:
            with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
                tc.main(argv)
        except SystemExit as e:
            code = f"SystemExit: {e.code}"
        out[name] = [buf.getvalue(), code]
    return out


def run_both(cases, tmp_dir: str, name: str):
    """(port, reference, port dir, reference dir): each side's printed
    output and exit per case, the reference in a child meanwhile."""
    ref_dir, port_dir = os.path.join(tmp_dir, "ref"), os.path.join(tmp_dir, "port")
    for d in (ref_dir, port_dir):
        _write_spec(d)
    child = ReferenceScript(f"CASES = {cases!r}\nDIR = {ref_dir!r}\n" + _CHILD, tmp_dir, name)
    try:
        port = run_port_cases(cases, port_dir)
        return port, child.result(), port_dir, ref_dir
    finally:
        child.close()


def normalized(text: str, directory: str) -> str:
    """The printed lines with the elapsed-ms field and the side's own
    directory taken out."""
    return re.sub(r" in \d+ms", " in <ms>", text.replace(directory, "<dir>"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_thread):  # noqa: F811
    return run_both(CASES, str(tmp_path_factory.mktemp("cli")), "cli")


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_printed_lines_equal(runs, name):
    port, ref, port_dir, ref_dir = runs
    got, want = port[name], ref[name]
    assert got[1] == want[1]
    assert normalized(got[0], port_dir) == normalized(want[0], ref_dir)
    assert got[0].strip() or got[1]


def test_written_files_equal(runs):
    _, _, port_dir, ref_dir = runs
    for base in ("trace.npz", "resumed.npz"):
        with np.load(os.path.join(port_dir, base)) as a, \
                np.load(os.path.join(ref_dir, base)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (base, k)

    def stat_rows(d):
        with open(os.path.join(d, "stats.jsonl")) as f:
            return [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in f]

    assert stat_rows(port_dir) == stat_rows(ref_dir) and stat_rows(port_dir)
    for base in ("spans.json", "s2s.json"):
        with open(os.path.join(port_dir, base)) as f, open(os.path.join(ref_dir, base)) as g:
            assert json.load(f) == json.load(g), base


def test_no_card_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.main(TPU_SIM + ["-n", "8", "--script", "t"])


def test_host_library_paths_raise(monkeypatch):
    from ringpop_tpu_torch import __main__ as entry

    # the process backend waits for the TCP half of the host library;
    # host-sim (= --sim) is ported (tests/test_torch_host_cluster.py)
    for argv in (["-n", "3", "--script", "t"], ["--backend", "proc", "--script", "t"]):
        with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1 item 12 \(b\)"):
            tc.main(argv)
    for command, item in (("worker", r"item 12 \(b\)"), ("generate-hosts", r"item 12 \(b\)")):
        monkeypatch.setattr(sys, "argv", ["ringpop_tpu_torch", command])
        with pytest.raises(NotImplementedError, match=item):
            entry.main()
    # the auditor is ported: it lists its entries, and with no card and
    # no --device it raises as the other entry points do
    monkeypatch.setattr(sys, "argv", ["ringpop_tpu_torch", "audit", "--list"])
    entry.main()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["ringpop_tpu_torch", "audit", "--entry", "swim_run"])
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        entry.main()
