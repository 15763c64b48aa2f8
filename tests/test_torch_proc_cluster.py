"""``tick-cluster --backend proc`` (the default) and the ``worker``: real
worker processes over TCP, on the CPU.

* The port of ``tests/test_cli.py::test_proc_tick_cluster_three_real_
  processes``: three ``python -m ringpop_tpu_torch worker --device cpu``
  processes, ``wait_healthy``, ``j``, then ``t`` polled until ``tick:
  CONVERGED [3]`` within a stated deadline (no fixed wait); each worker's
  ``device`` stats hook.
* ``tick_cluster.main`` with no ``--backend`` takes the proc path and
  prints the reference's line shapes.
* Every worker is gone after ``shutdown``, also when a test fails (the
  fixture checks ``poll()``).
* A worker with no card and no ``--device`` exits non-zero with
  ``resolve_device``'s message; ``ProcCluster`` with no card and no device
  raises before it spawns anything.

The base port of each cluster is a free run probed at random
(``free_port_run``), never a fixed range, so that the suite's workers and
the reference's own proc test can run at the same moment.  The workers run
one torch thread each (``OMP_NUM_THREADS=1``): the suite's workers share
the host.
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from ringpop_tpu_torch.cli import tick_cluster as tc
from ringpop_tpu_torch.cli.admin_client import admin_request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEALTHY_S = 90  # the reference's proc test waits as long
CONVERGE_S = 30  # deadline for `t` to report one checksum group
TICK_LINE = re.compile(r"^tick: (CONVERGED \[\d+\]|\d+ groups \[\d+( \d+)*\]) in \d+ms$")


def capture(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def tick_until(cluster, want: str, deadline_s: float) -> str:
    """Send ``t`` until its line starts with ``tick: {want}``; the line."""
    end = time.monotonic() + deadline_s
    lines = []
    while True:
        line = capture(lambda: cluster.cmd("t")).strip()
        lines.append(line)
        if line.startswith(f"tick: {want}"):
            return line
        if time.monotonic() > end:
            raise AssertionError(f"no '{want}' within {deadline_s} s: {lines[-5:]}")
        time.sleep(0.2)


def all_gone(cluster) -> bool:
    return all(proc.poll() is not None for proc in cluster.procs.values())


@pytest.fixture
def clusters(monkeypatch):
    """Make ``ProcCluster``s on the CPU (a free base port each); shut each
    down at the end, pass or fail, and require every worker gone."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    made = []

    def make(size: int):
        cluster = tc.ProcCluster(size, tc.free_port_run(size), log_level="error",
                                 device="cpu")
        made.append(cluster)
        return cluster

    yield make
    for cluster in made:
        cluster.shutdown()
        assert all_gone(cluster)
        shutil.rmtree(cluster.workdir, ignore_errors=True)  # the workers' logs


def test_proc_tick_cluster_three_real_processes(clusters):
    cluster = clusters(3)
    cluster.wait_healthy(HEALTHY_S)
    assert sorted(cluster.startup_s) == sorted(cluster.host_ports)
    out = capture(lambda: tc.run_script(cluster, "j"))
    assert "join: 3 nodes joined" in out
    line = tick_until(cluster, "CONVERGED [3]", CONVERGE_S)
    assert TICK_LINE.match(line), line
    stats_out = capture(lambda: cluster.cmd("s"))
    assert re.fullmatch(r"  checksum \d+: 3 nodes \[.*\]\n", stats_out), stats_out
    for host_port in cluster.host_ports:
        stats = admin_request(host_port, "/admin/stats")
        assert stats["process"]["pid"] == cluster.procs[host_port].pid
        assert sorted(stats["ring"]) == sorted(cluster.host_ports)
        hook = stats["hooks"]["device"]
        assert hook["device"] == "cpu" and hook["warmupS"] == 0.0
        assert hook["ringBatches"] >= 1
        assert hook["shortLaunches"] == hook["warpLaunches"] == 0
        assert hook["hostSyncs"] is None


def test_cli_default_backend_is_proc(monkeypatch):
    """No ``--backend``: real processes, the reference's lines."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    made = []

    class Recorded(tc.ProcCluster):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(tc, "ProcCluster", Recorded)
    base = tc.free_port_run(3)
    out = capture(lambda: tc.main(["--device", "cpu", "-n", "3", "--base-port", str(base),
                                   "--log-level", "error", "--script", "j,w4000,t,q"]))
    lines = out.splitlines()
    assert lines[0] == "join: 3 nodes joined", out
    assert TICK_LINE.match(lines[1]), out
    assert lines[2:] == ["resumed 0 nodes"], out  # shutdown's line, as the reference's
    (cluster,) = made
    assert cluster.host_ports == [f"127.0.0.1:{base + i}" for i in range(3)]
    assert cluster.device == torch.device("cpu") and cluster.log_level == "error"
    assert all_gone(cluster)
    shutil.rmtree(cluster.workdir, ignore_errors=True)


def test_worker_needs_a_card_or_device(monkeypatch, tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    port = tc.free_port_run(1)
    proc = subprocess.run(
        [sys.executable, "-m", "ringpop_tpu_torch", "worker", "--listen",
         f"127.0.0.1:{port}", "--hosts", str(tmp_path / "hosts.json")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device is visible; pass device='cpu'" in proc.stderr
    # the cluster refuses before it spawns a worker
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_spawn(*args, **kwargs):
        raise AssertionError("a worker was spawned")

    monkeypatch.setattr(subprocess, "Popen", no_spawn)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.ProcCluster(3, port)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.main(["-n", "3", "--base-port", str(port), "--script", "t"])



def test_free_port_run_leaves_the_reference_tests_ports(monkeypatch):
    import random

    # runs of 11 from these bases each overlap 24300-24360 or 24500-24502,
    # the ports tests/test_tcp_transport.py and tests/test_cli.py bind
    overlapping = [24290, 24360, 24498, 24502]
    draws = iter(overlapping)
    real = random.SystemRandom.randrange
    monkeypatch.setattr(random.SystemRandom, "randrange",
                        lambda self, lo, hi: next(draws, None) or real(self, lo, hi))
    base = tc.free_port_run(11)
    assert next(draws, None) is None  # every overlapping draw was passed over
    assert all(base + 10 < lo or base > hi for lo, hi in tc.RESERVED_PORTS), base
    assert tc.RESERVED_PORTS == ((24300, 24360), (24500, 24502))
