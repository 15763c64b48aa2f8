"""The trace-contract auditor (``ringpop_tpu_torch/analysis``) on the CPU.

The whole audit runs once (n = 64, the CLI's fixture size): every
registered entry on both backends must come out clean at severity error
and warning, the card-only contracts and the reference's HLO walks as
info findings, ``run_sweep+shard`` as an info finding and never clean.
Each planted fault of ``analysis/planted.py`` must be reported at
severity error (``tolist`` is the card's alone: the CPU's count of host
reads cannot see it, the lint can).  The carry table is held against the
reference's (``ringpop_tpu/analysis/budgets.py``, which imports no jax)
through ``CARRY_DIFFERENCES``; the CLI's listing, JSON lines and
refusals are checked in process.  No reference child runs here.
"""

from __future__ import annotations

import contextlib
import io
import json
from collections import Counter

import pytest
import torch

from test_torch_harness import one_thread  # noqa: F401 - a fixture

from ringpop_tpu_torch import __main__ as entry
from ringpop_tpu_torch.analysis import budgets, cli, contracts, lint, planted, registry

N = 64
PAIRS = list(registry.iter_entries())
AVAILABLE = [p for p in PAIRS if p[0] != "run_sweep+shard"]


@pytest.fixture(scope="module")
def audit(one_thread):  # noqa: F811
    reports, findings = contracts.audit_all(n=N, device="cpu")
    return {(r.entry, r.backend): r for r in reports}, findings


def test_every_pair_is_audited_or_named(audit):
    reports, findings = audit
    assert set(reports) == set(AVAILABLE)
    skipped = [f for f in findings if f.contract == "registry"]
    assert [(f.entry, f.severity) for f in skipped] == [("run_sweep+shard", "info")] * 2
    assert all("queue 1 item 11" in f.message for f in skipped)


@pytest.mark.parametrize("name,backend", AVAILABLE)
def test_entry_clean_on_cpu(audit, name, backend):
    r = audit[0][(name, backend)]
    assert r.device == "cpu" and r.n == N
    assert [str(f) for f in r.findings if f.severity != "info"] == []
    contracts_seen = {f.contract for f in r.findings}
    assert "no-counterpart" in contracts_seen and "byte-budget" in contracts_seen
    assert r.syncs is None and r.peak_bytes is None
    if r.mesh_size:
        assert "hop-budget" in contracts_seen
        row = budgets.HOP_BUDGETS[(name, r.mesh_size)]
        assert r.member_gathers == row["member_gathers"]
    ms = Counter(c.split("[")[0] for c in r.carries.values())
    assert dict(ms) == {k: v for k, v in budgets.CARRY_BUDGETS[(name, backend)].items() if v}


def test_run_scenario_keeps_to_tick1(audit):
    for backend in ("dense", "delta"):
        r = audit[0][("run_scenario", backend)]
        assert r.tick1_reads is not None and r.host_reads <= r.tick1_reads
        assert r.tick1_reads == budgets.SYNC_BUDGETS[("tick(1)", backend, N)]["reads"]


def test_census_tags_and_lineage(audit):
    reports = audit[0]
    delta = reports[("delta_run", "delta")]
    tags = {row["tag"] for row in delta.census}
    assert "NxC" in tags and not any(row["nxn"] for row in delta.census)
    dense = reports[("swim_run", "dense")]
    assert any(row["tag"] == "NxN" and row["dtype"] == "int32" for row in dense.census)
    rows = dense.census
    assert rows == sorted(rows, key=lambda r: (-r["bytes_each"] * r["count"], r["op"]))
    served = reports[("run_scenario+policy", "dense")]
    assert served.prng["roots"]["protocol"] > 0 and served.prng["roots"]["workload"] > 0


@pytest.mark.parametrize("name", sorted(planted.PLANTED))
def test_planted_fault_found_on_cpu(name, one_thread):  # noqa: F811
    p = planted.PLANTED[name]
    hits, _ = planted.run_planted(name, n=N, device="cpu")
    if p.card_only:
        # .tolist() dispatches no ATen op: the CPU's count is blind to it
        assert hits == []
    else:
        assert hits, f"{name}: no {p.contract} error"
        assert all(f.entry == p.entry for f in hits)
    assert not planted._KEPT


def test_tolist_seen_by_the_lint():
    src = ("def step_impl(state):\n"
           "    state.tick.tolist()\n"
           "    return state\n")
    found = lint.lint_source(src, "models/x.py", compiled_path=True)
    assert [f.contract for f in found] == ["lint:RPL001"]


def _reference_carries() -> dict:
    from ringpop_tpu.analysis import budgets as rbudgets

    return rbudgets.CARRY_BUDGETS


def test_carry_budgets_against_the_reference(audit):
    ref = _reference_carries()
    assert set(budgets.CARRY_BUDGETS) == set(ref) - {("run_sweep+shard", "dense"),
                                                     ("run_sweep+shard", "delta")}
    reports = audit[0]
    for key, mine in budgets.CARRY_BUDGETS.items():
        diff = Counter(mine)
        diff.subtract(ref[key])
        explained: Counter = Counter()
        carried = reports[key].carries
        for delta, fields, reason in budgets.CARRY_DIFFERENCES.get(key, ()):
            assert reason and delta, key
            explained.update(delta)
            for f in fields:
                assert f in carried, (key, f)
        assert +diff == +explained and -diff == -explained, key
        wide = {f for f, c in carried.items() if c.startswith(("int64", "float64"))}
        assert wide <= budgets.wide_fields(*key), key


def test_budget_tables_keep_their_rules():
    for (e, b, n), row in budgets.SYNC_BUDGETS.items():
        if e == "run_scenario":
            t1 = budgets.SYNC_BUDGETS[("tick(1)", b, n)]
            assert row["per_tick"] <= t1["per_tick"], (b, n)
        if "reads" in row:
            assert row["reads"] <= row["per_tick"], (e, b, n)
    assert set(budgets.BYTE_BUDGETS) == set(budgets.REFERENCE_CPU_PEAK)
    assert budgets.BYTE_TOLERANCE == 0.10
    for (e, d), row in budgets.HOP_BUDGETS.items():
        if e == "sharded_step+gather":
            # the gather lowering moves rows by gathers, never by hops
            assert row["member_gathers"] > 0 and row["hops"] == 0
        else:
            assert row["member_gathers"] == 0 and row["hops"] > 0


def test_print_budget_rows(audit):
    r = audit[0][("run_scenario", "delta")]
    rows = cli._budget_rows(r)
    assert rows[0] == '    ("run_scenario", "delta"): ' + str(
        dict(sorted(budgets.CARRY_BUDGETS[("run_scenario", "delta")].items()))) + ","
    assert '"per_tick": None, "reads": 18.5' in rows[1]
    assert rows[2].startswith('    ("tick(1)", "delta", 64)')


def _run_cli(argv) -> tuple[str, int]:
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf):
        try:
            cli.main(argv)
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else 1
    return buf.getvalue(), code


def test_cli_list_and_lint_only():
    out, code = _run_cli(["--list"])
    assert code == 0 and [ln.split()[0] for ln in out.splitlines()] == list(registry.ENTRY_POINTS)
    out, code = _run_cli(["--lint-only"])
    assert code == 0
    assert out.splitlines()[-1].startswith("audit: 0 programs, 0 lint findings, 0 errors")


def test_cli_json_subset(one_thread):  # noqa: F811
    out, code = _run_cli(["--device", "cpu", "--json", "--no-lint", "--entry",
                          "recv_merge_pallas,delta_merge_pallas,run_sweep+shard"])
    lines = [json.loads(ln) for ln in out.splitlines()]
    assert code == 0
    assert [(d["entry"], d["backend"]) for d in lines if d["kind"] == "entry"] == [
        ("recv_merge_pallas", "dense"), ("delta_merge_pallas", "delta")]
    assert [d["entry"] for d in lines if d["kind"] == "finding"] == ["run_sweep+shard"] * 2
    merge = lines[0]
    assert merge["host_reads"] == 0 and merge["carries"] == {} and merge["device"] == "cpu"


@pytest.mark.parametrize("argv,message", [
    (["--device", "cpu", "--entry", "swim_runn"], "unknown entry point"),
    (["--device", "cpu", "--entry", "swim_run", "--backend", "delta"], "matches no registered"),
    (["--no-compile", "--device", "cpu"], "no meaning in the port"),
    (["--device", "cpu", "--entry", "run_sweep+shard"], "0 programs audited"),
])
def test_cli_refusals(argv, message):
    with pytest.raises(SystemExit) as e:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(argv)
    assert message in str(e.value.code)


def test_cli_needs_a_card_without_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        cli.main(["--entry", "swim_run", "--no-lint"])


def test_main_dispatches_audit(monkeypatch):
    seen = []
    monkeypatch.setattr(cli, "main", lambda argv: seen.append(argv))
    monkeypatch.setattr("sys.argv", ["ringpop_tpu_torch", "audit", "--list"])
    entry.main()
    assert seen == [["--list"]]
    assert "audit" not in entry._NOT_PORTED
    for command in ("worker", "generate-hosts"):
        monkeypatch.setattr("sys.argv", ["ringpop_tpu_torch", command])
        with pytest.raises(NotImplementedError, match="item 12"):
            entry.main()
