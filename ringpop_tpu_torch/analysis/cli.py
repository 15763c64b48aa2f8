"""``python -m ringpop_tpu_torch audit`` — the trace-contract auditor CLI.

The port of ``ringpop_tpu/analysis/cli.py``.  Audits every registered
entry point (or a selection) on ``--device`` (``cuda`` unless told
``cpu``; with no card and no ``--device`` it raises, as ``tick-cluster``
does), lints the package and the checkout's ``chip_smoke.py``, and exits
1 when any finding reaches ``--fail-on`` severity.  The syncs, peak
bytes and hop launches are pinned on the card; on the CPU the audit
counts host reads (a lower bound) and reports the card-only contracts
as info findings.

Examples:

    python -m ringpop_tpu_torch audit --device cpu
    python -m ringpop_tpu_torch audit --fail-on error            # on the card
    python -m ringpop_tpu_torch audit --entry run_scenario --backend delta \\
        --n 65536 --print-budget                                  # a byte row
    python -m ringpop_tpu_torch audit --entry sharded_step --collectives
    python -m ringpop_tpu_torch audit --lint-only
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter

from ringpop_tpu_torch.analysis.findings import SEVERITY_RANK, at_least
from ringpop_tpu_torch.analysis.lint import lint_paths, package_root
from ringpop_tpu_torch.analysis.registry import ENTRY_POINTS


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m ringpop_tpu_torch audit",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--entry", default=None,
                    help="comma list of entry points (default: all; see --list)")
    ap.add_argument("--backend", choices=("dense", "delta", "both"), default="both")
    ap.add_argument("--device", default=None,
                    help="the torch device to audit on (cuda unless told; with no card and "
                         "no --device the audit raises)")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--ticks", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=32,
                    help="delta table width C (default 32: half the default n, so that the "
                         "census tells [N, C] from [N, N])")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--mesh", type=int, default=None,
                    help="shards of the sharded entries (default: each entry's own)")
    ap.add_argument("--fail-on", choices=("error", "warning", "info", "never"),
                    default="error", help="exit 1 when any finding reaches this severity")
    ap.add_argument("--json", action="store_true",
                    help="one JSON object per entry report and per other finding")
    ap.add_argument("--census", action="store_true",
                    help="print the tensor census rows")
    ap.add_argument("--collectives", action="store_true",
                    help="print the hop census of the sharded entries (hop launches, member "
                         "gathers)")
    ap.add_argument("--census-min-elems", type=int, default=None,
                    help="census threshold override (default: the entry's [N, C]-class floor)")
    ap.add_argument("--no-compile", action="store_true",
                    help="refused: the port runs eagerly and lowers nothing")
    ap.add_argument("--no-lint", action="store_true", help="skip the AST lint layer")
    ap.add_argument("--lint-only", action="store_true",
                    help="run only the AST lint layer (no entry runs)")
    ap.add_argument("--print-budget", action="store_true",
                    help="print ready-to-paste analysis/budgets.py rows (carry dtypes, syncs, "
                         "peak bytes, hops)")
    ap.add_argument("--list", action="store_true",
                    help="list registered entry points and exit")
    return ap.parse_args(argv)


def _budget_rows(r) -> list[str]:
    """The report's rows for the four tables of ``analysis/budgets.py``."""
    ms = Counter(c.split("[")[0] for c in r.carries.values())
    rows = [f'    ("{r.entry}", "{r.backend}"): {dict(sorted(ms.items()))},']
    syncs = "None" if r.syncs is None else f"{r.syncs:g}"
    rows.append(f'    ("{r.entry}", "{r.backend}", {r.n}): {{"ticks": {r.ticks}, '
                f'"per_tick": {syncs}, "reads": {r.host_reads:g}}},')
    if r.tick1_reads is not None:
        syncs = "None" if r.tick1_syncs is None else f"{r.tick1_syncs:g}"
        rows.append(f'    ("tick(1)", "{r.backend}", {r.n}): {{"ticks": {r.ticks}, '
                    f'"per_tick": {syncs}, "reads": {r.tick1_reads:g}}},')
    if r.peak_bytes is not None:
        rows.append(f'    ("{r.entry}", "{r.backend}", {r.n}): {{"ticks": {r.ticks}, '
                    f'"peak_bytes": {r.peak_bytes}}},')
    if r.mesh_size:
        hops = r.launches.get("ring_hop", 0) if r.device.startswith("cuda") else None
        rows.append(f'    ("{r.entry}", {r.mesh_size}): {{"n": {r.n}, "hops": {hops}, '
                    f'"member_gathers": {r.member_gathers}}},')
    return rows


def main(argv: list[str] | None = None) -> None:
    args = _parse(argv)

    if args.list:
        for name, spec in ENTRY_POINTS.items():
            print(f"{name:24s} [{'/'.join(spec.backends)}] {spec.doc}")
        return
    if args.no_compile:
        sys.exit("audit: --no-compile has no meaning in the port: it runs eagerly and lowers "
                 "no program (the reference's flag skipped its StableHLO lowering)")

    findings = []
    reports = []
    if not args.lint_only:
        from ringpop_tpu_torch import resolve_device
        from ringpop_tpu_torch.analysis.contracts import audit_all
        from ringpop_tpu_torch.analysis.registry import iter_entries

        names = args.entry.split(",") if args.entry else None
        backends = None if args.backend == "both" else (args.backend,)
        # a typo'd --entry (or a pair matching nothing) must not fail open
        if names is not None:
            unknown = [n for n in names if n not in ENTRY_POINTS]
            if unknown:
                sys.exit(f"audit: unknown entry point(s) {unknown}; --list shows the registry")
        if not list(iter_entries(names, backends)):
            sys.exit("audit: the --entry/--backend selection matches no registered "
                     "(entry, backend) pair")
        device = resolve_device(args.device)
        extra = {} if args.mesh is None else {"mesh": args.mesh}
        reports, audit_findings = audit_all(
            names, backends, n=args.n, ticks=args.ticks, capacity=args.capacity,
            replicas=args.replicas, device=device, census_min_elems=args.census_min_elems,
            **extra)
        findings += audit_findings

    lint_ran = args.lint_only or not args.no_lint
    if lint_ran:
        smoke = package_root().parent / "chip_smoke.py"
        findings += lint_paths(extra=[smoke] if smoke.exists() else [])

    if args.json:
        for r in reports:
            print(json.dumps({"kind": "entry", **r.to_json()}))
        for f in findings:
            if not any(f in r.findings for r in reports):
                print(json.dumps({"kind": "finding", **f.to_json()}))
    else:
        for r in reports:
            sev = Counter(f.severity for f in r.findings if f.severity != "info")
            status = ("clean" if not sev else
                      " ".join(f"{v} {k}" for k, v in sorted(sev.items())))
            syncs = ("" if r.syncs is None else f"syncs {r.syncs:g}/tick, ")
            peak = "" if r.peak_bytes is None else f", peak {r.peak_bytes} B"
            mesh = (f", shards={r.mesh_size} hops={r.launches.get('ring_hop', 0)} "
                    f"member-gathers={r.member_gathers}" if r.mesh_size else "")
            print(f"{r.entry} [{r.backend}] n={r.n} on {r.device}: {status}; {syncs}"
                  f"host reads {r.host_reads:g}/tick, {len(r.census)} census rows, "
                  f"prng roots={r.prng.get('roots', {})}{peak}{mesh}")
            if args.census:
                for row in r.census:
                    print(f"    [{row['tag']}] {row['dtype']}{row['shape']} x{row['count']} "
                          f"via {row['op']} ({row['bytes_each'] / 1e6:.3f} MB each)")
            if args.collectives and r.mesh_size:
                where = ("counted on the card" if r.device.startswith("cuda")
                         else "the CPU runs the plain hop: needs the card")
                print(f"    ring-hop launches {r.launches.get('ring_hop', 0)} ({where}), "
                      f"member gathers {r.member_gathers}")
            if args.print_budget:
                for line in _budget_rows(r):
                    print(line)
        lint_findings = [f for f in findings if f.contract.startswith("lint:")]
        for f in findings:
            if SEVERITY_RANK[f.severity] >= SEVERITY_RANK["warning"] or f.contract.startswith(
                    "lint:") or f.contract == "registry":
                print(str(f))
        total = Counter(f.severity for f in findings)
        lint_part = f"{len(lint_findings)} lint findings" if lint_ran else "lint skipped"
        print(f"audit: {len(reports)} programs, {lint_part}, {total.get('error', 0)} errors / "
              f"{total.get('warning', 0)} warnings / {total.get('info', 0)} info")

    if not args.lint_only and not reports:
        sys.exit("audit: 0 programs audited — every selected entry was skipped here (the "
                 "info findings above name what each one needs)")
    if args.fail_on != "never" and at_least(findings, args.fail_on):
        sys.exit(1)


if __name__ == "__main__":
    main()
