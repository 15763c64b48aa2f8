"""``python -m ringpop_tpu_torch`` — CLI dispatcher.

Subcommands (reference §2.2: main.js, scripts/tick-cluster.js,
scripts/generate-hosts.js):

  worker          run one node over TCP (main.js parity; --device)
  tick-cluster    multi-node harness & fault injector (``--backend
                  proc``, the default: real worker processes;
                  ``host-sim``; ``tpu-sim``)
  generate-hosts  write a hosts.json
  obs-ledger      summarize a dispatch-ledger .jsonl (obs/ledger.py)
  audit           the trace-contract auditor (analysis/cli.py)
"""

from __future__ import annotations

import sys


def main() -> None:
    argv = sys.argv[1:]
    command = argv[0] if argv else None
    rest = argv[1:]
    if command == "worker":
        from ringpop_tpu_torch.cli.main import main as worker_main

        worker_main(rest)
    elif command == "tick-cluster":
        from ringpop_tpu_torch.cli.tick_cluster import main as tick_main

        tick_main(rest)
    elif command == "generate-hosts":
        from ringpop_tpu_torch.cli.generate_hosts import main as hosts_main

        hosts_main(rest)
    elif command == "obs-ledger":
        from ringpop_tpu_torch.obs.ledger import main as ledger_main

        ledger_main(rest)
    elif command == "audit":
        from ringpop_tpu_torch.analysis.cli import main as audit_main

        audit_main(rest)
    else:
        print(__doc__)
        sys.exit(0 if command in (None, "-h", "--help") else 1)


if __name__ == "__main__":
    main()
