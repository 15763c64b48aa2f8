"""``python -m ringpop_tpu_torch`` — CLI dispatcher.

Subcommands:

  tick-cluster    the simulated cluster harness and fault injector
                  (``--backend tpu-sim`` or ``host-sim``)
  obs-ledger      summarize a dispatch-ledger .jsonl (obs/ledger.py)
  audit           the trace-contract auditor (analysis/cli.py)

The reference's ``worker`` and ``generate-hosts`` (the TCP half of its
host library) are not ported and raise.
"""

from __future__ import annotations

import sys

# what the port lacks of the reference's dispatcher, and where it waits
_NOT_PORTED = {
    "worker": "ROADMAP queue 1 item 12 (b) (the host library's TCP half)",
    "generate-hosts": "ROADMAP queue 1 item 12 (b) (the host library's TCP half)",
}


def main() -> None:
    argv = sys.argv[1:]
    command = argv[0] if argv else None
    rest = argv[1:]
    if command == "tick-cluster":
        from ringpop_tpu_torch.cli.tick_cluster import main as tick_main

        tick_main(rest)
    elif command == "audit":
        from ringpop_tpu_torch.analysis.cli import main as audit_main

        audit_main(rest)
    elif command == "obs-ledger":
        from ringpop_tpu_torch.obs.ledger import main as ledger_main

        ledger_main(rest)
    elif command in _NOT_PORTED:
        raise NotImplementedError(
            f"'{command}' is not ported to ringpop_tpu_torch: {_NOT_PORTED[command]}"
        )
    else:
        print(__doc__)
        sys.exit(0 if command in (None, "-h", "--help") else 1)


if __name__ == "__main__":
    main()
