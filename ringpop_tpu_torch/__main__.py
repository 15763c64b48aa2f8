"""``python -m ringpop_tpu_torch`` — CLI dispatcher.

Subcommands:

  tick-cluster    the simulated cluster harness and fault injector
                  (``--backend tpu-sim``)
  obs-ledger      summarize a dispatch-ledger .jsonl (obs/ledger.py)

The reference's ``worker`` and ``generate-hosts`` (its host library) and
``audit`` (its trace-contract auditor) are not ported and raise.
"""

from __future__ import annotations

import sys

# what the port lacks of the reference's dispatcher, and where it waits
_NOT_PORTED = {
    "worker": "ROADMAP queue 1 item 12 (the host library)",
    "generate-hosts": "ROADMAP queue 1 item 12 (the host library)",
    "audit": "ROADMAP queue 1 item 9 (audit and bench)",
}


def main() -> None:
    argv = sys.argv[1:]
    command = argv[0] if argv else None
    rest = argv[1:]
    if command == "tick-cluster":
        from ringpop_tpu_torch.cli.tick_cluster import main as tick_main

        tick_main(rest)
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
