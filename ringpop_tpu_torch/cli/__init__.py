"""CLI: the port of ``ringpop_tpu/cli`` (``tick-cluster``, its tpu-sim and
host-sim paths).

* ``python -m ringpop_tpu_torch tick-cluster --backend tpu-sim -n 64`` —
  the tensor simulation behind the reference's ``tick-cluster``
  command surface (keyboard commands, ``--script``, ``--scenario``,
  ``--incident``, ``--sweep``, ``--resume``), on ``--device`` (``cuda``
  unless told ``cpu``).
* ``python -m ringpop_tpu_torch tick-cluster --backend host-sim -n 5``
  (or ``--sim``) — the host library's in-process cluster on virtual
  time behind the same commands, each node's ring hashed on ``--device``.
* ``python -m ringpop_tpu_torch obs-ledger LEDGER.jsonl`` — the dispatch
  ledger's summary.

The reference's ``--backend proc``, ``worker`` and ``generate-hosts``
drive real processes over its TCP transport, which is not ported: they
raise.
"""
