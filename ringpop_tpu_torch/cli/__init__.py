"""CLI: the port of ``ringpop_tpu/cli`` (``tick-cluster``, tpu-sim path).

* ``python -m ringpop_tpu_torch tick-cluster --backend tpu-sim -n 64`` —
  the tensor simulation behind the reference's ``tick-cluster``
  command surface (keyboard commands, ``--script``, ``--scenario``,
  ``--incident``, ``--sweep``, ``--resume``), on ``--device`` (``cuda``
  unless told ``cpu``).
* ``python -m ringpop_tpu_torch obs-ledger LEDGER.jsonl`` — the dispatch
  ledger's summary.

The reference's ``--backend proc``/``host-sim``, ``worker`` and
``generate-hosts`` drive its host library (``harness.py``,
``ringpop.py``, ``transport/``), which is not ported: they raise.
"""
