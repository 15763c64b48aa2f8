"""CLI: the port of ``ringpop_tpu/cli`` (reference: main.js,
scripts/tick-cluster.js, scripts/generate-hosts.js).

* ``python -m ringpop_tpu_torch worker --listen H:P --hosts hosts.json``
  — one real node over the TCP transport (main.js parity), its ring on
  ``--device`` (``cuda`` unless told ``cpu``).
* ``python -m ringpop_tpu_torch tick-cluster -n 5`` — the multi-process
  cluster harness and fault injector (``--backend proc``, the default:
  one worker process a node), with the host library's in-process
  cluster on virtual time (``--backend host-sim`` or ``--sim``) and the
  tensor simulation (``--backend tpu-sim``) behind the same commands.
* ``python -m ringpop_tpu_torch generate-hosts`` — hosts.json generator.
* ``python -m ringpop_tpu_torch obs-ledger LEDGER.jsonl`` — the dispatch
  ledger's summary.
"""
