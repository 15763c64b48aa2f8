"""Pinned budgets of the port's entry points: carries, syncs, bytes, hops.

The port's own tables (``ringpop_tpu/analysis/budgets.py`` is the
reference's).  The auditor compares what an entry actually does against
what was explicitly allowed, so a silent regression (a widened carry
field, a new read back in the tick loop, a peak that grew, a new hop)
fails the audit until the change is justified and the row re-pinned.
Every number is the port's: the carries are read off its CPU runs (they
are the same on the card), the syncs, bytes and hops were measured on
the card named beside them.  Print ready-to-paste rows with::

    python -m ringpop_tpu_torch audit [--device cpu] --entry NAME --print-budget

* ``CARRY_BUDGETS`` — the dtype multiset of the tensors an entry carries
  from tick to tick: the state's fields and the net planes it updates
  (no key rides from tick to tick: every entry splits its key schedule
  before the first tick, as the reference's scans take theirs as xs).
  ``CARRY_DIFFERENCES`` gives each difference from the reference's row
  with the port's fields it concerns and its reason; an int64 or
  float64 field that no difference names is an error.
* ``SYNC_BUDGETS`` — host syncs a tick (a replica-tick for sweeps, a call
  for a kernel or one sharded step) per (entry, backend, n) at a pinned
  tick count.  The reference pins zero host transfers inside its
  compiled program; the port's tick is a host loop, so its budget is a
  count: each sync drains the card's queue.  ``tick(1)`` rows are the
  same scenario run as ``SimCluster.tick(1)`` calls, which
  ``run_scenario`` may not exceed.
* ``BYTE_BUDGETS`` — ``torch.cuda.max_memory_allocated`` over one call
  less the allocation at its start, within ``BYTE_TOLERANCE``: over the
  band is an error, under it by more a prompt to re-pin.
  ``REFERENCE_CPU_PEAK`` is the reference's CPU-XLA derived peak of the
  same rows, printed beside them for information, never a bound.
* ``HOP_BUDGETS`` — ring-hop kernel launches (``csrc/ring_hop.cu``) of
  one sharded step per (entry, shards), and its member gathers: the
  port's counterpart of the reference's collective census, in which on
  one card every cross-shard transfer is a launch of the hop.
"""

from __future__ import annotations

from collections import Counter

# (entry, backend) -> {dtype: carried fields}.  The dense state is
# view_key/tick int32 and pb/suspect_left int8; the delta state adds the
# base and table planes, with the packed bit words and the rolling
# digest as int64 (uint32 values); a scenario adds up and responsive
# (bool), the group ids (int32), the int16 period row of the overload
# shapes, the overload, policy and provenance carries.
CARRY_BUDGETS: dict[tuple[str, str], dict[str, int]] = {
    ("swim_run", "dense"): {"int32": 2, "int8": 2},
    ("delta_run", "delta"): {"int32": 7, "int64": 2, "int8": 2},
    ("run_scenario", "dense"): {"bool": 2, "int32": 3, "int8": 2},
    ("run_scenario", "delta"): {"bool": 2, "int32": 8, "int64": 2, "int8": 2},
    ("run_scenario+traffic", "dense"): {"bool": 2, "int32": 3, "int8": 2},
    ("run_scenario+traffic", "delta"): {"bool": 2, "int32": 8, "int64": 2, "int8": 2},
    ("run_scenario+incident", "dense"): {"bool": 3, "int16": 1, "int32": 4, "int8": 2},
    ("run_scenario+incident", "delta"): {"bool": 3, "int16": 1, "int32": 9, "int64": 2,
                                         "int8": 2},
    ("run_scenario+policy", "dense"): {"bool": 5, "int16": 1, "int32": 8, "int8": 2},
    ("run_scenario+policy", "delta"): {"bool": 5, "int16": 1, "int32": 13, "int64": 2,
                                       "int8": 2},
    ("run_scenario+provenance", "dense"): {"bool": 2, "int16": 2, "int32": 6, "int64": 1,
                                           "int8": 2},
    ("run_scenario+provenance", "delta"): {"bool": 2, "int16": 2, "int32": 11, "int64": 3,
                                           "int8": 2},
    ("run_sweep", "dense"): {"bool": 2, "int32": 3, "int8": 2},
    ("run_sweep", "delta"): {"bool": 2, "int32": 8, "int64": 2, "int8": 2},
    ("run_sweep+param_axes", "dense"): {"bool": 2, "int32": 3, "int8": 2},
    ("run_sweep+param_axes", "delta"): {"bool": 2, "int32": 8, "int64": 2, "int8": 2},
    ("recv_merge_pallas", "dense"): {},
    ("delta_merge_pallas", "delta"): {},
    ("sharded_step", "dense"): {"int32": 2, "int8": 2},
    ("sharded_step@4", "dense"): {"int32": 2, "int8": 2},
    ("sharded_step+gather", "dense"): {"int32": 2, "int8": 2},
    ("sharded_delta_step", "delta"): {"int32": 7, "int64": 2, "int8": 2},
}

_WORDS = ("uint32 words held in int64: torch's uint32 support is partial, so the packed "
          "base-pingable bits and the rolling view digest (uint32 values) ride as int64 "
          "(models/swim_delta.py DeltaState)")
_UNPACKED = ("bool[N] planes ride unpacked, a byte a node: the reference packs each into "
             "ceil(N/32) uint32 words (its r06 narrowing); the port reads them as masks every "
             "tick and packs only in checkpoints (models/swim_sim.py NetState)")
_KNOWS = ("the provenance knows words are int64 in the port (uint32 values; uint32 in "
          "checkpoint files): obs/provenance.py")
_LOOP_STATE = ("the reference's row counts the int32 loop state of the step's inner "
               "sort/fori kernels (its step has no tick scan); the port's step is a host loop "
               "with no loop state")
_STEP_STATE = "the port counts the state the step takes and returns"
_DENSE = ("view_key", "pb", "suspect_left", "tick")
_DELTA = ("base_key", "bp_mask", "bp_rank", "bp_list", "d_subj", "d_key", "d_pb", "d_sl",
          "tick", "overflow_drops", "digest")

# (entry, backend) -> [(dtype counts, port - reference; the port's
# fields it concerns; reason)].  A row's differences sum to its port
# multiset less the reference's (tests/test_torch_audit.py holds them).
CARRY_DIFFERENCES: dict[tuple[str, str], list[tuple[dict[str, int], tuple[str, ...], str]]] = {}


def _differ(rows: list[tuple[str, str]], delta: dict[str, int], fields: tuple[str, ...],
            reason: str) -> None:
    for row in rows:
        CARRY_DIFFERENCES.setdefault(row, []).append((delta, fields, reason))


_SCENARIOS = ("run_scenario", "run_scenario+traffic", "run_scenario+incident",
              "run_scenario+policy", "run_scenario+provenance", "run_sweep",
              "run_sweep+param_axes")
_differ([("delta_run", "delta")] + [(e, "delta") for e in _SCENARIOS],
        {"int64": 2, "uint32": -2}, ("bp_mask", "digest"), _WORDS)
_differ([(e, b) for e in _SCENARIOS for b in ("dense", "delta")],
        {"bool": 2, "uint32": -2}, ("up", "responsive"), _UNPACKED)
_differ([(e, b) for e in ("run_scenario+incident", "run_scenario+policy")
         for b in ("dense", "delta")], {"bool": 1, "uint32": -1}, ("ov_gray",), _UNPACKED)
_differ([("run_scenario+policy", b) for b in ("dense", "delta")],
        {"bool": 2, "uint32": -2}, ("po_shed", "po_quar"), _UNPACKED)
_differ([("run_scenario+provenance", b) for b in ("dense", "delta")],
        {"int64": 1, "uint32": -1}, ("pv_knows",), _KNOWS)
_differ([("recv_merge_pallas", "dense")], {"int32": -2}, (),
        "the reference's two int32 carries are the searchsorted scans inside its wrapper; "
        "the port's merge is a counting sort on the card, with no loop")
_differ([("sharded_step", "dense"), ("sharded_step@4", "dense")], {"int32": -24}, (),
        _LOOP_STATE)
_differ([("sharded_step+gather", "dense")], {"int32": -44}, (), _LOOP_STATE)
_differ([("sharded_delta_step", "delta")], {"int32": -110}, (), _LOOP_STATE)
_differ([(e, "dense") for e in ("sharded_step", "sharded_step@4", "sharded_step+gather")],
        {"int32": 2, "int8": 2}, _DENSE, _STEP_STATE)
_differ([("sharded_delta_step", "delta")], {"int32": 7, "int64": 2, "int8": 2}, _DELTA,
        _STEP_STATE + "; " + _WORDS)


def wide_fields(entry: str, backend: str) -> set[str]:
    """The carried fields a ``CARRY_DIFFERENCES`` entry names for the row:
    the only ones that may be int64 or float64."""
    return {f for _, fields, _ in CARRY_DIFFERENCES.get((entry, backend), ()) for f in fields}


# (entry, backend, n) -> {"ticks": the fixture's ticks, "per_tick": the
# card's host syncs a tick (a replica-tick for sweeps, a call for a
# kernel or one sharded step), "reads": the audit's dispatch count of
# host reads a tick (``aten._local_scalar_dense`` and data-dependent
# shapes, outside the kernels' plain versions: the same count on the CPU
# and the card, a lower bound of the card's syncs; left out where it was
# not counted)}.  The card's numbers: chip_smoke.py phase o on one
# NVIDIA H100 80GB HBM3, 700.00 W, the same in every run since the audit
# opens an empty window first; the fixture's "reads" from the CPU run of
# the same audit, equal to the card's.
SYNC_BUDGETS: dict[tuple[str, str, int], dict[str, float]] = {
    ("swim_run", "dense", 64): {"ticks": 4, "per_tick": 1.0, "reads": 1},
    ("delta_run", "delta", 64): {"ticks": 4, "per_tick": 11, "reads": 11},
    ("run_scenario", "dense", 64): {"ticks": 4, "per_tick": 3.25, "reads": 3},
    ("run_scenario", "delta", 64): {"ticks": 4, "per_tick": 18.75, "reads": 18.5},
    ("run_scenario+traffic", "dense", 64): {"ticks": 4, "per_tick": 3.25, "reads": 3},
    ("run_scenario+traffic", "delta", 64): {"ticks": 4, "per_tick": 18.75, "reads": 18.5},
    ("run_scenario+incident", "dense", 64): {"ticks": 4, "per_tick": 3.25, "reads": 3},
    ("run_scenario+incident", "delta", 64): {"ticks": 4, "per_tick": 18.5, "reads": 18.25},
    ("run_scenario+policy", "dense", 64): {"ticks": 4, "per_tick": 3.25, "reads": 3},
    ("run_scenario+policy", "delta", 64): {"ticks": 4, "per_tick": 18.5, "reads": 18.25},
    ("run_scenario+provenance", "dense", 64): {"ticks": 4, "per_tick": 3.75, "reads": 3},
    ("run_scenario+provenance", "delta", 64): {"ticks": 4, "per_tick": 18.5, "reads": 17.75},
    ("run_sweep", "dense", 64): {"ticks": 4, "per_tick": 3.125, "reads": 3},
    ("run_sweep", "delta", 64): {"ticks": 4, "per_tick": 16, "reads": 15.875},
    ("run_sweep+param_axes", "dense", 64): {"ticks": 4, "per_tick": 3.125, "reads": 3},
    ("run_sweep+param_axes", "delta", 64): {"ticks": 4, "per_tick": 16, "reads": 15.875},
    # the kernels' host-level calls and one sharded step: "ticks" 1 (a call)
    ("recv_merge_pallas", "dense", 64): {"ticks": 1, "per_tick": 0, "reads": 0},
    ("delta_merge_pallas", "delta", 64): {"ticks": 1, "per_tick": 0, "reads": 0},
    ("sharded_step", "dense", 64): {"ticks": 1, "per_tick": 1, "reads": 1},
    ("sharded_step@4", "dense", 64): {"ticks": 1, "per_tick": 1, "reads": 1},
    ("sharded_step+gather", "dense", 64): {"ticks": 1, "per_tick": 1, "reads": 1},
    ("sharded_delta_step", "delta", 64): {"ticks": 1, "per_tick": 11, "reads": 11},
    # the same scenario as SimCluster.tick(1) calls (run_host_loop): the
    # bound run_scenario keeps ("reads" counted at n = 64 on the CPU)
    ("tick(1)", "dense", 64): {"ticks": 4, "per_tick": 4, "reads": 3},
    ("tick(1)", "delta", 64): {"ticks": 4, "per_tick": 21.25, "reads": 20.25},
    # run_scenario at the byte rows' and the main paths' sizes, with its
    # tick(1) companion ("reads" of run_scenario counted on the card)
    ("run_scenario", "dense", 4096): {"ticks": 4, "per_tick": 3.25, "reads": 3},
    ("tick(1)", "dense", 4096): {"ticks": 4, "per_tick": 4},
    ("run_scenario", "delta", 4096): {"ticks": 4, "per_tick": 20.25, "reads": 20},
    ("tick(1)", "delta", 4096): {"ticks": 4, "per_tick": 21.75},
    ("run_scenario", "dense", 10000): {"ticks": 4, "per_tick": 3.25, "reads": 3},
    ("tick(1)", "dense", 10000): {"ticks": 4, "per_tick": 4},
    ("run_scenario", "delta", 65536): {"ticks": 4, "per_tick": 20.25, "reads": 20},
    ("tick(1)", "delta", 65536): {"ticks": 4, "per_tick": 23.5},
}

# (entry, backend, n) -> {"ticks", "peak_bytes"}: the peak over one call
# less the allocation at its start (after a garbage collection: earlier
# work's garbage freed inside the window hid up to 600 MB of a peak),
# the reference's three rows at 4 ticks (the delta ones at the audit's
# capacity 32, claim grid 48).  NVIDIA H100 80GB HBM3, 700.00 W
# (chip_smoke.py phase o; runs agree within 2.2%).
BYTE_BUDGETS: dict[tuple[str, str, int], dict[str, int]] = {
    ("run_scenario", "dense", 4096): {"ticks": 4, "peak_bytes": 1074129920},
    ("run_scenario", "delta", 4096): {"ticks": 4, "peak_bytes": 47954432},
    ("run_scenario", "delta", 65536): {"ticks": 4, "peak_bytes": 755976704},
}

# Fractional tolerance band around every pinned peak (the reference's).
BYTE_TOLERANCE = 0.10

# The reference's CPU-XLA derived peaks of the same rows, at 4 ticks
# (ringpop_tpu/analysis/budgets.py BYTE_BUDGETS): printed beside the
# port's for information only.
REFERENCE_CPU_PEAK: dict[tuple[str, str, int], int] = {
    ("run_scenario", "dense", 4096): 889737460,
    ("run_scenario", "delta", 4096): 35991920,
    ("run_scenario", "delta", 65536): 575688560,
}

# (entry, shards) -> {"n": fixture n, "hops": ring-hop launches a step
# (card), "member_gathers": gathers along the member axis a step (the
# same on the CPU and the card)}.  The ring entries declare p2p_only, so
# a member gather there is an error before its count is compared; the
# gather lowering's are its measured cost.  NVIDIA H100 80GB HBM3,
# 700.00 W (chip_smoke.py phase o).
HOP_BUDGETS: dict[tuple[str, int], dict[str, int]] = {
    ("sharded_step", 2): {"n": 64, "hops": 5, "member_gathers": 0},
    ("sharded_step@4", 4): {"n": 64, "hops": 15, "member_gathers": 0},
    ("sharded_step+gather", 2): {"n": 64, "hops": 0, "member_gathers": 3},
    ("sharded_delta_step", 2): {"n": 64, "hops": 2, "member_gathers": 0},
}


def format_multiset(ms: Counter | dict[str, int]) -> str:
    items = sorted(dict(ms).items())
    return "{" + ", ".join(f"{k}: {v}" for k, v in items) + "}"
