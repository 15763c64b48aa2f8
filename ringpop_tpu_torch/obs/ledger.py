"""Dispatch ledger: per-dispatch forensics for the scenario entry points.

The port of ``ringpop_tpu/obs/ledger.py``.  Every dispatch routed
through it gets one JSON line with the reference's field set:

    {"ts": ..., "program": "run_scenario", "backend": "dense",
     "platform": "gpu", "n": 16, "ticks": 60, "replicas": 1,
     "cold": true, "sig": ..., "trace_s": 0.0, "compile_s": 0.0,
     "execute_s": ..., "argument_bytes": ..., "output_bytes": ...,
     "temp_bytes": ..., "alias_bytes": ..., "generated_code_bytes": 0,
     "peak_bytes": ..., "peak_is_derived": false}

Cold/warm follows the reference's rule: a row is cold on the first
dispatch of its (program, abstract signature) pair, the signature being
each argument tensor's shape, dtype and device plus the static keyword
arguments; a second cold signature of one program names what changed in
``recompile_cause``.  PyTorch runs the port eagerly and compiles
nothing, so ``trace_s`` and ``compile_s`` are always 0.0: a cold row
only says that this shape is new.

``execute_s`` is the dispatch's time between two CUDA events on the
card and on the host clock on the CPU.  On the card the memory fields
are measured around the dispatch: ``argument_bytes`` and
``output_bytes`` are the bytes of the tensors passed in and returned
(``alias_bytes`` those of returned tensors that share an argument's
storage), ``peak_bytes`` is ``torch.cuda.max_memory_allocated`` over
the dispatch (the peak counter is reset at its start, so a caller that
reads the peak itself should not run with the ledger on), and
``temp_bytes`` is what the peak held beyond the memory allocated at
entry and the new outputs.  On the CPU they are zeros, as the
reference's rows are on a backend without a memory analysis.
``platform`` is ``"gpu"`` or ``"cpu"``, as jax names them, so that
summaries of both packages group alike.

The ledger is off by default: ``dispatch`` is then a plain call-through.
Turn it on with ``default_ledger().enable(path)`` or
``RINGPOP_LEDGER=/path/to.jsonl`` in the environment; ``path=None``
keeps rows in memory only.

Summarizer:  python -m ringpop_tpu_torch.obs.ledger LEDGER.jsonl
(also ``python -m ringpop_tpu_torch obs-ledger``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

ENV_VAR = "RINGPOP_LEDGER"

# In-memory row cap (the JSONL file keeps everything): a long-lived
# process must not keep one dict per dispatch forever.
MAX_ROWS_IN_MEMORY = 10_000

_MEM_FIELDS = (
    "argument_bytes",
    "output_bytes",
    "temp_bytes",
    "alias_bytes",
    "generated_code_bytes",
    "peak_bytes",
    "peak_is_derived",
)


def _zero_memory_row() -> dict[str, int | bool]:
    return {f: (False if f == "peak_is_derived" else 0) for f in _MEM_FIELDS}


def _flatten(x: Any, leaves: list) -> str:
    """The structure of ``x`` as a string, its leaves appended to
    ``leaves``: tensors and arrays are leaves; named tuples, tuples,
    lists, dicts, dataclasses and objects with attributes are walked;
    None is structure."""
    if x is None:
        return "None"
    if isinstance(x, (torch.Tensor, np.ndarray)):
        leaves.append(x)
        return "*"
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        inner = ",".join(_flatten(getattr(x, f), leaves) for f in x._fields)
        return f"{type(x).__name__}({inner})"
    if isinstance(x, (tuple, list)):
        inner = ",".join(_flatten(v, leaves) for v in x)
        return f"({inner})" if isinstance(x, tuple) else f"[{inner}]"
    if isinstance(x, dict):
        keys = sorted(x, key=str)
        inner = ",".join(f"{k!r}:{_flatten(x[k], leaves)}" for k in keys)
        return "{" + inner + "}"
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        inner = ",".join(_flatten(getattr(x, f.name), leaves) for f in dataclasses.fields(x))
        return f"{type(x).__name__}({inner})"
    names = getattr(type(x), "__slots__", None)
    if names is None and hasattr(x, "__dict__") and not callable(x):
        names = sorted(vars(x))
    if names and not isinstance(x, (str, bytes, torch.device, torch.dtype)):
        inner = ",".join(_flatten(getattr(x, a, None), leaves) for a in names)
        return f"{type(x).__name__}({inner})"
    leaves.append(x)
    return "*"


def _dtype_name(dtype: Any) -> str:
    return str(dtype).replace("torch.", "")


def _signature(args: tuple, statics: dict) -> tuple:
    """Hashable abstract signature of a dispatch: the argument structure,
    (shape, dtype, device) of each tensor or array leaf, and the STATIC
    keyword arguments as a name-keyed component, so that a second cold
    signature can name which static argument changed.  A host number
    among the arguments is a scalar of its type (as jit traces a Python
    number); any other leaf is its repr."""
    leaves: list = []
    return _abstract(_flatten(args, leaves), leaves, statics)


def _abstract(tree: str, leaves: list, statics: dict) -> tuple:
    parts = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            parts.append((tuple(leaf.shape), _dtype_name(leaf.dtype), str(leaf.device)))
        elif isinstance(leaf, np.ndarray):
            parts.append((tuple(leaf.shape), str(leaf.dtype), "cpu"))
        elif isinstance(leaf, (bool, int, float)):
            parts.append(((), type(leaf).__name__, "host"))
        else:
            parts.append(repr(leaf))
    static_items = tuple(sorted((k, repr(v)) for k, v in statics.items()))
    return (tree, tuple(parts), static_items)


def _sig_hash(sig: tuple) -> str:
    """Short stable digest of a signature: rows carry it so that a reader
    can check "one cold row per signature" without the signature."""
    return hashlib.sha1(repr(sig).encode()).hexdigest()[:12]


def _clip(s: str, width: int = 90) -> str:
    return s if len(s) <= width else s[: width - 1] + "…"


def _sig_diff(old: tuple, new: tuple) -> list[str]:
    """Human-readable causes of a new cold signature: which components
    of the abstract signature changed between two dispatches of one
    program."""
    causes: list[str] = []
    old_tree, old_parts, old_statics = old
    new_tree, new_parts, new_statics = new
    if old_tree != new_tree:
        causes.append("argument pytree structure changed")
    if len(old_parts) != len(new_parts):
        causes.append(f"argument leaf count {len(old_parts)} -> {len(new_parts)}")
    else:
        for i, (a, b) in enumerate(zip(old_parts, new_parts)):
            if a == b:
                continue
            if isinstance(a, tuple) and isinstance(b, tuple):
                what = "shape" if a[0] != b[0] else "dtype" if a[1] != b[1] else "placement"
                k = {"shape": 0, "dtype": 1, "placement": 2}[what]
                causes.append(f"arg leaf {i} {what} changed: {a[k]} -> {b[k]}")
            else:
                causes.append(f"arg leaf {i} changed: {_clip(repr(a))} -> {_clip(repr(b))}")
    od, nd = dict(old_statics), dict(new_statics)
    for k in sorted(set(od) | set(nd)):
        if od.get(k) != nd.get(k):
            causes.append(
                f"static '{k}' changed: {_clip(od.get(k, '<absent>'))} -> "
                f"{_clip(nd.get(k, '<absent>'))}"
            )
    return causes


def _cuda_device(leaves: list) -> torch.device | None:
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            return leaf.device
    return None


def _storages(leaves: list, device: torch.device) -> dict[int, int]:
    """{storage pointer: bytes} of the tensors on ``device``, each storage
    counted once."""
    out: dict[int, int] = {}
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor) and leaf.device == device:
            st = leaf.untyped_storage()
            out[st.data_ptr()] = st.nbytes()
    return out


class DispatchLedger:
    """JSON-lines flight recorder for dispatches (see the module
    docstring).  Thread-safe appends; one instance is process-global
    (``default_ledger``) so that every entry point shares a file."""

    def __init__(self, path: str | None = None):
        self.rows: list[dict[str, Any]] = []
        self._path = path
        self._explicit = path is not None
        self._enabled = path is not None
        # per-program signatures seen, in arrival order: a new cold
        # signature is diffed against these
        self._sigs: dict[str, list[tuple]] = {}
        self._lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------

    @property
    def path(self) -> str | None:
        self._maybe_enable_from_env()
        return self._path

    @property
    def enabled(self) -> bool:
        self._maybe_enable_from_env()
        return self._enabled

    def _maybe_enable_from_env(self) -> None:
        if not self._explicit and not self._enabled and os.environ.get(ENV_VAR):
            self.enable(os.environ[ENV_VAR])

    def enable(self, path: str | None = None) -> "DispatchLedger":
        """Start recording; ``path=None`` keeps rows in memory only."""
        self._path = path
        self._explicit = True
        self._enabled = True
        return self

    def disable(self) -> None:
        self._explicit = True
        self._enabled = False

    def clear(self) -> None:
        with self._lock:
            self.rows.clear()
            self._sigs.clear()

    # -- recording ----------------------------------------------------------

    def record(self, row: dict[str, Any]) -> dict[str, Any]:
        """Append a pre-built row.  A no-op while the ledger is disabled;
        in-memory rows are capped at ``MAX_ROWS_IN_MEMORY`` (oldest
        dropped; the file keeps all)."""
        if not self.enabled:
            return row
        row = dict(row)
        row.setdefault("ts", round(time.time(), 3))
        with self._lock:
            self.rows.append(row)
            if len(self.rows) > MAX_ROWS_IN_MEMORY:
                del self.rows[:-MAX_ROWS_IN_MEMORY]
            if self._path:
                with open(self._path, "a") as f:
                    f.write(json.dumps(row) + "\n")
        return row

    def dispatch(
        self,
        program: str,
        fn: Callable[..., Any],
        *args: Any,
        _meta: dict[str, Any] | None = None,
        _sig: tuple[tuple, dict[str, Any]] | None = None,
        **static_kwargs: Any,
    ) -> Any:
        """Run ``fn(*args, **static_kwargs)`` and record one row.

        Disabled (the default): a plain call-through.  Enabled: the call
        is timed to its end (``execute_s``; on the card between two CUDA
        events, waiting for the card) and recorded.  Static arguments
        are passed as keywords.  ``_sig=(tensors, statics)`` names what
        the row describes where ``fn`` takes tensors by keyword or holds
        them itself: the signature and ``argument_bytes`` are then those
        of ``tensors`` with the static configuration ``statics``, and
        the keywords are ``fn``'s own."""
        if not self.enabled:
            return fn(*args, **static_kwargs)
        out, row, execute_s = self._call(program, fn, args, static_kwargs, _meta, _sig,
                                         timed=True)
        row["execute_s"] = round(execute_s, 6)
        self.record(row)
        return out

    def launch(
        self,
        program: str,
        fn: Callable[..., Any],
        *args: Any,
        _meta: dict[str, Any] | None = None,
        _sig: tuple[tuple, dict[str, Any]] | None = None,
        **static_kwargs: Any,
    ) -> tuple[Any, dict[str, Any] | None]:
        """``dispatch`` without waiting for the work: run the call and
        return ``(out, row)`` with the row NOT yet recorded.  The caller
        drains the outputs at its own pace (typically after launching the
        next segment, so that the card's work and the host's copies
        overlap), then ``record``\\ s the row with its ``dispatch_s`` /
        ``drain_s`` / ``drain_overlap_s`` fields added (the streamed
        runner, ``scenarios/stream.py``).  Disabled: a plain
        call-through and a ``None`` row."""
        if not self.enabled:
            return fn(*args, **static_kwargs), None
        out, row, _ = self._call(program, fn, args, static_kwargs, _meta, _sig, timed=False)
        return out, row

    def _call(self, program, fn, args, kwargs, meta, described, *, timed: bool):
        tensors, statics = (args, kwargs) if described is None else described
        leaves: list = []
        sig = _abstract(_flatten(tensors, leaves), leaves, statics)
        prior = self._sigs.setdefault(program, [])
        cold = sig not in prior
        recompile_cause: list[str] | None = None
        if cold:
            if prior:
                recompile_cause = min((_sig_diff(p, sig) for p in prior), key=len) or [
                    "signature hash collision (identical components)"
                ]
            prior.append(sig)
        dev = _cuda_device(leaves)
        arg_st = {} if dev is None else _storages(leaves, dev)
        # the callee may take over a state it is handed (``_Handoff``):
        # hold no reference to it through the call
        leaves.clear()
        mem = _zero_memory_row()
        if dev is None:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            execute_s = time.perf_counter() - t0
        else:
            torch.cuda.reset_peak_memory_stats(dev)
            at_entry = torch.cuda.memory_allocated(dev)
            start = end = None
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            out = fn(*args, **kwargs)
            execute_s = 0.0
            if timed:
                end.record()
                end.synchronize()
                execute_s = start.elapsed_time(end) / 1000.0
            peak = torch.cuda.max_memory_allocated(dev)
            out_leaves: list = []
            _flatten(out, out_leaves)
            out_st = _storages(out_leaves, dev)
            alias = sum(b for p, b in out_st.items() if p in arg_st)
            new_out = sum(out_st.values()) - alias
            mem.update(
                argument_bytes=sum(arg_st.values()),
                output_bytes=sum(out_st.values()),
                alias_bytes=alias,
                temp_bytes=max(peak - at_entry - new_out, 0),
                peak_bytes=peak,
            )
        row = {
            "program": program,
            "platform": "cpu" if dev is None else "gpu",
            "cold": cold,
            "sig": _sig_hash(sig),
            "trace_s": 0.0,
            "compile_s": 0.0,
            **mem,
        }
        if recompile_cause is not None:
            row["recompile_cause"] = recompile_cause
        if meta:
            row.update(meta)
        return out, row, execute_s

    # -- reading back -------------------------------------------------------

    @staticmethod
    def load_rows(path: str) -> list[dict[str, Any]]:
        rows = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        return rows

    def summary(self) -> list[dict[str, Any]]:
        return summarize(self.rows)


def summarize(rows: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Aggregate ledger rows by (program, backend, platform, n, ticks,
    replicas): dispatch and cold counts, total compile seconds, execute
    percentiles (``stats.Histogram``), and the peak-bytes high-water
    mark."""
    from ringpop_tpu_torch.stats import Histogram

    groups: dict[tuple, dict[str, Any]] = {}
    hists: dict[tuple, Histogram] = {}
    for row in rows:
        key = tuple(row.get(k) for k in ("program", "backend", "platform", "n", "ticks",
                                         "replicas"))
        g = groups.setdefault(
            key,
            {
                "program": row.get("program"),
                "backend": row.get("backend"),
                "platform": row.get("platform"),
                "n": row.get("n"),
                "ticks": row.get("ticks"),
                "replicas": row.get("replicas"),
                "dispatches": 0,
                "cold": 0,
                "compile_s_total": 0.0,
                "peak_bytes_max": 0,
            },
        )
        g["dispatches"] += 1
        g["cold"] += int(bool(row.get("cold")))
        g["compile_s_total"] += float(row.get("compile_s") or 0.0)
        g["peak_bytes_max"] = max(g["peak_bytes_max"], int(row.get("peak_bytes") or 0))
        if row.get("execute_s") is not None:
            hists.setdefault(key, Histogram(seed=0)).update(float(row["execute_s"]))
    out = []
    for key, g in groups.items():
        hist = hists.get(key)
        if hist is not None:
            pct = hist.percentiles([0.5, 0.95, 0.99])
            g["execute_s"] = {
                "count": hist._count,
                "p50": pct["0.5"],
                "p95": pct["0.95"],
                "p99": pct["0.99"],
            }
        g["compile_s_total"] = round(g["compile_s_total"], 6)
        out.append(g)
    out.sort(key=lambda g: (str(g["program"]), str(g["backend"]), g["n"] or 0))
    return out


def summarize_runs(rows: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Per-soak pipelining summary: segment rows sharing a ``run_id``
    (one streamed scenario or sweep each, ``scenarios/stream.py``)
    aggregate into segment and cold counts, total compile, dispatch and
    drain seconds, and the share of drain work that ran while the next
    segment was already in flight (``drain_overlap_s`` / ``drain_s``)."""
    runs: dict[str, dict[str, Any]] = {}
    for row in rows:
        rid = row.get("run_id")
        if rid is None:
            continue
        g = runs.setdefault(
            rid,
            {
                "run_id": rid,
                "program": row.get("program"),
                "backend": row.get("backend"),
                "platform": row.get("platform"),
                "n": row.get("n"),
                "segment_ticks": row.get("segment_ticks"),
                "segments": 0,
                "cold": 0,
                "ticks": 0,
                "compile_s_total": 0.0,
                "dispatch_s_total": 0.0,
                "drain_s_total": 0.0,
                "drain_overlap_s_total": 0.0,
            },
        )
        g["segments"] += 1
        g["cold"] += int(bool(row.get("cold")))
        g["ticks"] += int(row.get("ticks") or 0)
        for src, dst in (
            ("compile_s", "compile_s_total"),
            ("dispatch_s", "dispatch_s_total"),
            ("drain_s", "drain_s_total"),
            ("drain_overlap_s", "drain_overlap_s_total"),
        ):
            g[dst] += float(row.get(src) or 0.0)
    out = []
    for g in runs.values():
        g["overlap_pct"] = (
            round(100.0 * g["drain_overlap_s_total"] / g["drain_s_total"], 1)
            if g["drain_s_total"]
            else 0.0
        )
        for f in ("compile_s_total", "dispatch_s_total", "drain_s_total",
                  "drain_overlap_s_total"):
            g[f] = round(g[f], 6)
        out.append(g)
    out.sort(key=lambda g: str(g["run_id"]))
    return out


_default = DispatchLedger()


def default_ledger() -> DispatchLedger:
    """The process-global ledger every instrumented call site shares."""
    return _default


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m ringpop_tpu_torch.obs.ledger",
        description="Summarize a dispatch-ledger JSON-lines file.",
    )
    ap.add_argument("path", help="ledger .jsonl written via RINGPOP_LEDGER "
                                 "or DispatchLedger.enable(path)")
    ap.add_argument("--json", action="store_true",
                    help="print one JSON summary row per group")
    args = ap.parse_args(argv)
    rows = DispatchLedger.load_rows(args.path)
    groups = summarize(rows)
    runs = summarize_runs(rows)
    if args.json:
        for g in groups:
            print(json.dumps(g))
        for g in runs:
            print(json.dumps({"kind": "run", **g}))
        return
    print(f"{len(rows)} dispatches in {args.path}")
    for g in groups:
        shape = f"n={g['n']} T={g['ticks']} R={g['replicas']}"
        ex = g.get("execute_s") or {}
        peak = g["peak_bytes_max"]
        peak_str = f"{peak / 1e6:.1f} MB" if peak >= 1e6 else f"{peak:,} B"
        print(
            f"  {g['program']} [{g['backend']}/{g['platform']}] {shape}: "
            f"{g['dispatches']} dispatches ({g['cold']} cold, "
            f"compile {g['compile_s_total']:.3f}s), "
            f"execute p50={ex.get('p50', 0):.4f}s p99={ex.get('p99', 0):.4f}s, "
            f"peak {peak_str}"
        )
    if runs:
        print(f"{len(runs)} streamed soaks:")
        for g in runs:
            print(
                f"  {g['run_id']} {g['program']} [{g['backend']}/"
                f"{g['platform']}] n={g['n']} S={g['segment_ticks']}: "
                f"{g['segments']} segments ({g['cold']} cold, compile "
                f"{g['compile_s_total']:.3f}s) over {g['ticks']} ticks, "
                f"drain {g['drain_s_total']:.3f}s "
                f"({g['overlap_pct']:.0f}% overlapped with dispatch)"
            )


if __name__ == "__main__":
    main()
