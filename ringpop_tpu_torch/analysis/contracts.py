"""The trace contracts in torch terms, checked on each entry point.

The port of ``ringpop_tpu/analysis/contracts.py``.  The reference reads
its contracts off a traced program (jaxpr and StableHLO); the port runs
eagerly, so ``audit_entry`` runs one registered entry once on its
fixture with every instrument on, and checks:

1. **host-read** — on the card, the host syncs of the call
   (``torch.cuda.set_sync_debug_mode("warn")``, one warning each) a
   tick against ``budgets.SYNC_BUDGETS``; on the CPU a dispatch mode
   counts ``aten._local_scalar_dense`` and the ops whose output shape
   depends on the data (``nonzero``, boolean indexing, ``unique``, ...)
   outside the kernels' plain versions (which stand in for kernels that
   read nothing back), against the row's CPU pin and the card's pin:
   a lower bound of the card's count (``.tolist()`` and ``.numpy()``
   dispatch nothing; the lint, RPL001, sees those).  ``run_scenario``
   may take no more syncs a tick than the same scenario as ``tick(1)``
   calls;
2. **handoff** — the reference's donation: an entry that takes its state
   over leaves no reference to it after the call; a weak reference to
   each entry-state tensor must be dead unless the output holds that
   very storage;
3. **carry-dtype** — the dtype multiset of the tensors the entry carries
   from tick to tick against ``budgets.CARRY_BUDGETS``; an int64 or
   float64 field that no ``CARRY_DIFFERENCES`` entry names is an error;
4. **prng-lineage** — every key that reaches a draw of ``prng`` during
   the call, by value: a key drawn from twice (overlapping elements) is
   an error, and so is a key that two declared streams share;
5. **census** — every op output with at least ``min_elems`` elements or
   shaped [..., N, N], grouped by (shape, dtype, op) and sorted by bytes;
   an [N, N] output is an error on the delta backend, and in a sharded
   entry a gather along the member axis into an [N, N] output (or an
   unsharded receiver merge) is a member gather: an error under the
   ring plane, counted against ``HOP_BUDGETS`` in the gather lowering.

On the card the call's peak (``torch.cuda.max_memory_allocated`` over
the call, less the allocation at its start) is held against
``BYTE_BUDGETS`` and the ring-hop launches of a sharded step against
``HOP_BUDGETS``; on the CPU each is an info finding that says it needs
the card.  The reference's StableHLO and post-SPMD walks
(``jaxpr_walk.py``, ``partitioning.py``'s sharding-propagation survival)
have no counterpart in eager torch: each entry reports that as an info
finding, never as a pass.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import warnings
import weakref
from collections import Counter
from typing import Any, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ringpop_tpu_torch.analysis import budgets
from ringpop_tpu_torch.analysis.findings import Finding
from ringpop_tpu_torch.analysis.registry import (
    Built,
    EntryUnavailable,
    build_entry,
    iter_entries,
)

# ops that read a value back to the host, or whose output shape depends
# on the data (the card must finish before the host knows the shape)
_READ_OPS = frozenset({"_local_scalar_dense", "nonzero", "masked_select", "_unique",
                       "_unique2", "unique_dim", "unique_consecutive", "bincount", "equal",
                       "repeat_interleave", "argwhere", "nonzero_numpy"})
_INDEX_OPS = frozenset({"index", "index_put", "index_put_", "_index_put_impl_"})
# ops that gather rows along axis 0 of their first argument
_ROW_GATHERS = frozenset({"index_select", "index", "gather", "take", "embedding"})
_WIDE = (torch.int64, torch.float64, torch.complex128)
_NO_COUNTERPART = (
    "the reference's StableHLO and post-SPMD walks (jaxpr_walk.py; partitioning.py's "
    "sharding-propagation survival and collective census) have no counterpart in eager "
    "torch: not checked")


@dataclasses.dataclass
class EntryReport:
    """One audited (entry, backend): findings plus report material."""

    entry: str
    backend: str
    n: int
    ticks: int
    device: str
    findings: list[Finding]
    census: list[dict[str, Any]]
    prng: dict[str, Any]
    carries: dict[str, str]  # field -> "dtype[shape]"
    syncs: float | None  # host syncs a tick (card), None on the CPU
    host_reads: float  # the dispatch mode's reads a tick (lower bound)
    tick1_syncs: float | None = None  # the same scenario as tick(1) calls (card)
    tick1_reads: float | None = None  # ... and its host reads
    peak_bytes: int | None = None
    launches: dict[str, int] = dataclasses.field(default_factory=dict)
    member_gathers: int = 0
    mesh_size: int = 0
    sync_sites: dict[str, int] = dataclasses.field(default_factory=dict)  # card: line -> syncs

    def to_json(self) -> dict[str, Any]:
        d = dataclasses.asdict(self)
        d["findings"] = [f.to_json() for f in self.findings]
        return d


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------


def _dim_name(d: int, dims: dict[str, int]) -> str:
    """Named-dim tag for a size; when several named dims share it the tag
    keeps every candidate ("N|C")."""
    matches = [name for name, val in dims.items() if d == val]
    return "|".join(matches) if matches else str(d)


def _tensors(x: Any) -> Iterator[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif hasattr(x, "_fields") or (dataclasses.is_dataclass(x) and not isinstance(x, type)):
        names = x._fields if hasattr(x, "_fields") else [f.name for f in dataclasses.fields(x)]
        for f in names:
            yield from _tensors(getattr(x, f))


class Census(TorchDispatchMode):
    """Records every op's outputs (metadata only: no tensor is kept) and
    counts host reads; ``n`` names the member axis for the [N, N] rules."""

    def __init__(self, *, n: int, dims: dict[str, int], min_elems: int, member_axis: bool):
        super().__init__()
        self.n, self.dims, self.min_elems = n, dims, min_elems
        self.member_axis = member_axis
        self.rows: dict[tuple, dict[str, Any]] = {}
        self.plain_depth = 0  # inside a kernel's plain version (CPU)
        self.reads = 0
        self.read_ops: Counter = Counter()
        self.member_gathers: Counter = Counter()
        self.float64: Counter = Counter()

    def _nxn(self, shape: tuple) -> bool:
        return self.n > 1 and sum(1 for d in shape if d == self.n) >= 2

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = func.overloadpacket.__name__
        if not self.plain_depth and (op in _READ_OPS or (op in _INDEX_OPS and any(
                isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
                for i in (args[1] if len(args) > 1 and isinstance(args[1], (list, tuple))
                          else ())))):
            self.reads += 1
            self.read_ops[op] += 1
        out = func(*args, **kwargs)
        for t in _tensors(out):
            shape = tuple(int(d) for d in t.shape)
            if t.dtype == torch.float64:
                self.float64[(shape, op)] += 1
            elems = math.prod(shape) if shape else 1
            nxn = self._nxn(shape)
            if elems < self.min_elems and not nxn:
                continue
            key = (shape, str(t.dtype).replace("torch.", ""), op)
            row = self.rows.get(key)
            if row is None:
                self.rows[key] = row = {
                    "shape": list(shape),
                    "tag": "x".join(_dim_name(d, self.dims) for d in shape),
                    "dtype": key[1], "op": op, "count": 0, "elems_each": elems,
                    "bytes_each": elems * t.element_size(), "nxn": nxn,
                }
            row["count"] += 1
            if self.member_axis and nxn and op in _ROW_GATHERS and self._along_members(
                    op, args, kwargs):
                self.member_gathers[(shape, op)] += 1
        return out

    def _along_members(self, op: str, args: tuple, kwargs: dict) -> bool:
        """Does this gather pick rows of a member plane ([N, *], axis 0)?"""
        src = args[0] if args else None
        if not isinstance(src, torch.Tensor) or src.dim() < 2 or src.shape[0] != self.n:
            return False
        if op == "index":
            idx = args[1] if len(args) > 1 else ()
            return len(idx) == 1 and idx[0] is not None
        if op in ("index_select", "gather"):
            dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
            return dim == 0
        return True

    def sorted_rows(self) -> list[dict[str, Any]]:
        return sorted(self.rows.values(), key=lambda r: (-r["bytes_each"] * r["count"], r["op"]))


class KeyLineage:
    """Every key ``prng`` derives or draws from during the block, by value.

    Roots name their stream; ``split``/``fold_in`` pass a key's streams to
    its children; each draw (``random_bits``, which ``uniform``,
    ``randint`` and ``categorical`` reach) records the elements it takes
    of its key.  The module's functions are wrapped for the block only."""

    _WRAPPED = ("split", "fold_in", "random_bits")

    def __init__(self, roots: dict[str, list[torch.Tensor]]):
        self.streams: dict[tuple[int, int], set[str]] = {}
        self.draws: dict[tuple[int, int], list[tuple[int, int]]] = {}
        self.derived: set[tuple[int, int]] = set()
        self.root_draws = {name: 0 for name in roots}
        self.mixed: list[tuple[tuple[int, int], set[str]]] = []
        self.reused: list[tuple[int, int]] = []
        self.unrooted = 0
        for name, keys in roots.items():
            for k in keys:
                for row in k.reshape(-1, 2).tolist():
                    self._add(tuple(row), {name})

    def _add(self, value: tuple[int, int], streams: set[str]) -> None:
        have = self.streams.setdefault(value, set())
        before = set(have)
        have |= streams
        if len(have) > 1 and have != before:
            self.mixed.append((value, set(have)))

    @staticmethod
    def _value(key: torch.Tensor) -> tuple[int, int]:
        k1, k2 = key.reshape(2).tolist()
        return (int(k1), int(k2))

    @contextlib.contextmanager
    def watch(self) -> Iterator["KeyLineage"]:
        from ringpop_tpu_torch import prng

        real = {f: getattr(prng, f) for f in self._WRAPPED}

        def derive(fn):
            def wrapped(key, *args, **kwargs):
                out = fn(key, *args, **kwargs)
                parent = self._value(key)
                self.derived.add(parent)
                streams = self.streams.get(parent, set())
                for row in out.reshape(-1, 2).tolist():
                    self._add(tuple(int(v) for v in row), streams)
                return out
            return wrapped

        def random_bits(key, shape, *args, offset: int = 0, **kwargs):
            value = self._value(key)
            span = (int(offset), int(offset) + math.prod(shape))
            for a, b in self.draws.get(value, ()):
                if a < span[1] and span[0] < b:
                    self.reused.append(value)
                    break
            self.draws.setdefault(value, []).append(span)
            streams = self.streams.get(value, set())
            if not streams:
                self.unrooted += 1
            for s in streams:
                self.root_draws[s] = self.root_draws.get(s, 0) + 1
            return real["random_bits"](key, shape, *args, offset=offset, **kwargs)

        prng.split = derive(real["split"])
        prng.fold_in = derive(real["fold_in"])
        prng.random_bits = random_bits
        try:
            yield self
        finally:
            for f, fn in real.items():
                setattr(prng, f, fn)

    def findings(self, entry: str) -> list[Finding]:
        out = []
        for value in sorted(set(self.reused)):
            out.append(Finding("prng-lineage", "error", entry,
                               f"prng-reuse: key {value} is drawn from twice (overlapping "
                               "elements) — the two draws read the same bits"))
        for value, streams in self.mixed:
            out.append(Finding("prng-lineage", "error", entry,
                               f"prng-mixing: key {value} belongs to the streams "
                               f"{sorted(streams)} — the streams share a lineage"))
        both = sorted(v for v in self.draws if v in self.derived)
        if both:
            out.append(Finding("prng-lineage", "warning", entry,
                               f"prng-draw-and-derive: {len(both)} key(s) are both drawn from "
                               "and split/folded — derived children correlate with the bits"))
        if self.unrooted:
            out.append(Finding("prng-lineage", "warning", entry,
                               f"{self.unrooted} draw(s) from keys no declared root derives"))
        for name, count in self.root_draws.items():
            if count == 0:
                out.append(Finding("prng-lineage", "info", entry,
                                   f"declared key root '{name}' never reaches a draw"))
        return out

    def summary(self) -> dict[str, Any]:
        return {"roots": dict(self.root_draws), "draw_values": len(self.draws),
                "derive_values": len(self.derived)}


def _kernel_counters() -> dict[str, Any]:
    from ringpop_tpu_torch.ops.delta_merge import merge_insert
    from ringpop_tpu_torch.ops.farmhash import farmhash32_batch
    from ringpop_tpu_torch.ops.gossip_remote_copy import hop
    from ringpop_tpu_torch.ops.recv_merge import recv_merge
    from ringpop_tpu_torch.ops.searchsorted import row_searchsorted

    return {"recv_merge": (recv_merge, "launches"),
            "farmhash32": (farmhash32_batch, "launches"),
            "farmhash32_short": (farmhash32_batch, "short_launches"),
            "row_searchsorted": (row_searchsorted, "launches"),
            "merge_insert": (merge_insert, "launches"),
            "ring_hop": (hop, "launches")}


def kernel_launches() -> dict[str, int]:
    """Each kernel wrapper's launch count so far (they count on the card only)."""
    return {k: int(getattr(fn, attr, 0)) for k, (fn, attr) in _kernel_counters().items()}


class HostReads:
    """Host syncs counted over blocks: on the card the warnings of
    ``set_sync_debug_mode("warn")``, on the CPU the census's reads.  The
    first time a process turns the warnings on, torch reports one sync
    of its own (``torch/cuda/__init__.py``), so the first block of a
    process is preceded by an empty one."""

    _primed = False

    def __init__(self, device: torch.device, census: Census):
        self.cuda = device.type == "cuda"
        self.census = census
        self.caught: list = []

    @contextlib.contextmanager
    def on(self) -> Iterator["HostReads"]:
        if not self.cuda:
            yield self
            return
        if not HostReads._primed:
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                torch.cuda.set_sync_debug_mode("default")
            HostReads._primed = True
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            self.caught = caught
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield self
            finally:
                torch.cuda.set_sync_debug_mode("default")

    def count(self) -> int:
        if self.cuda:
            return sum("synchroniz" in str(w.message) for w in self.caught)
        return self.census.reads

    def sites(self) -> dict[str, int]:
        """The card's syncs by the source line that made them."""
        out: Counter = Counter()
        for w in self.caught:
            if "synchroniz" in str(w.message):
                out[f"{w.filename.rsplit('ringpop_tpu_torch/', 1)[-1]}:{w.lineno}"] += 1
        return dict(out.most_common())


_PLAIN_VERSIONS = (("ringpop_tpu_torch.ops.recv_merge", "recv_merge_plain"),
                   ("ringpop_tpu_torch.ops.searchsorted", "row_searchsorted_plain"),
                   ("ringpop_tpu_torch.ops.delta_merge", "merge_insert_plain"),
                   ("ringpop_tpu_torch.ops.gossip_remote_copy", "hop_plain"),
                   ("ringpop_tpu_torch.ops.farmhash", "farmhash32_plain"))


@contextlib.contextmanager
def _plain_scope(census: Census) -> Iterator[None]:
    """Mark the kernels' plain versions (what a CPU tensor runs in place
    of a kernel) so that the census counts no host read inside them."""
    import importlib

    saved = []
    for mod_name, fn_name in _PLAIN_VERSIONS:
        mod = importlib.import_module(mod_name)
        real = getattr(mod, fn_name)

        def marked(*args, _real=real, **kwargs):
            census.plain_depth += 1
            try:
                return _real(*args, **kwargs)
            finally:
                census.plain_depth -= 1

        saved.append((mod, fn_name, real))
        setattr(mod, fn_name, marked)
    try:
        yield
    finally:
        for mod, fn_name, real in saved:
            setattr(mod, fn_name, real)


@contextlib.contextmanager
def _count_merges(counter: list[int]) -> Iterator[None]:
    """Count the unsharded receiver merges of the block (each rebuilds
    the whole [N, N] plane from every shard's senders)."""
    from ringpop_tpu_torch.models import swim_sim as sim

    real = sim.recv_merge

    def counted(*args, **kwargs):
        counter[0] += 1
        return real(*args, **kwargs)

    sim.recv_merge = counted
    try:
        yield
    finally:
        sim.recv_merge = real


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def _storage_ptrs(x: Any) -> set[int]:
    return {t.untyped_storage().data_ptr() for t in _tensors(x)}


def check_handoff(built: Built, refs: list, out: Any) -> list[Finding]:
    """Contract 2: after the call, every entry-state tensor is dead or
    held by the output itself."""
    if not built.donates:
        return []
    held = _storage_ptrs(out)
    kept = []
    for field, ref in refs:
        t = ref()
        if t is not None and t.untyped_storage().data_ptr() not in held:
            kept.append(field)
    if not kept:
        return []
    return [Finding("handoff", "error", built.name,
                    f"the entry state outlives the call: {sorted(kept)} are still referenced "
                    "but not by the output — the handoff keeps a reference (the state is "
                    "not freed when replaced)")]


def check_carry_dtypes(built: Built, carried: dict[str, torch.Tensor]) -> list[Finding]:
    """Contract 3: the carried dtype multiset against its pin, and no
    unpinned wide field."""
    findings = []
    multiset = Counter(str(t.dtype).replace("torch.", "") for t in carried.values())
    pinned = budgets.CARRY_BUDGETS.get((built.name, built.backend))
    if pinned is None:
        findings.append(Finding("carry-dtype", "warning", built.name,
                                f"no pinned carry budget for ({built.name}, {built.backend}); "
                                f"actual {budgets.format_multiset(multiset)} — pin it in "
                                "analysis/budgets.py"))
    elif Counter(pinned) != multiset:
        findings.append(Finding("carry-dtype", "error", built.name,
                                f"carry dtype budget drift: pinned "
                                f"{budgets.format_multiset(Counter(pinned))} but the entry "
                                f"carries {budgets.format_multiset(multiset)} — a widened or "
                                "added field must be justified and re-pinned"))
    allowed = budgets.wide_fields(built.name, built.backend)
    for field, t in sorted(carried.items()):
        if t.dtype in _WIDE and field not in allowed:
            findings.append(Finding("carry-dtype", "error", built.name,
                                    f"carried field {field} is {t.dtype} "
                                    f"{list(t.shape)}: 8 bytes an element, named by no "
                                    "CARRY_DIFFERENCES entry", where=field))
    return findings


def check_census(built: Built, census: Census, merges: int) -> tuple[list[Finding], int]:
    """Contract 5's findings: [N, N] outputs on the delta backend, and the
    member gathers of a sharded entry."""
    findings = []
    n = built.n
    others = [k for k, v in built.dims.items() if k != "N" and v == n]
    if not built.nxn_ok and others:
        findings.append(Finding("census", "info", built.name,
                                f"n = {n} equals {others}: an [N, N] plane cannot be told "
                                "from the others here"))
    elif not built.nxn_ok:
        rows = [r for r in census.rows.values() if r["nxn"]]
        for r in rows:
            findings.append(Finding("census", "error", built.name,
                                    f"an [N, N] intermediate {r['dtype']}{r['shape']} x"
                                    f"{r['count']} from '{r['op']}' on the delta backend: "
                                    "its state and temporaries are O(N * C)"))
    gathers = sum(census.member_gathers.values()) + merges
    if not built.mesh_size:
        return findings, gathers
    what = ", ".join(f"{op}{list(shape)} x{k}" for (shape, op), k in
                     sorted(census.member_gathers.items())) or "none by op"
    if built.p2p_only and gathers:
        findings.append(Finding("member-gather", "error", built.name,
                                f"{gathers} member gather(s) under the ring plane "
                                f"({what}; {merges} unsharded receiver merge(s)): every "
                                "cross-shard transfer must be a hop"))
    elif not built.p2p_only:
        row = budgets.HOP_BUDGETS.get((built.name, built.mesh_size))
        if row is None or row["n"] != n:
            findings.append(Finding("member-gather", "info", built.name,
                                    f"{gathers} member gather(s); no pin at n = {n}"))
        elif gathers > row["member_gathers"]:
            findings.append(Finding("member-gather", "error", built.name,
                                    f"{gathers} member gathers, over the pinned "
                                    f"{row['member_gathers']}"))
        elif gathers < row["member_gathers"]:
            findings.append(Finding("member-gather", "warning", built.name,
                                    f"{gathers} member gathers, under the pinned "
                                    f"{row['member_gathers']}: re-pin to lock it in"))
    return findings, gathers


def check_syncs(built: Built, syncs: float | None, reads: float,
                label: str | None = None) -> list[Finding]:
    """Contract 1 against ``SYNC_BUDGETS``: ``syncs`` (the card's count a
    tick, None on the CPU) against the row's ``per_tick`` and ``reads``
    (the dispatch mode's count a tick, the same on either device) against
    its ``reads`` where pinned; over is an error, under prompts a re-pin.
    On the CPU the reads are a lower bound of the card's syncs, so over
    ``per_tick`` is an error too."""
    entry = label or built.name
    row = budgets.SYNC_BUDGETS.get((entry, built.backend, built.n))
    if row is None or row["ticks"] != built.ticks:
        got = f"{syncs:g} host syncs, " if syncs is not None else ""
        return [Finding("host-read", "warning", built.name,
                        f"{entry}: {got}{reads:g} host reads a tick; no pin for "
                        f"({entry}, {built.backend}, {built.n}) at {built.ticks} ticks")]
    checks = [("host reads", reads, row.get("reads"))]
    if syncs is not None:
        checks.insert(0, ("host syncs", syncs, row["per_tick"]))
    elif reads > row["per_tick"] + 1e-9:
        checks.append(("host reads (at least the card's syncs)", reads, row["per_tick"]))
    findings = []
    for what, got, pin in checks:
        if pin is None:
            continue
        if got > pin + 1e-9:
            findings.append(Finding("host-read", "error", built.name,
                                    f"{entry}: {got:g} {what} a tick, over the pinned {pin:g} "
                                    "— a new read back in the loop"))
        elif got < pin - 1e-9:
            findings.append(Finding("host-read", "warning", built.name,
                                    f"{entry}: {got:g} {what} a tick, under the pinned {pin:g}: "
                                    "re-pin to lock the gain in"))
    return findings


def check_bytes(built: Built, peak: int) -> list[Finding]:
    row = budgets.BYTE_BUDGETS.get((built.name, built.backend, built.n))
    if row is None:
        return []
    if row["ticks"] != built.ticks:
        return [Finding("byte-budget", "info", built.name,
                        f"peak {peak} B at {built.ticks} ticks; pinned at {row['ticks']}")]
    pin, tol = row["peak_bytes"], budgets.BYTE_TOLERANCE
    ref = budgets.REFERENCE_CPU_PEAK.get((built.name, built.backend, built.n))
    note = f" (the reference's CPU-XLA derived peak, for information: {ref} B)" if ref else ""
    if peak > pin * (1 + tol):
        return [Finding("byte-budget", "error", built.name,
                        f"peak {peak} B over the pinned {pin} B + {tol:.0%}{note}")]
    if peak < pin * (1 - tol):
        return [Finding("byte-budget", "warning", built.name,
                        f"peak {peak} B under the pinned {pin} B - {tol:.0%}: re-pin to lock "
                        f"the reduction in{note}")]
    return []


def check_hops(built: Built, hops: int) -> list[Finding]:
    row = budgets.HOP_BUDGETS.get((built.name, built.mesh_size))
    if row is None or row["n"] != built.n:
        return [Finding("hop-budget", "info", built.name,
                        f"{hops} ring-hop launches a step; no pin at n = {built.n}")]
    if hops > row["hops"]:
        return [Finding("hop-budget", "error", built.name,
                        f"{hops} ring-hop launches a step, over the pinned {row['hops']}")]
    if hops < row["hops"]:
        return [Finding("hop-budget", "warning", built.name,
                        f"{hops} ring-hop launches a step, under the pinned {row['hops']}: "
                        "re-pin")]
    return []


# ---------------------------------------------------------------------------
# per-entry driver
# ---------------------------------------------------------------------------


def run_instrumented(built: Built, *, census_min_elems: int | None = None) -> dict[str, Any]:
    """Run ``built.call()`` once with every instrument on; returns what
    the checks read."""
    device = built.device
    cuda = device.type == "cuda"
    refs = []
    if built.box is not None and built.box.state is not None:
        from ringpop_tpu_torch.analysis.registry import state_fields

        refs = [(f, weakref.ref(t)) for f, t in state_fields(built.box.state).items()]
    census = Census(n=built.n, dims=built.dims, member_axis=built.mesh_size > 0,
                    min_elems=(census_min_elems if census_min_elems is not None
                               else built.census_min_elems))
    lineage = KeyLineage(built.key_roots)
    reads = HostReads(device, census)
    merges = [0]
    before = kernel_launches()
    peak = None
    if cuda:
        # garbage of earlier work freed inside the window would hide the
        # call's own peak
        gc.collect()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    ctx = _count_merges(merges) if built.mesh_size else contextlib.nullcontext()
    with ctx, lineage.watch(), _plain_scope(census), census, reads.on():
        out = built.call()
    syncs = reads.count()
    if cuda:
        # the call's own work drained outside the counted window
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) - base
    launches = {k: v - before[k] for k, v in kernel_launches().items()}
    sites = reads.sites() if cuda else {}
    handoff = check_handoff(built, refs, out)
    carried = built.carry(out)
    del out
    return dict(census=census, lineage=lineage, syncs=syncs, reads=census.reads, peak=peak,
                launches=launches, handoff=handoff, carried=carried, merges=merges[0],
                sync_sites=sites)


def _tick_loop_syncs(built: Built) -> tuple[float | None, float]:
    """(syncs or None on the CPU, host reads) a tick inside the
    ``tick(1)`` calls of the entry's scenario run as a host loop."""
    make, run = built.tick_loop
    cluster = make()
    census = Census(n=built.n, dims=built.dims, min_elems=1 << 62, member_axis=False)
    reads = HostReads(built.device, census)
    inside = [0, 0]
    real = cluster.tick

    def tick(k: int = 1):
        before = (reads.count(), census.reads)
        try:
            return real(k)
        finally:
            inside[0] += reads.count() - before[0]
            inside[1] += census.reads - before[1]

    cluster.tick = tick
    with _plain_scope(census), census, reads.on():
        run(cluster)
    per = [v / built.ticks for v in inside]
    return (per[0] if reads.cuda else None), per[1]


def audit_entry(
    name: str,
    backend: str,
    *,
    n: int = 64,
    ticks: int = 4,
    capacity: int = 32,
    replicas: int = 2,
    device: torch.device | str | None = None,
    census_min_elems: int | None = None,
    **extra: Any,
) -> EntryReport:
    """Run every contract against one (entry, backend) at the given
    fixture shape on ``device`` (``cuda`` unless named)."""
    built = build_entry(name, backend, n=n, ticks=ticks, capacity=capacity, replicas=replicas,
                        device=device, **extra)
    on_card = built.device.type == "cuda"
    got = run_instrumented(built, census_min_elems=census_min_elems)
    census: Census = got["census"]
    findings: list[Finding] = list(got["handoff"])
    findings += check_carry_dtypes(built, got["carried"])
    findings += got["lineage"].findings(built.name)
    census_findings, gathers = check_census(built, census, got["merges"])
    findings += census_findings
    syncs = got["syncs"] / built.steps if on_card else None
    reads = got["reads"] / built.steps
    findings += check_syncs(built, syncs, reads)
    tick1 = tick1_reads = None
    if built.tick_loop is not None:
        tick1, tick1_reads = _tick_loop_syncs(built)
        findings += check_syncs(built, tick1, tick1_reads, label="tick(1)")
        mine, theirs = (syncs, tick1) if on_card else (reads, tick1_reads)
        if mine > theirs + 1e-9:
            findings.append(Finding("host-read", "error", built.name,
                                    f"{mine:g} host {'syncs' if on_card else 'reads'} a tick, "
                                    f"over the {theirs:g} of the same scenario as tick(1) "
                                    "calls"))
    if on_card:
        findings += check_bytes(built, got["peak"])
        if built.mesh_size:
            findings += check_hops(built, got["launches"]["ring_hop"])
    else:
        findings.append(Finding("byte-budget", "info", built.name,
                                "peak bytes need the card (torch.cuda.max_memory_allocated)"))
        if built.mesh_size:
            findings.append(Finding("hop-budget", "info", built.name,
                                    "ring-hop launches need the card (kernel 5 counts its "
                                    "launches on CUDA tensors only)"))
    if census.float64:
        shapes = ", ".join(f"{op}{list(s)} x{k}"
                           for (s, op), k in sorted(census.float64.items())[:3])
        findings.append(Finding("carry-dtype", "info", built.name,
                                f"float64 intermediates: {shapes} (prng's exact float32 "
                                "multiply-add and the like)"))
    findings.append(Finding("no-counterpart", "info", built.name, _NO_COUNTERPART))
    return EntryReport(
        entry=built.name, backend=backend, n=n, ticks=ticks, device=str(built.device),
        findings=findings, census=census.sorted_rows(), prng=got["lineage"].summary(),
        carries={f: f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"
                 for f, t in got["carried"].items()},
        syncs=syncs, host_reads=reads, tick1_syncs=tick1, tick1_reads=tick1_reads,
        peak_bytes=got["peak"],
        launches=got["launches"], member_gathers=gathers, mesh_size=built.mesh_size,
        sync_sites=got["sync_sites"],
    )


def audit_all(names=None, backends=None, **kw: Any) -> tuple[list[EntryReport], list[Finding]]:
    """Audit every registered (entry, backend); returns the reports and
    the concatenated findings.  A fixture that cannot run here
    (``EntryUnavailable``) yields an info finding, not a crash and never
    a clean report."""
    reports = []
    findings: list[Finding] = []
    for name, backend in iter_entries(names, backends):
        try:
            report = audit_entry(name, backend, **kw)
        except EntryUnavailable as e:
            findings.append(Finding("registry", "info", name, f"skipped [{backend}]: {e}"))
            continue
        reports.append(report)
        findings += report.findings
    return reports, findings
