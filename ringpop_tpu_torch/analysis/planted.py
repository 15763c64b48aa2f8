"""Planted faults: what the audit must find, on the CPU and on the card.

Each fault patches one function of the port for the length of a block,
the way a regression would change it, and names the entry and the
contract that must report it at severity ``error``.  The audit's tests
run each on the CPU; ``chip_smoke.py`` phase o runs each on the card.
``tolist`` is seen on the card only: ``.tolist()`` dispatches no ATen
op, so the CPU's count of host reads cannot see it (the lint's RPL001
does).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Iterator

import torch

from ringpop_tpu_torch.analysis.findings import Finding

_KEPT: list[Any] = []  # what the planted handoff keeps


@dataclasses.dataclass(frozen=True)
class Planted:
    name: str
    entry: str
    backend: str
    contract: str
    what: str
    patch: Callable[[], contextlib.AbstractContextManager]
    card_only: bool = False


@contextlib.contextmanager
def _swap(module: Any, attr: str, make: Callable[[Any], Any]) -> Iterator[None]:
    real = getattr(module, attr)
    setattr(module, attr, make(real))
    try:
        yield
    finally:
        setattr(module, attr, real)


def _sim():
    from ringpop_tpu_torch.models import swim_sim

    return swim_sim


def _read_in_step(method: str):
    def make(real):
        def step(hand, *args, **kwargs):
            state, metrics = real(hand, *args, **kwargs)
            getattr(state.tick, method)()
            return state, metrics
        return step
    return lambda: _swap(_sim(), "_swim_step_handed", make)


def _keep_handoff():
    def make(real):
        def run(hand, *args, **kwargs):
            _KEPT.append(hand.state)
            return real(hand, *args, **kwargs)
        return run

    @contextlib.contextmanager
    def patch():
        try:
            with _swap(_sim(), "_swim_run_handed", make):
                yield
        finally:
            _KEPT.clear()
    return patch


def _float64_field():
    def make(real):
        def run(*args, **kwargs):
            state, metrics = real(*args, **kwargs)
            n = state.view_key.shape[0]
            wide = torch.zeros((n, n), dtype=torch.float64, device=state.view_key.device)
            return state._replace(damp=wide), metrics
        return run
    return lambda: _swap(_sim(), "_swim_run_handed", make)


def _key_drawn_twice():
    from ringpop_tpu_torch import prng

    def make(real):
        def uniform(key, shape, **kwargs):
            real(key, shape, **kwargs)
            return real(key, shape, **kwargs)
        return uniform
    return lambda: _swap(prng, "uniform", make)


def _streams_mixed():
    from ringpop_tpu_torch.analysis import registry

    return lambda: _swap(registry, "WORKLOAD_SEED", lambda real: 0)


def _nxn_in_delta():
    from ringpop_tpu_torch.models import swim_delta

    def make(real):
        def step(state, *args, **kwargs):
            out = real(state, *args, **kwargs)
            # a densified view: each viewer's first slot against every base key
            (out[0].d_key[:, :1] + out[0].base_key[None, :]).amax()
            return out
        return step
    return lambda: _swap(swim_delta, "delta_step_impl", make)


def _ring_bypassed():
    def make(real):
        def gather_rows(plane, idx):
            return plane.index_select(0, idx.long())
        return gather_rows
    return lambda: _swap(_sim(), "_gather_rows", make)


PLANTED: dict[str, Planted] = {p.name: p for p in (
    Planted("item", "swim_run", "dense", "host-read",
            "a step with .item() inside (one more read back a tick)", _read_in_step("item")),
    Planted("tolist", "swim_run", "dense", "host-read",
            "a step with .tolist() inside (the CPU's count cannot see it)",
            _read_in_step("tolist"), card_only=True),
    Planted("handoff", "swim_run", "dense", "handoff",
            "a handoff that keeps a reference to the entry state", _keep_handoff()),
    Planted("float64", "swim_run", "dense", "carry-dtype",
            "a float64 [N, N] field in the carried state", _float64_field()),
    Planted("key_twice", "swim_run", "dense", "prng-lineage",
            "every uniform draw made twice from its key", _key_drawn_twice()),
    Planted("streams_mixed", "run_scenario+traffic", "dense", "prng-lineage",
            "the workload on the protocol schedule's seed", _streams_mixed()),
    Planted("nxn", "delta_run", "delta", "census",
            "an [N, N] intermediate in the delta step", _nxn_in_delta()),
    Planted("member_gather", "sharded_step", "dense", "member-gather",
            "the ring's row fetch bypassed by a plain gather", _ring_bypassed()),
)}


def run_planted(name: str, **audit_kw: Any) -> tuple[list[Finding], list[Finding]]:
    """Audit the fault's entry with the fault planted; returns (the
    findings of its contract at severity error, all findings)."""
    from ringpop_tpu_torch.analysis.contracts import audit_entry

    p = PLANTED[name]
    with p.patch():
        report = audit_entry(p.entry, p.backend, **audit_kw)
    hits = [f for f in report.findings if f.contract == p.contract and f.severity == "error"]
    return hits, report.findings
