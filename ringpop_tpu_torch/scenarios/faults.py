"""The failure model's host side: directed link loss, latency, gray periods.

The port of ``ringpop_tpu/scenarios/faults.py``.  A
scenario's ``link_loss``/``delay``/``gray`` events lower to three
things the steps evaluate every tick, all O(N) or O(K * N), never an
[N, N] matrix:

* **Link rules** (``link_loss``/``delay``): K directed block rules,
  each ``(src bool[N], dst bool[N], p, delay, jitter)`` active during
  ``[start, end)``.  A message from s to r is governed by every active
  rule with ``src[s] & dst[r]``: drop probabilities compose as
  ``1 - prod(1 - p_k)`` and delays take the per-pair maxima.
* **Period rows** (``gray``): an int32[N] per-node protocol period,
  switched at event boundaries.  A gray node answers pings and serves
  as a witness every tick but initiates its own probe once per
  ``factor`` ticks; a row of P is ``SwimParams.phase_mod = P``.
* **Delay depth**: the ring length ``max(delay) + max(jitter) + 1`` of
  the in-flight claim buffer (``ClusterState.pending``, or the delta
  backend's ``pend_*`` lanes).

``compile_faults`` lowers them to the device tensors the compiled
runner (``runner.run_compiled``) evaluates each tick; ``HostPlan``
applies them through ``SimCluster`` at every boundary of the host loop
(``runner.run_host_loop``).  ``flap``/``rolling_restart`` need nothing
here: they expand to kill/revive primitives
(``spec.expand_fault_primitives``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ringpop_tpu_torch import resolve_device
from ringpop_tpu_torch.scenarios.spec import ScenarioSpec


class LinkRule(NamedTuple):
    """One directed block rule (host form; windows in spec ticks)."""

    start: int
    end: int
    src: tuple[int, ...]
    dst: tuple[int, ...]
    p: float  # extra drop probability on the link
    delay: int  # base latency in ticks
    jitter: int  # uniform extra latency in {0..jitter}


class FaultTensors(NamedTuple):
    """The rule table and period rows on the cluster's device.
    ``lr_d``/``lr_j`` are None when the spec delays nothing: their
    presence routes the step through the in-flight buffer (and widens
    its key split)."""

    lr_src: torch.Tensor  # bool[K, N]
    lr_dst: torch.Tensor  # bool[K, N]
    lr_p: torch.Tensor  # float32[K]
    lr_start: torch.Tensor  # int32[K]
    lr_end: torch.Tensor  # int32[K]
    lr_d: torch.Tensor | None  # int32[K] | None (no delay rules)
    lr_j: torch.Tensor | None  # int32[K] | None
    pe_tick: torch.Tensor  # int32[G] period-switch ticks
    pe_row: torch.Tensor  # int16[G, N] per-node period rows (the runner's carry form)


class OverloadConfig(NamedTuple):
    """The load-coupled gray loop's static knobs.  Per tick ``t`` in
    ``[start, end)``, with ``sends[i]`` the serve plane's send attempts
    landing on node i::

        pressure[i] = max(0, pressure[i] + sends[i] - capacity)
        gray[i]     = pressure[i] >= threshold
                      or (gray[i] and pressure[i] > recover)

    and node i's effective period at tick t + 1 is
    ``max(period[i], factor)`` while ``gray[i]``.  Outside the window
    pressure and gray are zero."""

    start: int  # window start tick (inclusive)
    end: int  # window end tick (exclusive)
    capacity: int  # sends a node absorbs per tick without pressure
    threshold: int  # pressure at which the node degrades to gray
    recover: int  # hysteresis: gray clears only at pressure <= recover
    factor: int  # the degraded protocol period while gray


def overload_config(spec: ScenarioSpec) -> OverloadConfig | None:
    """The spec's (at most one) ``overload`` event as its config, or None."""
    for e in spec.events:
        if e.op == "overload":
            return OverloadConfig(
                start=e.at,
                end=e.until if e.until is not None else spec.ticks,
                capacity=int(e.capacity),
                threshold=int(e.threshold),
                recover=int(e.recover) if e.recover is not None else 0,
                factor=int(e.factor),
            )
    return None


def overload_update(cfg: OverloadConfig, in_window, pressure, gray, sends):
    """One tick of the feedback state update on numpy arrays or torch
    tensors (exact integer and bool algebra): ``(pressure', gray')``.
    ``in_window`` is a host bool (or a bool array); outside the window
    both come back zero."""
    if torch.is_tensor(pressure):
        cnt = torch.clamp(pressure + sends - cfg.capacity, min=0)
        if isinstance(in_window, (bool, np.bool_)):
            # a host bool: no host-to-device copy (it would wait for the card)
            if not in_window:
                return torch.zeros_like(cnt), torch.zeros_like(gray)
            in_window = True
        else:
            cnt = torch.where(torch.as_tensor(in_window, device=cnt.device), cnt, 0)
    else:
        cnt = np.maximum(pressure + sends - cfg.capacity, 0)
        cnt = np.where(in_window, cnt, 0)
    new_gray = in_window & ((cnt >= cfg.threshold) | (gray & (cnt > cfg.recover)))
    return cnt, new_gray


def link_rules(spec: ScenarioSpec) -> list[LinkRule]:
    """The spec's link_loss/delay events as rules, in (at, spec order):
    one order everywhere, since the order of the composed drop product
    decides its float rounding."""
    rules = []
    for e in sorted(
        (e for e in spec.events if e.op in ("link_loss", "delay")), key=lambda e: e.at
    ):
        until = e.until if e.until is not None else spec.ticks
        rules.append(
            LinkRule(
                start=e.at,
                end=until,
                src=tuple(e.src),
                dst=tuple(e.dst),
                p=float(e.p) if e.p is not None else 0.0,
                delay=int(e.delay or 0) if e.op == "delay" else 0,
                jitter=int(e.jitter or 0) if e.op == "delay" else 0,
            )
        )
    return rules


def delay_depth(spec: ScenarioSpec) -> int:
    """Ring depth of the in-flight buffer: the largest latency plus one,
    or 0 without delay.  Overlapping rules combine as ``max_k(delay) +
    U{0..max_k(jitter)}``, so the bound takes the two maxima apart."""
    rules = [r for r in link_rules(spec) if r.delay + r.jitter]
    if not rules:
        return 0
    return max(r.delay for r in rules) + max(r.jitter for r in rules) + 1


def period_switches(spec: ScenarioSpec, n: int) -> list[tuple[int, np.ndarray]]:
    """``(tick, int32[N] period row)`` at every tick the period vector
    changes, in tick order.  Gray windows set the factor at ``at`` and
    restore 1 at ``until``; on a tick where one window ends and another
    starts, the restore applies first."""
    edits: list[tuple[int, tuple[int, ...], int]] = []
    for e in spec.events:
        if e.op != "gray":
            continue
        until = e.until if e.until is not None else spec.ticks
        edits.append((e.at, e.target_nodes(), int(e.factor)))
        if until < spec.ticks:
            edits.append((until, e.target_nodes(), 1))
    if not edits:
        return []
    period = np.ones(n, dtype=np.int32)
    out = []
    edits.sort(key=lambda e: e[2] != 1)
    for tick in sorted({t for t, _, _ in edits}):
        for t, nodes, val in edits:
            if t == tick:
                period[list(nodes)] = val
        out.append((tick, period.copy()))
    return out


def fault_marker_ticks(spec: ScenarioSpec) -> list[int]:
    """Every tick at which the link-rule or period configuration changes:
    the boundaries at which the host loop applies the plan again."""
    ticks: set[int] = set()
    for r in link_rules(spec):
        ticks.add(r.start)
        if r.end < spec.ticks:
            ticks.add(r.end)
    for e in spec.events:
        if e.op == "gray":
            ticks.add(e.at)
            until = e.until if e.until is not None else spec.ticks
            if until < spec.ticks:
                ticks.add(until)
    return sorted(t for t in ticks if 0 <= t < spec.ticks)


def rules_arrays(
    rules: list[LinkRule], n: int, at: int | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The rule table as ``(src[K, N], dst[K, N], p[K], d[K], j[K])``.
    ``at`` zeroes p, d and j of the rules inactive at that tick: an
    inactive rule is an exact factor 1.0 in the drop product."""
    k = len(rules)
    src = np.zeros((k, n), dtype=bool)
    dst = np.zeros((k, n), dtype=bool)
    p = np.zeros(k, dtype=np.float32)
    d = np.zeros(k, dtype=np.int32)
    j = np.zeros(k, dtype=np.int32)
    for i, r in enumerate(rules):
        src[i, list(r.src)] = True
        dst[i, list(r.dst)] = True
        if at is None or r.start <= at < r.end:
            p[i] = r.p
            d[i] = r.delay
            j[i] = r.jitter
    return src, dst, p, d, j


def compile_faults(
    spec: ScenarioSpec, n: int, device: torch.device | str | None = None
) -> FaultTensors | None:
    """The spec's fault events as tensors on ``device``, or None when it
    has none."""
    rules = link_rules(spec)
    switches = period_switches(spec, n)
    if not rules and not switches:
        return None
    dev = resolve_device(device)
    src, dst, p, d, j = rules_arrays(rules, n)
    # audit: allow=RPL001 numpy rule arrays, no tensor
    has_delay = bool((d + j).any())

    def on(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return FaultTensors(
        lr_src=on(src),
        lr_dst=on(dst),
        lr_p=on(p),
        lr_start=on(np.array([r.start for r in rules], dtype=np.int32)),
        lr_end=on(np.array([r.end for r in rules], dtype=np.int32)),
        lr_d=on(d) if has_delay else None,
        lr_j=on(j) if has_delay else None,
        pe_tick=on(np.array([t for t, _ in switches], dtype=np.int32)),
        pe_row=on(_narrow_period_rows(switches, n)),
    )


def _narrow_period_rows(switches, n: int) -> np.ndarray:
    """Period-switch rows in the runner's int16 carry form; a period past
    the int16 range is refused."""
    rows = np.stack([row for _, row in switches]) if switches else np.zeros((0, n), np.int32)
    if rows.size and rows.max() > np.iinfo(np.int16).max:
        raise ValueError(
            f"set_period row value {rows.max()} exceeds the int16 carry range"
        )
    return rows.astype(np.int16)


class HostPlan:
    """What ``run_host_loop`` applies at each ``faultcfg`` boundary, so
    that ``SimCluster.tick()`` sees the configuration in force."""

    def __init__(self, spec: ScenarioSpec, n: int):
        self.spec = spec
        self.n = n
        self.rules = link_rules(spec)
        self.switches = period_switches(spec, n)
        self.delay_depth = delay_depth(spec)
        self.has_delay = self.delay_depth > 0

    def prepare(self, cluster: Any) -> None:
        """Install the in-flight buffer when the spec delays messages: it
        must exist from tick 0, as its presence widens the key split."""
        if self.has_delay:
            cluster.enable_delay(self.delay_depth)

    def apply(self, cluster: Any, at: int) -> None:
        """Install the configuration in force at spec tick ``at``."""
        if self.rules:
            src, dst, p, d, j = rules_arrays(self.rules, self.n, at=at)
            cluster.set_link_rules(
                src, dst, p,
                d=d if self.has_delay else None,
                j=j if self.has_delay else None,
            )
        if self.switches:
            row = np.ones(self.n, dtype=np.int32)
            for t, r in self.switches:
                if t <= at:
                    row = r
            cluster.set_period(row)
