"""The remediation policy plane: one int-exact update, two executors.

The port of ``ringpop_tpu/policies/core.py``.  A policy is a per-tick
fold over the load signal the overload feedback loop reads
(``node_sends``, the landed sends per holder):

* a **pressure meter** per node, the leaky bucket
  ``press' = max(0, press + sends - admit_capacity)``, the shape of
  ``faults.overload_update``'s counter;
* an **admission (shedding) flag** per node with hysteresis: requests
  whose first resolved holder is shedding are dropped at arrival (one
  landed send, zero retries);
* a **quarantine flag** per node with hysteresis: served rings steer
  around pressured nodes (membership truth untouched);
* an **adaptive retry budget**: a trailing ``amp_window``-tick ring of
  (total sends, delivered) whose ratio, x16 fixed point, collapses the
  retry cap to ``retry_floor`` while it is at or over
  ``amp_threshold_x16``.

All of it is int32 arithmetic with fixed shapes, so the same
``policy_update`` body runs on torch tensors (the scenario runner) and
on numpy arrays (a host oracle).  A disabled mechanism gets an ``INF``
threshold, so every named policy is one program, and the knobs are
plain numbers a sweep varies per replica.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

# A threshold no int32 meter can reach: the OFF position for any
# mechanism (press < INF always, so the flag can never latch).
INF = 2**31 - 1


class PolicyConfig(NamedTuple):
    """The shape part of a policy (hashable)."""

    amp_window: int = 8  # trailing window (ticks) for the amp ratio


class PolicyKnobs(NamedTuple):
    """The operating point: host ints (or int32 scalars), one set per
    replica in a sweep (``policy_axes``)."""

    admit_capacity: Any  # sends/tick a holder absorbs before pressure
    shed_hi: Any  # press >= shed_hi latches the shedding flag
    shed_lo: Any  # hysteresis: shed holds while press > shed_lo
    quar_hi: Any  # press >= quar_hi latches ring quarantine
    quar_lo: Any  # hysteresis: quarantine holds while press > quar_lo
    amp_threshold_x16: Any  # amp (x16 fixed point) that cuts retries
    retry_floor: Any  # the cut retry cap (0 = no retries at all)


class CompiledPolicy(NamedTuple):
    """A named operating point: static config + concrete int knobs."""

    name: str
    config: PolicyConfig
    knobs: PolicyKnobs  # plain python ints


class _NumpyOps:
    """The array calls ``policy_update`` makes, on numpy arrays."""

    @staticmethod
    def i32(x):
        return np.asarray(x).astype(np.int32)

    @staticmethod
    def at_least(x, v):
        return np.maximum(x, v)

    where = staticmethod(np.where)

    @staticmethod
    def lanes(w, like):
        return np.arange(w)

    @staticmethod
    def total(x):
        return np.sum(x)


class _TorchOps:
    """The same calls on torch tensors (on their device)."""

    @staticmethod
    def i32(x):
        return x.to(torch.int32)

    @staticmethod
    def at_least(x, v):
        return torch.clamp(x, min=v)

    where = staticmethod(torch.where)

    @staticmethod
    def lanes(w, like):
        return torch.arange(w, device=like.device)

    @staticmethod
    def total(x):
        return x.sum(dtype=torch.int32)


def policy_update(cfg, knobs, press, shed, quar, sends_w, deliv_w,
                  node_sends, tick_sends, tick_delivered, t, max_retries):
    """One policy tick, on torch tensors or numpy arrays with one body.

    Reads tick ``t``'s serve outputs and returns the plane the serve at
    ``t + 1`` consults (the overload update's post-serve causality):
    ``(press, shed, quar, sends_w, deliv_w, retry_cap, amp_x16)``.  ``t``
    is a host int; the knobs are host ints or int32 scalars."""
    xp = _NumpyOps if isinstance(press, np.ndarray) else _TorchOps
    press = xp.i32(xp.at_least(press + node_sends - knobs.admit_capacity, 0))
    shed = (press >= knobs.shed_hi) | (shed & (press > knobs.shed_lo))
    quar = (press >= knobs.quar_hi) | (quar & (press > knobs.quar_lo))
    slot = xp.lanes(cfg.amp_window, press) == t % cfg.amp_window
    sends_w = xp.i32(xp.where(slot, tick_sends, sends_w))
    deliv_w = xp.i32(xp.where(slot, tick_delivered, deliv_w))
    ssum = xp.total(sends_w)
    dsum = xp.total(deliv_w)
    # a floor division of non-negative int32 values
    amp_x16 = xp.i32((16 * ssum) // xp.at_least(dsum, 1))
    cut = amp_x16 >= knobs.amp_threshold_x16
    retry_cap = xp.i32(xp.where(cut, knobs.retry_floor, max_retries))
    return press, shed, quar, sends_w, deliv_w, retry_cap, amp_x16


def init_policy_state(n: int, cfg: PolicyConfig, max_retries: int, net=None,
                      device: torch.device | str | None = None):
    """Fresh (or net-resumed) policy carry on ``device`` (the net's):
    ``(press int32[N], shed bool[N], quar bool[N], sends_w int32[W],
    deliv_w int32[W], retry_cap int32 scalar)``."""
    if net is not None and getattr(net, "po_press", None) is not None:
        return (
            net.po_press.to(torch.int32),
            net.po_shed.to(torch.bool),
            net.po_quar.to(torch.bool),
            net.po_sends_w.to(torch.int32),
            net.po_deliv_w.to(torch.int32),
            net.po_retry_cap.to(torch.int32),
        )
    if device is None and net is not None:
        device = net.up.device
    w = cfg.amp_window
    return (
        torch.zeros(n, dtype=torch.int32, device=device),
        torch.zeros(n, dtype=torch.bool, device=device),
        torch.zeros(n, dtype=torch.bool, device=device),
        torch.zeros(w, dtype=torch.int32, device=device),
        torch.zeros(w, dtype=torch.int32, device=device),
        torch.full((), int(max_retries), dtype=torch.int32, device=device),
    )


def knob_arrays(cp: CompiledPolicy, device: torch.device | str | None = None) -> PolicyKnobs:
    """The knobs as int32 scalars on ``device`` (made by fills: a host
    copy would wait for the card)."""
    return PolicyKnobs(*(torch.full((), int(v), dtype=torch.int32, device=device)
                         for v in cp.knobs))


# name -> (doc line, enabled mechanisms)
POLICIES: dict[str, tuple[str, tuple[str, ...]]] = {
    "admission": (
        "load-shedding at hot holders: drop excess arrivals at the "
        "pressured owner before a duty-phase timeout burns retries",
        ("admission",),
    ),
    "retry_budget": (
        "adaptive retry budgets: collapse RETRY_SCHEDULE consumption "
        "to retry_floor while trailing amplification >= threshold",
        ("retry_budget",),
    ),
    "quarantine": (
        "serve-side quarantine: steer served rings away from "
        "pressured nodes before suspicion fires (damped-mask reuse)",
        ("quarantine",),
    ),
    "combined": (
        "all three mechanisms at their default operating points",
        ("admission", "retry_budget", "quarantine"),
    ),
}


def default_knobs(name: str, n: int, m: int) -> dict[str, int]:
    """Scale-aware defaults: ``base`` mirrors the incident library's
    per-holder capacity ``max(3, 3m/2n)`` so a policy engages at the
    same pressure scale the cascading_overload meter does."""
    base = max(3, (3 * m) // (2 * n))
    knobs = dict(
        admit_capacity=base,
        shed_hi=INF, shed_lo=INF,
        quar_hi=INF, quar_lo=INF,
        amp_threshold_x16=INF, retry_floor=0,
    )
    _, mechs = POLICIES[name]
    if "admission" in mechs:
        knobs.update(shed_hi=2 * base, shed_lo=max(1, base // 2))
    if "quarantine" in mechs:
        # engage well below the incident's gray threshold (6x base):
        # steer the ring before the overload meter grays the node
        knobs.update(quar_hi=base, quar_lo=max(1, base // 4))
    if "retry_budget" in mechs:
        # 1.5x sends/delivered (x16 fixed point) — the acceptance bar
        knobs.update(amp_threshold_x16=24, retry_floor=0)
    return knobs


def parse_policy_arg(arg: str) -> tuple[str, dict[str, int]]:
    """``NAME[:k=v,...]`` -> (name, integer overrides)."""
    name, _, rest = arg.partition(":")
    name = name.strip()
    if name not in POLICIES:
        raise ValueError(
            f"unknown policy {name!r} (have {', '.join(sorted(POLICIES))})"
        )
    overrides: dict[str, int] = {}
    if rest.strip():
        for item in rest.split(","):
            key, eq, val = item.partition("=")
            key = key.strip()
            if not eq or key not in set(PolicyKnobs._fields) | {"amp_window"}:
                raise ValueError(
                    f"bad policy knob {item!r} (knobs: "
                    f"{', '.join(PolicyKnobs._fields)}, amp_window)"
                )
            overrides[key] = int(val)
    return name, overrides


def compile_policy(policy, *, n: int, m: int,
                   **overrides: int) -> CompiledPolicy:
    """Resolve a policy argument (name string with optional ``:k=v``
    knobs, dict from a stream cursor, or an already-compiled policy)
    into a concrete ``CompiledPolicy`` at cluster scale (n, m)."""
    if isinstance(policy, CompiledPolicy):
        return policy
    if isinstance(policy, dict):
        return from_dict(policy)
    name, parsed = parse_policy_arg(str(policy))
    parsed.update(overrides)
    amp_window = int(parsed.pop("amp_window", PolicyConfig().amp_window))
    if amp_window < 1:
        raise ValueError("amp_window must be >= 1")
    knobs = default_knobs(name, n, m)
    for key, val in parsed.items():
        knobs[key] = int(val)
    return CompiledPolicy(
        name=name,
        config=PolicyConfig(amp_window=amp_window),
        knobs=PolicyKnobs(**knobs),
    )


def to_dict(cp: CompiledPolicy) -> dict:
    """JSON-able form for stream cursors and golden metadata; round
    trips bit-exactly through ``from_dict`` (no scale rederivation)."""
    return {
        "name": cp.name,
        "amp_window": cp.config.amp_window,
        "knobs": {k: int(v) for k, v in cp.knobs._asdict().items()},
    }


def from_dict(d: dict) -> CompiledPolicy:
    return CompiledPolicy(
        name=str(d["name"]),
        config=PolicyConfig(amp_window=int(d["amp_window"])),
        knobs=PolicyKnobs(**{k: int(v) for k, v in d["knobs"].items()}),
    )


def format_catalog(n: int | None = None, m: int | None = None) -> str:
    """The ``--list-policies`` text: catalog + knob table (with the
    concrete defaults when a cluster scale is given)."""
    lines = ["policies (tick-cluster --policy NAME[:k=v,...]):", ""]
    for name, (doc, mechs) in POLICIES.items():
        lines.append(f"  {name:<14} {doc}")
        lines.append(f"  {'':<14} mechanisms: {', '.join(mechs)}")
        if n is not None and m is not None:
            knobs = default_knobs(name, n, m)
            shown = ", ".join(
                f"{k}={v}" for k, v in knobs.items() if v != INF
            )
            lines.append(f"  {'':<14} defaults @ n={n}, m={m}: {shown}")
        lines.append("")
    lines.append(
        "knobs: admit_capacity (pressure leak/tick), shed_hi/shed_lo "
        "(admission hysteresis), quar_hi/quar_lo (quarantine "
        "hysteresis), amp_threshold_x16 (x16 fixed-point amplification "
        "that cuts retries), retry_floor (the cut cap), amp_window "
        "(trailing ticks, compile-time)."
    )
    return "\n".join(lines)


def list_policies() -> list[str]:
    return sorted(POLICIES)
