"""Flap damping: detect and quarantine erratically-flapping members.

The reference *documents* this subsystem but never implemented it —
docs/architecture_design.md:73-82 describe penalty scores, decay, a
suppress limit, and ring eviction, yet no damping code exists in lib/
(SURVEY §5.3).  This module implements that documented design as an
opt-in extension (``RingPop(damping_enabled=True)``); disabled, behavior
is exactly the reference's.

Model (per the reference's own description):

* every node keeps a **damp score** for every other member;
* each *flap* — a disseminated status transition touching ``alive``
  (alive→suspect/faulty or suspect/faulty→alive) — adds ``penalty``;
* scores **decay exponentially** with half-life ``decay_half_life_ms``
  ("if the damp score goes down and then decays, the problem is fixed");
* a score above ``suppress_limit`` marks the member **damped**: it is
  removed from the hash ring (protecting lookups from shaky ownership)
  and reported via the ``memberDamped`` event + stats;
* once the decayed score falls below ``reuse_limit`` the member is
  reinstated (``memberUndamped``) and, if alive, returns to the ring.

The reference sketch also describes a damp-req fanout subprotocol
(confirming scores with k random members before damping).  In the
tick-synchronous rebuild every node evaluates the same disseminated
update stream, so local scores already agree cluster-wide up to
propagation delay; the fanout adds RPC round-trips without changing the
steady state and is intentionally omitted.

The port of ``ringpop_tpu/damping.py``.
"""

from __future__ import annotations

from typing import Any

from ringpop_tpu_torch.member import Status

DEFAULT_PENALTY = 500.0
DEFAULT_SUPPRESS_LIMIT = 2500.0
DEFAULT_REUSE_LIMIT = 500.0
DEFAULT_DECAY_HALF_LIFE_MS = 60_000.0

_FLAP_SET = {Status.alive, Status.suspect, Status.faulty}


class MemberDamping:
    def __init__(
        self,
        ringpop: Any,
        penalty: float = DEFAULT_PENALTY,
        suppress_limit: float = DEFAULT_SUPPRESS_LIMIT,
        reuse_limit: float = DEFAULT_REUSE_LIMIT,
        decay_half_life_ms: float = DEFAULT_DECAY_HALF_LIFE_MS,
    ):
        self.ringpop = ringpop
        self.penalty = penalty
        self.suppress_limit = suppress_limit
        self.reuse_limit = reuse_limit
        self.decay_half_life_ms = decay_half_life_ms
        # address -> (score at `stamp`, stamp ms, last seen status)
        self._scores: dict[str, tuple[float, float, str | None]] = {}
        self.damped: set[str] = set()

    # -- scorekeeping --------------------------------------------------------

    def _decayed(self, score: float, stamp: float, now: float) -> float:
        if score <= 0.0:
            return 0.0
        return score * 0.5 ** ((now - stamp) / self.decay_half_life_ms)

    def score_of(self, address: str) -> float:
        entry = self._scores.get(address)
        if entry is None:
            return 0.0
        return self._decayed(entry[0], entry[1], self.ringpop.clock.now())

    def record_updates(self, updates: list[dict[str, Any]]) -> None:
        """Feed applied membership updates; flaps accumulate penalty."""
        now = self.ringpop.clock.now()
        local = self.ringpop.whoami()
        for update in updates:
            address = update.get("address")
            status = update.get("status")
            if address is None or address == local:
                continue
            score, stamp, prev = self._scores.get(address, (0.0, now, None))
            score = self._decayed(score, stamp, now)
            is_flap = (
                prev is not None
                and prev != status
                and prev in _FLAP_SET
                and status in _FLAP_SET
                and (prev == Status.alive or status == Status.alive)
            )
            if is_flap:
                score += self.penalty
                self.ringpop.stat("increment", "damping.flap")
            self._scores[address] = (score, now, status)
            self._evaluate(address, score, status)

    def decay_tick(self) -> None:
        """Re-evaluate damped members.  Called on every applied update
        batch (listeners.py) AND every protocol period
        (ringpop.ping_member_now) so a quiet cluster still reinstates
        members whose scores have decayed."""
        for address in list(self.damped):
            entry = self._scores.get(address)
            if entry is None:
                continue
            self._evaluate(address, self.score_of(address), entry[2])

    # -- transitions ---------------------------------------------------------

    def _evaluate(self, address: str, score: float, status: str | None) -> None:
        if address not in self.damped and score > self.suppress_limit:
            self.damped.add(address)
            self.ringpop.stat("increment", "damping.damped")
            self.ringpop.logger.warn(
                "member damped for excessive flapping",
                {"member": address, "score": score},
            )
            if self.ringpop.ring.has_server(address):
                self.ringpop.ring.remove_server(address)
                self.ringpop.emit("ringChanged")
            self.ringpop.emit("memberDamped", address)
        elif address in self.damped and score < self.reuse_limit:
            self.damped.discard(address)
            self.ringpop.stat("increment", "damping.undamped")
            member = self.ringpop.membership.find_member_by_address(address)
            if member is not None and member.status in (Status.alive, Status.suspect):
                self.ringpop.ring.add_server(address)
                self.ringpop.emit("ringChanged")
            self.ringpop.emit("memberUndamped", address)

    def is_damped(self, address: str) -> bool:
        return address in self.damped

    def get_stats(self) -> dict[str, Any]:
        now = self.ringpop.clock.now()
        decayed = (
            (address, self._decayed(score, stamp, now))
            for address, (score, stamp, _) in self._scores.items()
        )
        return {
            "damped": sorted(self.damped),
            "scores": {a: round(s, 1) for a, s in decayed if s > 1.0},
        }
