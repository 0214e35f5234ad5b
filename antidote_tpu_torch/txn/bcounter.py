"""Bounded-counter (escrow) manager, the local half.

Decrements and outgoing transfers of a ``counter_b`` object are guarded
against the rights this replica's lane holds.  A refusal is queued as
demand (the rights a grant would have to bring) and deepens the key's
refusal streak, which scales the client's retry hint.

The requester loop that asks richer DCs for transfers
(``transfer_periodic``) and the granter side (``process_transfer``) ride
the inter-DC query channel and come with the inter-DC slice.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Tuple

#: period of the background transfer loop (s)
TRANSFER_FREQ = 0.1
#: ceiling on the client retry hint (ms)
HINT_CAP_MS = 2000

QueueKey = Tuple[Any, str]  # (key, bucket)


class NoPermissionsError(Exception):
    """Decrement exceeds locally-held rights."""

    def __init__(self, key, needed: int, held: int):
        super().__init__(
            f"insufficient rights for {key!r}: need {needed}, hold {held}")
        self.key = key
        self.needed = needed
        self.held = held


class BCounterManager:
    def __init__(self, my_dc: int,
                 clock: Callable[[], float] = time.monotonic):
        self.my_dc = my_dc
        self.clock = clock
        #: refused decrements awaiting rights: (key, bucket) -> the rights
        #: needed (the full decrement amount); entries retire on
        #: ``satisfied``
        self.pending: Dict[QueueKey, int] = {}
        #: refusal streaks: (key, bucket) -> (streak, last seen), reset
        #: by ``satisfied``
        self._refusals: Dict[QueueKey, Tuple[int, float]] = {}
        self.refused_total = 0
        self.requests_sent_total = 0
        self.grants_arrived_total = 0

    def check_decrement(self, ty, state, key, bucket: str,
                        amount: int) -> None:
        """Raise NoPermissionsError (and queue the demand) if this replica
        does not hold ``amount`` rights for the object."""
        held = ty.local_rights(state, self.my_dc)
        if held < amount:
            self.note_refusal(key, bucket, amount)
            raise NoPermissionsError(key, amount, held)

    def note_refusal(self, key, bucket: str, amount: int) -> int:
        """Record a refused decrement: queue its demand and deepen the
        key's refusal streak.  Returns the new streak."""
        qk = (key, bucket)
        self.pending[qk] = max(self.pending.get(qk, 0), int(amount))
        streak = self._refusals.get(qk, (0, 0.0))[0] + 1
        self._refusals[qk] = (streak, self.clock())
        self.refused_total += 1
        return streak

    def grant_hint_ms(self, key, bucket: str) -> int:
        """Retry hint for a refused decrement: about one transfer-loop
        period for a first refusal, longer for a deeper streak, capped."""
        streak = self._refusals.get((key, bucket), (1, 0.0))[0]
        return min(HINT_CAP_MS, int(TRANSFER_FREQ * 1e3) * (1 + streak))

    def satisfied(self, key, bucket: str) -> None:
        """Drop the key's queued demand and streak (a decrement of it
        went through)."""
        self.pending.pop((key, bucket), None)
        self._refusals.pop((key, bucket), None)

    def shortfall(self) -> int:
        """Total rights currently queued for."""
        return sum(self.pending.values())

    def status(self) -> dict:
        """The escrow block of a node's status."""
        return {
            "pending_keys": len(self.pending),
            "shortfall": self.shortfall(),
            "refused_total": self.refused_total,
            "requests_sent_total": self.requests_sent_total,
            "grants_arrived_total": self.grants_arrived_total,
        }

    def transfer_periodic(self, read_state, ty) -> int:
        raise NotImplementedError(
            "transfer_periodic: the rights-transfer loop rides the inter-DC "
            "query channel, which is not ported yet (the inter-DC slice)")

    def process_transfer(self, txm, key, bucket: str, amount: int,
                         to_dc: int) -> int:
        raise NotImplementedError(
            "process_transfer: granting rights to another DC rides the "
            "inter-DC query channel, which is not ported yet (the inter-DC "
            "slice)")
