"""Bounded-counter (escrow) manager.

Decrements and outgoing transfers of a ``counter_b`` object are guarded
against the rights this replica's lane holds.  A refusal is queued as
demand (the rights a grant would have to bring) and deepens the key's
refusal streak, which scales the client's retry hint.

The requester loop (``transfer_periodic``) asks the DCs holding the most
rights for a transfer over the inter-DC query channel, throttled per
(key, target) by a grace period; a sustained refusal streak asks for
headroom beyond the immediate shortfall.  The granter side
(``process_transfer``) answers by committing a ``("transfer", ...)``
update for what it holds.  Grants are non-idempotent commits and the
channel is at-most-once, so the throttle is set BEFORE the send: a reply
lost in flight never earns a blind resend inside the grace window.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

#: seconds a (key, target) pair is throttled after a transfer request
GRACE_PERIOD = 1.0
#: period of the background transfer loop (s)
TRANSFER_FREQ = 0.1
#: refusal streak at which the transfer loop asks for headroom beyond the
#: immediate shortfall (proactive rebalancing)
REBALANCE_STREAK = 2
#: cap on the headroom multiplier a streak can earn
REBALANCE_MAX_FACTOR = 4
#: ceiling on the client retry hint (ms)
HINT_CAP_MS = 2000
#: refusal streaks with no activity for this long are forgotten
STREAK_TTL = 10 * GRACE_PERIOD

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
        #: throttle map: ((key, bucket), target_dc) -> last request time;
        #: entries past the grace period are pruned every tick
        self._last_request: Dict[Tuple[QueueKey, int], float] = {}
        #: refusal streaks: (key, bucket) -> (streak, last seen), reset
        #: by ``satisfied``, pruned after STREAK_TTL of inactivity
        self._refusals: Dict[QueueKey, Tuple[int, float]] = {}
        #: wired by the inter-DC layer: (target_dc, key, bucket, amount)
        self.request_transfer: Optional[
            Callable[[int, Any, str, int], None]] = None
        #: batched twin: (target_dc, [(key, bucket, amount), ...]) — one
        #: tick's asks against one granter share one round trip
        self.request_transfer_many: Optional[
            Callable[[int, List[Tuple[Any, str, int]]], None]] = None
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

    # ------------------------------------------------------------------
    # requester side
    # ------------------------------------------------------------------
    def transfer_periodic(self, read_state: Callable[[Any, str], dict],
                          ty) -> int:
        """For each queued shortfall, ask the remote DCs holding the most
        rights.  ``read_state`` returns the current counter_b state fields
        (None for a never-written object).  Returns the number of requests
        sent."""
        now = self.clock()
        for tk, t in list(self._last_request.items()):
            if now - t >= GRACE_PERIOD:
                del self._last_request[tk]
        for qk, (_streak, t) in list(self._refusals.items()):
            if now - t >= STREAK_TTL and qk not in self.pending:
                del self._refusals[qk]
        if ((self.request_transfer is None
             and self.request_transfer_many is None) or not self.pending):
            return 0
        sent = 0
        #: this tick's asks in decision order: (dc, key, bucket, amount)
        asks: List[Tuple[int, Any, str, int]] = []
        for (key, bucket), needed in list(self.pending.items()):
            state = read_state(key, bucket)
            if state is None:
                # never written anywhere visible: no DC holds rights
                del self.pending[(key, bucket)]
                continue
            held = ty.local_rights(state, self.my_dc)
            shortfall = needed - max(held, 0)
            if shortfall <= 0:
                # grants arrived: the queued decrement is coverable now
                self.satisfied(key, bucket)
                self.grants_arrived_total += 1
                continue
            d = np.asarray(state["used"]).shape[0]
            rights_by_dc = sorted(
                ((ty.local_rights(state, dc), dc) for dc in range(d)
                 if dc != self.my_dc), reverse=True)
            # a sustained refusal streak is the demand signal: ask for
            # headroom so the next burst finds rights already here
            streak = self._refusals.get((key, bucket), (0, 0.0))[0]
            factor = 1
            if streak >= REBALANCE_STREAK:
                factor = min(REBALANCE_MAX_FACTOR, streak)
            remaining = shortfall * factor
            for rights, dc in rights_by_dc:
                if rights <= 0 or remaining <= 0:
                    break
                tk = ((key, bucket), dc)
                if now - self._last_request.get(tk, -1e9) < GRACE_PERIOD:
                    continue
                ask = min(remaining, rights)
                # throttle BEFORE the send (at-most-once channel)
                self._last_request[tk] = now
                asks.append((dc, key, bucket, ask))
                remaining -= ask
                sent += 1
                self.requests_sent_total += 1
        if self.request_transfer_many is not None:
            by_dc: Dict[int, List[Tuple[Any, str, int]]] = {}
            for dc, key, bucket, ask in asks:
                by_dc.setdefault(dc, []).append((key, bucket, ask))
            for dc, entries in by_dc.items():
                self.request_transfer_many(dc, entries)
        else:
            for dc, key, bucket, ask in asks:
                self.request_transfer(dc, key, bucket, ask)
        return sent

    # ------------------------------------------------------------------
    # granter side
    # ------------------------------------------------------------------
    def process_transfer(self, txm, key, bucket: str, amount: int,
                         to_dc: int) -> int:
        """Grant up to ``amount`` rights to ``to_dc`` by committing a
        transfer update; grants only what this replica holds.  Returns the
        granted amount (0 = refused)."""
        from antidote_tpu_torch.crdt import get_type
        from antidote_tpu_torch.overload import InsufficientRightsError

        ty = get_type("counter_b")
        # under the commit lock: this runs on the fabric's request thread,
        # racing commits that may grow the device tables
        with txm.commit_lock:
            state = txm.store.read_states(
                [(key, "counter_b", bucket)], txm.store.dc_max_vc())[0]
        if state is None:
            return 0
        grant = min(amount, ty.local_rights(state, self.my_dc))
        if grant <= 0:
            return 0
        try:
            txm.update_objects_static([
                (key, "counter_b", bucket,
                 ("transfer", (grant, to_dc, self.my_dc))),
            ])
        except InsufficientRightsError:
            # the read raced a commit that spent the rights: the escrow
            # certification refused the transfer, nothing was granted
            return 0
        return grant
