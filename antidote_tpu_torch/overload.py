"""The typed refusal errors the transaction layer and the cold tier raise,
their retry hint, and the deadline check.  The admission gates of the
serving planes are later work."""

from __future__ import annotations

import time
from typing import Optional


class BusyError(Exception):
    """Admission refused: the plane is at its in-flight/backlog cap.
    ``retry_after_ms`` is the hint for client backoff."""

    def __init__(self, msg: str, retry_after_ms: int = 50):
        super().__init__(msg)
        self.retry_after_ms = int(retry_after_ms)


class DeadlineExceeded(Exception):
    """The request outlived its deadline before execution started —
    aborted at dequeue."""


class ReadOnlyError(Exception):
    """The node is in degraded read-only mode (WAL appends failing);
    writes are rejected, reads keep serving."""

    def __init__(self, reason: str):
        super().__init__(f"node is read-only (degraded): {reason}")
        self.reason = reason


class InsufficientRightsError(Exception):
    """A bounded-counter (``counter_b``) decrement/transfer asked for more
    rights than this DC's escrow lane holds; nothing was applied."""

    def __init__(self, msg: str, retry_after_ms: int = 100,
                 key=None, needed: int = 0, held: int = 0):
        super().__init__(msg)
        self.retry_after_ms = int(retry_after_ms)
        self.key = key
        self.needed = int(needed)
        self.held = int(held)


class ColdMiss(Exception):
    """A read or write touched a cold-tier key whose device state could not
    be faulted back in right now: the fault-rate cap is exceeded, the
    fault-in hit an (injected or real) I/O error, or the checkpoint sidecar
    row failed its CRC.  The request was NOT served with a wrong value; the
    client retries after the hint.  ``permanent=True`` marks the one
    unrecoverable case, a sidecar row verifiably lost on every retained
    image, which an operator heals by re-bootstrapping from a peer, never
    by a silent bottom read."""

    def __init__(self, msg: str, retry_after_ms: int = 50,
                 permanent: bool = False):
        super().__init__(msg)
        self.retry_after_ms = int(retry_after_ms)
        self.permanent = bool(permanent)


def retry_hint_ms(streak: int) -> int:
    """Pressure-scaled retry hint: ``streak`` counts refusals since the
    plane last admitted work, so the hint backs off harder the longer the
    plane stays saturated, bounded 25..500 ms."""
    return max(25, min(500, 25 * (1 + int(streak) // 4)))


def check_deadline(deadline: Optional[float], where: str) -> None:
    if deadline is not None and time.monotonic() > deadline:
        raise DeadlineExceeded(
            f"request deadline passed before {where}; not executed"
        )
