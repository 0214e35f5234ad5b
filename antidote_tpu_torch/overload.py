"""The typed refusal errors the transaction layer raises, and the deadline
check.  The admission gates of the serving planes are later work."""

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


def check_deadline(deadline: Optional[float], where: str) -> None:
    if deadline is not None and time.monotonic() > deadline:
        raise DeadlineExceeded(
            f"request deadline passed before {where}; not executed"
        )
