"""Inter-DC transports.

Two tiers: a pub/sub stream for the transaction feed and a
request/response channel for log catch-up queries and the other requests
(bounded-counter grants, liveness checks).

``LoopbackHub`` is the in-process deterministic transport the tests use.
Messages enqueue; ``pump()`` drains until quiescent, so the causality and
buffering logic runs deterministically.  It can also drop messages on
demand to exercise the gap/catch-up path.  ``tcp.TcpFabric`` drives the
same replica callbacks over sockets for multi-process deployments.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Tuple


class LoopbackHub:
    """Deterministic in-process pub/sub + query fabric between replicas."""

    def __init__(self):
        #: dc_id -> subscriber callback (bytes -> None)
        self.subscribers: Dict[int, List[Callable[[bytes], None]]] = {}
        #: dc_id -> log-query handler (shard, origin, from_opid) -> [bytes]
        self.query_handlers: Dict[int, Callable] = {}
        #: dc_id -> generic request handler (kind, payload) -> reply
        self.request_handlers: Dict[int, Callable] = {}
        #: dc_id -> tick callback, run at every pump — replicas flush
        #: deferred heartbeats here (the in-process stand-in for a 1 s
        #: heartbeat timer)
        self.ticks: Dict[int, Callable[[], None]] = {}
        # bounded-by: test-only deterministic transport — pump() drains
        # to quiescence every round, no wire to fall behind
        self.queues: collections.deque = collections.deque()
        #: (from_dc, to_dc) pairs whose next N messages are dropped
        self.drop: Dict[Tuple[int, int], int] = {}
        self.delivered = 0
        self.dropped = 0

    def register(self, dc_id: int, on_message: Callable[[bytes], None],
                 query_handler: Callable) -> None:
        self.subscribers.setdefault(dc_id, [])
        self.query_handlers[dc_id] = query_handler

    def unregister(self, dc_id: int) -> None:
        """Forget a DC's handlers, subscriptions AND queued deliveries
        (node crash/restart: nothing may reach the ghost replica's
        callbacks — its dead node still holds the WAL files the reborn
        one appends to)."""
        self.query_handlers.pop(dc_id, None)
        self.request_handlers.pop(dc_id, None)
        self.ticks.pop(dc_id, None)
        self.subscribers.pop(dc_id, None)
        for pub, subs in self.subscribers.items():
            self.subscribers[pub] = [
                (to_dc, cb) for to_dc, cb in subs if to_dc != dc_id
            ]
        # bounded-by: rebuilt from the (test-only, pump-drained) queue
        self.queues = collections.deque(
            (to_dc, cb, data) for to_dc, cb, data in self.queues
            if to_dc != dc_id
        )

    def register_tick(self, dc_id: int, fn: Callable[[], None]) -> None:
        self.ticks[dc_id] = fn

    def register_request(self, dc_id: int, handler: Callable) -> None:
        """Attach a generic request handler ((kind, payload) -> reply):
        the request channel's other kinds (bounded-counter grants,
        liveness checks)."""
        self.request_handlers[dc_id] = handler

    def request(self, target_dc: int, kind: str, payload) -> object:
        """Synchronous cross-DC request."""
        return self.request_handlers[target_dc](kind, payload)

    def subscribe(self, subscriber_dc: int, publisher_dc: int,
                  on_message: Callable[[bytes], None]) -> None:
        self.subscribers.setdefault(publisher_dc, []).append(
            (subscriber_dc, on_message)
        )

    def publish(self, from_dc: int, data: bytes) -> None:
        for to_dc, cb in self.subscribers.get(from_dc, []):
            key = (from_dc, to_dc)
            if self.drop.get(key, 0) > 0:
                self.drop[key] -= 1
                self.dropped += 1
                continue
            self.queues.append((to_dc, cb, data))

    def query_log(self, target_dc: int, shard: int, origin: int,
                  from_opid: int) -> List[bytes]:
        """Synchronous catch-up query against a remote DC's log reader."""
        return self.query_handlers[target_dc](shard, origin, from_opid)

    def drop_next(self, from_dc: int, to_dc: int, n: int = 1) -> None:
        """Fault injection: lose the next n messages on a link."""
        self.drop[(from_dc, to_dc)] = self.drop.get((from_dc, to_dc), 0) + n

    def pump(self, max_rounds: int = 10_000, timeout: float = 0.0) -> int:
        """Deliver queued messages until quiescent; returns count.

        Ticks run before each drain round so deferred heartbeats flush
        (and their deliveries may unblock causal gates in the same pump).
        ``timeout`` is ``TcpFabric.pump``'s: the in-process hub never
        waits for a message, so it ignores it."""
        n = 0
        while n < max_rounds:
            for fn in list(self.ticks.values()):
                fn()
            if not self.queues:
                break
            while self.queues and n < max_rounds:
                _, cb, data = self.queues.popleft()
                cb(data)
                self.delivered += 1
                n += 1
        return n
