"""Multi-tenant QoS: tenant identity, weights, and weighted-fair lanes.

One node serves many tenants, so every bound that is global today — the admission gate,
the batch-gate/locked-plane queues, the merged group-commit batch — gets
a tenant-scoped twin here.  Scheduling semantics follow Dominant
Resource Fairness (Ghodsi et al., NSDI'11) in the single-resource case:
**weighted shares when contended, work-conserving when not** — an idle
tenant's capacity flows to whoever is backlogged, and a backlogged
tenant queues in its OWN bounded lane instead of occupying the shared
queue that everyone else's requests ride.

Tenant identity is derived from the bucket namespace: a bucket named
``acme/orders`` belongs to tenant ``acme`` **iff** ``acme`` is a
registered tenant; everything else (flat buckets, unregistered
prefixes) rides the ``default`` lane.  A client may also tag requests
explicitly (the ``tenant`` field on static read/update bodies — the
connection-handshake analogue for the native dialect); unregistered
tags fall back to bucket derivation.  Restricting lanes and metric
labels to the REGISTERED name set is deliberate: tenant names come from
operator configuration, never from the wire, so label cardinality (and
lane count) is bounded by config size — a hostile client inventing
bucket prefixes cannot OOM Prometheus or allocate lanes.

The registry is configured via repeatable ``console serve --tenant``
flags::

    --tenant "acme:3,max_in_flight=64,max_backlog=512" --tenant "free:1"

``weight`` governs the deficit-round-robin dequeue share and the
tenant's slice of a merged group-commit batch; ``max_in_flight``
(optional) caps the tenant's concurrent admitted requests;
``max_backlog`` (optional) overrides the tenant's lane depth (default:
a weight-proportional slice of the shared queue budget).
"""

from __future__ import annotations

import queue
import re
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

from antidote_tpu_torch.overload import BusyError, TenantBusyError, retry_hint_ms

#: the lane untagged / unregistered traffic rides
DEFAULT_TENANT = "default"

#: tenant names are operator-chosen and ride apb errmsg key=value pairs
#: (value grammar ``\S+``) and Prometheus labels — keep them boring
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.-]{0,63}$")


class TenantSpec:
    """One tenant's configured weight and caps."""

    __slots__ = ("name", "weight", "max_in_flight", "max_backlog")

    def __init__(self, name: str, weight: int = 1,
                 max_in_flight: Optional[int] = None,
                 max_backlog: Optional[int] = None):
        if not _NAME_RE.match(name):
            raise ValueError(
                f"bad tenant name {name!r}: want [A-Za-z0-9][A-Za-z0-9_.-]*"
            )
        if int(weight) < 1:
            raise ValueError(f"tenant {name}: weight must be >= 1")
        self.name = name
        self.weight = int(weight)
        self.max_in_flight = (
            None if max_in_flight is None else max(1, int(max_in_flight)))
        self.max_backlog = (
            None if max_backlog is None else max(1, int(max_backlog)))

    def as_dict(self) -> dict:
        return {
            "weight": self.weight,
            "max_in_flight": self.max_in_flight,
            "max_backlog": self.max_backlog,
        }


def parse_tenant_spec(text: str) -> TenantSpec:
    """Parse one ``--tenant`` flag value:
    ``name:weight[,max_in_flight=N][,max_backlog=N]`` (weight optional,
    defaults to 1: ``"free"`` alone is a valid spec)."""
    parts = [p.strip() for p in str(text).split(",") if p.strip()]
    if not parts:
        raise ValueError(f"empty tenant spec {text!r}")
    head, kwargs = parts[0], parts[1:]
    if ":" in head:
        name, _, w = head.partition(":")
        try:
            weight = int(w)
        except ValueError:
            raise ValueError(
                f"tenant spec {text!r}: weight {w!r} is not an integer")
    else:
        name, weight = head, 1
    caps: Dict[str, int] = {}
    for kv in kwargs:
        k, sep, v = kv.partition("=")
        k = k.strip()
        if not sep or k not in ("max_in_flight", "max_backlog"):
            raise ValueError(
                f"tenant spec {text!r}: unknown option {kv!r} "
                f"(want max_in_flight=N / max_backlog=N)")
        try:
            caps[k] = int(v)
        except ValueError:
            raise ValueError(f"tenant spec {text!r}: {k} {v!r} not an int")
    return TenantSpec(name.strip(), weight, **caps)


class TenantRegistry:
    """The closed set of tenants this node knows, with weights and caps.

    Always contains :data:`DEFAULT_TENANT`; an untenanted node is just a
    registry holding only the default lane, which makes every tenant
    code path degenerate to today's single-queue behavior (one lane,
    FIFO, shared bounds) — the serving stack never branches on
    "tenancy enabled"."""

    def __init__(self, specs: Iterable[TenantSpec] = ()):
        self._specs: Dict[str, TenantSpec] = {}
        for s in specs:
            if s.name in self._specs:
                raise ValueError(f"duplicate tenant {s.name!r}")
            self._specs[s.name] = s
        self._specs.setdefault(DEFAULT_TENANT, TenantSpec(DEFAULT_TENANT))
        #: stable lane/label order: default first, then config order
        self._names: Tuple[str, ...] = (
            (DEFAULT_TENANT,)
            + tuple(n for n in self._specs if n != DEFAULT_TENANT))

    @classmethod
    def from_flags(cls, flags: Optional[Iterable[str]]) -> "TenantRegistry":
        return cls([parse_tenant_spec(f) for f in (flags or ())])

    # ------------------------------------------------------------------
    @property
    def names(self) -> Tuple[str, ...]:
        """The BOUNDED label/lane set (config-sized, never wire-fed)."""
        return self._names

    @property
    def multi(self) -> bool:
        """True when any non-default tenant is configured."""
        return len(self._names) > 1

    def spec(self, name: str) -> TenantSpec:
        return self._specs.get(name) or self._specs[DEFAULT_TENANT]

    def weight(self, name: str) -> int:
        return self.spec(name).weight

    def max_in_flight(self, name: str) -> Optional[int]:
        return self.spec(name).max_in_flight

    def max_backlog(self, name: str) -> Optional[int]:
        return self.spec(name).max_backlog

    def total_weight(self, names: Optional[Iterable[str]] = None) -> int:
        use = self._names if names is None else tuple(names)
        return sum(self.weight(n) for n in use) or 1

    def label(self, name) -> str:
        """Clamp an arbitrary tenant-ish value onto the bounded label
        set (metrics MUST go through this — tools/lint.py's
        tenant-label rule)."""
        return name if name in self._specs else DEFAULT_TENANT

    # ------------------------------------------------------------------
    # identity derivation
    # ------------------------------------------------------------------
    def tenant_of(self, bucket) -> str:
        """Tenant owning ``bucket``: the ``tenant/`` prefix when (and
        only when) it names a registered tenant, else the default
        lane.  Accepts str or bytes (the apb dialect carries buckets
        as bytes)."""
        if isinstance(bucket, bytes):
            try:
                bucket = bucket.decode("utf-8", "replace")
            except Exception:
                return DEFAULT_TENANT
        if isinstance(bucket, str) and "/" in bucket:
            prefix = bucket.split("/", 1)[0]
            if prefix in self._specs:
                return prefix
        return DEFAULT_TENANT

    def resolve(self, tag, buckets: Iterable = ()) -> str:
        """Tenant for one request: an explicit registered tag wins
        (the connection-handshake path), else the first bucket whose
        prefix names a registered tenant, else default.  Mixed-tenant
        requests are accounted to the first matching bucket — one
        request is one admission unit, it cannot ride two lanes."""
        if tag is not None and tag in self._specs:
            return tag
        for b in buckets:
            t = self.tenant_of(b)
            if t != DEFAULT_TENANT:
                return t
        return DEFAULT_TENANT

    def status(self) -> dict:
        return {n: self._specs[n].as_dict() for n in self._names}


class TenantLanes:
    """Per-tenant bounded FIFO lanes with deficit-round-robin dequeue —
    the drop-in replacement for the serving pipeline's shared
    ``queue.Queue`` bounds (batch gate, locked plane).

    **Admission** (``put_nowait``): each lane is bounded by the
    tenant's ``max_backlog`` (default: a weight-proportional slice of
    the shared ``maxsize`` budget, so lanes partition the old global
    cap); a full lane refuses typed :class:`TenantBusyError` with a
    per-lane pressure-scaled hint, while the sum-of-lanes backstop
    refuses plain :class:`BusyError`.  With only the default lane the
    slice IS the whole budget — identical to the old shared queue.

    **Dequeue** (``get``/``get_nowait``): unit-cost deficit round
    robin — each visit tops a backlogged lane's deficit up by its
    weight and serves while credit lasts, so contended throughput
    shares converge to the weight ratio; an emptied lane's deficit
    resets (no idle credit hoarding) and empty lanes are skipped
    entirely (work conservation).

    Control items (shutdown sentinels) ride a separate tiny deque,
    bypass lane bounds, and are served first — a saturated lane must
    never wedge ``close()``."""

    def __init__(self, registry: TenantRegistry, maxsize: int,
                 name: str = "queue"):
        self.registry = registry
        self.maxsize = int(maxsize)
        self.name = name
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        total_w = registry.total_weight()
        #: per-tenant bounded FIFO lanes, one per registered name
        # bounded-by: each deque capped at its lane_caps entry below
        self._lanes: Dict[str, deque] = {
            n: deque() for n in registry.names}
        self.lane_caps: Dict[str, int] = {}
        for n in registry.names:
            cap = registry.max_backlog(n)
            if cap is None:
                cap = max(1, (self.maxsize * registry.weight(n)) // total_w)
            self.lane_caps[n] = cap
        #: DRR credit per lane (reset when the lane drains)
        self._deficit: Dict[str, int] = {n: 0 for n in registry.names}
        self._order: Tuple[str, ...] = registry.names
        self._rr = 0
        self._total = 0
        #: typed sheds per lane since boot (node-status observability)
        self.shed_counts: Dict[str, int] = {n: 0 for n in registry.names}
        #: per-lane refusal streaks since last successful enqueue —
        #: feeds the same pressure-scaled hint as the admission gate
        self._streaks: Dict[str, int] = {n: 0 for n in registry.names}
        #: shutdown sentinels only
        # bounded-by: only close() enqueues here (one sentinel per stop)
        self._control: deque = deque()

    # ------------------------------------------------------------------
    # producer side
    # ------------------------------------------------------------------
    def put_nowait(self, item, tenant: Optional[str] = None) -> None:
        with self._not_empty:
            if tenant is None:
                # control plane: shutdown sentinels bypass lane bounds
                self._control.append(item)
                self._not_empty.notify()
                return
            lane = self._lanes.get(tenant)
            if lane is None:
                tenant = DEFAULT_TENANT
                lane = self._lanes[tenant]
            if len(lane) >= self.lane_caps[tenant]:
                self.shed_counts[tenant] += 1
                self._streaks[tenant] += 1
                if not self.registry.multi:
                    # untenanted: the single default lane IS the shared
                    # bound, so quota pressure is global pressure — keep
                    # the plain queue.Full contract (the server maps it
                    # to the classic global-busy reply, byte-identical
                    # to the pre-tenancy shared queue.Queue).  A
                    # tenant_busy here would tell clients a sibling
                    # lane has headroom when no sibling exists.
                    raise queue.Full
                raise TenantBusyError(
                    f"tenant {tenant} lane full at {self.name} "
                    f"({self.lane_caps[tenant]} requests parked)",
                    tenant=tenant,
                    retry_after_ms=retry_hint_ms(self._streaks[tenant]),
                )
            if self._total >= self.maxsize:
                # sum-of-lanes backstop (reachable only when operator
                # max_backlog overrides oversubscribe the shared budget)
                self.shed_counts[tenant] += 1
                self._streaks[tenant] += 1
                raise BusyError(
                    f"{self.name} full ({self.maxsize} requests parked)",
                    retry_after_ms=retry_hint_ms(self._streaks[tenant]),
                )
            lane.append(item)
            self._streaks[tenant] = 0
            self._total += 1
            self._not_empty.notify()

    def put(self, item, tenant: Optional[str] = None) -> None:
        """Blocking-queue-compatible alias; control items never block
        and work items refuse typed rather than park the producer."""
        self.put_nowait(item, tenant)

    # ------------------------------------------------------------------
    # consumer side (DRR)
    # ------------------------------------------------------------------
    def get(self, timeout: Optional[float] = None):
        with self._not_empty:
            if timeout is None:
                while self._total == 0 and not self._control:
                    self._not_empty.wait()
            else:
                end = time.monotonic() + timeout
                while self._total == 0 and not self._control:
                    left = end - time.monotonic()
                    if left <= 0:
                        raise queue.Empty
                    self._not_empty.wait(left)
            return self._pop_locked()

    def get_nowait(self):
        with self._lock:
            if self._total == 0 and not self._control:
                raise queue.Empty
            return self._pop_locked()

    def _pop_locked(self):
        if self._control:
            return self._control.popleft()
        n = len(self._order)
        # termination: some lane is non-empty (total > 0); visiting it
        # tops its deficit up to >= 1, so it serves within two visits
        for _ in range(2 * n + 1):
            name = self._order[self._rr]
            lane = self._lanes[name]
            if not lane:
                # drained lane: forfeit leftover credit (work
                # conservation — idle tenants must not hoard deficit
                # and then burst past their weight share)
                self._deficit[name] = 0
                self._rr = (self._rr + 1) % n
                continue
            if self._deficit[name] <= 0:
                self._deficit[name] += self.registry.weight(name)
            if self._deficit[name] > 0:
                self._deficit[name] -= 1
                self._total -= 1
                if self._deficit[name] <= 0:
                    # quantum spent: yield the pointer so the next
                    # backlogged lane serves before this one tops up
                    # again — without this, a top-up always leaves
                    # credit and the pointed-at lane monopolizes
                    self._rr = (self._rr + 1) % n
                return lane.popleft()
            self._rr = (self._rr + 1) % n
        raise queue.Empty  # unreachable; defensive against count drift

    # ------------------------------------------------------------------
    # introspection (queue.Queue-compatible where the server cares)
    # ------------------------------------------------------------------
    def qsize(self) -> int:
        with self._lock:
            return self._total

    def empty(self) -> bool:
        return self.qsize() == 0

    def depths(self) -> Dict[str, int]:
        with self._lock:
            return {n: len(self._lanes[n]) for n in self._order}

    def status(self) -> dict:
        with self._lock:
            return {
                n: {
                    "depth": len(self._lanes[n]),
                    "cap": self.lane_caps[n],
                    "shed_total": self.shed_counts[n],
                }
                for n in self._order
            }


def batch_rounds(items: List, tenant_of, registry: TenantRegistry,
                 ) -> List[List]:
    """Split one merged batch into weight-proportional rounds so no
    tenant monopolizes a single pass through a critical section (the
    group-commit certification/WAL/scatter path in txn/manager.py).

    Each round admits at most ``max(1, (B * w_t) // W)`` of tenant
    *t*'s members, where *B* is the batch size and *W* the summed
    weight of tenants **still holding work** — recomputed per round, so
    the split is work-conserving: a lone tenant gets the whole batch in
    one round (today's behavior, zero extra lock cycles), and capacity
    freed by finished tenants flows to the still-backlogged ones.
    Relative order within a tenant is preserved; items carry no
    ordering guarantee across tenants (they were concurrent)."""
    remaining: Dict[str, deque] = {}
    order: List[str] = []
    for it in items:
        t = tenant_of(it)
        if t not in remaining:
            remaining[t] = deque()
            order.append(t)
        remaining[t].append(it)
    if len(remaining) <= 1:
        return [items] if items else []
    total = len(items)
    rounds: List[List] = []
    while remaining:
        w_sum = registry.total_weight(order)
        batch: List = []
        for t in list(order):
            lane = remaining[t]
            quota = max(1, (total * registry.weight(t)) // w_sum)
            for _ in range(min(quota, len(lane))):
                batch.append(lane.popleft())
            if not lane:
                del remaining[t]
                order.remove(t)
        rounds.append(batch)
    return rounds


__all__ = ["DEFAULT_TENANT", "TenantSpec", "TenantRegistry",
           "TenantLanes", "parse_tenant_spec", "batch_rounds"]
