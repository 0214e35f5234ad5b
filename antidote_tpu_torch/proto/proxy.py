"""Server-side proxy / forwarding plane: any follower is a safe entrypoint.

* **Read proxying** — a follower receiving a session read outside its ring
  arcs relays it to the arc owner over a pooled internal channel (one hop
  at most: the proxied request carries a ``proxied`` no-reproxy flag, and
  a node serving a proxied frame answers locally or refuses typed — it
  never proxies again).
* **Write forwarding** — a follower receiving a write or transaction op
  forwards it to the owner's write plane under the at-most-once
  ``request_sent`` discipline: send-phase transport failures redial within
  a bounded budget, reply-phase failures surface the typed
  :class:`~antidote_tpu_torch.overload.ForwardFailed` ("may have
  executed"), never a blind resend of a non-idempotent commit.  Forwarded
  work re-enters the owner's admission gate and re-checks its (shrunken)
  deadline there, so a proxy hop never amplifies overload.
* **Fleet health** — :class:`FleetHealth` merges the owner's liveness
  registry (piggybacked on every ``follower_report`` reply) with this
  node's own connect/timeout observations under a bounded cooldown; when a
  proxy target dies mid-request the forwarding node fails over to a live
  shadow of the arc itself, so a bare client pointed at one follower gets
  the read-your-writes failover the session client implements.

The plane proxies at the semantic level (objects, updates, clock), always
over native-dialect pooled channels — an apb edge request is decoded once,
forwarded native and re-encoded — so both dialects share one failover
loop and one fault site (``proxy.forward``).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from antidote_tpu_torch import faults as _faults
from antidote_tpu_torch.overload import (
    BusyError,
    TenantBusyError,
    ColdMiss,
    DeadlineExceeded,
    ForwardFailed,
    InsufficientRightsError,
    NotOwnerError,
    ReadOnlyError,
    ReplicaLagging,
    check_deadline,
)
from antidote_tpu_torch.proto.client import (
    AntidoteClient,
    HashRing,
    RemoteAbort,
    RemoteBusy,
    RemoteColdMiss,
    RemoteDeadline,
    RemoteError,
    RemoteInsufficientRights,
    RemoteLagging,
    RemoteNotOwner,
    RemoteReadOnly,
    RemoteTenantBusy,
)

Addr = Tuple[str, int]


class ProxyExhausted(Exception):
    """Internal: every candidate hop of a proxied READ failed (dead,
    refused, or fault-injected).  The serving path catches this and
    falls back to a terminal LOCAL attempt — whose typed gate error is
    the honest last resort the client sees.  Never crosses the wire."""

    def __init__(self, last: Optional[BaseException]):
        super().__init__(str(last) if last is not None else "no candidates")
        self.last = last


def _rethrow(e: BaseException) -> None:
    """Map a pooled channel's client-side ``Remote*`` error back to the
    server-side typed exception vocabulary, so the edge reply encodes
    exactly what the owner answered (both dialects' error mappers key
    on these types)."""
    from antidote_tpu_torch.txn.manager import AbortError

    if isinstance(e, RemoteTenantBusy):
        # preserve the tenant attribution across the hop: the edge
        # reply must still say WHICH lane refused, not "node busy"
        raise TenantBusyError(str(e), tenant=e.tenant,
                              retry_after_ms=e.retry_after_ms) from e
    if isinstance(e, RemoteBusy):
        raise BusyError(str(e), e.retry_after_ms) from e
    if isinstance(e, RemoteDeadline):
        raise DeadlineExceeded(str(e)) from e
    if isinstance(e, RemoteAbort):
        raise AbortError(str(e)) from e
    if isinstance(e, RemoteReadOnly):
        raise ReadOnlyError(str(e)) from e
    if isinstance(e, RemoteColdMiss):
        raise ColdMiss(str(e), e.retry_after_ms, permanent=e.permanent) from e
    if isinstance(e, RemoteLagging):
        raise ReplicaLagging(str(e), e.retry_after_ms,
                             redirect=e.redirect) from e
    if isinstance(e, RemoteNotOwner):
        raise NotOwnerError(e.redirect) from e
    if isinstance(e, RemoteInsufficientRights):
        raise InsufficientRightsError(str(e), e.retry_after_ms) from e
    raise RuntimeError(str(e)) from e


class FleetHealth:
    """A node's live view of the serving fleet: the owner registry's
    typed states (learned from ``follower_report`` replies) merged with
    LOCAL connect/timeout observations under a bounded cooldown — the
    server-side twin of SessionClient's ``_dead`` map.  Placement rides
    the same unseeded :class:`HashRing` every client uses (fleet-wide
    agreement on arc owners); the failover tail is seeded per NODE so
    a dead endpoint's arcs spread over the survivors instead of every
    proxying node stampeding the same shadow."""

    #: a locally-observed-dead endpoint is skipped for this long before
    #: its arcs are retried (the registry may still say "ok" for up to
    #: REPLICA_DOWN_S — local observations win in the meantime)
    DEAD_S = 2.0

    def __init__(self, vnodes: int = 64, seed: Optional[int] = None,
                 metrics=None):
        if seed is None:
            seed = int.from_bytes(os.urandom(8), "big")
        self.vnodes = int(vnodes)
        self.seed = int(seed)
        self.metrics = metrics
        self._lock = threading.Lock()
        #: addr -> monotonic time until which it is locally dead
        self._dead: Dict[Addr, float] = {}
        #: addr -> registry state (ok | lagging | down | bootstrapping…)
        self._states: Dict[Addr, str] = {}
        self.ring = HashRing((), vnodes=self.vnodes, seed=self.seed)

    # -- registry feed --------------------------------------------------
    def update_fleet(self, followers: Dict[str, dict]) -> None:
        """Absorb one registry snapshot (``name -> {addr, state}``).
        The ring is rebuilt only when the serving membership actually
        changed — snapshots arrive once per report interval."""
        eps: List[Addr] = []
        states: Dict[Addr, str] = {}
        for _name, ent in sorted((followers or {}).items()):
            addr = ent.get("addr")
            if not addr:
                continue
            ep = (addr[0], int(addr[1]))
            states[ep] = str(ent.get("state", "ok"))
            if states[ep] != "down":
                eps.append(ep)
        with self._lock:
            self._states = states
            if eps != self.ring.endpoints:
                self.ring = HashRing(eps, vnodes=self.vnodes,
                                     seed=self.seed)
        if self.metrics is not None:
            for ep, st in states.items():
                self.metrics.fleet_health.set(
                    0 if (st == "down" or not self.alive(ep)) else 1,
                    endpoint=f"{ep[0]}:{ep[1]}")

    # -- local observations ---------------------------------------------
    def mark_dead(self, ep: Addr) -> None:
        with self._lock:
            self._dead[ep] = time.monotonic() + self.DEAD_S
        if self.metrics is not None:
            self.metrics.fleet_health.set(0, endpoint=f"{ep[0]}:{ep[1]}")

    def mark_ok(self, ep: Addr) -> None:
        with self._lock:
            was_dead = self._dead.pop(ep, None) is not None
        if was_dead and self.metrics is not None:
            self.metrics.fleet_health.set(1, endpoint=f"{ep[0]}:{ep[1]}")

    def alive(self, ep: Addr) -> bool:
        with self._lock:
            until = self._dead.get(ep)
            if until is not None:
                if until > time.monotonic():
                    return False
                del self._dead[ep]  # cooldown over: arcs come back
            return self._states.get(ep, "ok") != "down"

    # -- routing --------------------------------------------------------
    def preferred(self, key, bucket) -> Optional[Addr]:
        with self._lock:
            ring = self.ring
        return ring.preferred(key, bucket)

    def candidates(self, key, bucket) -> List[Addr]:
        """Alive-filtered failover order for one key's arc: preferred
        first (fleet-wide agreement), then this node's seeded-jitter
        survivor order."""
        with self._lock:
            ring = self.ring
        return [ep for ep in ring.order(key, bucket) if self.alive(ep)]

    def snapshot(self) -> dict:
        with self._lock:
            now = time.monotonic()
            return {
                "endpoints": [f"{h}:{p}" for h, p in self.ring.endpoints],
                "states": {f"{h}:{p}": s
                           for (h, p), s in sorted(self._states.items())},
                "locally_dead": [f"{h}:{p}"
                                 for (h, p), t in sorted(self._dead.items())
                                 if t > now],
            }


class ProxyPlane:
    """Pooled, deadline-bounded internal channels from one serving node
    to the rest of the fleet, plus the forwarding state machines on top
    of them.  One instance per follower :class:`ProtocolServer`."""

    #: idle channels kept per target (each borrow past this dials)
    POOL_PER_TARGET = 4
    #: dial/IO timeout of an internal channel (the per-request deadline
    #: still shrinks the forwarded budget below this)
    DIAL_TIMEOUT_S = 5.0
    #: send-phase redials of a forwarded write before the typed refusal
    FORWARD_ATTEMPTS = 2

    def __init__(self, follower, metrics, vnodes: int = 64,
                 seed: Optional[int] = None):
        self.follower = follower
        self.metrics = metrics
        self.health = FleetHealth(vnodes=vnodes, seed=seed,
                                  metrics=metrics)
        self._pool_lock = threading.Lock()
        #: bounded-by: POOL_PER_TARGET idle channels per target addr
        self._pools: Dict[Addr, List[AntidoteClient]] = {}
        #: sticky owner channel for interactive txns: the owner's txn
        #: registry is global across connections, and the owner's own
        #: conn-drop discipline aborts whatever a dead channel orphans
        self._txn_lock = threading.Lock()
        self._txn_chan: Optional[AntidoteClient] = None
        #: txids forwarded through the sticky channel and not yet
        #: finished — an edge client dying mid-txn aborts these at the
        #: owner (the follower-side twin of _abort_orphan)
        self.forwarded_txns: set = set()
        self._fleet_v = object()  # always != first observed version
        self._closed = False
        #: forwarded-traffic counters for node_status / the bench gate
        self._stats_lock = threading.Lock()
        self.counts: Dict[str, int] = {
            "read": 0, "write": 0, "txn": 0, "failover": 0}

    # -- fleet plumbing -------------------------------------------------
    def _refresh(self) -> None:
        fol = self.follower
        v = getattr(fol, "fleet_table_v", 0)
        if v != self._fleet_v:
            self._fleet_v = v
            self.health.update_fleet(getattr(fol, "fleet_table", None)
                                     or {})

    def _self_addr(self) -> Optional[Addr]:
        addr = getattr(self.follower, "client_addr", None)
        return (addr[0], int(addr[1])) if addr else None

    def _owner_addr(self) -> Optional[Addr]:
        addr = getattr(self.follower, "owner_client_addr", None)
        return (addr[0], int(addr[1])) if addr else None

    def route(self, objects) -> Optional[Addr]:
        """The arc owner a read should serve from, or None when this
        node should serve it locally (in-arc, unknown fleet, or no
        self-identity yet).  The first object's key owns the routing —
        a multi-object session read is one snapshot unit."""
        self._refresh()
        me = self._self_addr()
        if me is None or not objects:
            return None
        key, _t, bucket = objects[0]
        pref = self.health.preferred(key, bucket)
        if pref is None or pref == me or not self.health.alive(pref):
            return None
        return pref

    def ring_hint(self) -> Optional[dict]:
        """The fleet+arcs hint attached to proxied replies and typed
        follower errors: capable clients rebuild their ring from it in
        place and converge back to zero-hop."""
        self._refresh()
        owner = self._owner_addr()
        eps = self.health.ring.endpoints
        if owner is None and not eps:
            return None
        return {
            "owner": list(owner) if owner else None,
            "followers": [[h, p] for h, p in eps],
            "vnodes": self.health.vnodes,
        }

    # -- channel pool ---------------------------------------------------
    def _borrow(self, ep: Addr) -> AntidoteClient:
        with self._pool_lock:
            lst = self._pools.get(ep)
            if lst:
                return lst.pop()
        return AntidoteClient(ep[0], ep[1], timeout=self.DIAL_TIMEOUT_S)

    def _return(self, ep: Addr, c: AntidoteClient) -> None:
        with self._pool_lock:
            if not self._closed:
                lst = self._pools.setdefault(ep, [])
                if len(lst) < self.POOL_PER_TARGET:
                    lst.append(c)
                    return
        c.close()

    @staticmethod
    def _scrap(c: AntidoteClient) -> None:
        try:
            c.close()
        except OSError:
            pass

    @staticmethod
    def _remaining_ms(deadline: Optional[float]) -> Optional[float]:
        """The deadline budget LEFT for the inner hop — the forwarded
        request re-checks it at the target, so queue time spent here is
        never granted back (deadline propagation, not reset)."""
        if deadline is None:
            return None
        return max(1.0, (deadline - time.monotonic()) * 1e3)

    def _count(self, kind: str, failed_hops: int = 0) -> None:
        with self._stats_lock:
            self.counts[kind] += 1
            if failed_hops:
                self.counts["failover"] += 1

    def _fault(self, ep: Addr) -> Optional[str]:
        """Consult the ``proxy.forward`` chaos site for one hop.  Keyed
        by the target ``"host:port"``: drop = hop is dead, error =
        send-phase transport failure, delay = slow link."""
        d = _faults.hit("proxy.forward", key=f"{ep[0]}:{ep[1]}")
        if d is None:
            return None
        if d.action == "delay":
            time.sleep(float(d.arg or 0.01))
            return None
        return d.action

    # -- read proxying --------------------------------------------------
    def proxy_read(self, objects, clock, deadline: Optional[float],
                   first: Optional[Addr] = None,
                   tenant: Optional[str] = None):
        """Relay a read to the arc owner, failing over server-side
        through the arc's live shadows and the owner.  Returns
        ``(values, commit_clock)`` exactly as the target answered;
        raises :class:`ProxyExhausted` when every hop failed (the
        caller's terminal local attempt owns the last-resort typed
        error) — deterministic refusals (deadline, abort, cold-miss)
        re-raise immediately instead of burning hops."""
        self._refresh()
        check_deadline(deadline, "proxy read")
        me = self._self_addr()
        cands: List[Addr] = []
        if first is not None:
            cands.append(first)
        if objects:
            key, _t, bucket = objects[0]
            for ep in self.health.candidates(key, bucket):
                if ep != me and ep not in cands:
                    cands.append(ep)
        owner = self._owner_addr()
        if owner is not None and owner != me and owner not in cands:
            cands.append(owner)
        last: Optional[BaseException] = None
        failed = 0
        for ep in cands:
            check_deadline(deadline, "proxy read hop")
            act = self._fault(ep)
            if act is not None:
                self.health.mark_dead(ep)
                last = ConnectionError(f"proxy.forward fault: {act}")
                failed += 1
                continue
            try:
                c = self._borrow(ep)
            except (ConnectionError, OSError) as e:
                self.health.mark_dead(ep)
                last, failed = e, failed + 1
                continue
            t0 = time.monotonic()
            try:
                vals, vc = c.read_objects(
                    objects, clock=clock,
                    deadline_ms=self._remaining_ms(deadline),
                    proxied=True, tenant=tenant)
            except (RemoteLagging, RemoteNotOwner, RemoteBusy) as e:
                # the hop is up but refused (behind the token / ring
                # disagreement / shedding): try the next shadow — its
                # no-reproxy discipline kept the refusal one hop deep
                self._return(ep, c)
                last, failed = e, failed + 1
                continue
            except (RemoteDeadline, RemoteColdMiss, RemoteAbort,
                    RemoteReadOnly) as e:
                self._return(ep, c)
                _rethrow(e)
            except RemoteError as e:
                self._return(ep, c)
                _rethrow(e)
            except (ConnectionError, OSError) as e:
                self._scrap(c)
                self.health.mark_dead(ep)
                last, failed = e, failed + 1
                continue
            self._return(ep, c)
            self.health.mark_ok(ep)
            self.metrics.proxy_hop_seconds.observe(time.monotonic() - t0)
            self.metrics.proxy_total.inc(
                kind="read", outcome="failover" if failed else "ok")
            self._count("read", failed)
            return vals, vc
        self.metrics.proxy_total.inc(kind="read", outcome="error")
        raise ProxyExhausted(last)

    # -- write forwarding -----------------------------------------------
    def forward_update(self, updates, clock, deadline: Optional[float],
                       tenant: Optional[str] = None):
        """Forward a static write to the owner write plane, at most
        once: dial/send-phase failures redial within the bounded
        budget; a reply-phase failure surfaces the typed
        :class:`ForwardFailed` — the owner may have committed.  Send
        exhaustion surfaces the classic typed ``not_owner`` redirect,
        so a ring-aware client still learns where the owner lives."""
        check_deadline(deadline, "forward write")
        owner = self._owner_addr()
        if owner is None:
            raise NotOwnerError(None)
        last: Optional[BaseException] = None
        for attempt in range(self.FORWARD_ATTEMPTS):
            check_deadline(deadline, "forward write attempt")
            act = self._fault(owner)
            if act is not None:
                # injected hop death BEFORE the send phase: safe redial
                last = ConnectionError(f"proxy.forward fault: {act}")
                continue
            try:
                c = self._borrow(owner)
            except (ConnectionError, OSError) as e:
                last = e  # dial failure: the request never left
                continue
            t0 = time.monotonic()
            try:
                vc = c.update_objects(
                    updates, clock=clock,
                    deadline_ms=self._remaining_ms(deadline),
                    proxied=True, tenant=tenant)
            except (ConnectionError, OSError) as e:
                self._scrap(c)
                if getattr(e, "request_sent", True):
                    self.metrics.proxy_total.inc(kind="write",
                                                 outcome="error")
                    raise ForwardFailed(
                        "forwarded write: the owner connection died "
                        "awaiting the reply — the owner may have "
                        "executed it; not resending (re-read at your "
                        "session token to find out)") from e
                last = e
                continue
            except RemoteError as e:
                # a typed refusal at the owner (busy/deadline/abort/
                # read_only…) passes through verbatim — the proxy adds
                # no retry of its own, so it cannot amplify overload
                self._return(owner, c)
                self.metrics.proxy_total.inc(kind="write",
                                             outcome="refused")
                self._count("write")
                _rethrow(e)
            self._return(owner, c)
            self.metrics.proxy_hop_seconds.observe(time.monotonic() - t0)
            self.metrics.proxy_total.inc(
                kind="write", outcome="failover" if attempt else "ok")
            self._count("write", attempt)
            return vc
        self.metrics.proxy_total.inc(kind="write", outcome="error")
        raise NotOwnerError(owner) if last is None else \
            self._owner_unreachable(owner, last)

    @staticmethod
    def _owner_unreachable(owner: Addr, last: BaseException):
        err = NotOwnerError(owner)
        err.__cause__ = last
        return err

    # -- interactive txn forwarding -------------------------------------
    def txn_call(self, code, body):
        """Forward one interactive-txn op over the sticky owner
        channel and return the decoded reply body.  START redials once
        on a send-phase failure (no txn state exists yet); any later
        op whose channel dies surfaces :class:`ForwardFailed` — the
        owner aborts whatever the dead channel orphaned."""
        from antidote_tpu_torch.proto.codec import MessageCode

        owner = self._owner_addr()
        if owner is None:
            raise NotOwnerError(None)
        with self._txn_lock:
            redialed = False
            while True:
                c = self._txn_chan
                if c is None:
                    try:
                        c = AntidoteClient(owner[0], owner[1],
                                           timeout=self.DIAL_TIMEOUT_S)
                    except (ConnectionError, OSError) as e:
                        self.metrics.proxy_total.inc(kind="txn",
                                                     outcome="error")
                        raise self._owner_unreachable(owner, e)
                    self._txn_chan = c
                t0 = time.monotonic()
                try:
                    resp = c._call(code, body)
                except RemoteError as e:
                    self.metrics.proxy_total.inc(kind="txn",
                                                 outcome="refused")
                    self._count("txn")
                    _rethrow(e)
                except (ConnectionError, OSError) as e:
                    self._txn_chan = None
                    self._scrap(c)
                    safe_redial = (not getattr(e, "request_sent", True)
                                   and code == MessageCode.START_TRANSACTION
                                   and not redialed)
                    if not safe_redial:
                        self.metrics.proxy_total.inc(kind="txn",
                                                     outcome="error")
                        raise ForwardFailed(
                            "forwarded transaction op: the owner "
                            "channel died — the op may have executed "
                            "and the owner aborts orphans of a dead "
                            "channel; restart the transaction") from e
                    redialed = True
                    continue
                self.metrics.proxy_hop_seconds.observe(
                    time.monotonic() - t0)
                self.metrics.proxy_total.inc(kind="txn", outcome="ok")
                self._count("txn")
                return resp

    def abort_forwarded(self, txid) -> None:
        """Best-effort abort of a forwarded txn whose EDGE client died
        (the follower-side twin of the owner's conn-drop rollback)."""
        from antidote_tpu_torch.proto.codec import MessageCode

        self.forwarded_txns.discard(txid)
        try:
            self.txn_call(MessageCode.ABORT_TRANSACTION, {"txid": txid})
        except Exception:
            pass  # the owner's own orphan discipline is the backstop

    # -- observability / lifecycle --------------------------------------
    def stats(self) -> dict:
        self._refresh()  # status must show the CURRENT learned fleet
        with self._stats_lock:
            counts = dict(self.counts)
        return {"forwarded": counts, "fleet": self.health.snapshot()}

    def close(self) -> None:
        with self._pool_lock:
            self._closed = True
            pools, self._pools = self._pools, {}
        for lst in pools.values():
            for c in lst:
                self._scrap(c)
        with self._txn_lock:
            c, self._txn_chan = self._txn_chan, None
        if c is not None:
            self._scrap(c)
