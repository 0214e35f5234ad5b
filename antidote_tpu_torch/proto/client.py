"""Python clients for the wire protocol — the antidotec_pb analogue.

One socket, request/response in lockstep (the reference client multiplexes
the same way: each request waits for its reply before the next).
:class:`AntidoteClient` speaks the msgpack dialect, :class:`ApbClient` the
``antidote_pb`` protobuf one; both raise the same typed ``Remote*`` errors,
and both talk to a server of either package.  :class:`SessionClient`
carries a causal session over an owner and its follower fleet, routing
reads over the fleet's consistent-hash ring (:class:`HashRing`).
"""

from __future__ import annotations

import bisect
import hashlib
import os
import socket
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import msgpack

from antidote_tpu_torch.proto import apb
from antidote_tpu_torch.proto.codec import (
    MessageCode,
    decode,
    decode_value,
    encode_with,
    merge_clock,
    read_frame_buffered,
)


class RemoteAbort(Exception):
    """Server aborted the transaction."""


class RemoteError(Exception):
    """Server-side error reply."""


class RemoteBusy(RemoteError):
    """Server shed the request (overload admission / bounded queue).
    ``retry_after_ms`` is the server's backoff hint."""

    def __init__(self, msg: str, retry_after_ms: int = 50):
        super().__init__(msg)
        self.retry_after_ms = int(retry_after_ms)


class RemoteTenantBusy(RemoteBusy):
    """The request was refused by its TENANT's quota (weighted-fair
    lane full or per-tenant in-flight cap) while the node as a whole
    had headroom — retrying against a sibling node won't help until
    this tenant's own backlog drains.  ``tenant`` names the lane;
    subclasses :class:`RemoteBusy` so generic backoff loops keep
    working, while fairness-aware callers can tell quota pressure
    apart from global overload."""

    def __init__(self, msg: str, retry_after_ms: int = 50, tenant: str = ""):
        super().__init__(msg, retry_after_ms=retry_after_ms)
        self.tenant = str(tenant)


class RemoteDeadline(RemoteError):
    """The request outlived its deadline server-side; it was aborted at
    dequeue — never executed."""


class RemoteReadOnly(RemoteError):
    """The node is in degraded read-only mode (WAL appends failing);
    writes are rejected, reads keep serving."""


class RemoteNotOwner(RemoteError):
    """The node is a follower read replica; writes and interactive
    transactions must go to the owner.  ``redirect`` is the owner's
    ``[host, port]`` when the follower knows it."""

    def __init__(self, msg: str, redirect=None):
        super().__init__(msg)
        self.redirect = redirect


class RemoteLagging(RemoteError):
    """A follower's applied clock was still behind the session token
    after its park window (or it is mid-bootstrap/heal): the read was
    NOT served.  Retry after ``retry_after_ms`` or fail over —
    ``redirect`` names the owner."""

    def __init__(self, msg: str, retry_after_ms: int = 50, redirect=None):
        super().__init__(msg)
        self.retry_after_ms = int(retry_after_ms)
        self.redirect = redirect


class RemoteForwardFailed(RemoteError):
    """A follower forwarding this write/txn op to the owner
    lost the owner connection AFTER the request left its socket: the
    owner **may have executed** it, and the at-most-once contract
    forbids a blind resend.  Re-read at the session token to learn the
    outcome (or retry only if the op is idempotent)."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.maybe_executed = True


class RemoteInsufficientRights(RemoteError):
    """A bounded-counter (``counter_b``) decrement/transfer exceeded the
    serving DC's locally-held escrow rights — the op was NOT executed
    (zero oversell).  ``retry_after_ms`` is scaled by the expected grant
    arrival: the server's background rights-transfer loop has been told
    about the shortfall, so waiting out the hint usually finds rights
    rebalanced here."""

    def __init__(self, msg: str, retry_after_ms: int = 100):
        super().__init__(msg)
        self.retry_after_ms = int(retry_after_ms)


class RemoteColdMiss(RemoteError):
    """A cold-tier key's fault-in was refused (rate cap, I/O fault, or
    sidecar CRC failure): the read/write was NOT served — retry after
    ``retry_after_ms``.  ``permanent=True`` means the key's backing row
    is verifiably lost on every retained image (operator repair:
    re-bootstrap the store from a peer/follower)."""

    def __init__(self, msg: str, retry_after_ms: int = 50,
                 permanent: bool = False):
        super().__init__(msg)
        self.retry_after_ms = int(retry_after_ms)
        self.permanent = bool(permanent)


class ClientTxn:
    def __init__(self, client: "AntidoteClient", txid: int):
        self._client = client
        self.txid = txid

    def read_objects(self, objects: Sequence[Tuple[Any, str, str]]) -> List[Any]:
        body = self._client._call(MessageCode.READ_OBJECTS, {
            "txid": self.txid, "objects": list(objects),
        })
        return [decode_value(v) for v in body["values"]]

    def update_objects(self, updates: Sequence[Tuple]) -> None:
        self._client._call(MessageCode.UPDATE_OBJECTS, {
            "txid": self.txid, "updates": list(updates),
        })

    def commit(self) -> List[int]:
        body = self._client._call(MessageCode.COMMIT_TRANSACTION,
                                  {"txid": self.txid})
        return body["commit_clock"]

    def abort(self) -> None:
        self._client._call(MessageCode.ABORT_TRANSACTION, {"txid": self.txid})


class AntidoteClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 8087,
                 timeout: float = 30.0, tenant: Optional[str] = None):
        #: connection-level tenant tag: attached to every
        #: static read/update body so the server's weighted-fair lanes
        #: classify this connection even when its buckets are untagged.
        #: A registered ``tenant/bucket`` prefix still wins server-side.
        self.tenant = tenant
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        # hot-path plumbing: a buffered reader coalesces the header+body
        # reads into ~one syscall per reply, and one persistent Packer
        # skips per-call packer construction — this client is the load
        # generator of the wire benchmarks, where its CPU bills against
        # the server
        self._rfile = self._sock.makefile("rb")
        self._packer = msgpack.Packer(use_bin_type=True)
        #: the last ring hint a follower attached to a reply: ``{owner,
        #: followers, vnodes}`` — consumed (and cleared) by SessionClient
        #: to refresh its fleet in place
        self.ring_hint: Optional[dict] = None

    # ------------------------------------------------------------------
    def _call(self, code: MessageCode, body: Any):
        with self._lock:
            # tag transport failures with whether the request LEFT the
            # socket: a send-phase failure is always safe to retry, a
            # reply-phase one means the server may have executed it
            # (the at-most-once discipline)
            try:
                self._sock.sendall(encode_with(self._packer, code, body))
            except (ConnectionError, OSError) as e:
                e.request_sent = False
                raise
            try:
                resp_code, resp = decode(read_frame_buffered(self._rfile))
            except (ConnectionError, OSError) as e:
                e.request_sent = True
                raise
        if isinstance(resp, dict) and resp.get("ring_hint") is not None:
            self.ring_hint = resp["ring_hint"]
        if resp_code == MessageCode.ERROR_RESP:
            err = resp.get("error")
            if err == "aborted":
                raise RemoteAbort(resp.get("detail", ""))
            if err == "tenant_busy":
                raise RemoteTenantBusy(resp.get("detail", ""),
                                       int(resp.get("retry_after_ms", 50)),
                                       tenant=resp.get("tenant") or "")
            if err == "busy":
                raise RemoteBusy(resp.get("detail", ""),
                                 int(resp.get("retry_after_ms", 50)))
            if err == "deadline":
                raise RemoteDeadline(resp.get("detail", ""))
            if err == "read_only":
                raise RemoteReadOnly(resp.get("detail", ""))
            if err == "not_owner":
                raise RemoteNotOwner(resp.get("detail", ""),
                                     redirect=resp.get("redirect"))
            if err == "lagging":
                raise RemoteLagging(resp.get("detail", ""),
                                    int(resp.get("retry_after_ms", 50)),
                                    redirect=resp.get("redirect"))
            if err == "cold_miss":
                raise RemoteColdMiss(resp.get("detail", ""),
                                     int(resp.get("retry_after_ms", 50)),
                                     permanent=bool(
                                         resp.get("permanent")))
            if err == "forward_failed":
                raise RemoteForwardFailed(resp.get("detail", ""))
            if err == "insufficient_rights":
                raise RemoteInsufficientRights(
                    resp.get("detail", ""),
                    int(resp.get("retry_after_ms", 100)))
            raise RemoteError(f"{err}: {resp.get('detail')}")
        return resp

    # ------------------------------------------------------------------
    def start_transaction(self, clock: Optional[Sequence[int]] = None,
                          props: Optional[dict] = None) -> ClientTxn:
        body = self._call(MessageCode.START_TRANSACTION, {
            "clock": None if clock is None else [int(x) for x in clock],
            "props": props,
        })
        return ClientTxn(self, body["txid"])

    def update_objects(self, updates: Sequence[Tuple],
                       clock: Optional[Sequence[int]] = None,
                       deadline_ms: Optional[float] = None,
                       tenant: Optional[str] = None,
                       proxied: bool = False) -> List[int]:
        req = {
            "updates": list(updates),
            "clock": None if clock is None else [int(x) for x in clock],
        }
        if tenant is None:
            tenant = self.tenant
        if tenant:
            req["tenant"] = tenant
        if deadline_ms is not None:
            # relative budget; the server aborts the request at dequeue
            # once it has outlived this (RemoteDeadline reply)
            req["deadline_ms"] = float(deadline_ms)
        if proxied:
            # no-reforward flag: this request already crossed one
            # server-side hop — the receiver answers locally or refuses
            # typed, never forwards again
            req["proxied"] = True
        body = self._call(MessageCode.STATIC_UPDATE_OBJECTS, req)
        return body["commit_clock"]

    def read_objects(self, objects: Sequence[Tuple[Any, str, str]],
                     clock: Optional[Sequence[int]] = None,
                     deadline_ms: Optional[float] = None,
                     tenant: Optional[str] = None,
                     proxied: bool = False):
        req = {
            "objects": list(objects),
            "clock": None if clock is None else [int(x) for x in clock],
        }
        if tenant is None:
            tenant = self.tenant
        if tenant:
            req["tenant"] = tenant
        if deadline_ms is not None:
            req["deadline_ms"] = float(deadline_ms)
        if proxied:
            req["proxied"] = True  # no-reproxy flag: one hop max
        body = self._call(MessageCode.STATIC_READ_OBJECTS, req)
        return ([decode_value(v) for v in body["values"]],
                body["commit_clock"])

    def get_connection_descriptor(self) -> dict:
        return self._call(MessageCode.GET_CONNECTION_DESCRIPTOR,
                          {})["descriptor"]

    def connect_to_dcs(self, descriptors) -> None:
        """Subscribe this node's DC to remote DCs' txn streams
        (antidote_dc_manager:subscribe_updates_from)."""
        self._call(MessageCode.CONNECT_TO_DCS,
                   {"descriptors": list(descriptors)})

    def create_dc(self, nodes) -> None:
        self._call(MessageCode.CREATE_DC, {"nodes": list(nodes)})

    def node_status(self, include_ready: bool = False) -> dict:
        """Operator snapshot (console `status`; no reference pb
        equivalent — the reference exposes this via riak-admin/console).
        ``include_ready`` additionally runs the server-side readiness
        probe (heavier: device round trip + WAL barrier)."""
        return self._call(MessageCode.NODE_STATUS,
                          {"include_ready": include_ready})["status"]

    def checkpoint_now(self) -> dict:
        """Run one synchronous checkpoint cycle on the server (console
        `checkpoint-now`); returns the published manifest summary.
        Blocks for the image stream — admin use, not a data-path call."""
        return self._call(MessageCode.CHECKPOINT_NOW, {})["checkpoint"]

    def replica_admin(self, op: str = "status", name: Optional[str] = None,
                      addr=None) -> dict:
        """Follower registry op against an owner (console
        ``replica-add``/``replica-remove``/``replica-status``); ``status``
        also answers on a follower (its own view)."""
        body: dict = {"op": op}
        if name is not None:
            body["name"] = name
        if addr is not None:
            body["addr"] = list(addr)
        return self._call(MessageCode.REPLICA_ADMIN, body)["replicas"]

    def close(self) -> None:
        try:
            self._rfile.close()
        except OSError:
            pass
        self._sock.close()


def _h64(data: bytes) -> int:
    """Stable 64-bit hash for ring placement (never Python's salted
    ``hash``: every client must map a key to the same arc)."""
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "big")


class HashRing:
    """Consistent-hash ring over a follower fleet: keys map to a preferred
    follower through virtual nodes, so adding or removing a follower
    remaps only its own arcs (~1/N of the keyspace), and a fleet-wide
    client population agrees on the mapping with no coordination.

    The PLACEMENT hash is unseeded — every client routes a key to the same
    preferred replica (which is what makes the fleet's snapshot caches
    compose).  The FALLBACK order is seeded per client: when an arc's
    owner dies, each client walks a differently-jittered order over the
    survivors, so a death spreads across the fleet instead of stampeding
    every client onto the same next endpoint.  Arcs equal the JAX
    package's ring for the same fleet and seed."""

    def __init__(self, endpoints: Sequence[Tuple[str, int]],
                 vnodes: int = 64, seed: int = 0):
        self.vnodes = int(vnodes)
        self.seed = int(seed)
        self.endpoints: List[Tuple[str, int]] = [
            (h, int(p)) for h, p in endpoints]
        pts: List[Tuple[int, int]] = []
        for i, (host, port) in enumerate(self.endpoints):
            for v in range(self.vnodes):
                pts.append((_h64(f"{host}:{port}#{v}".encode()), i))
        pts.sort()
        self._points = pts
        self._hashes = [h for h, _ in pts]

    def __len__(self) -> int:
        return len(self.endpoints)

    def _key_hash(self, key, bucket) -> int:
        return _h64(msgpack.packb([key, bucket], use_bin_type=True,
                                  default=repr))

    def preferred(self, key, bucket) -> Optional[Tuple[str, int]]:
        """The key's arc owner (None on an empty ring)."""
        if not self._points:
            return None
        kh = self._key_hash(key, bucket)
        i = bisect.bisect_right(self._hashes, kh) % len(self._points)
        return self.endpoints[self._points[i][1]]

    def order(self, key, bucket) -> List[Tuple[str, int]]:
        """Failover order for a key: the arc owner first (fleet-wide
        agreement), then every other endpoint in this client's seeded-
        jitter order (fleet-wide disagreement, on purpose)."""
        pref = self.preferred(key, bucket)
        if pref is None:
            return []
        kh = self._key_hash(key, bucket)
        tail = [ep for ep in self.endpoints if ep != pref]
        tail.sort(key=lambda ep: _h64(
            struct.pack(">QQ", self.seed & ((1 << 64) - 1), kh)
            + f"{ep[0]}:{ep[1]}".encode()))
        return [pref] + tail

    def arc_share(self) -> Dict[Tuple[str, int], float]:
        """Fraction of the hash space each endpoint owns."""
        if not self._points:
            return {}
        span = float(1 << 64)
        out = {ep: 0.0 for ep in self.endpoints}
        prev = self._points[-1][0] - (1 << 64)
        for h, idx in self._points:
            out[self.endpoints[idx]] += (h - prev) / span
            prev = h
        return out

    def arc_share_by_name(self, digits: int = 4) -> Dict[str, float]:
        """:meth:`arc_share` keyed ``"host:port"`` and rounded (the form
        console ``replica-status`` and session stats show)."""
        return {f"{h}:{p}": round(v, digits)
                for (h, p), v in self.arc_share().items()}


class ApbClient:
    """Client speaking the antidote_pb protobuf dialect: static
    reads/updates with the session clock riding the transaction
    timestamp, typed errors decoded from the errmsg prefix
    (:func:`antidote_tpu_torch.proto.apb.parse_error_text`) into the SAME
    ``Remote*`` exceptions the native client raises.  Carries the native
    client's at-most-once tagging: transport failures are marked with
    whether the request left the socket."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8087,
                 timeout: float = 30.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        self._rfile = self._sock.makefile("rb")
        #: the last ring hint learned from a reply: proxied reads carry it
        #: as an optional msgpack field, typed redirects as the
        #: errmsg-encoded ``fleet=`` param
        self.ring_hint: Optional[dict] = None

    def _call(self, name: str, body: Dict[str, Any]):
        frame = apb.encode_frame_body(name, body)
        with self._lock:
            try:
                self._sock.sendall(struct.pack(">I", len(frame)) + frame)
            except (ConnectionError, OSError) as e:
                e.request_sent = False
                raise
            try:
                data = read_frame_buffered(self._rfile)
            except (ConnectionError, OSError) as e:
                e.request_sent = True
                raise
        resp_name, resp = apb.decode_frame_body(data)
        if resp_name == "ApbErrorResp":
            err = apb.parse_error_text(resp.get("errmsg", b""))
            kind, detail = err["kind"], err["detail"]
            if err.get("fleet") or err.get("redirect"):
                self.ring_hint = {"owner": err.get("redirect"),
                                  "followers": err.get("fleet") or [],
                                  "vnodes": None}
            if kind == "tenant_busy":
                raise RemoteTenantBusy(detail, err["retry_after_ms"],
                                       tenant=err.get("tenant") or "")
            if kind == "busy":
                raise RemoteBusy(detail, err["retry_after_ms"])
            if kind == "deadline":
                raise RemoteDeadline(detail)
            if kind == "read_only":
                raise RemoteReadOnly(detail)
            if kind == "not_owner":
                raise RemoteNotOwner(detail, redirect=err["redirect"])
            if kind == "lagging":
                raise RemoteLagging(detail, err["retry_after_ms"],
                                    redirect=err["redirect"])
            if kind == "forward_failed":
                raise RemoteForwardFailed(detail)
            if kind == "insufficient_rights":
                raise RemoteInsufficientRights(detail,
                                               err["retry_after_ms"])
            raise RemoteError(f"{kind}: {detail}")
        hint = resp.get("ring_hint") if isinstance(resp, dict) else None
        if hint is not None:
            self.ring_hint = msgpack.unpackb(hint, raw=False)
        return resp_name, resp

    @staticmethod
    def _txn_clock(clock) -> Dict[str, Any]:
        if clock is None:
            return {}
        return {"timestamp": msgpack.packb([int(x) for x in clock])}

    def read_objects(self, objects: Sequence[Tuple[Any, str, str]],
                     clock: Optional[Sequence[int]] = None,
                     deadline_ms=None):
        name, resp = self._call("ApbStaticReadObjects", {
            "transaction": self._txn_clock(clock),
            "objects": [
                {"key": apb.to_bytes(k), "type": apb.TYPE_IDS[t],
                 "bucket": apb.to_bytes(b)}
                for k, t, b in objects
            ],
        })
        vals = [apb.read_resp_to_value(r)
                for r in resp["objects"]["objects"]]
        vc = msgpack.unpackb(resp["committime"]["commit_time"],
                             raw=False)
        return vals, vc

    def update_objects(self, updates: Sequence[Tuple],
                       clock: Optional[Sequence[int]] = None,
                       deadline_ms=None) -> List[int]:
        name, resp = self._call("ApbStaticUpdateObjects", {
            "transaction": self._txn_clock(clock),
            "updates": [apb.update_op_from_native(u) for u in updates],
        })
        return msgpack.unpackb(resp["commit_time"], raw=False)

    def close(self) -> None:
        try:
            self._rfile.close()
        except OSError:
            pass
        self._sock.close()


class SessionClient:
    """Causal session over an owner and its follower fleet.

    Carries a compact VC session token: every commit clock and read
    snapshot the session observes folds into it (``merge_clock``), and it
    rides as the causal clock of every request — so read-your-writes and
    monotonic reads hold whichever replica serves, across follower kills.

    Reads route over a consistent-hash ring (:class:`HashRing`) across the
    followers: each key has one preferred replica fleet-wide, failover
    walks a per-client seeded order over the survivors, and the owner is
    always the last resort.  Writes always go to the owner.  Typed
    ``lagging`` / ``not_owner`` redirects and connection deaths fail over
    alike; when every endpoint fails, the typed ``ReplicaDown`` surfaces.
    The fleet is passed statically (``followers``) or learned from the
    owner's replica registry (``discover=True``; :meth:`refresh_fleet`),
    and server-attached ring hints refresh it in place.  ``dialect``
    picks the wire codec: ``native`` (msgpack) or ``apb`` (protobuf)."""

    #: a connection-dead endpoint is skipped this long before a retry
    DEAD_S = 2.0

    def __init__(self, owner, followers=(), timeout: float = 30.0,
                 dialect: str = "native", ring_vnodes: int = 64,
                 seed: Optional[int] = None, discover: bool = False):
        self.owner = (owner[0], int(owner[1]))
        self.timeout = timeout
        if dialect not in ("native", "apb"):
            raise ValueError(f"unknown dialect {dialect!r}")
        self.dialect = dialect
        self.ring_vnodes = int(ring_vnodes)
        if seed is None:
            seed = int.from_bytes(os.urandom(8), "big")
        self.seed = int(seed)
        #: the session token (None until the first clock is observed)
        self.token: Optional[List[int]] = None
        self._conns: dict = {}
        #: addr -> monotonic time until which it is skipped
        self._dead: Dict[Tuple[str, int], float] = {}
        #: typed redirects honored, failovers on connection death, ring
        #: hints absorbed, and reads served per endpoint
        self.redirects = 0
        self.failovers = 0
        self.hints_applied = 0
        self.served_by: Dict[Tuple[str, int], int] = {}
        self.followers: List[Tuple[str, int]] = []
        self.ring = HashRing((), vnodes=self.ring_vnodes, seed=self.seed)
        self._discover = bool(discover)
        self._set_fleet(followers)
        if self._discover and not self.followers:
            self.refresh_fleet()

    # -- fleet -------------------------------------------------------------
    def _set_fleet(self, followers) -> None:
        self.followers = [(h, int(p)) for h, p in followers]
        self.ring = HashRing(self.followers, vnodes=self.ring_vnodes,
                             seed=self.seed)

    def refresh_fleet(self) -> List[Tuple[str, int]]:
        """Re-learn the fleet from the owner's replica registry: every
        follower it reports ok or lagging with a known client address."""
        c = AntidoteClient(self.owner[0], self.owner[1],
                           timeout=self.timeout)
        try:
            st = c.replica_admin("status")
        finally:
            c.close()
        fleet = [(f["addr"][0], int(f["addr"][1]))
                 for _name, f in sorted((st.get("followers") or {}).items())
                 if f.get("state") in ("ok", "lagging") and f.get("addr")]
        self._set_fleet(fleet)
        return self.followers

    # -- connections -------------------------------------------------------
    def _conn(self, addr):
        c = self._conns.get(addr)
        if c is None:
            cls = AntidoteClient if self.dialect == "native" else ApbClient
            try:
                c = cls(addr[0], addr[1], timeout=self.timeout)
            except (ConnectionError, OSError) as e:
                # a DIAL failure never carried a request: a retry is safe
                e.request_sent = False
                raise
            self._conns[addr] = c
        return c

    def _drop(self, addr) -> None:
        c = self._conns.pop(addr, None)
        if c is not None:
            try:
                c.close()
            except OSError:
                pass

    def observe(self, clock) -> None:
        """Fold an observed clock into the session token."""
        self.token = merge_clock(self.token, clock)

    def _absorb_hint(self, conn) -> None:
        """Apply a server-attached ring hint in place, so the next read
        routes zero-hop.  A hint never shrinks knowledge: an owner-only
        hint leaves the ring alone."""
        hint = getattr(conn, "ring_hint", None)
        if not hint:
            return
        conn.ring_hint = None
        changed = False
        owner = hint.get("owner")
        if owner and (owner[0], int(owner[1])) != self.owner:
            self.owner = (owner[0], int(owner[1]))
            changed = True
        fleet = [(h, int(p)) for h, p in (hint.get("followers") or ())]
        if fleet and fleet != self.followers:
            self._set_fleet(fleet)
            changed = True
        if changed:
            self.hints_applied += 1

    # -- session ops -------------------------------------------------------
    def update_objects(self, updates: Sequence[Tuple]) -> List[int]:
        """Session write at the owner; the commit clock folds into the
        token.  At most once: only a SEND-phase failure is redialed; a
        connection dying while awaiting the reply surfaces, since the
        owner may have executed the write."""
        from antidote_tpu_torch.overload import ReplicaDown

        last: Optional[BaseException] = None
        for _attempt in range(2):
            try:
                addr = self.owner
                vc = self._conn(addr).update_objects(updates,
                                                     clock=self.token)
                self.observe(vc)
                self._absorb_hint(self._conns.get(addr))
                return vc
            except RemoteNotOwner as e:
                # the "owner" endpoint is a follower that told us where to
                # go
                self._absorb_hint(self._conns.get(self.owner))
                if not e.redirect:
                    raise
                self.redirects += 1
                self.owner = (e.redirect[0], int(e.redirect[1]))
                last = e
            except (ConnectionError, OSError) as ex:
                self._drop(self.owner)
                self.failovers += 1
                if getattr(ex, "request_sent", True):
                    raise ConnectionError(
                        f"session write: connection to owner {self.owner} "
                        "died awaiting the reply — the write may have "
                        "executed; not resending") from ex
                last = ex
        raise ReplicaDown(
            f"session write: owner {self.owner} unreachable") from last

    def _read_candidates(self, objects):
        """Ring failover order for a read, lazily: the first object's key
        routes the whole read (one snapshot unit); recently dead endpoints
        are skipped; the owner is always last."""
        now = time.monotonic()
        for ep, until in list(self._dead.items()):
            if until <= now:
                del self._dead[ep]
        if len(self.ring) and objects:
            key, _t, bucket = objects[0]
            pref = self.ring.preferred(key, bucket)
            if pref is not None and pref not in self._dead:
                yield pref
            for ep in self.ring.order(key, bucket)[1:]:
                if ep not in self._dead:
                    yield ep
        yield self.owner

    def read_objects(self, objects: Sequence[Tuple[Any, str, str]],
                     _relearn: bool = True):
        """Session read: the key's ring-preferred follower first, then the
        survivors, then the owner; the reply's snapshot clock folds into
        the token.  A read every endpoint refused re-learns the fleet once
        (with discovery) before the typed ReplicaDown."""
        from antidote_tpu_torch.overload import ReplicaDown

        last: Optional[BaseException] = None
        for addr in self._read_candidates(objects):
            try:
                vals, vc = self._conn(addr).read_objects(objects,
                                                         clock=self.token)
            except (RemoteLagging, RemoteNotOwner) as e:
                self.redirects += 1
                self._absorb_hint(self._conns.get(addr))
                last = e
                continue
            except (ConnectionError, OSError) as ex:
                self._drop(addr)
                if addr != self.owner:
                    self._dead[addr] = time.monotonic() + self.DEAD_S
                self.failovers += 1
                last = ex
                continue
            self.observe(vc)
            self._absorb_hint(self._conns.get(addr))
            self.served_by[addr] = self.served_by.get(addr, 0) + 1
            return vals, vc
        if self._discover and _relearn:
            try:
                self.refresh_fleet()
            except (ConnectionError, OSError, RemoteError):
                pass
            else:
                return self.read_objects(objects, _relearn=False)
        raise ReplicaDown("session read: every endpoint (followers and "
                          "owner) refused or dropped the request") from last

    def stats(self) -> dict:
        """Ring size, per-endpoint arc shares, reads served per endpoint,
        redirects, failovers and hints applied."""
        return {"ring_size": len(self.ring),
                "arc_share": self.ring.arc_share_by_name(),
                "served_by": {f"{h}:{p}": n
                              for (h, p), n in sorted(self.served_by.items())},
                "redirects": self.redirects, "failovers": self.failovers,
                "hints_applied": self.hints_applied}

    def close(self) -> None:
        for addr in list(self._conns):
            self._drop(addr)
