"""Python clients for the wire protocol — the antidotec_pb analogue.

One socket, request/response in lockstep (the reference client multiplexes
the same way: each request waits for its reply before the next).
:class:`AntidoteClient` speaks the msgpack dialect, :class:`ApbClient` the
``antidote_pb`` protobuf one; both raise the same typed ``Remote*`` errors,
and both talk to a server of either package.  The follower fleet's
session client and hash ring come with inter-DC replication.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import msgpack

from antidote_tpu_torch.proto import apb
from antidote_tpu_torch.proto.codec import (
    MessageCode,
    decode,
    decode_value,
    encode_with,
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
                       tenant: Optional[str] = None) -> List[int]:
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
        body = self._call(MessageCode.STATIC_UPDATE_OBJECTS, req)
        return body["commit_clock"]

    def read_objects(self, objects: Sequence[Tuple[Any, str, str]],
                     clock: Optional[Sequence[int]] = None,
                     deadline_ms: Optional[float] = None,
                     tenant: Optional[str] = None):
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

    def close(self) -> None:
        try:
            self._rfile.close()
        except OSError:
            pass
        self._sock.close()


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
