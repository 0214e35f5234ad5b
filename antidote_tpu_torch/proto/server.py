"""Protocol server: TCP acceptor pool + request dispatcher.

The reference's ranch listener (100 acceptors, max 1024 connections, port
8087; ``antidote_pb_sup``) becomes a ``ThreadingTCPServer``; the
decode→process→encode loop with error replies mirrors
``antidote_pb_protocol:loop/handle``, and the dispatch table mirrors
``antidote_pb_process:process/1``.  Both wire dialects share the port: the
msgpack frames of :mod:`codec` and the ``antidote_pb`` protobuf of
:mod:`apb`, byte for byte the JAX package's.

Static reads and updates ride a staged pipeline: handler threads decode
and park work at a bounded batch gate (per-tenant lanes); the dispatcher
launches merged epoch reads against the pinned serving epoch without a
device sync; the writeback thread materializes them (the only stage that
blocks on the device) and wakes the handlers; a locked worker runs the
group-commit merge and the reads the epoch cannot serve; a ticker
publishes serving epochs.  Every device launch goes to the current CUDA
stream of the thread that issues it, and no thread here switches
streams, so a batch launched on the dispatcher and materialized on the
writeback thread is ordered after the publishes it read.

With ``native_frontend=True`` the advertised port belongs to the C++ epoll
plane (``proto/native_frontend.py``): it accepts, frames, admits and
answers whole-batch snapshot-cache hits off the interpreter lock, and the
frames it cannot answer cross to per-connection drain workers here, which
run the same serving core as the socketserver handlers.  The follower's
proxy plane comes with inter-DC replication: ``follower=`` raises.
"""

from __future__ import annotations

import itertools
import logging
import queue
import socketserver
import struct
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from antidote_tpu_torch import faults as _faults
from antidote_tpu_torch.api.node import AntidoteNode
from antidote_tpu_torch.overload import (
    AdmissionGate,
    BusyError,
    ColdMiss,
    DeadlineExceeded,
    InsufficientRightsError,
    ReadOnlyError,
    TenantBusyError,
    check_deadline,
    deadline_from_ms,
)
from antidote_tpu_torch.tenancy import TenantLanes, TenantRegistry
from antidote_tpu_torch.proto import apb
from antidote_tpu_torch.proto.codec import (
    MessageCode,
    decode,
    encode,
    encode_value,
    freeze,
    read_frame_buffered,
    write_frame_body,
    write_message,
)
from antidote_tpu_torch.txn.manager import AbortError, Transaction

DEFAULT_PORT = 8087
log = logging.getLogger(__name__)

_STOP = object()


class _StaticWork:
    """One client's static read/update — or an interactive COMMIT — parked
    at the batch gate / locked-plane merge point."""

    __slots__ = ("kind", "objects", "updates", "clock", "event", "result",
                 "error", "deadline", "t_submit", "wants_bytes",
                 "reply_bytes", "txid", "tenant")

    def __init__(self, kind, objects=None, updates=None, clock=None,
                 deadline=None, wants_bytes=False, txid=None, tenant=None):
        self.kind = kind
        self.objects = objects
        self.updates = updates
        self.clock = clock
        #: tenant lane this work rides: derived from the
        #: bucket namespace / request tag at decode; None = default
        self.tenant = tenant
        #: interactive commit works (kind == "commit") carry the txid;
        #: the locked worker resolves it to the registered Transaction
        #: at the merge point
        self.txid = txid
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        #: absolute monotonic deadline (None = none): checked when the
        #: batch dispatcher DEQUEUES the work — a request that outlived
        #: its caller while parked is aborted, not executed
        self.deadline: Optional[float] = deadline
        #: submit timestamp (stage_parked histogram)
        self.t_submit = 0.0
        #: native-dialect reads ask the writeback stage to serialize the
        #: reply frame for them (batched reply serialization: one tight
        #: encode loop instead of per-connection wakeup-then-frame)
        self.wants_bytes = wants_bytes
        self.reply_bytes: Optional[bytes] = None


class RawReply:
    """A fully-framed response produced by the writeback stage — the
    handler sends the bytes as-is."""

    __slots__ = ("buf",)

    def __init__(self, buf: bytes):
        self.buf = buf


class _EpochReadBatch:
    """A launched (but unmaterialized) merged epoch-read batch in flight
    between the dispatcher's launch stage and the writeback stage: device
    handles plus the per-work result spans."""

    __slots__ = ("pending", "works", "spans", "vc_list")

    def __init__(self, pending, works, spans, vc_list):
        self.pending = pending
        self.works = works
        self.spans = spans
        self.vc_list = vc_list


def _decode_objects(objs):
    return [(freeze(k), t, b) for k, t, b in (freeze(o) for o in objs)]


def _decode_updates(ups):
    return [(freeze(k), t, b, freeze(op)) for k, t, b, op in
            (freeze(u) for u in ups)]


def _vc(x) -> Optional[np.ndarray]:
    # a wire-decoded int list -> the host clock the manager takes
    return None if x is None else np.asarray(x, np.int32)


class ProtocolServer:
    """Serves ``node`` on ``host:port`` (0 picks a free port) in both wire
    dialects.  The node's device is the server's: a CUDA node's reads and
    commits launch its kernels, and a failed launch fails the request typed,
    never falling back to the CPU."""

    def __init__(self, node: AntidoteNode, host: str = "127.0.0.1",
                 port: int = 0, max_connections: int = 1024,
                 batch_static: bool = True, max_in_flight: int = 256,
                 max_in_flight_per_client: int = 64, queue_max: int = 4096,
                 default_deadline_ms: Optional[float] = None,
                 epoch_tick_ms: float = 100.0,
                 snapshot_cache_size: Optional[int] = None,
                 group_commit_window_us: float = 0.0,
                 follower=None, native_frontend: bool = False,
                 native_mirror_cap: int = 1 << 18, tenants=None):
        if follower is not None:
            raise NotImplementedError(
                "follower: read replicas and the proxy plane come with "
                "inter-DC replication, which is not ported")
        # --- native serving front-end ----------------------------------
        #: a C++ epoll thread owning accept / framing / hot-read decode /
        #: admission / whole-batch cache hits on the ADVERTISED port;
        #: Python sees only drained misses, writes, txns and apb frames.
        #: Created before any thread starts: a plane that cannot serve
        #: raises NativeFrontendUnavailable from here and leaves nothing
        #: running (no fallback; only ANTIDOTE_NATIVE_FRONTEND=off serves
        #: from the socketserver plane, which stays bound either way)
        self.native = None
        self._native_drain = None
        if native_frontend:
            from antidote_tpu_torch.proto.native_frontend import (
                NativeFrontend)

            self.native = NativeFrontend.create(
                host, port, max_connections, max_in_flight,
                max_in_flight_per_client, mirror_cap=native_mirror_cap)
        self.node = node
        #: multi-tenant QoS: weights + caps for every tenant this node
        #: serves.  An untenanted node gets a registry holding only the
        #: default lane — every tenant code path then degenerates to the
        #: single-queue behavior.
        self.tenants: TenantRegistry = tenants or TenantRegistry()
        self._lock = threading.Lock()
        self._txns: Dict[int, Transaction] = {}
        #: metric sink for the overload planes: the node's own registry
        self.metrics = node.metrics
        #: overload admission: global + per-client (peer host)
        #: in-flight caps.  Past a cap, the request is answered with a
        #: typed busy error carrying a retry-after hint — never parked
        #: forever (the riak_core vnode overload answer, {error,
        #: overload}).  Per-HOST, not per-socket: each connection's
        #: handler thread is serial, so per-socket in-flight never
        #: exceeds 1 — bounding a client machine's whole connection
        #: fleet is what actually prevents monopolization
        self.admission = AdmissionGate(
            max_in_flight, max_in_flight_per_client,
            gauge=self.metrics.in_flight, tenants=self.tenants,
        )
        #: default per-request deadline (ms) when the client sends none;
        #: None = requests without a deadline_ms field never expire
        self.default_deadline_ms = default_deadline_ms
        self._conn_ids = itertools.count(1)
        #: cross-connection batch gate: static reads/updates from
        #: concurrent connections coalesce into single device launches
        #: instead of one launch per socket (the reference scales the same
        #: path with 20 read servers per partition)
        self.batch_static = batch_static
        self._closing = False
        #: BOUNDED: a full gate answers busy instead of buffering without
        #: limit (admission usually sheds first; this cap is the backstop
        #: against a stalled dispatcher).  Per-tenant bounded LANES with
        #: deficit-round-robin dequeue: a backlogged tenant
        #: fills its OWN lane and sheds typed tenant_busy there, instead
        #: of occupying the shared budget everyone else's requests ride.
        self._static_q = TenantLanes(self.tenants, queue_max,
                                     name="static batch gate")
        self._batch_max = 1024
        #: per-handler-thread scratch (stage_decode timing)
        self._tls = threading.local()
        # --- staged serving pipeline ---------------------------------
        #: serving-epoch publication cadence for the dedicated ticker
        self.epoch_tick_ms = epoch_tick_ms
        txm = node.txm
        # the group-commit merge point caps any single tenant's share of
        # one merged batch (weight-proportional rounds)
        txm.tenants = self.tenants
        #: lock-split epoch reads need the batch dispatcher;
        #: epoch_tick_ms <= 0 disables the whole epoch plane (operator
        #: escape hatch back to the locked serving path)
        self._epoch_reads = bool(batch_static and epoch_tick_ms > 0)
        if self._epoch_reads:
            txm.enable_serving_epochs()
            self._epoch_reads = txm.serving_epochs  # clocksi-only
            if snapshot_cache_size is not None:
                txm.store.snapshot_cache_cap = int(snapshot_cache_size)
            if txm.store.metrics is None:
                txm.store.metrics = self.metrics
        #: launched-but-unmaterialized epoch read batches between the
        #: dispatcher and the writeback worker.  BOUNDED: a lagging
        #: writeback stage backpressures the dispatcher (which then
        #: backpressures the bounded batch gate) instead of queueing
        #: device handles without limit.
        self._writeback_q: "queue.Queue" = queue.Queue(maxsize=16)
        #: the LOCKED plane's feed: update groups, interactive COMMITs
        #: (the cross-connection group-commit merge point) and reads the
        #: epoch cannot serve, processed by a dedicated worker so a
        #: commit group never parks the dispatcher's read-launch stage.
        #: BOUNDED: past the cap the work sheds with a typed busy error,
        #: same as the gate — per-tenant lanes + DRR here too (the merge
        #: point is where a write storm actually queues)
        self._locked_q = TenantLanes(self.tenants, queue_max,
                                     name="locked plane")
        #: optional gather window at the merge point: after the locked
        #: worker's first dequeue it keeps draining up to this long, so
        #: moderate-load commit groups widen before taking the commit
        #: lock once.  0 (default) = natural batching only (whatever
        #: queued during the previous group's execution).
        self._group_window_s = max(0.0, float(group_commit_window_us)) / 1e6
        self._ticker_stop = threading.Event()
        if batch_static:
            self._batcher = threading.Thread(
                target=self._static_loop, daemon=True,
                name="antidote-proto-batch",
            )
            self._batcher.start()
            self._writeback = threading.Thread(
                target=self._writeback_loop, daemon=True,
                name="antidote-proto-writeback",
            )
            self._writeback.start()
            self._locked_worker = threading.Thread(
                target=self._locked_loop, daemon=True,
                name="antidote-proto-locked",
            )
            self._locked_worker.start()
            # the ticker runs with the batch pipeline — even with the
            # epoch plane disabled (epoch_tick_ms <= 0) it still drives
            # the LOCKED path's per-table epoch ladder
            self._ticker = threading.Thread(
                target=self._epoch_ticker, daemon=True,
                name="antidote-epoch-ticker",
            )
            self._ticker.start()
        #: connection cap (the reference's ranch listener caps at
        #: 1024).  The accept
        #: loop blocks on the semaphore when the cap is reached, so
        #: excess connections queue in the kernel listen backlog instead
        #: of exhausting server threads — ranch's backpressure shape.
        self.max_connections = max_connections
        self._conn_slots = threading.BoundedSemaphore(max_connections)
        handler = self._make_handler()
        conn_slots = self._conn_slots

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True
            closing = False
            # while the accept loop parks on the cap, excess connections
            # must queue in the kernel listen backlog (ranch's shape) —
            # the socketserver default of 5 would drop their SYNs
            request_queue_size = max_connections

            def shutdown(self):
                self.closing = True
                super().shutdown()

            def process_request(self, request, client_address):
                # hold the accept loop until a slot frees: backpressure,
                # not thread-per-connection without bound.  Poll so a
                # shutdown() issued while the cap is saturated can still
                # unpark the serve_forever loop instead of deadlocking.
                while not conn_slots.acquire(timeout=0.1):
                    if self.closing:
                        self.shutdown_request(request)
                        return
                try:
                    super().process_request(request, client_address)
                except BaseException:
                    conn_slots.release()
                    raise

            def process_request_thread(self, request, client_address):
                try:
                    super().process_request_thread(request, client_address)
                finally:
                    conn_slots.release()

        self._server = Server(
            (host, port if self.native is None else 0), handler)
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"antidote-proto:{self.port}",
        )
        self._thread.start()
        if self.native is not None:
            self.port = self.native.port
            store = node.txm.store
            # fast-serve needs the epoch plane, and every armed
            # frontend.* fault rule must keep firing — rules apply
            # Python-side per drained frame, so a natively-served hit
            # would bypass them; with any armed, everything crosses.  A
            # store feeds ONE mirror: a second native server on the node
            # forwards every frame (the JAX package rewires the store to
            # the newest server, and the older one's mirror then misses
            # invalidations)
            if (self._epoch_reads
                    and not _faults.armed_prefix("frontend.")
                    and store.native_mirror is None):
                store.native_mirror = self.native
            else:
                self.native.set_fast_serve(False)
            self._native_drain = threading.Thread(
                target=self._native_drain_loop, daemon=True,
                name="antidote-native-drain",
            )
            self._native_drain.start()

    # ------------------------------------------------------------------
    def _make_handler(server_self):
        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # txns this connection started and has not finished: a
                # dropped connection must not pin open transactions (they
                # hold the certification-GC floor — manager._open_snaps —
                # forever; the reference's coordinator FSMs die with the
                # client process and roll back the same way)
                conn_txns = set()
                try:
                    self._serve(conn_txns)
                finally:
                    for txid in conn_txns:
                        server_self._abort_orphan(txid)

            def _serve(self, conn_txns):
                # admission key = peer host: one client machine's whole
                # connection fleet shares one per-client budget
                try:
                    client_id = self.request.getpeername()[0]
                except OSError:
                    client_id = f"conn{next(server_self._conn_ids)}"
                metrics = server_self.metrics
                # buffered framing: header + body in ~one syscall each
                rfile = self.request.makefile("rb")
                while True:
                    try:
                        frame = read_frame_buffered(rfile)
                    except (ConnectionError, OSError, ValueError):
                        return
                    # frontend.recv fault site (chaos: an armed plan
                    # drops, truncates or delays inbound frames)
                    frame = server_self._frame_fault(frame)
                    if frame is None:
                        return
                    # ADMISSION: acquire an in-flight slot before
                    # any decode/dispatch work.  Past the global or
                    # per-client cap the request is answered with a
                    # typed busy error + retry-after hint — the client
                    # backs off, the server never queues unboundedly.
                    t0 = time.monotonic()
                    try:
                        server_self.admission.enter(client_id)
                    except BusyError as e:
                        metrics.shed.inc(plane="server")
                        if not self._reply_error(frame, "busy", e):
                            return
                        continue
                    # decode-stage clock: runs until the work parks at
                    # the batch gate (observed in _submit)
                    server_self._tls.t0 = t0
                    try:
                        if not self._handle_admitted(frame, conn_txns):
                            return
                    finally:
                        server_self.admission.exit(client_id)
                        metrics.server_request_seconds.observe(
                            time.monotonic() - t0)

            def _reply_error(self, frame, kind: str, e) -> bool:
                """Typed error reply in the FRAME'S dialect; False when
                the connection died mid-write."""
                retry_ms = int(getattr(e, "retry_after_ms", 0))
                try:
                    if frame and frame[0] in apb.APB_REQUEST_CODES:
                        write_frame_body(self.request, apb.overload_error(
                            kind, str(e), retry_ms))
                    else:
                        resp = {"error": kind, "detail": str(e)}
                        if retry_ms:
                            resp["retry_after_ms"] = retry_ms
                        write_message(self.request,
                                      MessageCode.ERROR_RESP, resp)
                    return True
                except (ConnectionError, OSError):
                    return False

            def _handle_admitted(self, frame, conn_txns) -> bool:
                """One admitted request end-to-end; False = drop conn."""
                buf = server_self._frame_reply(frame, conn_txns)
                try:
                    self.request.sendall(buf)
                except (ConnectionError, OSError):
                    return False
                return True

        return Handler

    # ------------------------------------------------------------------
    # serving core
    # ------------------------------------------------------------------
    def _frame_reply(self, frame: bytes, conn_txns) -> bytes:
        """One request frame → one fully-framed reply, both dialects
        (admission is the caller's job; the error mapping here mirrors
        antidote_pb_protocol:handle's error replies)."""
        # dialect dispatch on the code byte: antidote_pb request codes
        # (apb.APB_REQUEST_CODES) are disjoint from the native msgpack
        # codes, so existing antidotec_pb clients connect to the same
        # port
        if frame and frame[0] in apb.APB_REQUEST_CODES:
            resp_body = apb.handle_request(
                self, frame[0], frame[1:], conn_txns, lock=self._lock,
            )
            return struct.pack(">I", len(resp_body)) + resp_body
        code = body = None
        try:
            code, body = decode(frame)
            resp_code, resp = self._process(code, body)
            if code == MessageCode.START_TRANSACTION:
                conn_txns.add(resp["txid"])
            elif code in (MessageCode.COMMIT_TRANSACTION,
                          MessageCode.ABORT_TRANSACTION):
                conn_txns.discard(body.get("txid"))
        except AbortError as e:
            if code == MessageCode.UPDATE_OBJECTS:
                conn_txns.discard(body.get("txid"))
            resp_code, resp = MessageCode.ERROR_RESP, {
                "error": "aborted", "detail": str(e)
            }
        except InsufficientRightsError as e:
            # escrow refusal: the counter_b decrement/transfer
            # exceeded this DC's locally-held rights — nothing executed;
            # the hint tracks the background transfer loop's expected
            # grant arrival (a COMMIT refusal closed the txn server-side,
            # so the descriptor must not linger in conn_txns)
            if code in (MessageCode.UPDATE_OBJECTS,
                        MessageCode.COMMIT_TRANSACTION):
                conn_txns.discard(body.get("txid"))
            resp_code, resp = MessageCode.ERROR_RESP, {
                "error": "insufficient_rights", "detail": str(e),
                "retry_after_ms": int(e.retry_after_ms),
            }
        except TenantBusyError as e:
            # tenant-scoped quota/lane refusal: typed
            # distinctly from global busy — the client learns its OWN
            # quota (not the node) is the bottleneck, so failover to a
            # sibling node won't help but backing off will
            resp_code, resp = MessageCode.ERROR_RESP, {
                "error": "tenant_busy", "detail": str(e),
                "retry_after_ms": int(e.retry_after_ms),
                "tenant": e.tenant,
            }
        except BusyError as e:
            # downstream cap (commit backlog / batch gate): same typed
            # shape as the admission shed
            resp_code, resp = MessageCode.ERROR_RESP, {
                "error": "busy", "detail": str(e),
                "retry_after_ms": int(e.retry_after_ms),
            }
        except DeadlineExceeded as e:
            resp_code, resp = MessageCode.ERROR_RESP, {
                "error": "deadline", "detail": str(e)
            }
        except ColdMiss as e:
            # cold-tier fault-in refused (rate cap / I/O fault / CRC
            # failure): the key's device row stays cold this round —
            # the client retries after the hint; the value was NEVER
            # served wrong
            resp_code, resp = MessageCode.ERROR_RESP, {
                "error": "cold_miss", "detail": str(e),
                "retry_after_ms": int(e.retry_after_ms),
                "permanent": bool(e.permanent),
            }
        except ReadOnlyError as e:
            resp_code, resp = MessageCode.ERROR_RESP, {
                "error": "read_only", "detail": str(e)
            }
        except Exception as e:  # error reply, keep the conn
            log.exception("request failed")
            resp_code, resp = MessageCode.ERROR_RESP, {
                "error": type(e).__name__, "detail": str(e)
            }
        if isinstance(resp, RawReply):
            # the writeback stage already framed the reply
            return resp.buf
        return encode(resp_code, resp)

    def _frame_fault(self, frame: bytes) -> Optional[bytes]:
        """Apply an armed ``frontend.recv`` fault rule to one inbound
        frame.  None = drop the connection."""
        d = _faults.hit("frontend.recv")
        if d is None:
            return frame
        if d.action == "drop":
            return None
        if d.action == "truncate":
            keep = int(d.arg) if d.arg else max(1, len(frame) // 2)
            return frame[:keep]
        if d.action == "delay":
            time.sleep(float(d.arg or 0.01))
        return frame

    def _abort_orphan(self, txid: int) -> None:
        """Roll back a transaction whose client connection died."""
        with self._lock:
            txn = self._txns.pop(txid, None)
            if txn is not None and txn.active:
                self.node.abort_transaction(txn)

    # ------------------------------------------------------------------
    # native front-end drain plane
    # ------------------------------------------------------------------
    def _native_drain_loop(self):
        """Fans batch-drain crossings out to per-connection workers.

        The C++ loop serves whole-batch cache hits itself; everything it
        can't (misses, writes, interactive txns, apb frames, admission
        sheds) crosses here in packed batches — ONE interpreter-lock
        acquisition per drain, then per-conn queues so one slow device
        batch never head-of-line-blocks another connection's frames.
        Reply order per connection is preserved: the native loop only
        fast-serves a conn with no frame still pending in Python."""
        nf = self.native
        workers: Dict[int, "queue.SimpleQueue"] = {}
        while not self._closing:
            batch = nf.take_batch(200)
            now = time.monotonic()
            for conn_id, kind, aux, payload in batch:
                if kind == nf.K_CONN_DROP:
                    q = workers.pop(conn_id, None)
                    if q is not None:
                        q.put(None)
                    continue
                q = workers.get(conn_id)
                if q is None:
                    # admitted frames hold admission slots until
                    # frontend_send releases them, and the native loop
                    # stops reading sockets when its crossing queue
                    # fills — so this queue's depth is bounded by the
                    # admission caps and the native QUEUE_CAP
                    q = queue.SimpleQueue()
                    workers[conn_id] = q
                    threading.Thread(
                        target=self._native_conn_worker, daemon=True,
                        args=(conn_id, q),
                        name=f"antidote-native-conn-{conn_id}",
                    ).start()
                q.put((kind, aux, payload, now))
        for q in workers.values():
            q.put(None)

    def _native_conn_worker(self, conn_id: int, q: "queue.SimpleQueue"):
        """One drained connection's serving thread — the twin of a
        socketserver Handler: the same fault site, the same serving core,
        the same orphan-txn rollback when the conn drops."""
        nf = self.native
        conn_txns = set()
        try:
            while True:
                item = q.get()
                if item is None or self._closing:
                    return
                kind, aux, frame, t0 = item
                admitted = 1 if kind == nf.K_FRAME else 0
                frame = self._frame_fault(frame)
                if frame is None:
                    # chaos drop: account the slot, then drop the conn —
                    # the Python plane's silent-close twin
                    nf.send(conn_id, b"", admitted)
                    nf.close_conn(conn_id)
                    continue
                if kind == nf.K_SHED:
                    # the native loop refused admission; serialize the
                    # typed busy reply in the frame's dialect here
                    # (Python owns the apb encoder)
                    self.metrics.shed.inc(plane="server")
                    nf.send(conn_id, self._busy_reply_bytes(frame, aux), 0)
                    continue
                self._tls.t0 = t0
                try:
                    buf = self._frame_reply(frame, conn_txns)
                except Exception as e:  # never wedge the admission slot
                    log.exception("native drain request failed")
                    buf = encode(MessageCode.ERROR_RESP, {
                        "error": type(e).__name__, "detail": str(e)})
                nf.send(conn_id, buf, admitted)
                self.metrics.server_request_seconds.observe(
                    time.monotonic() - t0)
        finally:
            for txid in conn_txns:
                self._abort_orphan(txid)

    def _busy_reply_bytes(self, frame: bytes, hint_ms: int) -> bytes:
        """Framed admission-shed reply in the frame's dialect (the native
        loop sheds apb frames to Python — kind 2 — because the apb error
        encoder lives here)."""
        if frame and frame[0] in apb.APB_REQUEST_CODES:
            body = apb.overload_error(
                "busy", "server admission refused", int(hint_ms))
            return struct.pack(">I", len(body)) + body
        return encode(MessageCode.ERROR_RESP, {
            "error": "busy", "detail": "server admission refused",
            "retry_after_ms": int(hint_ms),
        })

    def _native_advance(self) -> None:
        """Push the freshly-published serving epoch to the C++ mirror —
        called by the epoch ticker right after every publish.  The
        mirror's re-stamping is sound because every effect applied since
        the last advance invalidated its keys eagerly (under the commit
        lock, BEFORE the publish made them visible)."""
        nf = self.native
        txm = self.node.txm
        if nf is None or txm.store.native_mirror is not nf:
            return
        ep = txm.store.serving_epoch
        if ep is None:
            nf.set_clockless_ok(False)
            return
        nf.advance(int(ep.id), ep.vc.tolist(),
                   int(ep.vc[txm.my_dc]) >= txm.epoch_lag_counter)

    # ------------------------------------------------------------------
    # static batch gate
    # ------------------------------------------------------------------
    def static_read(self, objects, clock, deadline=None, wants_bytes=False,
                    tenant=None):
        """Batched static read: (values, snapshot_vc) — or a
        :class:`RawReply` when ``wants_bytes`` and the writeback stage
        serialized the native reply frame itself."""
        tenant = self.tenants.resolve(tenant, (o[2] for o in objects))
        if not self.batch_static:
            with self._lock:
                check_deadline(deadline, "dispatch")
                return self.node.read_objects(objects, clock=_vc(clock))
        clock_vc = _vc(clock)
        fast = self._try_cache_read(objects, clock_vc, wants_bytes)
        if fast is not None:
            return fast
        w = _StaticWork("read", objects=objects, clock=clock_vc,
                        deadline=deadline, wants_bytes=wants_bytes,
                        tenant=tenant)
        out = self._submit(w)
        if w.reply_bytes is not None:
            return RawReply(w.reply_bytes)
        return out

    def _try_cache_read(self, objects, clock, wants_bytes):
        """Hot-key fast path, ON the handler thread: when every object of
        an epoch-eligible read resolves from the snapshot cache (or is
        bottom at the epoch), the reply is served right here — no gate,
        no dispatcher hop, no device work.  Returns the reply or None.

        No epoch pin: this path touches only host-side structures (cache
        entries, directory, the epoch's used-rows snapshot) — never the
        frozen device buffers the pin protects."""
        if not self._epoch_reads:
            return None
        txm = self.node.txm
        store = txm.store
        ep = store.serving_epoch
        if ep is None:
            return None
        if int(ep.vc[txm.my_dc]) < txm.epoch_lag_counter:
            return None
        if clock is not None and not (clock <= ep.vc).all():
            return None
        vals = store.epoch_cache_read(objects, ep)
        if vals is None:
            return None
        vc_list = [int(x) for x in ep.vc]
        if wants_bytes:
            return RawReply(encode(MessageCode.READ_OBJECTS_RESP, {
                "values": [encode_value(v) for v in vals],
                "commit_clock": vc_list,
            }))
        return vals, vc_list

    def static_update(self, updates, clock, deadline=None, tenant=None):
        """Batched static update: commit VC (raises AbortError on cert).
        Parks DIRECTLY at the locked worker's merge point — the
        dispatcher stage only ever forwarded updates, and the extra
        queue hop + thread wakeup per write was measurable on the
        2-core write-plane floor."""
        tenant = self.tenants.resolve(tenant, (u[2] for u in updates))
        if not self.batch_static:
            with self._lock:
                check_deadline(deadline, "dispatch")
                return self.node.update_objects(updates, clock=_vc(clock))
        return self._submit(_StaticWork("update", updates=updates,
                                        clock=_vc(clock),
                                        deadline=deadline, tenant=tenant),
                            self._locked_q)

    def _submit(self, work: _StaticWork, q: Optional[TenantLanes] = None):
        """Park a work on a pipeline queue (default: the batch gate;
        interactive commits go straight to the locked-plane merge point
        — one hop fewer) and wait for its stage to reply.  Tenant
        discipline: the work enters its tenant's in-flight
        account (typed ``tenant_busy`` past a configured cap) and its
        tenant's bounded LANE — never the shared budget."""
        if self._closing:
            raise ConnectionError("server shutting down")
        if q is None:
            q = self._static_q
        tenant = self.tenants.label(work.tenant)
        m = self.metrics
        try:
            self.admission.tenant_enter(tenant)
        except TenantBusyError:
            m.shed.inc(plane="tenant")
            # tenant-label-ok: `tenant` is clamped by TenantRegistry.label
            m.tenant_shed.inc(tenant=tenant, plane="admission")
            raise
        now = time.monotonic()
        work.t_submit = now
        t0 = getattr(self._tls, "t0", None)
        if t0 is not None:
            m.stage_decode_seconds.observe(now - t0)
            self._tls.t0 = None
        try:
            try:
                # bounded gate: shed with a typed busy error instead of
                # parking behind an unbounded backlog
                q.put_nowait(work, tenant)
            except TenantBusyError:
                m.shed.inc(plane="tenant")
                # tenant-label-ok: clamped by TenantRegistry.label above
                m.tenant_shed.inc(
                    tenant=tenant,
                    plane=("batch_gate" if q is self._static_q
                           else "locked"))
                raise
            except (BusyError, queue.Full):
                m.shed.inc(plane="server_queue")
                raise BusyError(
                    f"static batch gate full ({q.maxsize} requests "
                    f"parked)",
                    retry_after_ms=100,
                ) from None
            if q is self._static_q:
                m.commit_gate_depth.set(q.qsize())
            if not work.event.wait(timeout=300):
                raise TimeoutError("static batch dispatcher stalled")
        finally:
            self.admission.tenant_exit(tenant)
            # tenant-label-ok: clamped by TenantRegistry.label above
            m.tenant_in_flight.set(
                self.admission.tenant_in_flight(tenant), tenant=tenant)
        # tenant-label-ok: clamped by TenantRegistry.label above
        m.tenant_request_seconds.observe(time.monotonic() - now,
                                         tenant=tenant)
        if work.error is not None:
            raise work.error
        return work.result

    def _drain_batch(self, q, window_s: float = 0.0):
        """Block for one work, drain whatever else queued (up to
        ``_batch_max``); with ``window_s`` keep gathering late arrivals
        up to that long (the --group-commit-window-us merge window).
        Returns (works, stop_seen)."""
        batch = [q.get()]
        deadline = (time.monotonic() + window_s) if window_s > 0 else None
        while len(batch) < self._batch_max:
            try:
                batch.append(q.get_nowait())
            except queue.Empty:
                if deadline is None:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(q.get(timeout=left))
                except queue.Empty:
                    break
        stop = any(w is _STOP for w in batch)
        return [w for w in batch if w is not _STOP], stop

    def _shed_expired(self, works, where: str, observe_parked=False):
        """Deadline discipline shared by both planes: work that outlived
        its caller while parked is aborted AT DEQUEUE — executing it
        would burn a device launch on a reply nobody is waiting for."""
        live: List[_StaticWork] = []
        now = time.monotonic()
        m = self.metrics
        for w in works:
            if observe_parked and w.t_submit:
                m.stage_parked_seconds.observe(now - w.t_submit)
            if w.deadline is not None and now > w.deadline:
                m.shed.inc(plane="deadline")
                w.error = DeadlineExceeded(
                    f"request deadline passed while parked at the "
                    f"{where}; not executed")
                w.event.set()
            else:
                live.append(w)
        return live

    @staticmethod
    def _fail_queue_remainder(q) -> None:
        """Shutdown drain: fail anything that raced the stop sentinel
        into the queue — a handler parked behind it must not wait out
        its submit timeout."""
        while True:
            try:
                w = q.get_nowait()
            except queue.Empty:
                return
            if w is not _STOP:
                w.error = ConnectionError("server shutting down")
                w.event.set()

    def _static_loop(self):
        """The DISPATCHER stage of the serving pipeline: drain whatever
        queued while the previous group executed, LAUNCH merged epoch
        reads lock-free (device handles go to the writeback stage — this
        thread never blocks on the device), and forward everything else
        to the locked-plane worker.  Natural batching — no gather delay:
        at low load a lone request runs immediately; under load the
        batch grows to whatever queued during the previous launch, and
        batch N+1 is being decoded by handler threads while batch N
        executes on device and batch N-1's replies are serialized by the
        writeback worker."""
        q = self._static_q
        m = self.metrics
        while True:
            works, stop = self._drain_batch(q)
            m.commit_gate_depth.set(q.qsize())
            works = self._shed_expired(works, "batch gate",
                                       observe_parked=True)
            try:
                reads = [w for w in works if w.kind == "read"]
                rest = [w for w in works if w.kind != "read"]
                if reads and self._epoch_reads:
                    # lock-split: reads pinned at/below the published
                    # serving epoch never park behind a commit group
                    t0 = time.monotonic()
                    reads = self._launch_epoch_reads(reads)
                    m.stage_launch_seconds.observe(time.monotonic() - t0)
                # updates and unservable reads go to the locked-plane
                # worker: a commit group (or the compile hiding inside
                # one) never parks the dispatcher's launch stage.
                # path=locked counts only reads actually enqueued — a
                # queue-full shed is not a served read (a rerouted
                # work's already-launched objects still show under
                # gather: a real, if wasted, launch)
                for w in rest + reads:
                    try:
                        self._locked_q.put_nowait(
                            w, self.tenants.label(w.tenant))
                    except TenantBusyError as e:
                        m.shed.inc(plane="tenant")
                        # tenant-label-ok: clamped via TenantRegistry.label
                        m.tenant_shed.inc(tenant=e.tenant, plane="locked")
                        w.error = e
                        w.event.set()
                        continue
                    except (BusyError, queue.Full):
                        m.shed.inc(plane="server_queue")
                        w.error = BusyError(
                            f"static batch gate full (locked plane: "
                            f"{self._locked_q.maxsize} parked)",
                            retry_after_ms=100)
                        w.event.set()
                        continue
                    if w.kind == "read":
                        m.serving_reads.inc(len(w.objects), path="locked")
            except BaseException as e:  # never strand a parked connection
                for w in works:
                    if not w.event.is_set():
                        w.error = e
                        w.event.set()
            if stop:
                self._locked_q.put(_STOP)
                self._fail_queue_remainder(q)
                return

    def _locked_loop(self):
        """The LOCKED plane's worker — and the write plane's MERGE POINT
       : static update groups and interactive COMMITs arriving
        on different connections drain into ONE merged batch that takes
        the commit lock once, certifies once, appends once and scatters
        once, with per-source acks fanned back out.  Also serves the
        reads the epoch path cannot (clocks ahead of the epoch,
        composite maps, promoted keys, no epoch yet).  Runs under
        ``self._lock`` — serialized against nothing but itself and
        inline (batch_static off) dispatch; the epoch read plane never
        waits for it."""
        q = self._locked_q
        while True:
            works, stop = self._drain_batch(q, self._group_window_s)
            # re-checked at THIS dequeue too (the overload contract at
            # the merge point): a work can expire while parked behind a
            # slow commit group — this plane's whole job is absorbing
            # those.  Write works park here directly (no dispatcher
            # hop), so this dequeue also owns their parked-stage clock;
            # rerouted reads were already observed at the batch gate.
            writes = self._shed_expired(
                [w for w in works if w.kind != "read"], "locked plane",
                observe_parked=True)
            reads = self._shed_expired(
                [w for w in works if w.kind == "read"], "locked plane")
            try:
                ups = [w for w in writes if w.kind == "update"]
                commits = [w for w in writes if w.kind == "commit"]
                with self._lock:
                    # writes first: the merged read then serves at a
                    # snapshot covering them (fresh + cache friendly)
                    if ups or commits:
                        self._run_commit_merge(ups, commits)
                    if reads:
                        self._run_read_group(reads)
            except BaseException as e:  # never strand a parked connection
                for w in works:
                    if not w.event.is_set():
                        w.error = e
                        w.event.set()
            if stop:
                self._fail_queue_remainder(q)
                return

    # ------------------------------------------------------------------
    # lock-split epoch reads (dispatcher launch stage)
    # ------------------------------------------------------------------
    def _launch_epoch_reads(
            self, works: List[_StaticWork]) -> List[_StaticWork]:
        """Launch epoch-eligible read works as merged lock-free gathers
        against the frozen serving epoch (async dispatch only — never a
        device sync) and hand the device handles to the writeback stage.
        Returns the works that must take the locked path: clocks ahead
        of the epoch, objects the epoch cannot serve (composite maps,
        promoted keys, unfrozen tables), or no epoch at all."""
        leftover: List[_StaticWork] = []
        for chunk in self._chunk_epoch_works(works):
            leftover.extend(self._launch_epoch_chunk(chunk))
        return leftover

    def _launch_epoch_chunk(
            self, works: List[_StaticWork]) -> List[_StaticWork]:
        """One bounded launch chunk: pin the epoch, classify, launch ONE
        merged gather, enqueue for writeback.  Returns locked-path works."""
        txm = self.node.txm
        store = txm.store
        ep = store.pin_serving_epoch()
        if ep is None:
            return works
        # a clockless read must still see every locally-ACKED commit.
        # Commit groups publish BEFORE replying, so acked == covered —
        # except across a deferred/failed publish, which raises the lag
        # floor; an epoch below the floor cannot serve clockless reads.
        # (Deliberately NOT commit_counter: a commit minted mid-flight
        # has not acked yet, and gating on it would park reads behind
        # every in-flight commit — the convoy this plane removes.)
        if int(ep.vc[txm.my_dc]) < txm.epoch_lag_counter:
            store.unpin_serving_epoch(ep)
            return works
        merged: List[_StaticWork] = []
        locked: List[_StaticWork] = []
        for w in works:
            if w.clock is None or (w.clock <= ep.vc).all():
                merged.append(w)
            else:
                locked.append(w)
        if not merged:
            store.unpin_serving_epoch(ep)
            return works
        objs: list = []
        spans = []
        for w in merged:
            spans.append((len(objs), len(objs) + len(w.objects)))
            objs.extend(w.objects)
        try:
            pending, fallback = store.epoch_read_launch(objs, ep)
        except BaseException:
            store.unpin_serving_epoch(ep)
            log.exception("epoch read launch failed; locked fallback")
            return works
        keep, kspans = merged, spans
        if fallback:
            fb = set(fallback)
            keep, kspans = [], []
            for w, (lo, hi) in zip(merged, spans):
                if fb.isdisjoint(range(lo, hi)):
                    keep.append(w)
                    kspans.append((lo, hi))
                else:
                    # a work with ANY unservable object reroutes whole —
                    # its launched siblings' results are simply dropped
                    locked.append(w)
        if not keep:
            store.unpin_serving_epoch(ep)
            return locked
        vc_list = [int(x) for x in ep.vc]
        # bounded handoff: a lagging writeback stage backpressures this
        # dispatcher (and through the bounded gate, the clients)
        self._writeback_q.put(_EpochReadBatch(pending, keep, kspans,
                                              vc_list))
        return locked

    #: merged epoch-read launches are chunked at this many objects, so a
    #: saturated gate hands the writeback stage bounded batches and the
    #: first replies of a burst are not held behind its last objects
    EPOCH_LAUNCH_CHUNK = 512

    def _chunk_epoch_works(self, works: List[_StaticWork]):
        """Split eligible works into launch chunks of ≤ EPOCH_LAUNCH_CHUNK
        total objects (a single oversized work still gets its own
        chunk)."""
        chunk: List[_StaticWork] = []
        n = 0
        for w in works:
            if chunk and n + len(w.objects) > self.EPOCH_LAUNCH_CHUNK:
                yield chunk
                chunk, n = [], 0
            chunk.append(w)
            n += len(w.objects)
        if chunk:
            yield chunk

    def _writeback_loop(self):
        """The WRITEBACK stage: the only pipeline stage allowed to block
        on the device.  Materializes launched epoch-read batches, decodes
        values (back-filling the hot-key snapshot cache), serializes the
        native reply frames in one tight loop, and wakes the parked
        handler threads."""
        q = self._writeback_q
        m = self.metrics
        while True:
            batch = q.get()
            if batch is _STOP:
                return
            store = self.node.txm.store
            t0 = time.monotonic()
            try:
                # the writeback stage owns the device sync
                vals = store.epoch_read_finish(batch.pending)
                for w, (lo, hi) in zip(batch.works, batch.spans):
                    w.result = (vals[lo:hi], batch.vc_list)
                    if w.wants_bytes:
                        w.reply_bytes = encode(
                            MessageCode.READ_OBJECTS_RESP, {
                                "values": [encode_value(v)
                                           for v in vals[lo:hi]],
                                "commit_clock": batch.vc_list,
                            })
                    w.event.set()
            except BaseException as e:
                log.exception("epoch read writeback failed")
                for w in batch.works:
                    if not w.event.is_set():
                        w.error = e
                        w.event.set()
            finally:
                store.unpin_serving_epoch(batch.pending.ep)
                m.stage_writeback_seconds.observe(time.monotonic() - t0)

    # ------------------------------------------------------------------
    # serving-epoch ticker (dedicated publication thread)
    # ------------------------------------------------------------------
    #: per-table cadence of the LOCKED path's epoch ladder
    #: (TypedTable.publish_epoch full-head copies)
    TABLE_EPOCH_S = 2.0
    #: at most this many full-head table publishes per tick — the
    #: per-tick publication cost cap (a tick can no longer stall the
    #: pipeline for one whole-store copy sweep)
    TABLE_EPOCHS_PER_TICK = 1

    def _epoch_ticker(self):
        """Publishes serving epochs on a fixed cadence so an
        interactive-txn-only (or remote-ingress-only) workload still gets
        fresh epochs — commit groups publish inline before their acks,
        the ticker covers everything else (including deferred-publish
        retries).  Runs OFF the dispatcher thread: a publication tick can
        never stall a parked read batch (reads don't take the lock the
        publish holds)."""
        txm = self.node.txm
        # with the epoch plane off, the ticker still drives the table
        # ladder — at a relaxed cadence (the ladder's own per-table
        # cadence is TABLE_EPOCH_S anyway)
        tick = (max(float(self.epoch_tick_ms), 1.0) / 1e3
                if self._epoch_reads else 0.5)
        while not self._ticker_stop.wait(tick):
            try:
                if self._epoch_reads:
                    txm.publish_serving_epoch()
                    self._native_advance()
                self._publish_table_epochs_capped()
            except Exception:
                log.exception("epoch ticker publish failed")

    def _publish_table_epochs_capped(self) -> int:
        """The locked path's per-table epoch ladder (read-while-write
        double buffer for clock-pinned reads), budgeted: at most
        ``TABLE_EPOCHS_PER_TICK`` full-head copies per tick, each table
        at most every ``TABLE_EPOCH_S``.  A table publishes only when new
        commits landed AND some read actually took the slow path since
        its last publish — (a) alone copies heads for workloads that
        never fold, (b) alone is satisfied forever by one old historical
        read.  Returns the number of tables published."""
        txm = self.node.txm
        store = txm.store
        budget = self.TABLE_EPOCHS_PER_TICK
        published = 0
        now = time.monotonic()
        with txm.commit_lock:
            # least-recently-published first: with more continuously-
            # eligible tables than budget slots per cadence window, a
            # fixed scan order would starve the tables at the tail of
            # the dict forever
            tables = sorted(store.tables.values(),
                            key=lambda t: getattr(t, "_pub_at", 0.0))
            for t in tables:
                if budget == 0:
                    break
                if (t.slow_serves != getattr(t, "_pub_slow_serves", -1)
                        and store.mutation_epoch != getattr(t, "_pub_mut",
                                                            -1)
                        and now - getattr(t, "_pub_at", 0.0)
                        >= self.TABLE_EPOCH_S):
                    t._pub_slow_serves = t.slow_serves
                    t._pub_mut = store.mutation_epoch
                    t._pub_at = now
                    t.publish_epoch()
                    budget -= 1
                    published += 1
        return published

    def _run_read_group(self, works: List[_StaticWork]) -> None:
        # requests whose causal clock is already covered locally merge
        # into ONE snapshot read; a clock AHEAD of local replication (or
        # bogus) must WAIT inside start_transaction — running it solo
        # keeps one slow client from head-of-line-blocking the batch.
        covered = self._covered_vc()
        merged, solo = [], []
        for w in works:
            if w.clock is None or (w.clock <= covered).all():
                merged.append(w)
            else:
                solo.append(w)
        if merged:
            clock = None
            for w in merged:
                if w.clock is not None:
                    clock = (w.clock if clock is None
                             else np.maximum(clock, w.clock))
            objs: list = []
            offs = [0]
            for w in merged:
                objs.extend(w.objects)
                offs.append(len(objs))
            try:
                vals, vc = self.node.read_objects(objs, clock=clock)
                for i, w in enumerate(merged):
                    w.result = (vals[offs[i]:offs[i + 1]], vc)
                    w.event.set()
            except Exception:
                solo = merged + solo  # isolate the offender
        for w in solo:
            if w.event.is_set():
                continue
            try:
                w.result = self.node.read_objects(w.objects, clock=w.clock)
            except Exception as e:
                w.error = e
            w.event.set()

    def _covered_vc(self):
        """Freshest locally-covered clock (entry-wise)."""
        txm = self.node.txm
        vc = txm.store.dc_max_vc().copy()
        vc[txm.my_dc] = max(int(vc[txm.my_dc]), txm.commit_counter)
        return vc

    def _run_commit_merge(self, ups: List[_StaticWork],
                          commits: List[_StaticWork]) -> None:
        """The write plane's merge point: static update groups
        AND interactive COMMITs from different connections fuse into ONE
        ``commit_transactions_group`` call — one commit-lock take, one
        certification pass, one WAL append, one device scatter — with
        per-source results fanned back out (a member's failure-atomic
        rollback rolls back only its own sub-group)."""
        txm = self.node.txm
        # resolve interactive commit works to their registered txns
        # (self._lock is held by the locked worker)
        inter: List = []
        for w in commits:
            txn = self._txns.get(w.txid)
            if txn is None or not txn.active:
                w.error = KeyError(
                    f"unknown or finished transaction {w.txid}")
                w.event.set()
                continue
            inter.append((w, txn))
        pending = list(ups)
        first = True
        # Static group members share a snapshot, so two read-bearing
        # writes to one hot key first-committer-abort each other — a
        # conflict the pre-batch serial path could never produce (each
        # request's snapshot followed the previous commit).  Losers
        # retry as a FOLLOW-UP GROUP at a fresh snapshot (≥1 winner per
        # round → ≤N rounds, still one device append per round) —
        # equivalent to some serial interleaving, so no spurious abort
        # escapes to a client.  (Blind commutative updates bypass
        # certification entirely and never enter this loop's retries.)
        # Interactive commits ride the FIRST round only: their abort is
        # the client's to observe, never auto-retried.
        while pending or (first and inter):
            staged = []
            for w in pending:
                # re-check per-work deadlines at every retry round: a
                # conflict-retry loop under load must not keep executing
                # work whose caller has already timed out
                if (w.deadline is not None
                        and time.monotonic() > w.deadline):
                    self.metrics.shed.inc(plane="deadline")
                    w.error = DeadlineExceeded(
                        "request deadline passed before commit; "
                        "not executed")
                    w.event.set()
                    continue
                try:
                    txn = txm.start_transaction(w.clock)
                    try:
                        txm.update_objects(w.updates, txn)
                    except Exception:
                        txm.abort_transaction(txn)
                        raise
                    staged.append((w, txn))
                except Exception as e:
                    w.error = e
                    w.event.set()
            batch = staged + (inter if first else [])
            first = False
            if not batch:
                return
            try:
                outs = txm.commit_transactions_group(
                    [t for _, t in batch])
            except Exception as e:
                for w, txn in batch:
                    # a backlog-shed group comes back with its txns
                    # still OPEN — server-created static txns must be
                    # aborted here (their clients only see the error
                    # reply); an interactive holder's txn stays open on
                    # BusyError so the SAME commit is retryable, and on
                    # any other failure the _process wrapper unregisters
                    # the (now closed) txn
                    if w.kind == "update" and txn.active:
                        txm.abort_transaction(txn)
                    w.error = e
                    w.event.set()
                return
            retry = []
            for (w, txn), r in zip(batch, outs):
                if isinstance(r, AbortError) and w.kind == "update":
                    retry.append(w)
                elif isinstance(r, Exception):
                    w.error = r
                    w.event.set()
                else:
                    w.result = r
                    w.event.set()
            pending = retry

    # ------------------------------------------------------------------
    def _process(self, code: MessageCode, body: Any):
        # per-request deadline: client-supplied relative ``deadline_ms``
        # (native dialect only), else the configured server default.
        # Work that outlives it while queued is aborted at dequeue.
        deadline = deadline_from_ms(
            body.get("deadline_ms") if isinstance(body, dict) else None,
            self.default_deadline_ms,
        )
        # static ops route through the gate helpers OUTSIDE the lock (the
        # gate's dispatcher takes it; with batching off they lock inline)
        # — the ONLY static dispatch path, so it cannot drift from a
        # duplicate
        if code == MessageCode.STATIC_READ_OBJECTS:
            objs = _decode_objects(body["objects"])
            out = self.static_read(
                objs, body.get("clock"),
                deadline=deadline, wants_bytes=True,
                tenant=body.get("tenant"),
            )
            if isinstance(out, RawReply):
                # batched reply serialization: the writeback stage framed
                # the response; the handler sends the bytes as-is
                return MessageCode.READ_OBJECTS_RESP, out
            vals, vc = out
            return MessageCode.READ_OBJECTS_RESP, {
                "values": [encode_value(v) for v in vals],
                "commit_clock": [int(x) for x in vc],
            }
        if code == MessageCode.STATIC_UPDATE_OBJECTS:
            vc = self.static_update(
                _decode_updates(body["updates"]), body.get("clock"),
                deadline=deadline, tenant=body.get("tenant"),
            )
            return MessageCode.COMMIT_RESP, {
                "commit_clock": [int(x) for x in vc]
            }
        if code == MessageCode.COMMIT_TRANSACTION and self.batch_static:
            # interactive commits join the cross-connection merge point:
            # instead of serializing through the dispatch
            # lock one at a time, the commit parks at the locked
            # worker and fuses with whatever static updates and OTHER
            # connections' commits drained in the same batch
            txid = body["txid"]
            # an interactive commit's tenant comes from its buffered
            # writeset's buckets (the txn was started tag-free)
            with self._lock:
                txn = self._txns.get(txid)
            tenant = self.tenants.resolve(
                body.get("tenant"),
                (e.bucket for e, _ in getattr(txn, "writeset", ()) or ()))
            w = _StaticWork("commit", deadline=deadline, txid=txid,
                            tenant=tenant)
            try:
                vc = self._submit(w, self._locked_q)
            except BusyError:
                # the txn stays OPEN and registered: the busy reply's
                # retry-after hint is honest — the SAME commit can be
                # resubmitted (manager backlog-shed semantics)
                raise
            except BaseException:
                # unregister AND abort-if-still-open: a work shed at
                # the merge-point dequeue (deadline, queue overflow,
                # shutdown) never reached the commit group, so the txn
                # is still ACTIVE — popping it without aborting would
                # orphan an open txn nothing can reach, pinning the
                # certification-GC floor forever
                with self._lock:
                    txn = self._txns.pop(txid, None)
                if txn is not None and txn.active:
                    self.node.abort_transaction(txn)
                raise
            with self._lock:
                self._txns.pop(txid, None)
            return MessageCode.COMMIT_RESP, {
                "commit_clock": [int(x) for x in vc]
            }
        if code == MessageCode.REPLICA_ADMIN:
            # the follower-replica registry lives on the replica plane,
            # which this package has not: the JAX server's reply to a
            # node started without one, word for word
            raise RuntimeError("no replica plane attached (start "
                               "with --interdc or --follower-of)")
        if code == MessageCode.CHECKPOINT_NOW:
            # admin op, OUTSIDE the dispatch lock: the checkpointer has
            # its own serialization, and streaming a multi-second image
            # while holding the dispatch lock would park the locked
            # plane behind an operator command
            return MessageCode.OPERATION_RESP, {
                "checkpoint": self.node.checkpoint_now()
            }
        with self._lock:
            # deadline re-checked at dequeue (= after the lock convoy):
            # a request that outlived its caller is not executed
            try:
                check_deadline(deadline, "dispatch")
            except DeadlineExceeded:
                self.metrics.shed.inc(plane="deadline")
                raise
            return self._dispatch(code, body)

    def _dispatch(self, code: MessageCode, body: Any):
        node = self.node
        if code == MessageCode.START_TRANSACTION:
            txn = node.start_transaction(
                clock=_vc(body.get("clock")), props=body.get("props"),
            )
            self._txns[txn.txid] = txn
            return MessageCode.START_TRANSACTION_RESP, {"txid": txn.txid}
        if code == MessageCode.READ_OBJECTS:
            txn = self._txn(body["txid"])
            vals = node.read_objects(_decode_objects(body["objects"]), txn)
            return MessageCode.READ_OBJECTS_RESP, {
                "values": [encode_value(v) for v in vals]
            }
        if code == MessageCode.UPDATE_OBJECTS:
            txn = self._txn(body["txid"])
            try:
                node.update_objects(_decode_updates(body["updates"]), txn)
            except AbortError:
                self._txns.pop(body["txid"], None)
                raise
            return MessageCode.OPERATION_RESP, {"ok": True}
        if code == MessageCode.COMMIT_TRANSACTION:
            # keep the txn registered until the outcome is known: a
            # commit-backlog BusyError leaves it OPEN (the shed happens
            # before the group touches it), so the busy reply's retry
            # hint is honest — the SAME commit can be resubmitted
            txn = self._txn(body["txid"])
            try:
                commit_vc = node.commit_transaction(txn)
            except BusyError:
                raise
            except BaseException:
                self._txns.pop(body["txid"], None)  # txn is dead
                raise
            self._txns.pop(body["txid"], None)
            return MessageCode.COMMIT_RESP, {
                "commit_clock": [int(x) for x in commit_vc]
            }
        if code == MessageCode.ABORT_TRANSACTION:
            txn = self._txns.pop(body["txid"])
            node.abort_transaction(txn)
            return MessageCode.OPERATION_RESP, {"ok": True}
        if code == MessageCode.GET_CONNECTION_DESCRIPTOR:
            return MessageCode.OPERATION_RESP, {
                "descriptor": self._get_descriptor(),
            }
        if code == MessageCode.CONNECT_TO_DCS:
            self._connect_to_dcs(body.get("descriptors", []))
            return MessageCode.OPERATION_RESP, {"ok": True}
        if code == MessageCode.CREATE_DC:
            self._create_dc(body.get("nodes", []))
            return MessageCode.OPERATION_RESP, {"ok": True}
        if code == MessageCode.NODE_STATUS:
            status = node.status(
                include_ready=bool(body.get("include_ready"))
            )
            # the server's own admission plane rides along (the node
            # object can't see it)
            status.setdefault("overload", {}).update({
                "in_flight": self.admission.in_flight(),
                "max_in_flight": self.admission.max_in_flight,
                "max_in_flight_per_client": self.admission.max_per_client,
                "batch_gate_depth": self._static_q.qsize(),
                "batch_gate_max": self._static_q.maxsize,
            })
            status["pipeline"] = self._pipeline_status()
            status["tenants"] = self._tenant_status()
            return MessageCode.OPERATION_RESP, {"status": status}
        raise ValueError(f"unhandled message code {code!r}")

    def _txn(self, txid: int) -> Transaction:
        txn = self._txns.get(txid)
        if txn is None:
            raise KeyError(f"unknown or finished transaction {txid}")
        return txn

    # ------------------------------------------------------------------
    # DC management (antidote_pb_process:process create_dc /
    # get_connection_descriptor / connect_to_dcs clauses) — shared by both
    # wire dialects.  Without inter-DC replication a node has no
    # descriptor and subscribes to no DC: the JAX server's replies to a
    # node started without a replica, word for word.
    # ------------------------------------------------------------------
    def _get_descriptor(self) -> dict:
        raise RuntimeError("no inter-DC replica attached")

    def _connect_to_dcs(self, descriptors) -> None:
        raise RuntimeError("no inter-DC replica attached")

    def _create_dc(self, nodes) -> None:
        """The reference assembles a riak cluster from ``nodes`` here;
        this build's DC is assembled at boot (console serve /
        cluster.boot ctl_wire), so a single-node list is acknowledged
        (the DC exists) and a multi-node list is refused with the
        operator path, matching create_dc's error reply shape."""
        if len(nodes) > 1:
            raise RuntimeError(
                "create_dc_failed: multi-member DCs assemble via "
                "cluster.boot + ctl_wire, not the client protocol"
            )

    # ------------------------------------------------------------------
    def _tenant_status(self) -> dict:
        """Per-tenant QoS block for node status: configured
        weight/caps plus live in-flight, lane depths and typed-shed
        odometers — the block that makes noisy-neighbor interference
        observable before anyone's p99 says so."""
        gate = self._static_q.status()
        locked = self._locked_q.status()
        out = {"multi": self.tenants.multi, "tenants": {}}
        for name in self.tenants.names:
            spec = self.tenants.spec(name)
            out["tenants"][name] = {
                "weight": spec.weight,
                "max_in_flight": spec.max_in_flight,
                "in_flight": self.admission.tenant_in_flight(name),
                "batch_gate": gate.get(name, {}),
                "locked": locked.get(name, {}),
            }
        return out

    # ------------------------------------------------------------------
    def _pipeline_status(self) -> dict:
        """Stage-timing + serving-plane block for node status — the
        server-side breakdown the wire bench freezes into its artifact
        (decode / parked / launch / writeback µs per stage)."""
        m = self.metrics

        def us(h):
            s = h.summary()
            return {
                "count": s["count"],
                "sum_ms": round(s["count"] * s["mean"] * 1e3, 3),
                "mean_us": round(s["mean"] * 1e6, 1),
                "p50_us": round(s["p50"] * 1e6, 1),
                "p99_us": round(s["p99"] * 1e6, 1),
            }

        out = {
            "epoch_reads": self._epoch_reads,
            "stages": {
                "decode": us(m.stage_decode_seconds),
                "parked": us(m.stage_parked_seconds),
                "launch": us(m.stage_launch_seconds),
                "writeback": us(m.stage_writeback_seconds),
            },
            "reads": {
                path[0]: int(v)
                for path, v in sorted(m.serving_reads.snapshot().items())
            },
            "snapshot_cache": {
                ev[0]: int(v)
                for ev, v in sorted(m.snapshot_cache.snapshot().items())
            },
            "epoch_publish": {
                mode[0]: int(v)
                for mode, v in sorted(m.epoch_publish.snapshot().items())
            },
            "serving_epoch_id": int(m.serving_epoch_id.value()),
            "writeback_depth": self._writeback_q.qsize(),
            "locked_depth": self._locked_q.qsize(),
            "group_commit_window_us": round(self._group_window_s * 1e6, 1),
        }
        if self.native is not None:
            out["native"] = self.native.stats()
        store = self.node.txm.store
        out["snapshot_cache"]["size"] = len(store.snapshot_cache)
        out["snapshot_cache"]["cap"] = store.snapshot_cache_cap
        out["materializer"] = store.materializer_status()
        return out

    # ------------------------------------------------------------------
    def is_alive(self) -> bool:
        """Supervision probe (supervise.Supervisor child health)."""
        return self._thread.is_alive()

    def close(self) -> None:
        self._closing = True
        self._ticker_stop.set()
        self._server.shutdown()
        self._server.server_close()
        if self.native is not None:
            # unwire the mirror FIRST: the store must stop pushing into a
            # handle about to be stopped
            store = self.node.txm.store
            if store.native_mirror is self.native:
                store.native_mirror = None
            self.native.close()
            if self._native_drain is not None:
                self._native_drain.join(timeout=5)
        if self.batch_static:
            # the gate is bounded now: a full queue + wedged dispatcher
            # must not turn close() into a forever-blocking put
            stop_by = time.monotonic() + 5.0
            while True:
                try:
                    self._static_q.put_nowait(_STOP)
                    break
                except queue.Full:
                    if time.monotonic() >= stop_by:
                        break  # dispatcher wedged; it is a daemon thread
                    time.sleep(0.05)
            self._batcher.join(timeout=5)
            # stop the writeback stage AFTER the dispatcher: in-flight
            # launched batches still get materialized and replied.
            # Fresh grace window — the gate put loop + batcher join may
            # have consumed the earlier one entirely, and giving up on
            # the first Full would drop in-flight replies.
            stop_by = time.monotonic() + 5.0
            while True:
                try:
                    self._writeback_q.put_nowait(_STOP)
                    break
                except queue.Full:
                    if time.monotonic() >= stop_by:
                        break
                    time.sleep(0.05)
            self._writeback.join(timeout=5)
            # the dispatcher's stop path forwarded _STOP to the locked
            # worker; it drains whatever raced in behind the sentinel
            self._locked_worker.join(timeout=5)
            self._ticker.join(timeout=5)
        self._thread.join(timeout=5)
