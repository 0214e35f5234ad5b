"""TCP inter-DC fabric — real sockets between replicas.

Two inter-DC channels over plain TCP with length-prefixed frames: each DC
runs one endpoint socket; peers open one connection for the subscription
stream (the server pushes frames) and one for synchronous queries (log
catch-up, bounded-counter grants, liveness checks).

Interface-compatible with ``LoopbackHub``: incoming stream messages are
queued and delivered on ``pump()``, so replica state is only touched from
the pumping thread; query/request handlers run on server threads under the
DC's handler lock.  The receive side of every subscription belongs to the
native pump (``native_pump``), which raises rather than falls back when
it cannot run; the operator's ``ANTIDOTE_NATIVE_PUMP=off`` gives one
Python reader thread per subscription.
"""

from __future__ import annotations

import collections
import logging
import queue
import random
import socket
import socketserver
import time
import struct
import threading
from typing import Callable, Dict, List, Optional, Tuple

import msgpack

from antidote_tpu_torch import faults
from antidote_tpu_torch.interdc.native_pump import NativePump
from antidote_tpu_torch.obs.metrics import net_metrics
from antidote_tpu_torch.supervise import ThreadLoop

log = logging.getLogger(__name__)

_HDR = struct.Struct(">IB")
K_SUB, K_PUSH, K_LOGQ, K_REQ, K_REPLY, K_ERR = 1, 2, 3, 4, 5, 6
#: native-pump sentinel (pump.cc K_CONN_DROP): a subscription stream
#: died; resubscribe instead of delivering
K_CONN_DROP = 0


def _frame(kind: int, body) -> bytes:
    payload = msgpack.packb(body, use_bin_type=True)
    return _HDR.pack(len(payload) + 1, kind) + payload


def _send(sock, kind: int, body) -> None:
    sock.sendall(_frame(kind, body))


def _recv(sock) -> Tuple[int, object]:
    hdr = _read_exact(sock, _HDR.size)
    n, kind = _HDR.unpack(hdr)
    payload = _read_exact(sock, n - 1)
    return kind, msgpack.unpackb(payload, raw=False, strict_map_key=False)


def _read_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _hard_close(sock) -> None:
    """shutdown + close.  A bare close() while ANOTHER thread is parked
    in recv() on the socket never sends the FIN — the in-flight syscall
    keeps the kernel file alive — so the peer would never learn the
    connection died.  shutdown() tears the stream down immediately and
    wakes the parked reader."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class _Subscriber:
    """One subscription stream's sender side: a BOUNDED outbox drained
    by a dedicated writer thread.

    The old design wrote frames synchronously from ``push()`` under a
    per-stream lock — one stalled subscriber could park the publisher's
    COMMIT path for the full SO_SNDTIMEO window, and the kernel socket
    buffer was the only bound.  Now ``push()`` never blocks: past the
    outbox cap the frame is dropped for THIS subscriber only (counted in
    ``antidote_interdc_egress_window_drops_total``) and the subscriber
    heals through the opid-gap catch-up path — the same repair that
    covers a severed link, so a lagging peer costs a bounded outbox, not
    unbounded publisher memory."""

    #: frames parked per lagging subscriber before drops begin; sized so
    #: a normal pump hiccup (GC pause, one slow device launch) rides
    #: through, while a wedged peer caps out in ~1 MB of small frames
    OUTBOX_MAX = 1024
    _CLOSE = object()

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.outbox: "queue.Queue" = queue.Queue(maxsize=self.OUTBOX_MAX)
        self._thread: Optional[threading.Thread] = None

    def start(self, on_dead: Callable[["_Subscriber"], None]) -> None:
        self._thread = threading.Thread(
            target=self._writer, args=(on_dead,), daemon=True,
            name=f"interdc-egress:{self.sock.fileno()}")
        self._thread.start()

    #: frames one send carries at most: a heartbeat's burst (a ping for
    #: every shard of the publisher) leaves in a few system calls, not in
    #: one a frame
    SEND_BATCH = 256

    def _writer(self, on_dead) -> None:
        while True:
            item = self.outbox.get()
            frames = []
            while item is not self._CLOSE:
                frames.append(_frame(K_PUSH, item))
                if len(frames) >= self.SEND_BATCH:
                    break
                try:
                    item = self.outbox.get_nowait()
                except queue.Empty:
                    break
            if frames:
                try:
                    self.sock.sendall(b"".join(frames))
                except OSError:  # dead, or stalled past SO_SNDTIMEO
                    on_dead(self)
                    return
            if item is self._CLOSE:
                return

    def offer(self, data: bytes) -> bool:
        """Queue one frame; False = outbox full, frame dropped."""
        try:
            self.outbox.put_nowait(data)
            return True
        except queue.Full:
            return False

    def stop(self) -> None:
        try:
            self.outbox.put_nowait(self._CLOSE)
        except queue.Full:
            pass  # writer will exit on the closed socket's send error


class _Endpoint:
    """One DC's listening side: accepts subscriber streams and queries."""

    def __init__(self, fabric: "TcpFabric", dc_id: int, host: str, port: int):
        self.fabric = fabric
        self.dc_id = dc_id
        self.lock = threading.RLock()          # guards handler invocations
        self.query_handler: Optional[Callable] = None
        self.request_handler: Optional[Callable] = None
        #: live subscription streams (each a _Subscriber with its own
        #: bounded outbox + writer thread); _subs_lock guards membership
        self._subs: List[_Subscriber] = []
        self._subs_lock = threading.Lock()
        #: live query/request connections (server side): close() must
        #: shut these down too, or a killed endpoint would keep serving
        #: RPCs through parked handler threads
        self._queries: set = set()
        ep = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                try:
                    kind, body = _recv(self.request)
                except (ConnectionError, OSError):
                    return
                if kind == K_SUB:
                    # a send-only timeout (SO_SNDTIMEO) bounds how long
                    # one stalled subscriber can wedge its WRITER THREAD
                    # (not the publisher — push() never blocks); reads
                    # (the park loop below) are unaffected
                    self.request.setsockopt(
                        socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                        struct.pack("ll", 10, 0),
                    )
                    # register BEFORE the ack, start the writer AFTER it:
                    # a publish racing registration only enqueues, and the
                    # outbox preserves order — so the ack is always the
                    # stream's first frame, and once subscribe() returns
                    # every later publish sees the subscriber
                    entry = _Subscriber(self.request)
                    with ep._subs_lock:
                        ep._subs.append(entry)
                    try:
                        _send(self.request, K_REPLY, "subscribed")
                    except OSError:
                        ep._drop_sub(entry)
                        return
                    entry.start(ep._drop_sub)
                    # park until the peer closes (reads detect EOF)
                    try:
                        while self.request.recv(1):
                            pass
                    except OSError:
                        pass
                    ep._drop_sub(entry)
                    entry.stop()
                    return
                # query connection: serve request/reply until EOF
                with ep._subs_lock:
                    ep._queries.add(self.request)
                try:
                    while True:
                        try:
                            reply = ep._serve(kind, body)
                            _send(self.request, K_REPLY, reply)
                            kind, body = _recv(self.request)
                        except (ConnectionError, OSError):
                            return
                        except Exception as e:
                            try:
                                _send(self.request, K_ERR, repr(e))
                                kind, body = _recv(self.request)
                            except (ConnectionError, OSError):
                                return
                finally:
                    with ep._subs_lock:
                        ep._queries.discard(self.request)

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"interdc:{dc_id}:{self.port}",
        )
        self._thread.start()

    def _serve(self, kind: int, body):
        if kind == K_LOGQ:
            # read-only (scans the replica's sent chain): lock-free, so a
            # catch-up query from a peer that is itself mid-pump can never
            # join a cross-DC lock cycle
            msgs = self.query_handler(
                body["shard"], body["origin"], body["from"]
            )
            return [bytes(m) for m in msgs]
        if kind == K_REQ:
            # mutates node state (e.g. a bcounter grant commits a txn):
            # excluded against this DC's pump by the handler lock
            with self.lock:
                return self.request_handler(body["kind"], body["payload"])
        raise ValueError(f"unknown frame kind {kind}")

    def _drop_sub(self, entry: _Subscriber) -> None:
        with self._subs_lock:
            if entry in self._subs:
                self._subs.remove(entry)
        try:
            entry.sock.close()
        except OSError:
            pass

    def push(self, data: bytes) -> None:
        """Fan one frame out to every subscriber WITHOUT blocking: each
        stream has a bounded outbox drained by its own writer thread.  A
        full outbox (lagging subscriber) drops the frame for that stream
        only — its opid-gap catch-up replays the loss from the log."""
        with self._subs_lock:
            conns = list(self._subs)
        for entry in conns:
            if not entry.offer(data):
                net_metrics().egress_window_drops.inc()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        with self._subs_lock:
            # _hard_close, not close(): the park/serve threads are
            # blocked in recv() on these sockets, and a bare close never
            # sends the FIN that tells subscribers the stream died
            for s in self._subs:
                _hard_close(s.sock)
                s.stop()
            self._subs.clear()
            for c in list(self._queries):
                _hard_close(c)
            self._queries.clear()


class TcpFabric:
    """LoopbackHub-compatible transport over real sockets.

    In-process it behaves like the hub (tests run 2-3 DCs on localhost);
    across processes, exchange ``address_of`` endpoints via descriptors and
    call ``connect_remote``.  The native pump is created first, so a pump
    that cannot run raises :class:`NativePumpUnavailable` before any
    endpoint or thread exists.
    """

    #: inbox high-water mark (frames parked for pump()); past it the
    #: Python readers shed — see ``inbox`` below
    INBOX_MAX = 16384

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 public_host: Optional[str] = None, reconnect: bool = True,
                 backoff_base: float = 0.05, backoff_max: float = 2.0,
                 max_reconnect_tries: Optional[int] = None):
        #: native receive plane (cpp/pump.cc): ONE epoll thread owns all
        #: subscription sockets — kernel reads + framing in C++.  None
        #: only under the operator's ANTIDOTE_NATIVE_PUMP=off (Python
        #: reader threads); otherwise raises NativePumpUnavailable
        self._np = NativePump.create()
        self.host = host
        #: fixed listen port for the FIRST registered endpoint (0 =
        #: ephemeral).  Deployments binding 0.0.0.0 need a publishable
        #: port — an ephemeral one can't be mapped through a container
        #: boundary or firewall
        self._bind_port = port
        #: address advertised in connection descriptors; a 0.0.0.0 bind
        #: address is meaningless to a REMOTE DC (it would connect to
        #: itself), so operators set the reachable name here.  It is
        #: substituted ONLY into exported Descriptors — local dialing
        #: (in-process subscribe/_rpc) keeps the bind address, which an
        #: external DNS/LB name may not hairpin back to
        self.public_host = public_host
        #: severed subscriptions re-dial with jittered exponential
        #: backoff in [backoff_base, backoff_max] seconds; None budget =
        #: keep trying until the fabric closes (the riak_core stance:
        #: links heal, processes don't give up on them)
        self.reconnect = reconnect
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.max_reconnect_tries = max_reconnect_tries
        self.endpoints: Dict[int, _Endpoint] = {}
        #: dc_id -> tick callback (deferred-heartbeat flush at pump)
        self._ticks: Dict[int, Callable] = {}
        #: dc_id -> flush callback, run when a pump batch ends (replicas
        #: settle the gate drains their deliveries owed)
        self._flushes: Dict[int, Callable] = {}
        #: per pumping thread: True while the frame being delivered has
        #: more frames of its batch behind it
        self._tl = threading.local()
        #: dc_id -> (host, port) dialable FROM THIS PROCESS
        self.addresses: Dict[int, Tuple[str, int]] = {}
        #: dc_id -> (host, port) to put in exported descriptors
        self.advertised: Dict[int, Tuple[str, int]] = {}
        #: subscriber-side inbox: (deliver, data) pairs await pump().
        #: BOUNDED — when the pump falls this far behind, readers shed
        #: the newest frames instead of buffering without limit; the
        #: per-chain opid gap the shed opens is closed by catch-up once
        #: the pump drains (antidote_interdc_ingress_shed_total counts)
        self.inbox: "queue.Queue" = queue.Queue(maxsize=self.INBOX_MAX)
        self._readers: List[threading.Thread] = []
        self._closed = False
        #: jitter source for reconnect backoff (NOT the fault plan's rng)
        self._rng = random.Random()
        #: native-pump handle lifecycle guard (the teardown race):
        #: close() could null + free the pump BETWEEN a pump
        #: thread's None-check and its take_batch/add call.  A plain
        #: mutex around the calls would serialize concurrent pumpers
        #: across the full blocking poll window, so instead callers
        #: REFCOUNT the handle (_np_enter/_np_exit) and close() waits
        #: under the condition until every in-flight native call drains
        #: before freeing — concurrency preserved, no use-after-free.
        self._np_cv = threading.Condition()
        self._np_users = 0
        self._np_tags: Dict[int, Callable] = {}
        self._np_next = 1
        #: decoded frames awaiting delivery (batch drains outpace pump)
        # bounded-by: one native take_batch crossing (≤512 frames),
        # consumed before the next crossing in _get_message
        self._np_ready: "collections.deque" = collections.deque()
        self._query_conns: Dict[Tuple[int, int], socket.socket] = {}
        self._query_lock = threading.Lock()
        self.delivered = 0

    # -- LoopbackHub interface -----------------------------------------
    def register(self, dc_id: int, on_message, query_handler) -> None:
        # the fixed port (if any) goes to the first endpoint; in-process
        # multi-DC tests register several per fabric and keep ephemeral
        port = self._bind_port if not self.endpoints else 0
        ep = _Endpoint(self, dc_id, self.host, port)
        ep.query_handler = query_handler
        self.endpoints[dc_id] = ep
        # local dialing keeps the BIND address; public_host goes only
        # into exported descriptors (advertised_of) — an external LB/DNS
        # name may not resolve or hairpin from inside this process
        self.addresses[dc_id] = (ep.host, ep.port)
        self.advertised[dc_id] = (self.public_host or ep.host, ep.port)
        inj = faults.get_injector()
        if inj is not None:
            inj.register_endpoint(
                f"interdc.ep.{dc_id}",
                kill=lambda d=dc_id: self.kill_endpoint(d),
                restart=lambda d=dc_id: self.restart_endpoint(d),
            )

    def register_request(self, dc_id: int, handler) -> None:
        self.endpoints[dc_id].request_handler = handler

    def address_of(self, dc_id: int) -> Tuple[str, int]:
        return self.addresses[dc_id]

    def advertised_of(self, dc_id: int) -> Tuple[str, int]:
        """The address to export in a Descriptor (public_host for local
        endpoints, the learned address for remote ones)."""
        return self.advertised.get(dc_id, self.addresses[dc_id])

    def connect_remote(self, dc_id: int, host: str, port: int) -> None:
        """Learn a remote (possibly other-process) DC's endpoint."""
        self.addresses[dc_id] = (host, port)
        self.advertised[dc_id] = (host, port)

    # -- endpoint crash/revive (chaos tests + operators) ---------------
    def kill_endpoint(self, dc_id: int) -> None:
        """Crash one DC's listening endpoint: the server and every
        subscriber stream die, exactly what a process kill does to the
        socket layer.  Peers' reconnect loops take over from here."""
        self.endpoints[dc_id].close()

    def restart_endpoint(self, dc_id: int) -> None:
        """Rebind a killed endpoint on its old port with its old
        handlers; reconnecting subscribers find it at the same address."""
        old = self.endpoints[dc_id]
        ep = _Endpoint(self, dc_id, self.host, old.port)
        ep.query_handler = old.query_handler
        ep.request_handler = old.request_handler
        self.endpoints[dc_id] = ep
        self.addresses[dc_id] = (ep.host, ep.port)
        self.advertised[dc_id] = (self.public_host or ep.host, ep.port)

    # -- subscriptions ---------------------------------------------------
    def subscribe(self, subscriber_dc: int, publisher_dc: int,
                  on_message) -> None:
        deliver = self._make_deliver(publisher_dc, subscriber_dc,
                                     on_message)
        sock = self._dial_sub(subscriber_dc, publisher_dc)
        self._attach(sock, subscriber_dc, publisher_dc, deliver)

    def _dial_sub(self, subscriber_dc: int, publisher_dc: int,
                  timeout: float = 5.0) -> socket.socket:
        """Open one subscription stream: connect, K_SUB, await the ack.
        Raises ConnectionError/OSError on any failure (reconnect loops
        catch and back off)."""
        host, port = self.addresses[publisher_dc]
        sock = socket.create_connection((host, port), timeout=timeout)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _send(sock, K_SUB, subscriber_dc)
            # wait for the registration ack before handing the socket to
            # the reader — subscribe() returning means the stream is live
            kind, _ = _recv(sock)
            if kind != K_REPLY:
                raise ConnectionError(f"bad subscription ack kind {kind}")
            sock.settimeout(None)
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        return sock

    def _np_enter(self):
        """Pin the native pump for one call; None if closed/absent."""
        with self._np_cv:
            np_pump = self._np
            if np_pump is not None:
                self._np_users += 1
            return np_pump

    def _np_exit(self) -> None:
        with self._np_cv:
            self._np_users -= 1
            if self._np_users == 0:
                self._np_cv.notify_all()

    def _np_alloc_tag(self) -> int:
        """Mint a subscription tag under the cv lock: two concurrent
        subscribes (overlapping ctl_wire re-wires) must never share a
        tag, or one stream's deliver callback silently overwrites the
        other's."""
        with self._np_cv:
            tag = self._np_next
            self._np_next += 1
            return tag

    def _attach(self, sock: socket.socket, subscriber_dc: int,
                publisher_dc: int, deliver) -> None:
        np_pump = self._np_enter()
        if np_pump is not None:
            # native plane: hand the raw fd to the epoll pump (pinned:
            # close() must not free it mid-add)
            try:
                tag = self._np_alloc_tag()
                self._np_tags[tag] = (deliver, subscriber_dc, publisher_dc)
                np_pump.add(sock.detach(), tag)
            finally:
                self._np_exit()
            return
        t = threading.Thread(
            target=self._reader_loop,
            args=(sock, subscriber_dc, publisher_dc, deliver), daemon=True,
            name=f"sub:{subscriber_dc}<-{publisher_dc}")
        t.start()
        self._readers.append(t)

    def _reader_loop(self, sock, subscriber_dc: int, publisher_dc: int,
                     deliver) -> None:
        """Python-plane reader: drain frames; on disconnect, re-dial
        with backoff instead of dying (the stream heals, the opid-gap
        catch-up replays whatever the outage lost)."""
        while True:
            try:
                while True:
                    kind, body = _recv(sock)
                    if kind == K_PUSH:
                        try:
                            self.inbox.put_nowait((deliver, bytes(body)))
                        except queue.Full:
                            # pump saturated: shed, the chain gap heals
                            # via catch-up once the pump drains
                            net_metrics().ingress_shed.inc()
            except (ConnectionError, OSError):
                pass
            try:
                sock.close()
            except OSError:
                pass
            sock = self._reconnect(subscriber_dc, publisher_dc)
            if sock is None:
                return

    def _reconnect(self, subscriber_dc: int,
                   publisher_dc: int) -> Optional[socket.socket]:
        """Re-dial a dropped subscription with jittered exponential
        backoff.  Returns a live (acked) socket, or None when the fabric
        closed / reconnect is disabled / the retry budget ran out.
        Messages published during the outage are NOT lost: the replica's
        chain-gap detection queries the publisher's log from the last
        delivered opid once the stream is back."""
        if not self.reconnect or self._closed:
            return None
        link = f"{publisher_dc}->{subscriber_dc}"
        attempt = 0
        while not self._closed:
            if (self.max_reconnect_tries is not None
                    and attempt >= self.max_reconnect_tries):
                log.error("subscription %s: reconnect budget (%d) "
                          "exhausted; stream stays down", link, attempt)
                return None
            delay = min(self.backoff_max,
                        self.backoff_base * (2 ** min(attempt, 16)))
            # full jitter in [0.5x, 1.5x): concurrent reconnects from
            # many subscribers must not stampede a reborn endpoint
            time.sleep(delay * (0.5 + self._rng.random()))
            attempt += 1
            net_metrics().reconnect_attempts.inc(link=link)
            try:
                sock = self._dial_sub(subscriber_dc, publisher_dc)
            except (ConnectionError, OSError):
                continue
            net_metrics().reconnects.inc(link=link)
            log.warning("subscription %s: reconnected after %d attempt(s)",
                        link, attempt)
            return sock
        return None

    def _make_deliver(self, publisher_dc: int, subscriber_dc: int, cb):
        """Wrap a subscriber callback with the link's fault filter.
        Runs on the pump (control) thread, so seeded decisions are
        deterministic for a given delivery order."""

        def deliver(data: bytes) -> None:
            inj = faults.get_injector()
            if inj is not None:
                if inj.is_severed(publisher_dc, subscriber_dc):
                    return
                d = inj.hit("interdc.deliver",
                            key=(publisher_dc, subscriber_dc))
                if d is not None:
                    if d.action == "drop":
                        return
                    if d.action == "delay":
                        # redeliver in a later pump round (reordering);
                        # the rule decides again on the retry.  A full
                        # inbox degrades the delay to a drop — both are
                        # faults the chain repair already covers
                        try:
                            self.inbox.put_nowait((deliver, data))
                        except queue.Full:
                            net_metrics().ingress_shed.inc()
                        return
                    if d.action == "truncate":
                        data = data[: int(d.arg or 4)]
                    elif d.action == "dup":
                        cb(data)
                    elif d.action == "error":
                        raise RuntimeError(
                            "injected fault: interdc.deliver "
                            f"{publisher_dc}->{subscriber_dc}")
            cb(data)

        return deliver

    def publish(self, from_dc: int, data: bytes) -> None:
        self.endpoints[from_dc].push(data)

    #: per-attempt deadline for query-channel calls: a wedged peer must
    #: not hang a catch-up forever
    QUERY_TIMEOUT_S = 30.0

    def _rpc(self, target_dc: int, kind: int, body):
        src = next(iter(self.endpoints), None)
        inj = faults.get_injector()
        if inj is not None:
            if src is not None and inj.is_severed(src, target_dc):
                raise ConnectionError(
                    f"injected partition: dc{src} <-> dc{target_dc}")
            d = inj.hit("interdc.rpc", key=(src, target_dc))
            if d is not None:
                if d.action == "delay" and d.arg:
                    time.sleep(float(d.arg))
                elif d.action in ("drop", "error"):
                    raise ConnectionError(
                        f"injected fault: interdc.rpc -> dc{target_dc}")
        last: Optional[Exception] = None
        for _attempt in range(2):
            with self._query_lock:
                key = (threading.get_ident(), target_dc)
                sock = self._query_conns.get(key)
                if sock is None:
                    host, port = self.addresses[target_dc]
                    try:
                        sock = socket.create_connection(
                            (host, port), timeout=self.QUERY_TIMEOUT_S)
                    except OSError as e:
                        last = e
                        continue
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                    self._query_conns[key] = sock
            try:
                _send(sock, kind, body)
            except (ConnectionError, OSError) as e:
                # SEND failed — a cached conn gone stale (the peer's
                # endpoint was killed and reborn on the same port): the
                # request never got out, so redialing and resending is
                # always safe
                self._drop_query_conn(key, sock)
                last = e
                net_metrics().rpc_retries.inc()
                continue
            try:
                rkind, reply = _recv(sock)
            except socket.timeout as e:
                # reply deadline: the remote MAY be executing the request
                # — re-sending could double-apply a state-mutating K_REQ
                # (bcounter grants), so surface instead of retrying
                self._drop_query_conn(key, sock)
                raise ConnectionError(
                    f"query to dc{target_dc} exceeded "
                    f"{self.QUERY_TIMEOUT_S}s deadline") from e
            except (ConnectionError, OSError) as e:
                # reply LOST after a complete send: the remote may have
                # executed a state-mutating K_REQ — at-most-once, no
                # blind resend (K_LOGQ catch-up reads retry on the next
                # chain ping instead)
                self._drop_query_conn(key, sock)
                raise ConnectionError(
                    f"query to dc{target_dc}: connection died awaiting "
                    "the reply (remote may have executed)") from e
            if rkind == K_ERR:
                raise RuntimeError(
                    f"remote error from dc{target_dc}: {reply}")
            return reply
        raise ConnectionError(
            f"query channel to dc{target_dc} failed") from last

    def _drop_query_conn(self, key, sock) -> None:
        with self._query_lock:
            self._query_conns.pop(key, None)
        try:
            sock.close()
        except OSError:
            pass

    def query_log(self, target_dc: int, shard: int, origin: int,
                  from_opid: int) -> List[bytes]:
        return [bytes(m) for m in self._rpc(
            target_dc, K_LOGQ,
            {"shard": shard, "origin": origin, "from": from_opid},
        )]

    def request(self, target_dc: int, kind: str, payload):
        return self._rpc(target_dc, K_REQ,
                         {"kind": kind, "payload": payload})

    def register_flush(self, dc_id: int, fn) -> None:
        """Callback run at the end of every pump batch (the frames one
        native crossing brought, or the pump call's return)."""
        self._flushes[dc_id] = fn

    def batching(self) -> bool:
        """Whether the delivery running on this thread has more frames of
        its pump batch behind it."""
        return getattr(self._tl, "batching", False)

    def _flush(self) -> None:
        for fn in list(self._flushes.values()):
            fn()

    def register_tick(self, dc_id: int, fn) -> None:
        """Tick callback run at each pump — replicas flush deferred
        heartbeats here (see LoopbackHub.register_tick)."""
        self._ticks[dc_id] = fn

    def pump(self, max_rounds: int = 100_000, timeout: float = 0.5) -> int:
        """Deliver queued stream messages on the calling thread until the
        fabric is quiescent.

        Quiescence contract: "no traffic beyond two rounds of tick
        output" — ticks (deferred-heartbeat flushes) run at entry, at
        the first idle, and ONCE MORE at return (so a commit made by a
        server thread mid-pump still flushes its safe time before this
        pump returns), but tick-generated frames past the budget wait
        for the next pump: with the native receive plane our own pings
        arrive fast enough that an unbounded drain-ticks loop would
        never terminate."""
        n = 0
        # ticks may PUBLISH (heartbeat pings), and with the native
        # receive plane our own pings come back fast enough to keep the
        # loop busy forever — bound the flushes per pump() call so
        # "quiescent" means "no traffic beyond two rounds of tick
        # output", the LoopbackHub contract
        tick_budget = 2
        for fn in list(self._ticks.values()):
            fn()
        last_tick = time.monotonic()
        tick_budget -= 1
        while n < max_rounds:
            try:
                cb, data = self._get_message(timeout)
            except queue.Empty:
                if tick_budget <= 0:
                    # final flush WITHOUT re-draining: safe times of
                    # commits made mid-pump still reach the wire before
                    # we return (the documented invariant); any frames
                    # they generate are the next pump's work
                    for fn in list(self._ticks.values()):
                        fn()
                    return n
                tick_budget -= 1
                for fn in list(self._ticks.values()):
                    fn()
                try:
                    cb, data = self._get_message(min(timeout, 0.05))
                except queue.Empty:
                    # same final-flush invariant as the exhausted-budget
                    # branch: safe times of mid-pump commits reach the
                    # wire before returning
                    for fn in list(self._ticks.values()):
                        fn()
                    return n
            # take the local handler locks so server threads (queries,
            # bcounter grants) never interleave with gate processing
            more = bool(self._np_ready) and n + 1 < max_rounds
            self._tl.batching = more
            try:
                with self._local_locks():
                    cb(data)
            finally:
                self._tl.batching = False
            if not more or not self._np_ready:
                self._flush()
            self.delivered += 1
            n += 1
            if time.monotonic() - last_tick >= self.TICK_EVERY_S:
                # a fabric that never goes quiet still flushes heartbeats:
                # without them a peer's stable snapshot stops advancing
                for fn in list(self._ticks.values()):
                    fn()
                last_tick = time.monotonic()
        return n

    #: ticks run at least this often while a pump call keeps delivering
    TICK_EVERY_S = 0.02

    #: the serving pump loop's idle wait: a quiet fabric returns and
    #: ticks (flushes heartbeats) every few tens of milliseconds, which
    #: bounds how long a reader's clock waits for a remote commit to
    #: become stable
    LOOP_IDLE_S = 0.02

    def start_pump_loop(self, name: str = "interdc-pump") -> ThreadLoop:
        """The replication drain loop of a serving node: ``pump`` called
        over and over on a supervisable thread."""
        return ThreadLoop(lambda: self.pump(timeout=self.LOOP_IDLE_S),
                          interval_s=0.002, name=name).start()

    def _get_message(self, timeout: float):
        """Next (deliver, data) from the Python inbox or the native
        pump, whichever has one first; raises queue.Empty on timeout.
        Native frames arrive in BATCHES (one ctypes crossing drains up
        to 512) and carry the raw wire payload — unpack here.  A
        K_CONN_DROP sentinel (kind 0, queued by pump.cc when a stream
        dies) triggers an off-thread resubscribe instead of a
        delivery."""
        if self._np is None:
            return self.inbox.get(timeout=timeout)
        if self._np_ready:
            return self._np_ready.popleft()
        deadline = time.monotonic() + timeout
        while True:
            try:
                # native mode feeds the inbox only with DELAYED
                # redeliveries (fault filter) — drain those first
                return self.inbox.get_nowait()
            except queue.Empty:
                pass
            rem = deadline - time.monotonic()
            wait_ms = max(1, int(rem * 1000)) if rem > 0 else 1
            # pin the handle per iteration: close() waits
            # out in-flight calls, and a pump that loses the race just
            # goes idle — never an AttributeError or use-after-free.
            # Concurrent pumpers still poll concurrently (no mutex held
            # across the blocking native wait).
            np_pump = self._np_enter()
            if np_pump is None:  # fabric closed mid-pump: go idle
                raise queue.Empty
            try:
                batch = np_pump.take_batch(wait_ms)
            finally:
                self._np_exit()
            for tag, kind, payload in batch:
                ent = self._np_tags.get(tag)
                if ent is None:
                    continue
                deliver, sub_dc, pub_dc = ent
                if kind == K_CONN_DROP:
                    self._on_native_drop(tag, sub_dc, pub_dc)
                    continue
                if kind == K_PUSH:
                    body = msgpack.unpackb(payload, raw=False,
                                           strict_map_key=False)
                    self._np_ready.append((deliver, bytes(body)))
            if self._np_ready:
                return self._np_ready.popleft()
            if rem <= 0:
                raise queue.Empty

    def native_stats(self) -> Optional[dict]:
        """The native pump's frames drained and the crossings that
        returned frames (None on the Python reader threads)."""
        np_pump = self._np
        if np_pump is None:
            return None
        return {"frames": np_pump.frames, "takes": np_pump.takes}

    def _on_native_drop(self, tag: int, subscriber_dc: int,
                        publisher_dc: int) -> None:
        """A native-plane subscription died (sentinel from pump.cc's
        close path — EOF, read error, or an over-cap/corrupt frame).
        Resubscribe off-thread with backoff; the epoll loop keeps
        serving the other streams meanwhile."""
        if self._closed or not self.reconnect:
            self._np_tags.pop(tag, None)
            return
        log.warning("subscription %s->%s: native stream dropped; "
                    "resubscribing", publisher_dc, subscriber_dc)

        def resub():
            sock = self._reconnect(subscriber_dc, publisher_dc)
            if sock is None:
                self._np_tags.pop(tag, None)
                return
            np_pump = self._np_enter()
            if np_pump is not None:
                try:
                    np_pump.add(sock.detach(), tag)  # same tag: same deliver
                finally:
                    self._np_exit()
                return
            # fabric torn down while we were backing off
            try:
                sock.close()
            except OSError:
                pass

        threading.Thread(target=resub, daemon=True,
                         name=f"resub:{subscriber_dc}<-{publisher_dc}"
                         ).start()

    def _local_locks(self):
        """A context manager holding every local endpoint's handler lock."""
        eps = list(self.endpoints.values())

        class _Multi:
            def __enter__(self):
                for e in eps:
                    e.lock.acquire()

            def __exit__(self, *exc):
                for e in reversed(eps):
                    e.lock.release()
                return False

        return _Multi()

    @staticmethod
    def interconnect(fabrics: List["TcpFabric"]) -> None:
        """Share endpoint addresses between per-DC fabrics (the in-process
        stand-in for exchanging descriptors between deployments)."""
        for a in fabrics:
            for b in fabrics:
                for dc, addr in b.addresses.items():
                    a.addresses.setdefault(dc, addr)

    def close(self) -> None:
        self._closed = True  # stops reconnect loops before sockets die
        # unpublish the handle, then wait out every pinned native call
        # before freeing: a pump blocked in take_batch finishes its
        # bounded poll, exits the refcount, and the next _np_enter sees
        # None and goes idle — never a use-after-free
        with self._np_cv:
            np_pump, self._np = self._np, None
            while self._np_users > 0:
                self._np_cv.wait(timeout=1.0)
        if np_pump is not None:
            np_pump.close()
        for ep in self.endpoints.values():
            ep.close()
        with self._query_lock:
            for s in self._query_conns.values():
                try:
                    s.close()
                except OSError:
                    pass
            self._query_conns.clear()
