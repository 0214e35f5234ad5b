"""Intra-DC RPC: msgpack request/reply over TCP.

The stand-in for disterl between a DC's member nodes: one threaded server
per member; clients keep one connection per (thread, target).  Frames are
a 4-byte big-endian length and a msgpack body, ``{"m": method, "a":
[args]}`` one way and ``{"ok": result}`` or ``{"err": message}`` back —
the JAX package's wire form, so the two packages' members speak alike.

Fault sites: ``rpc.call`` (keyed by method: ``delay`` sleeps, ``error``
fails the call with :class:`RpcError`, ``drop`` fails it as a lost request
does, with :class:`RpcTimeout`), and every server registers itself as the
endpoint ``rpc.server.<port>`` so a fault plan can kill and restart it.
"""

from __future__ import annotations

import logging
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional

import msgpack
import numpy as np

from antidote_tpu_torch import faults
from antidote_tpu_torch.store.kv import Effect, freeze_key

log = logging.getLogger(__name__)

_HDR = struct.Struct(">I")

#: per-attempt deadline (s); generous — it bounds hangs, not latency
DEFAULT_TIMEOUT_S = 30.0
#: transport-error redials per call
DEFAULT_RETRIES = 3
#: first redial's backoff (s); doubles on each further redial
BACKOFF_BASE_S = 0.05


class RpcError(RuntimeError):
    """The remote handler raised; carries the remote repr."""


class RpcTimeout(RpcError):
    """The call exhausted its deadline/retry budget.  Distinct from
    RpcError (remote raised): the remote MAY have executed the request —
    callers retry only idempotent methods after this."""


def _np_default(x):
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    raise TypeError(f"not msgpack-able: {type(x)}")


def _send(sock: socket.socket, obj: Any) -> None:
    data = msgpack.packb(obj, use_bin_type=True, default=_np_default)
    sock.sendall(_HDR.pack(len(data)) + data)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv(sock: socket.socket) -> Any:
    (n,) = _HDR.unpack(_read_exact(sock, _HDR.size))
    return msgpack.unpackb(_read_exact(sock, n), raw=False,
                           strict_map_key=False)


class RpcServer:
    """Dispatches {"m": method, "a": [args]} to registered handlers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._bind_host = host
        self.handlers: Dict[str, Callable] = {}
        #: live handler connections — close() must sever these, or a
        #: closed server keeps answering through parked threads
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        srv_self = self

        class Handler(socketserver.BaseRequestHandler):
            def setup(self):
                with srv_self._conns_lock:
                    srv_self._conns.add(self.request)

            def finish(self):
                with srv_self._conns_lock:
                    srv_self._conns.discard(self.request)

            def handle(self):
                while True:
                    try:
                        req = _recv(self.request)
                    except (ConnectionError, OSError):
                        return
                    try:
                        fn = srv_self.handlers[req["m"]]
                        reply = {"ok": fn(*req.get("a", []))}
                    except Exception as e:
                        # protocol errors follow a PREFIX convention
                        # ("abort: ...", "not_owner: ...") and stay quiet;
                        # anything else is a handler bug — log its
                        # traceback here, the reply carries the message
                        if not str(e).startswith(
                                ("abort", "not_owner", "busy",
                                 "overlay-resync")):
                            log.exception("rpc handler %r failed",
                                          req.get("m"))
                        reply = {"err": f"{type(e).__name__}: {e}"}
                    try:
                        _send(self.request, reply)
                    except (ConnectionError, OSError):
                        return

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._server_cls, self._handler_cls = Server, Handler
        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._serve()
        inj = faults.get_injector()
        if inj is not None:
            inj.register_endpoint(f"rpc.server.{self.port}",
                                  kill=self.close, restart=self.restart)

    def _serve(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"cluster-rpc:{self.port}")
        self._thread.start()

    def register(self, name: str, fn: Callable) -> None:
        self.handlers[name] = fn

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        with self._conns_lock:
            # shutdown THEN close: a bare close on a socket another thread
            # is recv()-blocked on never sends the FIN
            for c in list(self._conns):
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    c.close()
                except OSError:
                    pass
            self._conns.clear()
        self._thread.join(timeout=10)

    def restart(self) -> None:
        """Rebind on the SAME port with the same handler table (a killed
        member coming back); clients redial into it."""
        self._server = self._server_cls((self._bind_host, self.port),
                                        self._handler_cls)
        self._serve()


class RpcClient:
    """One connection per calling thread; calls are synchronous.

    Every call carries a deadline (per-attempt socket timeout) and a
    bounded retry budget with exponential backoff for SEND failures.  A
    reply that times out or is lost surfaces as :class:`RpcTimeout`
    without a resend: the remote may have executed the request, and only
    the caller knows whether the method is idempotent."""

    def __init__(self, host: str, port: int):
        self.addr = (host, port)
        self._local = threading.local()

    def _sock(self) -> socket.socket:
        s = getattr(self._local, "sock", None)
        if s is None:
            s = socket.create_connection(self.addr,
                                         timeout=DEFAULT_TIMEOUT_S)
            s.settimeout(DEFAULT_TIMEOUT_S)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.sock = s
        return s

    def _drop_sock(self) -> None:
        s = getattr(self._local, "sock", None)
        self._local.sock = None
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def call(self, method: str, *args) -> Any:
        d = faults.hit("rpc.call", key=method)
        if d is not None:
            if d.action == "delay" and d.arg:
                time.sleep(float(d.arg))
            elif d.action == "error":
                raise RpcError(f"injected fault: rpc.call {method}")
            elif d.action == "drop":
                # a lost request or reply: the call fails as a real drop
                # does once its deadline fires
                self._drop_sock()
                _net_deadline()
                raise RpcTimeout(
                    f"injected drop: rpc.call {method} to {self.addr}")
        last: Optional[Exception] = None
        for attempt in range(DEFAULT_RETRIES):
            if attempt:
                _net_retry()
                time.sleep(BACKOFF_BASE_S * (2 ** (attempt - 1)))
            try:
                s = self._sock()
                _send(s, {"m": method, "a": list(args)})
            except (ConnectionError, OSError) as e:
                # the request never reached the handler: safe to redial
                self._drop_sock()
                last = e
                continue
            try:
                reply = _recv(s)
            except socket.timeout as e:
                self._drop_sock()
                _net_deadline()
                raise RpcTimeout(
                    f"{method} to {self.addr} exceeded "
                    f"{DEFAULT_TIMEOUT_S}s deadline") from e
            except (ConnectionError, OSError) as e:
                self._drop_sock()
                _net_deadline()
                raise RpcTimeout(
                    f"{method} to {self.addr}: connection died awaiting "
                    "the reply (remote may have executed)") from e
            if "err" in reply:
                raise RpcError(reply["err"])
            return reply["ok"]
        _net_deadline()
        raise RpcTimeout(
            f"{method} to {self.addr} failed after {DEFAULT_RETRIES} "
            f"attempt(s)") from last

    def close(self) -> None:
        # only the calling thread's connection: others close with their
        # threads (daemon server threads see EOF)
        self._drop_sock()


def _net_retry() -> None:
    from antidote_tpu_torch.obs.metrics import net_metrics

    net_metrics().rpc_retries.inc()


def _net_deadline() -> None:
    from antidote_tpu_torch.obs.metrics import net_metrics

    net_metrics().rpc_deadline_exceeded.inc()


# ---------------------------------------------------------------------------
# wire form for effects (coordinator <-> owner)
# ---------------------------------------------------------------------------
def eff_to_wire(eff: Effect) -> dict:
    return {
        "k": eff.key, "t": eff.type_name, "b": eff.bucket,
        "a": np.asarray(eff.eff_a, np.int64).tobytes(),
        "eb": np.asarray(eff.eff_b, np.int32).tobytes(),
        "bl": [(int(h), bytes(d)) for h, d in eff.blob_refs],
    }


def eff_from_wire(w: dict) -> Effect:
    return Effect(
        freeze_key(w["k"]), w["t"], w["b"],
        np.frombuffer(w["a"], np.int64),
        np.frombuffer(w["eb"], np.int32),
        [(int(h), bytes(d)) for h, d in w.get("bl", [])],
    )
