"""ctypes binding for the native inter-DC stream pump (``cpp/pump.cc``).

One C++ epoll thread owns every subscription socket: kernel reads and
frame assembly happen in native code, off the interpreter lock, and
Python drains whole frames in batches.  The library is built at first use
by ``native_build`` into ``antidote_tpu_torch/_build/``, like the WAL, the
front end and the router.

No fallback: a library that cannot be built, loaded or bound, a
``pump_new`` that fails, or an injected ``native_pump.load`` fault raises
:class:`NativePumpUnavailable` before any thread starts.  Only the
operator's switch ``ANTIDOTE_NATIVE_PUMP=off`` makes
:meth:`NativePump.create` return None (logged and counted in
``pump_fallback``); the fabric then runs one Python reader thread per
subscription.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from pathlib import Path
from typing import Optional, Tuple

from antidote_tpu_torch import faults, native_build

log = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "cpp" / "pump.cc"

_lib = None
_lib_lock = threading.Lock()


class NativePumpUnavailable(RuntimeError):
    """The native receive plane was asked for and cannot run: its library
    did not build or load, its epoll loop did not start, or a fault plan
    injected the load failure."""


def count_python_readers(reason: str) -> None:
    """An operator's choice of the Python reader threads: logged, and
    counted in ``pump_fallback``."""
    from antidote_tpu_torch.obs.metrics import net_metrics

    log.info("native pump off (%s): one Python reader thread per "
             "subscription", reason)
    net_metrics().pump_fallback.inc()


def bind(lib):
    """Declare the pump's C interface on a loaded library (this
    package's build, or another build of the same source)."""
    lib.pump_new.restype = ctypes.c_void_p
    lib.pump_new.argtypes = []
    lib.pump_add.restype = ctypes.c_int
    lib.pump_add.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_long]
    lib.pump_take.restype = ctypes.c_long
    lib.pump_take.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long), ctypes.c_int,
    ]
    lib.pump_take_batch.restype = ctypes.c_long
    lib.pump_take_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.c_long, ctypes.c_int,
    ]
    lib.pump_queued.restype = ctypes.c_long
    lib.pump_queued.argtypes = [ctypes.c_void_p]
    lib.pump_free.restype = None
    lib.pump_free.argtypes = [ctypes.c_void_p]
    return lib


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            lib = bind(ctypes.CDLL(str(native_build.ensure(SOURCE, "pump"))))
        except (OSError, AttributeError, native_build.NativeBuildError) as e:
            raise NativePumpUnavailable(f"native pump: {e}") from e
        _lib = lib
        return lib


class NativePump:
    """Owns detached socket fds; yields (tag, kind, payload) frames."""

    _BATCH = 512

    #: frame kind queued by the native loop when a subscription socket
    #: drops (EOF, read error, corrupt frame) — carries the tag and an
    #: empty payload.  The fabric resubscribes with backoff on seeing it
    K_CONN_DROP = 0

    def __init__(self, lib, h):
        self._lib = lib
        self._h = h
        #: scratch buffers, one pair per draining thread: a reader waiting
        #: for a client clock pumps beside the pump loop, and two native
        #: crossings filling one buffer would hand each thread the other's
        #: bytes (duplicated frames, lost frames, torn frames)
        self._tls = threading.local()
        self._count_lock = threading.Lock()
        #: frames drained and native crossings that returned frames
        #: (the frames-per-take figure)
        self.frames = 0
        self.takes = 0

    @staticmethod
    def create() -> Optional["NativePump"]:
        """The running native pump; None only under
        ``ANTIDOTE_NATIVE_PUMP=off``.  Raises
        :class:`NativePumpUnavailable`."""
        if os.environ.get("ANTIDOTE_NATIVE_PUMP", "on") == "off":
            count_python_readers("ANTIDOTE_NATIVE_PUMP=off")
            return None
        if faults.hit("native_pump.load") is not None:
            raise NativePumpUnavailable("injected fault: native_pump.load")
        lib = _load_lib()
        h = lib.pump_new()
        if not h:
            # a pump with no epoll loop would close every fd handed to
            # add(), silently blackholing each subscription
            raise NativePumpUnavailable(
                "native pump: pump_new failed (epoll/eventfd)")
        return NativePump(lib, h)

    def add(self, fd: int, tag: int) -> None:
        """Register a connected socket fd; the pump OWNS it from here
        (pass ``sock.detach()``)."""
        if self._h is None:
            os.close(fd)  # closed pump: don't leak the detached fd
            return
        self._lib.pump_add(self._h, fd, tag)

    def _scratch(self):
        """This thread's (payload buffer, descriptor array)."""
        t = self._tls
        if not hasattr(t, "buf"):
            t.buf = ctypes.create_string_buffer(1 << 20)
            t.descs = (ctypes.c_long * (3 * self._BATCH))()
        return t

    def take(self, timeout_ms: int) -> Optional[Tuple[int, int, bytes]]:
        if self._h is None:
            return None
        sc = self._scratch()
        tag = ctypes.c_long()
        kind = ctypes.c_int()
        need = ctypes.c_long()
        n = self._lib.pump_take(self._h, sc.buf, len(sc.buf),
                                ctypes.byref(tag), ctypes.byref(kind),
                                ctypes.byref(need), int(timeout_ms))
        if n == -2:
            # frame larger than the scratch buffer: grow and retake
            sc.buf = ctypes.create_string_buffer(int(need.value) + 1024)
            return self.take(timeout_ms)
        if n < 0:
            return None
        with self._count_lock:
            self.frames += 1
            self.takes += 1
        return (int(tag.value), int(kind.value),
                ctypes.string_at(sc.buf, n))

    def take_batch(self, timeout_ms: int) -> list:
        """Drain up to _BATCH frames in one native crossing —
        [(tag, kind, payload)], [] after timeout."""
        if self._h is None:
            return []
        sc = self._scratch()
        n = self._lib.pump_take_batch(self._h, sc.buf, len(sc.buf),
                                      sc.descs, self._BATCH,
                                      int(timeout_ms))
        if n <= 0:
            # nothing, or the head frame alone exceeds the scratch
            # buffer — the single-frame path grows the buffer
            if n == 0 and self.queued() > 0:
                f = self.take(0)
                return [f] if f is not None else []
            return []
        d = sc.descs
        total = sum(d[i * 3 + 2] for i in range(n))
        raw = ctypes.string_at(sc.buf, total)
        out = []
        off = 0
        for i in range(n):
            ln = d[i * 3 + 2]
            out.append((int(d[i * 3]), int(d[i * 3 + 1]),
                        raw[off:off + ln]))
            off += ln
        with self._count_lock:
            self.frames += n
            self.takes += 1
        return out

    def queued(self) -> int:
        if self._h is None:
            return 0
        return int(self._lib.pump_queued(self._h))

    def close(self) -> None:
        if self._h is not None:
            h, self._h = self._h, None
            self._lib.pump_free(h)
