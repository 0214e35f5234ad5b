"""Supervision tree for the host runtime's long-running services.

The reference supervises every subsystem under a one_for_one root with
restart intensity 5-in-10s (``antidote_sup``); a crashed vnode master
or listener restarts in place, and exceeding the intensity takes the
node down rather than limping.  The device data plane has no processes
to supervise, but the HOST runtime around it — protocol listener,
metrics endpoint — is threads, and threads die silently.  This module restores the OTP discipline:

    sup = Supervisor()
    sup.add("proto", start=lambda: ProtocolServer(node, port=p),
            alive=lambda s: s.is_alive(), stop=lambda s: s.close())
    sup.start()

One monitor thread polls each child's ``alive`` probe; a dead child is
stopped (best effort) and restarted via its ``start`` factory.  More
than ``max_restarts`` restarts of one child within ``window_s`` seconds
escalates: the supervisor stops everything and invokes ``on_giveup``
(default: log CRITICAL), matching the OTP shutdown-on-intensity rule.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger(__name__)


class Child:
    def __init__(self, name: str, start: Callable[[], Any],
                 alive: Callable[[Any], bool],
                 stop: Optional[Callable[[Any], None]] = None):
        self.name = name
        self.start = start
        self.alive = alive
        self.stop = stop
        self.handle: Any = None
        self.restarts: List[float] = []  # monotonic restart times


class ThreadLoop:
    """A supervisable repeating-call thread (the worker-process shape
    OTP's gen_server loop gives every subsystem for free).

    ``fn`` is called repeatedly with ``interval_s`` sleeps between
    calls; an exception logs, marks the loop crashed, and ENDS the
    thread — the supervisor's ``alive`` probe then sees a dead child
    and restarts it through the factory, which is the whole point:
    threads must die loudly, not limp silently.

        sup.add("interdc-pump",
                start=lambda: ThreadLoop(fabric.pump, name="pump").start(),
                alive=ThreadLoop.is_alive, stop=ThreadLoop.stop)
    """

    def __init__(self, fn: Callable[[], Any], interval_s: float = 0.01,
                 name: str = "loop"):
        self.fn = fn
        self.interval_s = interval_s
        self.name = name
        self.crashed: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)

    def start(self) -> "ThreadLoop":
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.fn()
            except Exception as e:
                # die loudly: the supervisor restarts a fresh loop
                self.crashed = e
                log.exception("%s: loop crashed", self.name)
                return
            self._stop.wait(self.interval_s)

    def is_alive(self) -> bool:
        return self._thread.is_alive()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)


class Supervisor:
    """one_for_one over service objects (antidote_sup parity: restart
    intensity ``max_restarts`` within ``window_s``, default 5-in-10s)."""

    def __init__(self, max_restarts: int = 5, window_s: float = 10.0,
                 poll_s: float = 0.5,
                 on_giveup: Optional[Callable[[str], None]] = None):
        self.max_restarts = max_restarts
        self.window_s = window_s
        self.poll_s = poll_s
        self.on_giveup = on_giveup
        self.children: Dict[str, Child] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.gave_up: Optional[str] = None

    def add(self, name: str, start: Callable[[], Any],
            alive: Callable[[Any], bool],
            stop: Optional[Callable[[Any], None]] = None) -> None:
        assert self._thread is None, "add children before start()"
        self.children[name] = Child(name, start, alive, stop)

    # ------------------------------------------------------------------
    def start(self) -> None:
        for c in self.children.values():
            c.handle = c.start()
        self._thread = threading.Thread(target=self._monitor, daemon=True,
                                        name="antidote-sup")
        self._thread.start()

    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_s):
            for c in self.children.values():
                try:
                    ok = c.handle is not None and c.alive(c.handle)
                except Exception:
                    ok = False
                if ok:
                    continue
                now = time.monotonic()
                c.restarts = [t for t in c.restarts
                              if now - t < self.window_s]
                if len(c.restarts) >= self.max_restarts:
                    self._giveup(c.name)
                    return
                log.warning("supervisor: child %r died; restarting",
                            c.name)
                self._safe_stop(c)
                try:
                    c.handle = c.start()
                    c.restarts.append(now)
                except Exception:
                    log.exception("supervisor: restart of %r failed",
                                  c.name)
                    c.handle = None
                    c.restarts.append(now)

    def _giveup(self, name: str) -> None:
        """Restart intensity exceeded: stop everything (the OTP
        supervisor-shutdown rule — a flapping child means the node is
        unhealthy; limping on masks it)."""
        self.gave_up = name
        log.critical("supervisor: child %r exceeded %d restarts in %.0fs; "
                     "shutting the tree down", name, self.max_restarts,
                     self.window_s)
        for c in self.children.values():
            self._safe_stop(c)
        if self.on_giveup is not None:
            try:
                self.on_giveup(name)
            except Exception:
                log.exception("on_giveup callback failed")

    def _safe_stop(self, c: Child) -> None:
        if c.handle is not None and c.stop is not None:
            try:
                c.stop(c.handle)
            except Exception:
                pass
        c.handle = None

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        for c in self.children.values():
            self._safe_stop(c)
