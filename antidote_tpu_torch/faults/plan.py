"""Seeded fault plans + the process-wide injector (the port's own copy of
the JAX package's ``faults/plan.py``; the plans, rules and decisions are
the same).

The deterministic core of the chaos layer (see package docstring in
``__init__.py``): a :class:`FaultPlan` is a declarative, seeded list of
rules; :func:`install` arms it as the process-wide
:class:`FaultInjector` that instrumented sites consult.  All decisions
draw from one ``random.Random(seed)`` under a lock, so a given plan +
a deterministic delivery order (the single pump thread) reproduces the
same fault sequence run after run.
"""

from __future__ import annotations

import logging
import random
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

#: actions a rule may take at a site; sites interpret them locally:
#:   drop     — discard the message / skip the operation
#:   dup      — deliver the message twice (chain logic must dedupe)
#:   delay    — defer the message one delivery round / sleep arg seconds
#:   truncate — corrupt the frame to its first ``arg`` bytes
#:   error    — raise (ConnectionError at transports, IOError at the WAL)
#:   enospc   — WAL-append site only: raise OSError(errno.ENOSPC) — a
#:              full disk; drives the node's read-only degraded mode
#:   io_error — WAL-append site only: raise OSError(errno.EIO) — a
#:              dying device; same degraded-mode path
ACTIONS = ("drop", "dup", "delay", "truncate", "error", "enospc",
           "io_error")


class Decision:
    """What a site should do for one hit: ``action`` + optional arg."""

    __slots__ = ("action", "arg", "site")

    def __init__(self, action: str, arg: Any = None, site: str = ""):
        self.action = action
        self.arg = arg
        self.site = site

    def __repr__(self):
        return f"Decision({self.action!r}, arg={self.arg!r}, site={self.site!r})"


class FaultRule:
    """One match+action rule.  ``key=None`` matches every key at the
    site; ``p`` is the per-hit firing probability; ``times`` bounds the
    total number of firings (None = unlimited)."""

    __slots__ = ("site", "action", "key", "p", "times", "arg", "fired")

    def __init__(self, site: str, action: str, key=None, p: float = 1.0,
                 times: Optional[int] = None, arg: Any = None):
        assert action in ACTIONS, action
        self.site = site
        self.action = action
        self.key = key
        self.p = float(p)
        self.times = times
        self.arg = arg
        self.fired = 0

    def matches(self, site: str, key) -> bool:
        if site != self.site:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        return self.key is None or self.key == key

    def __repr__(self):
        return (f"FaultRule({self.site!r}, {self.action!r}, key={self.key!r},"
                f" p={self.p}, times={self.times}, fired={self.fired})")


class FaultPlan:
    """A seeded, declarative set of fault rules.

        plan = FaultPlan(seed=7)
        plan.drop("interdc.deliver", key=(0, 1), p=0.3)
        plan.dup("interdc.deliver", p=0.1, times=5)
        plan.error("wal.append", times=1)
        inj = faults.install(plan)

    Known sites (grep for ``faults.hit``):

    ==================  =============================  =================
    site                key                            planes
    ==================  =============================  =================
    interdc.deliver     (publisher_dc, subscriber_dc)  TcpFabric streams
    interdc.rpc         (src_dc, target_dc)            log catch-up + query
    rpc.call            method name                    intra-DC cluster RPC
    wal.append          WAL file basename              durable log
    wal.fsync           WAL file basename              group-fsync plane
                                                       (delay stretches the
                                                       sync window; error/
                                                       enospc/io_error fail
                                                       the covering ticket)
    wal.truncate_below  WAL file basename              checkpoint reclaim
                                                       (delay holds the
                                                       deleter mid-pass;
                                                       error aborts it —
                                                       retried next ckpt)
    ckpt.write          checkpoint name (ckpt_N)       image stream (per
                                                       chunk: delay holds
                                                       the writer mid-
                                                       stream; enospc/
                                                       io_error abort the
                                                       attempt, publishing
                                                       and truncating
                                                       nothing)
    ckpt.fsync          checkpoint name                image fsync (rides
                                                       the group-fsync
                                                       coordinator)
    ckpt.rename         checkpoint name                atomic publish
                                                       rename
    ckpt.ship           checkpoint name (ckpt_N)       follower image
                                                       shipping (per
                                                       fetched chunk:
                                                       delay holds the
                                                       shipper mid-image
                                                       so chaos can kill
                                                       a follower mid-
                                                       bootstrap; error/
                                                       io_error/enospc
                                                       fail the fetch —
                                                       the follower's
                                                       bootstrap retries)
    coldtier.fault      tiered table name              cold-tier fault-in
                                                       (delay
                                                       holds the read
                                                       mid-fault-in;
                                                       error/io_error/
                                                       enospc refuse it
                                                       with a typed
                                                       ColdMiss — never
                                                       a wrong value,
                                                       the client
                                                       retries on the
                                                       hint)
    bcounter.transfer   (key, granter_dc)              escrow grant plane
                                                       (delay
                                                       stretches a grant
                                                       so chaos can kill
                                                       the granter mid-
                                                       transfer; drop/
                                                       error starve the
                                                       requester — the
                                                       at-most-once
                                                       channel never
                                                       blind-resends, the
                                                       next tick re-asks)
    native_pump.load    None                           native receive plane
    native_frontend.load None                          native front end
                                                       (any action: the
                                                       server refuses to
                                                       start, typed)
    frontend.recv       None                           inbound frames on
                                                       either accept plane
                                                       (drop closes the
                                                       conn; truncate
                                                       keeps ``arg`` bytes;
                                                       delay sleeps)
    ==================  =============================  =================
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.rules: List[FaultRule] = []

    def add(self, site: str, action: str, key=None, p: float = 1.0,
            times: Optional[int] = None, arg: Any = None) -> "FaultPlan":
        self.rules.append(FaultRule(site, action, key, p, times, arg))
        return self

    # -- conveniences ---------------------------------------------------
    def drop(self, site: str, key=None, p: float = 1.0,
             times: Optional[int] = None) -> "FaultPlan":
        return self.add(site, "drop", key, p, times)

    def dup(self, site: str, key=None, p: float = 1.0,
            times: Optional[int] = None) -> "FaultPlan":
        return self.add(site, "dup", key, p, times)

    def delay(self, site: str, key=None, p: float = 1.0,
              times: Optional[int] = None, seconds: float = 0.0) -> "FaultPlan":
        return self.add(site, "delay", key, p, times, arg=seconds)

    def truncate(self, site: str, key=None, p: float = 1.0,
                 times: Optional[int] = None, keep: int = 4) -> "FaultPlan":
        return self.add(site, "truncate", key, p, times, arg=keep)

    def error(self, site: str, key=None, p: float = 1.0,
              times: Optional[int] = None, message: str = "injected fault"
              ) -> "FaultPlan":
        return self.add(site, "error", key, p, times, arg=message)

    def enospc(self, site: str = "wal.append", key=None, p: float = 1.0,
               times: Optional[int] = None) -> "FaultPlan":
        """Full-disk injection on the WAL append path: the site raises
        ``OSError(errno.ENOSPC)``, flipping the node into read-only
        degraded mode until the rule stops firing (auto-recovery)."""
        return self.add(site, "enospc", key, p, times)

    def io_error(self, site: str = "wal.append", key=None, p: float = 1.0,
                 times: Optional[int] = None) -> "FaultPlan":
        """Dying-device injection on the WAL append path
        (``OSError(errno.EIO)``); same degraded-mode path as enospc."""
        return self.add(site, "io_error", key, p, times)


class FaultInjector:
    """The armed form of a plan: holds the seeded RNG, live partition
    state, per-(site, action) hit counters, and the named kill/restart
    registry for endpoints (fabric listeners, RPC servers)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.rng = random.Random(plan.seed)
        self.rules = list(plan.rules)
        self.counts: Dict[Tuple[str, str], int] = {}
        #: severed link pairs, stored unordered (a partition cuts both
        #: the stream and the query channel in both directions)
        self._severed: set = set()
        #: name -> (kill_fn, restart_fn) for registered endpoints
        self._endpoints: Dict[str, Tuple[Callable, Callable]] = {}
        self._lock = threading.Lock()

    # -- rule evaluation ------------------------------------------------
    def hit(self, site: str, key=None) -> Optional[Decision]:
        """Evaluate the site against the plan; None means proceed
        normally.  The FIRST matching rule that fires wins."""
        with self._lock:
            for rule in self.rules:
                if not rule.matches(site, key):
                    continue
                if rule.p < 1.0 and self.rng.random() >= rule.p:
                    continue
                rule.fired += 1
                ck = (site, rule.action)
                self.counts[ck] = self.counts.get(ck, 0) + 1
                self._count_metric(site, rule.action)
                return Decision(rule.action, rule.arg, site)
        return None

    def _count_metric(self, site: str, action: str) -> None:
        try:
            from antidote_tpu_torch.obs.metrics import net_metrics

            net_metrics().faults_injected.inc(site=site, action=action)
        except Exception:  # metrics must never break injection
            pass

    def fired(self, site: str, action: Optional[str] = None) -> int:
        """Total decisions taken at a site (optionally one action)."""
        with self._lock:
            return sum(n for (s, a), n in self.counts.items()
                       if s == site and (action is None or a == action))

    # -- partitions -----------------------------------------------------
    def sever(self, a: int, b: int) -> None:
        """Cut the link between two DCs (both directions, both the
        stream and the query channel)."""
        with self._lock:
            self._severed.add(frozenset((a, b)))
        log.info("faults: severed link %s <-> %s", a, b)

    def heal(self, a: int, b: int) -> None:
        with self._lock:
            self._severed.discard(frozenset((a, b)))
        log.info("faults: healed link %s <-> %s", a, b)

    def heal_all(self) -> None:
        with self._lock:
            self._severed.clear()
        log.info("faults: all links healed")

    def is_severed(self, a, b) -> bool:
        if not self._severed:
            return False
        return frozenset((a, b)) in self._severed

    # -- endpoint kill/restart -----------------------------------------
    def register_endpoint(self, name: str, kill: Callable[[], None],
                          restart: Callable[[], None]) -> None:
        """Transports self-register their listeners here so chaos
        tests can crash and revive them by name."""
        with self._lock:
            self._endpoints[name] = (kill, restart)

    def endpoints(self) -> List[str]:
        with self._lock:
            return sorted(self._endpoints)

    def kill(self, name: str) -> None:
        kill, _ = self._endpoints[name]
        log.info("faults: killing endpoint %r", name)
        kill()

    def restart(self, name: str) -> None:
        _, restart = self._endpoints[name]
        log.info("faults: restarting endpoint %r", name)
        restart()


#: env var carrying a JSON fault plan for SUBPROCESS chaos: entrypoints
#: that cannot be reached by an in-process ``install`` (console serve
#: children the chaos suite SIGKILLs) arm it at boot via
#: :func:`install_from_env`.  Shape:
#:   {"seed": 7, "rules": [{"site": "ckpt.write", "action": "delay",
#:                          "key": null, "p": 1.0, "times": null,
#:                          "arg": 0.05}, ...]}
PLAN_ENV = "ANTIDOTE_FAULT_PLAN"


def plan_from_env() -> Optional[FaultPlan]:
    """Parse :data:`PLAN_ENV` into a FaultPlan (None when unset).  A
    malformed spec raises — a chaos run silently proceeding WITHOUT its
    faults would green-light untested behavior."""
    import json
    import os

    raw = os.environ.get(PLAN_ENV)
    if not raw:
        return None
    spec = json.loads(raw)
    plan = FaultPlan(seed=int(spec.get("seed", 0)))
    for r in spec.get("rules", []):
        key = r.get("key")
        if isinstance(key, list):
            key = tuple(key)
        plan.add(r["site"], r["action"], key=key,
                 p=float(r.get("p", 1.0)), times=r.get("times"),
                 arg=r.get("arg"))
    return plan


def install_from_env() -> Optional[FaultInjector]:
    """Arm the env-declared plan, if any (subprocess chaos hook)."""
    plan = plan_from_env()
    if plan is None:
        return None
    log.warning("arming fault plan from %s: %d rule(s), seed %d",
                PLAN_ENV, len(plan.rules), plan.seed)
    return install(plan)


# ---------------------------------------------------------------------------
# process-wide installation
# ---------------------------------------------------------------------------
_ACTIVE: Optional[FaultInjector] = None


def install(plan: FaultPlan) -> FaultInjector:
    """Arm a plan process-wide; returns the injector (also reachable via
    :func:`get_injector`).  Replaces any previously installed plan."""
    global _ACTIVE
    _ACTIVE = FaultInjector(plan)
    return _ACTIVE


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def get_injector() -> Optional[FaultInjector]:
    return _ACTIVE


def hit(site: str, key=None) -> Optional[Decision]:
    """Site-side fast path: one global read when no plan is armed."""
    inj = _ACTIVE
    if inj is None:
        return None
    return inj.hit(site, key)


def is_severed(a, b) -> bool:
    inj = _ACTIVE
    if inj is None:
        return False
    return inj.is_severed(a, b)


def armed_prefix(prefix: str) -> bool:
    """True when ANY armed rule targets a site under ``prefix`` — the
    native front-end consults this at server start: with a
    ``frontend.*`` rule armed it disables its in-C++ fast-serve path so
    every frame crosses to Python, where the rule actually fires (a
    natively-served hit would otherwise dodge the chaos plan)."""
    inj = _ACTIVE
    if inj is None:
        return False
    with inj._lock:
        return any(r.site.startswith(prefix) for r in inj.rules)
