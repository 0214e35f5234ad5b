"""Transaction layer: ClockSI snapshot transactions over the sharded store.

  * snapshot selection: txn snapshot VC = the DC's stable VC with the own
    lane at the commit counter, merged with the client's causal clock.
  * reads: batched device reads at the snapshot VC, with the
    transaction's own pending writes overlaid on top; maps assemble from
    one membership read per batch and one field read per nesting level.
    Reads without a write set go through the store's decoded-value cache
    (plain values, and maps assembled whole).
  * updates: type-check against the CRDT registry, run pre-commit hooks,
    expand map ops into membership and field updates, generate downstream
    effects (reading current state when the type requires it), number
    them per key within the txn, buffer in the write-set.
  * commit: first-committer-wins certification per key, skipped for blind
    updates of commutative types; the escrow pass reserves ``counter_b``
    rights once per key for the whole group; then one commit-counter bump
    per txn mints its commit VC and the effects reach the store in commit
    order.
  * tenancy: with a TenantRegistry installed (``tenants``, set by the wire
    server), a merged commit group is split into weight-proportional
    rounds, each a merged batch of its own, so one tenant's write storm
    cannot fill a whole merge while another tenant's commit waits.
  * serving epochs (``enable_serving_epochs``): a write-bearing commit
    round publishes a store-wide serving snapshot before it returns, so a
    lock-free epoch read admitted after the commit sees it; with the
    epoch plane idle, publishes are rate-limited and the lag floor
    ``epoch_lag_counter`` rises instead.
  * durability (a store with a log): each member of a commit group is
    logged failure-atomically on its own — a member whose WAL append is
    refused is NACKed alone — and no commit is acknowledged before the
    group fsync that covers it completed.  A refused append (ENOSPC, EIO)
    puts the node in degraded read-only mode: writes are refused typed,
    reads keep serving, and the mode exits once an append probe succeeds.
  * replication seams: ``commit_listeners`` see every acknowledged
    commit's effects (the inter-DC egress), ``on_clock_wait`` is pumped
    while a client clock waits for the stable snapshot, and
    ``apply_remote`` ingests a remote transaction.
  * protocols: ``clocksi`` (Cure, full-vector snapshots) or ``gr``
    (GentleRain: the remote lanes of a snapshot collapse to the scalar
    global stable time, the minimum over the lanes).
"""

from __future__ import annotations

import errno
import itertools
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt import COMPOSITE_NAMES, get_type, is_type
from antidote_tpu_torch.crdt import maps as maps_mod
from antidote_tpu_torch.overload import (BusyError, DeadlineExceeded,
                                         InsufficientRightsError,
                                         ReadOnlyError, check_deadline)
from antidote_tpu_torch.store.kv import BoundObject, Effect, KVStore, _pad_lane
from antidote_tpu_torch.txn.bcounter import BCounterManager
from antidote_tpu_torch.txn.hooks import HookRegistry

Update = Tuple[Any, str, str, Tuple[str, Any]]  # (key, type_name, bucket, op)

log = logging.getLogger(__name__)


class AbortError(Exception):
    """Transaction aborted (certification conflict or pre-commit hook)."""


class Transaction:
    _ids = itertools.count(1)

    def __init__(self, snapshot_vc: np.ndarray, props: Optional[dict] = None):
        self.txid = next(Transaction._ids)
        self.snapshot_vc = np.asarray(snapshot_vc, np.int32)
        self.props = dict(props or {})
        self.writeset: List[Tuple[Effect, Tuple[str, Any]]] = []
        self.active = True
        #: (key, bucket) -> host base state at the snapshot, read once
        self.base_states: Dict[Tuple[Any, str], Dict[str, Any]] = {}
        #: (key, bucket) -> (overlaid device state, n effects folded): the
        #: overlay advances incrementally as the write-set grows
        self.overlay_cache: Dict[Tuple[Any, str], Tuple[Any, int]] = {}
        #: tentative commit VC frozen at first overlay: all of the txn's
        #: uncommitted dots share one stamp (re-stamped at real commit)
        self.tentative_vc: Optional[np.ndarray] = None
        #: True once the txn performed a client-level read (read-modify-
        #: write txns keep first-committer-wins certification)
        self.did_read = False
        #: True once the txn buffered an update certification must cover
        #: (state-dependent downstream or a non-commutative type)
        self.cert_required = False

    def pending_for(self, key, bucket) -> List[Effect]:
        return [e for e, _ in self.writeset
                if e.key == key and e.bucket == bucket]


class TransactionManager:
    """One per replica — owns the commit stream for ``my_dc``."""

    def __init__(self, store: KVStore, my_dc: int = 0, cert: bool = True,
                 protocol: str = "clocksi"):
        if protocol not in ("clocksi", "gr"):
            raise ValueError(f"unknown transaction protocol {protocol!r} "
                             "(clocksi or gr)")
        self.store = store
        self.cfg: AntidoteConfig = store.cfg
        self.my_dc = my_dc
        self.cert = cert
        self.protocol = protocol
        self.commit_counter = 0
        #: held across counter increment -> apply -> commit listeners, and
        #: taken by anything deriving a SAFE time from the counter (the
        #: inter-DC heartbeat): a ping minted from a mid-commit counter
        #: would outrun its own transaction on the wire.  Reentrant:
        #: commit listeners themselves send heartbeats
        self.commit_lock = threading.RLock()
        #: True while a multi-transaction group is mid-publish: every
        #: member's counter is minted, so a safe-time ping must wait for
        #: the group's last egress message
        self._publishing_group = False
        #: called with (effects, commit_vc, origin) after every
        #: acknowledged local commit — the inter-DC egress seam
        self.commit_listeners: List = []
        #: called while a client clock waits for the stable snapshot; the
        #: inter-DC layer points it at its message pump
        self.on_clock_wait = lambda: None
        #: set by the inter-DC replica: remote transactions then apply on
        #: the pump's thread, writing the tables in place, so a read holds
        #: the commit lock (a read beside the drain could gather a head
        #: half-written by a remote transaction, or fold a ring the drain
        #: just collected past the read's snapshot)
        self.remote_ingest = False
        #: threads allowed to park on the commit lock before new commit
        #: attempts are refused with a typed BusyError
        self.max_commit_backlog = 64
        self._backlog_lock = threading.Lock()
        self._commit_backlog = 0
        #: multi-tenant QoS: when the serving layer installs a
        #: TenantRegistry here, a merged group-commit batch is split into
        #: weight-proportional ROUNDS so no tenant's writes occupy more
        #: than its share of the merge (work-conserving: a lone tenant
        #: still gets the whole batch).  None = untenanted.
        self.tenants = None
        #: (key, bucket) -> own-lane counter of its last certified commit;
        #: entries at or below every open txn's snapshot are GC'd
        self.committed_keys: Dict[Tuple[Any, str], int] = {}
        #: certification stamps touched since the last checkpoint capture
        #: (the delta link's committed-keys window); None = overflow past
        #: the cap: the next stamp rebases
        self.ckpt_dirty_committed: "set | None" = set()
        #: non-None while the node is in degraded READ-ONLY mode: the WAL
        #: refused an append.  Writes are refused with ReadOnlyError, reads
        #: keep serving; the mode exits once an append probe succeeds
        self.read_only_reason: Optional[str] = None
        #: earliest monotonic time of the next recovery probe
        self._ro_probe_at = 0.0
        #: open txid -> its own-lane snapshot (the GC floor)
        self._open_snaps: Dict[int, int] = {}
        self._cert_gc_every = 1024
        self._next_cert_gc = self._cert_gc_every
        self.hooks = HookRegistry()
        self.bcounters = BCounterManager(my_dc)
        #: NodeMetrics (attached by AntidoteNode) or None
        self.metrics = None
        #: serving-epoch publication: when enabled, every write-bearing
        #: commit round publishes a fresh store-wide serving snapshot
        #: before it returns
        self.serving_epochs = False
        #: highest own-lane commit counter returned while its publish was
        #: deferred, skipped or failed: clockless epoch reads may serve
        #: from an epoch only when it covers this floor (0 = every commit
        #: so far returned under a covering epoch)
        self.epoch_lag_counter = 0
        #: monotonic time of the last INLINE (commit-path) publish and the
        #: epoch-plane read count seen then — see EPOCH_INLINE_PUBLISH_S
        self._last_inline_publish = 0.0
        self._reads_at_last_publish = -1.0

    #: with the epoch plane idle (no cache or gather read since the last
    #: inline publish), a write round skips its publish when the last one
    #: is younger than this; the lag floor rises instead, and the next
    #: round after the window (or after any epoch read) publishes again.
    #: With epoch reads flowing, every write round publishes before it
    #: returns
    EPOCH_INLINE_PUBLISH_S = 0.025

    #: recovery probes while read-only are spaced at least this far apart
    RO_PROBE_INTERVAL_S = 0.25
    #: the errnos of a refused WAL append that flip read-only mode
    _DISK_ERRNOS = (errno.ENOSPC, errno.EIO, errno.EROFS, errno.EDQUOT)
    #: checkpoint windows of certification stamps past this size stop
    #: tracking (the next stamp rebases)
    _CKPT_COMMITTED_CAP = 262144

    @property
    def checkpoint_barrier(self):
        """The lock a checkpoint stamp holds: under it no commit, WAL
        append or apply is in flight, so (applied VC, commit counter,
        certification stamps, directory, WAL append sequences) form one
        consistent cut.  A checkpoint failing (ENOSPC while streaming its
        image) never flips read-only mode — that is the WAL append path's
        contract — and a read-only node can still checkpoint."""
        return self.commit_lock

    def check_writable(self) -> None:
        """Raise :class:`ReadOnlyError` while in degraded read-only mode.
        A call past the probe interval re-probes the WAL first, so the mode
        exits (on the next write attempt) once appends succeed again."""
        if self.read_only_reason is None:
            return
        now = time.monotonic()
        if now >= self._ro_probe_at and self.store.log is not None:
            self._ro_probe_at = now + self.RO_PROBE_INTERVAL_S
            try:
                self.store.log.probe_append()
            except OSError:
                pass
            else:
                log.warning("WAL appends succeed again; leaving degraded "
                            "read-only mode (was: %s)", self.read_only_reason)
                self.read_only_reason = None
                if self.metrics is not None:
                    self.metrics.degraded_read_only.set(0)
                return
        if self.metrics is not None:
            self.metrics.shed.inc(plane="read_only")
        raise ReadOnlyError(self.read_only_reason)

    def _enter_read_only(self, exc: OSError) -> None:
        self.read_only_reason = (
            f"WAL append failed ({errno.errorcode.get(exc.errno, exc.errno)}"
            f"): {exc}")
        self._ro_probe_at = time.monotonic() + self.RO_PROBE_INTERVAL_S
        if self.metrics is not None:
            self.metrics.degraded_read_only.set(1)
        log.error("entering degraded READ-ONLY mode: %s",
                  self.read_only_reason)

    def _wal_refusal(self, e: Exception) -> Exception:
        """A member's WAL refusal as the client sees it: a disk-class errno
        flips read-only mode (once) and surfaces typed; anything else
        passes through."""
        if isinstance(e, OSError) and e.errno in self._DISK_ERRNOS:
            if self.read_only_reason is None:
                self._enter_read_only(e)
            out = ReadOnlyError(self.read_only_reason)
            out.__cause__ = e
            return out
        return e

    # ------------------------------------------------------------------
    # serving-epoch publication (lock-split reads)
    # ------------------------------------------------------------------
    def enable_serving_epochs(self) -> None:
        # clocksi only: a GentleRain client holds scalarized clocks, and
        # an epoch's full vector handed back as one could stall forever
        if self.protocol == "clocksi":
            self.serving_epochs = True

    def serving_epoch_vc(self) -> np.ndarray:
        """The publishable snapshot clock E: the freshest applied lanes
        with the own lane raised to the commit counter.  Caller must hold
        the commit lock (E must be captured with no apply in flight)."""
        vc = self.store.dc_max_vc().copy()
        vc[self.my_dc] = max(int(vc[self.my_dc]), self.commit_counter)
        return vc

    def publish_serving_epoch(self) -> str:
        """Publish under the commit lock (a no-op when the current epoch
        already covers the store)."""
        with self.commit_lock:
            return self._publish_serving_epoch_locked()

    def _publish_serving_epoch_locked(self) -> str:
        st = self.store.publish_serving_epoch(self.serving_epoch_vc())
        self.native_advance_locked()
        return st

    def native_advance_locked(self) -> None:
        """Move the native front end's mirror to the current serving epoch
        (caller holds the commit lock).  Every publish runs it — the
        ticker's, a remote apply's and a write round's inline one, before
        the round's acknowledgements leave — so the C++ hit check
        (``stamp == cur_epoch``) never serves an entry that a published
        write has passed: a late fill stamped with the previous epoch
        misses from the moment the publish returns.  Under the commit
        lock, advances reach the mirror in epoch order."""
        nm = self.store.native_mirror
        if nm is None:
            return
        ep = self.store.serving_epoch
        if ep is None:
            nm.set_clockless_ok(False)
            return
        nm.advance(int(ep.id), ep.vc.tolist(),
                   int(ep.vc[self.my_dc]) >= self.epoch_lag_counter)

    def _native_lag_raised(self) -> None:
        """The serving epoch just started lagging the commit counter: the
        native front end must stop serving clockless reads from it (the
        Python cache read refuses through ``epoch_lag_counter``; the C++
        loop learns the same fact here).  The next publish that catches
        up turns it back on (``native_advance_locked``)."""
        nm = self.store.native_mirror
        if nm is not None:
            nm.set_clockless_ok(False)

    # ------------------------------------------------------------------
    # transaction lifecycle
    # ------------------------------------------------------------------

    def _snapshot_vc(self) -> np.ndarray:
        """Remote lanes from the DC stable snapshot, own lane from the
        commit counter (local commits apply synchronously).  GentleRain
        replaces the vector with the scalar GST — the minimum entry over
        the lanes — on every lane but the own one."""
        snap = self.store.stable_vc().copy()
        snap[self.my_dc] = self.commit_counter
        if self.protocol == "gr":
            gst = int(snap.min())
            snap = np.full_like(snap, gst)
            snap[self.my_dc] = self.commit_counter
        return snap

    def start_transaction(self, clock: Optional[np.ndarray] = None,
                          props: Optional[dict] = None) -> Transaction:
        snap = self._snapshot_vc()
        if clock is not None:
            clock = np.asarray(clock, np.int32)
            mask = np.arange(len(snap)) != self.my_dc
            for _ in range(10_000):
                if (clock[mask] <= snap[mask]).all():
                    break
                # a remote lane ahead of the stable snapshot: wait for
                # replication to bring it (the inter-DC pump runs here)
                self.on_clock_wait()
                snap = self._snapshot_vc()
            else:
                raise TimeoutError(
                    f"stable snapshot {snap} never reached client clock "
                    f"{clock}")
            snap = np.maximum(snap, clock)
        if self.metrics is not None:
            self.metrics.open_transactions.inc()
        txn = Transaction(snap, props)
        self._open_snaps[txn.txid] = int(snap[self.my_dc])
        return txn

    def read_objects(self, objects: Sequence[BoundObject], txn: Transaction,
                     _internal: bool = False):
        if self.remote_ingest:
            with self.commit_lock:
                return self._read_objects(objects, txn, _internal)
        return self._read_objects(objects, txn, _internal)

    def _read_objects(self, objects: Sequence[BoundObject],
                      txn: Transaction, _internal: bool):
        assert txn.active
        if not _internal:
            # a client-level read makes the txn read-bearing: the
            # commutativity bypass is off for it (internal reads — map
            # fields, downstream state — mark cert_required at the update)
            txn.did_read = True
            if self.metrics is not None:
                self.metrics.operations.inc(len(objects), type="read")
        out: List[Any] = [None] * len(objects)
        plain = [i for i, o in enumerate(objects)
                 if o[1] not in COMPOSITE_NAMES]
        comp = [i for i, o in enumerate(objects) if o[1] in COMPOSITE_NAMES]
        if plain:
            objs = [objects[i] for i in plain]
            if txn.writeset:
                # the pending-write overlay needs full states on the host
                states = self._read_states_with_overlay(objs, txn)
                vals = [get_type(t).value(st, self.store.blobs, self.cfg)
                        for (_, t, _), st in zip(objs, states)]
            else:
                vals = self._read_values_resolved(objs, txn)
            for i, v in zip(plain, vals):
                out[i] = v
        if comp:
            vals = self._read_maps([objects[i] for i in comp], txn)
            for i, v in zip(comp, vals):
                out[i] = v
        return out

    def _read_maps(self, objects, txn: Transaction) -> List[dict]:
        """Map values, assembled per nesting level (``maps.assemble``).
        Without a write set they are value-cached whole: a write to any
        field or to the membership invalidates the parent's entry (the
        derived-key walk of ``KVStore.apply_effect_groups``)."""
        def assemble(objs):
            return maps_mod.assemble(
                objs, lambda o: self.read_objects(o, txn, _internal=True))

        if not txn.writeset:
            return self._cached_values(objects, txn, assemble)
        return assemble(objects)

    def _read_values_resolved(self, objs, txn: Transaction) -> List[Any]:
        """Values via the serving read, through the decoded-value cache:
        a hit skips the device gather and the decode; misses fall through
        and latest reads back-fill the cache."""
        return self._cached_values(
            objs, txn, lambda miss: self._values_resolved_uncached(miss, txn))

    def _values_resolved_uncached(self, objs, txn: Transaction) -> List[Any]:
        """The cache's misses, through the store's resolved read at the
        transaction's snapshot (``KVStore.read_values_resolved``)."""
        return self.store.read_values_resolved(objs, txn.snapshot_vc)

    def _cached_values(self, objs, txn: Transaction, compute) -> List[Any]:
        """The decoded-value-cache protocol of plain and composite reads:
        bulk probe, ``compute`` the misses, back-fill latest reads under
        the mutation-epoch guard (a commit between capture and fill drops
        the fill)."""
        read_tup = tuple(int(x) for x in txn.snapshot_vc)
        allv, miss_idx = self.store.value_cache_bulk_get(objs, read_tup)
        if not miss_idx:
            return allv
        fill_vc = self.store.applied_max_tuple()
        fill_epoch = self.store.mutation_epoch
        is_latest = all(r >= f for r, f in zip(read_tup, fill_vc))
        miss_objs = [objs[j] for j in miss_idx]
        vals = compute(miss_objs)
        if is_latest:
            for (key, _t, bucket), v in zip(miss_objs, vals):
                self.store.value_cache_fill(key, bucket, v, fill_vc,
                                            fill_epoch)
        for j, gi in enumerate(miss_idx):
            allv[gi] = vals[j]
        return allv

    def update_objects(self, updates: Sequence[Update],
                       txn: Transaction) -> None:
        assert txn.active
        if self.metrics is not None:
            self.metrics.operations.inc(len(updates), type="update")
        for u in updates:
            self._apply_update(u, txn, run_hooks=True)

    def _apply_update(self, update, txn: Transaction,
                      run_hooks: bool = False) -> None:
        key, type_name, bucket, op = update
        if not is_type(type_name):
            raise TypeError(f"unknown CRDT type {type_name!r}")
        ty = get_type(type_name)
        if not ty.is_operation(op):
            raise TypeError(f"invalid operation {op!r} for {type_name}")
        if run_hooks:
            try:
                key, type_name, op = self.hooks.execute_pre_commit_hook(
                    key, type_name, bucket, op)
            except Exception as e:
                self._mark_aborted(txn)
                raise AbortError(f"pre-commit hook failed: {e}") from e
            # re-validate the hook-transformed update: a misbehaving hook
            # must abort, not generate malformed effects
            if not is_type(type_name):
                self._mark_aborted(txn)
                raise AbortError(
                    f"pre-commit hook produced unknown type {type_name!r}")
            ty = get_type(type_name)
            if not ty.is_operation(op):
                self._mark_aborted(txn)
                raise AbortError(f"pre-commit hook produced invalid op "
                                 f"{op!r} for {type_name}")
        if type_name in COMPOSITE_NAMES:
            # a map op expands into membership and field updates; the
            # children skip the bucket hooks (they ran on the map op)
            txn.cert_required = True

            def read_field_value(fk, ft):
                return self.read_objects([(fk, ft, bucket)], txn,
                                         _internal=True)[0]

            for sub in maps_mod.expand_update(key, type_name, bucket, op,
                                              read_field_value):
                self._apply_update(sub, txn)
            return
        guarded_b = (type_name == "counter_b"
                     and op[0] in ("decrement", "transfer"))
        if (guarded_b or ty.require_state_downstream(op)
                or not ty.commutative_blind):
            txn.cert_required = True
        state = None
        # the key's slot-tier cfg: a promoted key's state has the wider
        # tier's widths
        cfg_k = self.cfg
        if ty.require_state_downstream(op):
            state = self._read_states_with_overlay(
                [(key, type_name, bucket)], txn)[0]
            ent = self.store.locate(key, type_name, bucket, create=False)
            if ent is not None:
                cfg_k = self.store.table(ent[0]).cfg
        # escrow lane guard: a counter_b decrement or outgoing transfer
        # must spend THIS replica's lane; whether the lane holds the
        # rights is the commit's escrow pass
        if guarded_b:
            src_lane = op[1][-1]
            if src_lane != self.my_dc:
                self._mark_aborted(txn)
                raise AbortError(
                    f"counter_b {op[0]} must spend this replica's lane "
                    f"{self.my_dc}, not {src_lane}")
        seq = len(txn.pending_for(key, bucket))
        for eff_a, eff_b, blob_refs in ty.downstream(op, state,
                                                     self.store.blobs, cfg_k):
            eff_a, eff_b = ty.stamp_op_seq(eff_a, eff_b, seq)
            seq += 1
            txn.writeset.append(
                (Effect(key, type_name, bucket, eff_a, eff_b, blob_refs), op))

    def commit_transaction(self, txn: Transaction) -> np.ndarray:
        out = self.commit_transactions_group([txn])[0]
        if isinstance(out, Exception):
            raise out
        return out

    def commit_transactions_group(self, txns: Sequence[Transaction],
                                  deadline: Optional[float] = None):
        """Commit several independent transactions as ONE grouped store
        append — semantically identical to committing them one after the
        other: each txn gets its own commit timestamp, certification is
        first-committer-wins INCLUDING against earlier txns of the group,
        and effects reach the store in commit order.  Returns, per txn, the
        commit VC or the AbortError it would have raised.

        Admission is bounded: past ``max_commit_backlog`` parked callers
        the group is refused with :class:`BusyError` (the txns stay open
        for a retry).  ``deadline`` (absolute monotonic) is re-checked
        once the lock is held.  A write-bearing group is refused with
        :class:`ReadOnlyError` in degraded read-only mode (the check also
        runs the recovery probe).

        With ``tenants`` installed the group is split into
        weight-proportional rounds (:meth:`_tenant_rounds`).  The
        deadline and writable checks gate the FIRST round only: a
        first-round failure re-raises (nothing committed); a later
        round's failure must not raise — earlier rounds' commit VCs are
        final — so it becomes the failed txns' per-txn results (their
        txns aborted)."""
        has_writes = any(t.writeset for t in txns)
        rounds = self._tenant_rounds(txns)
        with self._backlog_lock:
            if self._commit_backlog >= self.max_commit_backlog:
                if self.metrics is not None:
                    self.metrics.shed.inc(plane="txn")
                raise BusyError(
                    f"commit backlog at max_commit_backlog="
                    f"{self.max_commit_backlog}")
            self._commit_backlog += 1
        try:
            results: dict = {}
            outs = self._commit_round(rounds[0], deadline, has_writes,
                                      first=True)
            for t, r in zip(rounds[0], outs):
                results[id(t)] = r
            for ri in range(1, len(rounds)):
                try:
                    outs = self._commit_round(rounds[ri], deadline,
                                              has_writes, first=False)
                except BaseException as e:
                    # rounds before this one COMMITTED: fail the rest per
                    # txn (aborted), never the whole group, or a client's
                    # resend would double-apply the acknowledged ones
                    err = e if isinstance(e, Exception) \
                        else RuntimeError(f"commit round failed: {e!r}")
                    for rnd in rounds[ri:]:
                        for t in rnd:
                            if t.active:
                                self._mark_aborted(t)
                            results[id(t)] = err
                    break
                for t, r in zip(rounds[ri], outs):
                    results[id(t)] = r
            if has_writes and self.store.log is not None \
                    and self.metrics is not None:
                for i, d in enumerate(self.store.log.segment_depths()):
                    self.metrics.wal_segment_depth.set(d, segment=str(i))
            return [results[id(t)] for t in txns]
        except BaseException:
            # a failed group must not leak open transactions: they pin the
            # certification-GC floor forever
            for t in txns:
                if t.active:
                    self._mark_aborted(t)
            raise
        finally:
            with self._backlog_lock:
                self._commit_backlog -= 1

    def _tenant_rounds(self, txns: Sequence[Transaction]) -> List[List]:
        """Weight-proportional round split of one merged commit group.
        Untenanted managers, single-member groups and groups whose
        members all belong to one tenant keep the one-round path."""
        reg = self.tenants
        if reg is None or not reg.multi or len(txns) <= 1:
            return [list(txns)]
        from antidote_tpu_torch.tenancy import batch_rounds

        def tenant_of(t):
            return reg.resolve(None, (e.bucket for e, _ in t.writeset))

        return batch_rounds(list(txns), tenant_of, reg)

    def _commit_round(self, txns: Sequence[Transaction],
                      deadline: Optional[float], has_writes: bool,
                      first: bool):
        """One round under the commit lock; the deadline and writable
        checks run on the first round only."""
        with self.commit_lock:
            if first:
                try:
                    check_deadline(deadline, "commit dequeue")
                except DeadlineExceeded:
                    if self.metrics is not None:
                        self.metrics.shed.inc(plane="deadline")
                    raise
                if has_writes:
                    self.check_writable()
            return self._commit_round_locked(txns)

    def _commit_round_locked(self, txns: Sequence[Transaction]):
        """One merged commit round under the lock, then — for a
        write-bearing round with serving epochs on — the inline publish
        before the round returns (a clockless epoch read admitted after
        this commit must find an epoch that covers it).  A deferred,
        skipped or failed publish raises the lag floor instead: epoch
        reads below it go to the (always fresh) locked path."""
        round_writes = any(t.writeset for t in txns)
        t0 = time.monotonic()
        try:
            out = self._commit_group_locked(txns)
            if round_writes and self.serving_epochs:
                self._publish_inline()
        except OSError as e:
            if round_writes and e.errno in self._DISK_ERRNOS:
                # the WAL refused the append before any table mutated
                # (durability first): fail the round, go read-only
                self._enter_read_only(e)
                raise ReadOnlyError(self.read_only_reason) from e
            raise
        finally:
            if self.metrics is not None and round_writes:
                self.metrics.commit_seconds.observe(time.monotonic() - t0)
                self.metrics.commit_merge_width.observe(
                    sum(1 for t in txns if t.writeset))
        return out

    def _publish_inline(self) -> None:
        """The write round's publish, skipped while the epoch plane is
        idle and the last inline publish is younger than
        ``EPOCH_INLINE_PUBLISH_S`` (a write storm with no epoch reader
        would otherwise pay a publish per round serving nobody)."""
        now = time.monotonic()
        reads_now = -1.0
        if self.metrics is not None:
            sr = self.metrics.serving_reads
            reads_now = sr.value(path="cache") + sr.value(path="gather")
        idle = reads_now == self._reads_at_last_publish
        if idle and now - self._last_inline_publish \
                < self.EPOCH_INLINE_PUBLISH_S:
            self.epoch_lag_counter = self.commit_counter
            self._native_lag_raised()
            return
        self._last_inline_publish = now
        self._reads_at_last_publish = reads_now
        try:
            st = self._publish_serving_epoch_locked()
        except Exception:
            st = "error"
            log.exception("serving-epoch publish failed")
        if st not in ("published", "noop"):
            self.epoch_lag_counter = self.commit_counter
            self._native_lag_raised()

    def _commit_group_locked(self, txns: Sequence[Transaction]):
        out: List[Any] = []
        # (txn, commit_vc, effects, stamped {ck: prev}, counter)
        pend: List[tuple] = []
        # each unique written key is looked up once for the whole group;
        # members then check/update this batch-local view
        last_seen: Dict[tuple, int] = {}
        for txn in txns:
            for eff, _ in txn.writeset:
                ck = (eff.key, eff.bucket)
                if ck not in last_seen:
                    last_seen[ck] = self.committed_keys.get(ck, 0)
        esc_spends, esc_avail = self._escrow_ledger(txns)
        for txn in txns:
            assert txn.active
            txn.active = False
            self._open_snaps.pop(txn.txid, None)
            if self.metrics is not None:
                self.metrics.open_transactions.dec()
            if not txn.writeset:
                out.append(txn.snapshot_vc.copy())
                continue
            explicit = txn.props.get("certify")
            cert = self.cert if explicit is None else bool(explicit)
            # commutativity bypass: blind updates of commutative types from
            # a txn that read nothing commute with every interleaving, so
            # they need no first-committer-wins round.  An EXPLICIT
            # certify=true prop opts back in.
            bypass = (cert and explicit is None and not txn.did_read
                      and not txn.cert_required)
            if bypass:
                cert = False
                if self.metrics is not None:
                    self.metrics.cert_bypass.inc()
            snap_here = int(txn.snapshot_vc[self.my_dc])
            conflict = next((eff.key for eff, _ in txn.writeset
                             if last_seen[(eff.key, eff.bucket)] > snap_here),
                            None) if cert else None
            if conflict is not None:
                if self.metrics is not None:
                    self.metrics.aborted_transactions.inc()
                out.append(AbortError(
                    f"certification conflict on key {conflict!r}"))
                continue
            refusal = self._escrow_reserve(esc_spends.get(txn.txid),
                                           esc_avail)
            if refusal is not None:
                if self.metrics is not None:
                    self.metrics.aborted_transactions.inc()
                    self.metrics.escrow_refusals.inc()
                    self.metrics.escrow_shortfall.set(
                        self.bcounters.shortfall())
                out.append(refusal)
                continue
            self.commit_counter += 1
            commit_vc = txn.snapshot_vc.copy()
            commit_vc[self.my_dc] = self.commit_counter
            # dots observed from the txn's OWN overlay carry the tentative
            # own-lane ts; if other txns committed in between, the real ts
            # differs — rewrite them
            if txn.tentative_vc is not None:
                tent_own = int(txn.tentative_vc[self.my_dc])
                if tent_own != self.commit_counter:
                    for eff, _ in txn.writeset:
                        eff.eff_a, eff.eff_b = get_type(
                            eff.type_name).restamp_own_dots(
                                self.cfg, eff.eff_a, eff.eff_b, self.my_dc,
                                tent_own, self.commit_counter)
            if self.metrics is not None:
                self.metrics.commit_batch_size.observe(len(txn.writeset))
            # mark BEFORE later group members certify; bypassed members
            # never touch the stamp table (a blind write invalidates nobody)
            stamped: Dict[tuple, Optional[int]] = {}
            if not bypass:
                for eff, _ in txn.writeset:
                    ck = (eff.key, eff.bucket)
                    if ck not in stamped:
                        stamped[ck] = self.committed_keys.get(ck)
                    self.committed_keys[ck] = self.commit_counter
                    ckd = self.ckpt_dirty_committed
                    if ckd is not None:
                        ckd.add(ck)
                        if len(ckd) > self._CKPT_COMMITTED_CAP:
                            self.ckpt_dirty_committed = None
                    last_seen[ck] = self.commit_counter
            pend.append((len(out), txn, commit_vc,
                         [e for e, _ in txn.writeset], stamped,
                         self.commit_counter))
            out.append(commit_vc)
        if pend:
            try:
                errors, ticket = self.store.apply_effect_groups([
                    (effs, [vc] * len(effs), [self.my_dc] * len(effs))
                    for _i, _t, vc, effs, _s, _c in pend
                ])
            except BaseException:
                # nothing reached the store: un-stamp every member's marks
                # and counters, or later txns would first-committer-abort
                # against writes that never existed
                for _i, _t, _vc, _e, stamped, ctr in reversed(pend):
                    self._unstamp(stamped, ctr)
                self.commit_counter = pend[0][5] - 1
                raise
            # failure-atomic PER MEMBER: a NACKed member rolls back only
            # its own stamps (reverse order unwinds same-key overwrites)
            # and keeps its counter hole — certification compares
            # magnitudes, so holes are safe
            ok = []
            for (i, txn, vc, effs, stamped, ctr), err in zip(
                    reversed(pend), reversed(errors)):
                if err is None:
                    ok.append((i, txn, vc, effs))
                    continue
                self._unstamp(stamped, ctr)
                out[i] = self._wal_refusal(err)
            ok.reverse()
            # the acknowledgement gate: the group fsync, submitted before
            # the device apply and run beside it, must complete before any
            # member is acknowledged.  A failed or stalled fsync fails
            # every acknowledgement of the group typed (read-only mode)
            if ticket is not None:
                try:
                    try:
                        ticket.wait()
                    except TimeoutError as e:
                        raise OSError(errno.EIO,
                                      f"WAL group fsync stalled: {e}") from e
                except OSError as e:
                    err = self._wal_refusal(e)
                    for i, _txn, _vc, _effs in ok:
                        out[i] = err
                    ok = []
            # every member's counter is minted but members publish one at
            # a time: a safe-time ping from an early member's listener
            # would cover later members not yet on the stream, and a
            # subscriber would drop them as duplicates.  The flag defers
            # such pings until the whole group is published
            self._publishing_group = len(ok) > 1
            try:
                for _i, txn, vc, effs in ok:
                    for listener in self.commit_listeners:
                        listener(effs, vc, self.my_dc)
                    for eff, op in txn.writeset:
                        self.hooks.execute_post_commit_hook(
                            eff.key, eff.type_name, eff.bucket, op)
            finally:
                self._publishing_group = False
        if self.commit_counter >= self._next_cert_gc:
            self._gc_committed_keys()
            self._next_cert_gc = self.commit_counter + self._cert_gc_every
        return out

    def _unstamp(self, stamped: Dict[tuple, Optional[int]], ctr: int) -> None:
        """Undo one member's certification stamps (those still its own)."""
        for ck, old in stamped.items():
            if self.committed_keys.get(ck) == ctr:
                if old is None:
                    self.committed_keys.pop(ck, None)
                else:
                    self.committed_keys[ck] = old

    def _escrow_ledger(self, txns):
        """The escrow pass's batch-local view: per txn, its net counter_b
        spends per key ``{ck: (net spend, decremented)}``, and per spent
        key the rights this lane holds, read ONCE for the whole group at
        the freshest local view.  Within a txn, spends net against its own
        increments on this lane (its effects apply atomically), but a
        surplus never credits the group's ledger."""
        spends: Dict[int, Dict[tuple, Tuple[int, int]]] = {}
        avail: Dict[tuple, int] = {}
        for txn in txns:
            dec: Dict[tuple, int] = {}
            spend: Dict[tuple, int] = {}
            credit: Dict[tuple, int] = {}
            for eff, op in txn.writeset:
                if eff.type_name != "counter_b":
                    continue
                ck = (eff.key, eff.bucket)
                n = int(op[1][0])
                if op[0] in ("decrement", "transfer"):
                    spend[ck] = spend.get(ck, 0) + n
                    if op[0] == "decrement":
                        dec[ck] = dec.get(ck, 0) + n
                elif op[0] == "increment" and op[1][1] == self.my_dc:
                    credit[ck] = credit.get(ck, 0) + n
            net = {ck: (n - credit.get(ck, 0), dec.get(ck, 0))
                   for ck, n in spend.items() if n > credit.get(ck, 0)}
            if net:
                spends[txn.txid] = net
                avail.update(dict.fromkeys(net, 0))
        if avail:
            ty_b = get_type("counter_b")
            keys = list(avail)
            states = self.store.read_states(
                [(k, "counter_b", b) for k, b in keys],
                self.store.dc_max_vc())
            for ck, st in zip(keys, states):
                avail[ck] = int(ty_b.local_rights(st, self.my_dc))
        return spends, avail

    def _escrow_reserve(self, spends, avail):
        """Reserve one txn's net spends against the group's ledger.
        Returns the typed refusal for the first key short of rights
        (nothing reserved), or None once every spend is reserved."""
        if spends is None:
            return None
        short = next(((ck, n, d) for ck, (n, d) in spends.items()
                      if n > avail[ck]), None)
        if short is not None:
            (key, bucket), needed, dec_amt = short
            if dec_amt > 0:
                self.bcounters.note_refusal(key, bucket, dec_amt)
            else:
                # a refused outgoing transfer is not queued as demand
                self.bcounters.refused_total += 1
            return InsufficientRightsError(
                f"insufficient rights for {key!r}: need {needed}, hold "
                f"{avail[(key, bucket)]}",
                retry_after_ms=self.bcounters.grant_hint_ms(key, bucket),
                key=key, needed=needed, held=avail[(key, bucket)])
        for ck, (n, _d) in spends.items():
            avail[ck] -= n
            self.bcounters.satisfied(*ck)
        return None

    def _gc_committed_keys(self) -> None:
        """Drop certification entries no open (or future) txn can conflict
        with: cert aborts iff last_commit > snapshot, every open txn's
        own-lane snapshot is ≥ the floor, and future txns start at the
        current counter."""
        floor = min(self._open_snaps.values(), default=self.commit_counter)
        if self.commit_counter - floor > 64 * self._cert_gc_every:
            import warnings

            warnings.warn(
                f"certification GC floor lags {self.commit_counter - floor} "
                f"commits behind: {len(self._open_snaps)} transaction(s) "
                "left open",
                RuntimeWarning,
                stacklevel=2,
            )
        if floor <= 0:
            return
        self.committed_keys = {
            k: v for k, v in self.committed_keys.items() if v > floor
        }

    def _mark_aborted(self, txn: Transaction) -> None:
        """Close an active txn as aborted, keeping the gauge and the
        counter exact."""
        self._open_snaps.pop(txn.txid, None)
        if txn.active and self.metrics is not None:
            self.metrics.open_transactions.dec()
            self.metrics.aborted_transactions.inc()
        txn.active = False

    def abort_transaction(self, txn: Transaction) -> None:
        self._mark_aborted(txn)
        txn.writeset.clear()

    # ------------------------------------------------------------------
    # static transactions
    # ------------------------------------------------------------------
    def update_objects_static(self, updates: Sequence[Update],
                              clock: Optional[np.ndarray] = None
                              ) -> np.ndarray:
        txn = self.start_transaction(clock)
        try:
            self.update_objects(updates, txn)
            return self.commit_transaction(txn)
        except Exception:
            if txn.active:
                self.abort_transaction(txn)
            raise

    def read_objects_static(self, objects: Sequence[BoundObject],
                            clock: Optional[np.ndarray] = None):
        txn = self.start_transaction(clock)
        try:
            vals = self.read_objects(objects, txn)
            self.commit_transaction(txn)  # empty write-set: closes the txn
        except Exception:
            if txn.active:
                self.abort_transaction(txn)
            raise
        return vals, txn.snapshot_vc

    # ------------------------------------------------------------------
    # remote ingestion (the inter-DC causal gate's apply)
    # ------------------------------------------------------------------
    def apply_remote(self, effects: Sequence[Effect], commit_vc: np.ndarray,
                     origin: int) -> None:
        commit_vc = np.asarray(commit_vc, np.int32)
        with self.commit_lock:
            self.store.apply_effects(effects, [commit_vc] * len(effects),
                                     [origin] * len(effects))
            if self.serving_epochs:
                # keep the lock-free read plane moving with replication.
                # No lag-floor bump: remote effects were never acknowledged
                # to a local client, so clockless reads owe them nothing
                # (the ticker's retry publishes them within a tick)
                try:
                    self._publish_serving_epoch_locked()
                except Exception:
                    log.exception("serving-epoch publish failed")

    # ------------------------------------------------------------------
    def _read_states_with_overlay(self, objects, txn: Transaction):
        """Host states at the txn snapshot with its pending writes applied
        on the store's device (stamped with a tentative commit VC one past
        the snapshot, frozen at the txn's first overlay)."""
        miss = [i for i, (k, _t, b) in enumerate(objects)
                if (k, b) not in txn.base_states]
        if miss:
            fresh = self.store.read_states([objects[i] for i in miss],
                                           txn.snapshot_vc)
            for i, st in zip(miss, fresh):
                k, _t, b = objects[i]
                txn.base_states[(k, b)] = st
        states = [txn.base_states[(k, b)] for k, _t, b in objects]
        if not txn.writeset:
            return states
        if txn.tentative_vc is None:
            tentative = txn.snapshot_vc.copy()
            tentative[self.my_dc] = self.commit_counter + 1
            txn.tentative_vc = tentative
        for i, (key, type_name, bucket) in enumerate(objects):
            pend = txn.pending_for(key, bucket)
            if not pend:
                continue
            # overlay at the key's slot-tier widths
            ent = self.store.locate(key, type_name, bucket, create=False)
            cfg_k = self.store.table(ent[0]).cfg if ent else self.cfg
            dk = (key, bucket)
            cached = txn.overlay_cache.get(dk)
            if cached is not None and cached[1] <= len(pend):
                state, done = cached
            else:
                state, done = states[i], 0
            state = overlay_effects(get_type(type_name), cfg_k, state,
                                    pend[done:], txn.tentative_vc,
                                    self.my_dc, self.store.device,
                                    fresh=done == 0)
            txn.overlay_cache[dk] = (state, len(pend))
            states[i] = host_state(state)
        return states


def host_state(state) -> Dict[str, np.ndarray]:
    """A host copy of one key's overlay state: the ``[1, ...]`` tensors a
    batched ``apply`` returns, or the numpy arrays of an ``apply_host``."""
    return {f: (x[0].cpu().numpy() if isinstance(x, torch.Tensor) else x)
            for f, x in state.items()}


def overlay_effects(ty, cfg_k, state, effects, tentative_vc, my_dc: int,
                    device, fresh: bool):
    """Fold pending effects onto one key's state, stamped with the
    tentative commit VC at lane ``my_dc``.  Types with a host twin
    (``apply_host``, rga) fold numpy arrays on the host: a transaction's
    Nth insert then costs a few array ops instead of device launches.
    Other types fold through their batched ``apply`` on ``device``, on a
    batch of one.  ``fresh`` says ``state`` is a host base state (not an
    earlier overlay's result)."""
    apply_host = getattr(ty, "apply_host", None)
    if apply_host is not None:
        tvc = np.asarray(tentative_vc, np.int32)
        for eff in effects:
            state = apply_host(
                cfg_k, state,
                _pad_lane(eff.eff_a, ty.eff_a_width(cfg_k), np.int64),
                _pad_lane(eff.eff_b, ty.eff_b_width(cfg_k), np.int32),
                tvc, my_dc)
        return state
    if fresh:
        state = {f: torch.as_tensor(x, device=device)[None]
                 for f, x in state.items()}
    tvc = torch.as_tensor(np.asarray(tentative_vc, np.int32),
                          device=device)[None]
    origin = torch.full((1,), my_dc, dtype=torch.int32, device=device)
    for eff in effects:
        a = _pad_lane(eff.eff_a, ty.eff_a_width(cfg_k), np.int64)
        b = _pad_lane(eff.eff_b, ty.eff_b_width(cfg_k), np.int32)
        state = ty.apply(cfg_k, state, torch.tensor(a, device=device)[None],
                         torch.tensor(b, device=device)[None], tvc, origin)
    return state
