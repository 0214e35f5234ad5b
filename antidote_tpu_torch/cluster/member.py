"""ClusterMember — one member of a multi-member DC.

A DC's shards spread over N members joined by the intra-DC RPC:

  * shard ownership: member ``i`` of ``n`` owns shards {s : s % n == i};
    the explicit ``shard_map`` (shard -> owner) is the routing truth;
  * member 0 is the DC's commit SEQUENCER: it mints the DC-wide own-lane
    commit timestamps, returning per-shard previous-ts chains so owners
    apply own-DC commits gap-free in ts order, and keeps the ledger of
    every issue (which txn holds which ts) that takeover consults;
  * owners certify at prepare (first-committer-wins per key + a prepared
    lock) and apply at commit;
  * stable time: each member gossips its owned shards' applied clock rows;
    the DC stable snapshot is the entry-wise min over the assembled
    (shards x D) matrix via ``stable_min_of`` — with the cluster's shard
    count at or past its threshold, the ``stable_min`` kernel on the
    member's device.

Coordinators (``cluster/coordinator.py``) run on any member and drive these
handlers over the RPC.

Fault tolerance (the reference's supervised coordinators and vnode
takeover):

  * PREPARE LOG: with a ``log_dir``, every prepare, commit and abort and
    every sequencer issue is appended to a durable ``prepare.wal`` beside
    the shard WALs (the JAX package's records, byte for byte), so staged
    write-sets and the ts ledger survive a member crash.
  * TAKEOVER: a coordinator dying between sequencing and the commit
    fan-out leaves a hole in a shard's ts chain.  Any member can call
    ``resolve_wedged()``: the sequencer looks up the blocking txn, polls
    every member for its outcome, and either completes the commit (someone
    already applied it — atomicity) or aborts it everywhere after a block
    barrier that shuts the door on a still-racing zombie coordinator.
    Decisions are recorded at the sequencer, so re-resolution is
    idempotent.
  * REJOIN: boot with ``recover=True`` on the same ``log_dir`` — the store
    replays its WAL onto the member's device, the prepare log restores
    staged txns, prepared locks and the sequencer ledger, and
    ``resolve_wedged()`` settles anything issued around the crash.

LIVE MEMBERSHIP (``cluster/join.py``): shards move one at a time between
members while the DC serves — a two-phase move (export a copy, import,
relinquish, broadcast the move's epoch).  A shard mid-move refuses new work
with retryable ``not_owner:``/``busy:`` errors, which the coordinators ride
out by refreshing their map; ownership changes are durable ``own`` records
of the prepare log, so a member crashing mid-move rejoins with the moved
layout.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from antidote_tpu_torch.api.node import AntidoteNode
from antidote_tpu_torch.cluster.rpc import (RpcClient, RpcServer,
                                            eff_from_wire, eff_to_wire)
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.log import segment_index
from antidote_tpu_torch.log.wal import ShardWAL, replay
from antidote_tpu_torch.store.kv import (Effect, freeze_key, key_to_shard,
                                         stable_min_of)
from antidote_tpu_torch.txn.bcounter import NoPermissionsError
from antidote_tpu_torch.txn.manager import (AbortError, host_state,
                                            overlay_effects)

log = logging.getLogger(__name__)

#: the RPC surface of a member (the JAX member's handlers)
HANDLERS = ("m_read_values", "m_downstream", "m_prepare", "m_commit",
            "m_abort", "m_clocks", "m_seq", "m_ready", "m_seq_counter",
            "m_txn_status", "m_block_txn", "m_forget_txn",
            "m_resolve_chain", "m_txn_sequenced", "m_resolve_stale_txn",
            "m_process_transfer", "m_shard_map", "m_membership",
            "m_join_begin", "m_seed_map", "m_export_shard",
            "m_import_shard", "m_relinquish_shard", "m_cancel_export",
            "m_set_owner", "m_forget_member")

#: how long a read or downstream waits for its shard's own lane to reach
#: the requested timestamp before it gives up (s)
READ_SAFE_TIMEOUT_S = 30.0

#: bound on remembered txn outcomes and ledger entries (GC floor)
_LEDGER_CAP = 8192



def owned_shards(cfg: AntidoteConfig, member_id: int, n_members: int):
    """The INITIAL (boot-time) modular layout: member ``i`` owns the shards
    ``s % n == i``.  Ownership afterwards is the explicit shard map's,
    changed only by live join/leave moves."""
    return [s for s in range(cfg.n_shards) if s % n_members == member_id]


def _count_shard_move(role: str) -> None:
    """One completed shard move at this member (``role``: ``import`` or
    ``relinquish``), on the process' net metrics."""
    try:
        from antidote_tpu_torch.obs.metrics import net_metrics

        net_metrics().shard_moves.inc(role=role)
    except Exception:  # noqa: BLE001 — metrics never break a move
        log.debug("shard move metric failed", exc_info=True)


def overlay_digest(seed: int, wires) -> int:
    """Rolling, process-independent fingerprint of an effect-wire
    sequence (incremental overlay shipping)."""
    d = seed
    for w in wires:
        d = zlib.crc32(w["eb"], zlib.crc32(w["a"], d)) & 0xFFFFFFFF
    return d


def _int_map(m) -> Dict[int, int]:
    """A prev-by-shard map off the wire or a log record, whose keys may be
    ``str`` or ``int``."""
    return {int(k): int(v) for k, v in m.items()}


class Sequencer:
    """DC-wide commit-timestamp authority (member 0).

    ``next_ts(shards, txid)`` -> (ts, {shard: previous ts issued for it}) —
    the per-shard chain lets owners apply own-DC commits contiguously.  The
    ledger (``issued`` + per-shard ``chain``) is what takeover consults to
    identify the txn blocking a wedged chain."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counter = 0
        self.last_ts: Dict[int, int] = {}
        #: ts -> (txid, [shards], {shard: prev}, monotonic issue time)
        self.issued: "OrderedDict[int, tuple]" = OrderedDict()
        #: shard -> [(ts, txid)] ascending (bounded)
        self.chain: Dict[int, List[Tuple[int, int]]] = {}
        #: txid -> ts (was this txn ever issued a ts? bounded like issued)
        self.txid_index: "OrderedDict[int, int]" = OrderedDict()
        #: txid -> takeover decision tuple (idempotent re-resolution),
        #: trimmed to _LEDGER_CAP like every other outcome ledger
        self.resolutions: "OrderedDict[int, tuple]" = OrderedDict()

    def next_ts(self, shards, txid: int = 0) -> Tuple[int, Dict[int, int]]:
        with self._lock:
            self.counter += 1
            ts = self.counter
            prev = {}
            for s in shards:
                s = int(s)
                prev[s] = self.last_ts.get(s, 0)
                self.last_ts[s] = ts
                self.chain.setdefault(s, []).append((ts, int(txid)))
                if len(self.chain[s]) > _LEDGER_CAP:
                    del self.chain[s][: -_LEDGER_CAP // 2]
            self.issued[ts] = (int(txid), [int(s) for s in shards], prev,
                               time.monotonic())
            if txid:
                self.txid_index[int(txid)] = ts
            while len(self.issued) > _LEDGER_CAP:
                self.issued.popitem(last=False)
            while len(self.txid_index) > _LEDGER_CAP:
                self.txid_index.popitem(last=False)
            return ts, prev

    def trim_resolutions(self) -> None:
        with self._lock:
            while len(self.resolutions) > _LEDGER_CAP:
                self.resolutions.popitem(last=False)

    def restore_issue(self, ts: int, txid: int, shards, prev) -> None:
        """Rebuild one ledger entry from the prepare log (recovery).
        Restored entries carry issue time 0 — older than any grace."""
        with self._lock:
            self.counter = max(self.counter, int(ts))
            for s in shards:
                s = int(s)
                self.last_ts[s] = max(self.last_ts.get(s, 0), int(ts))
                self.chain.setdefault(s, []).append((int(ts), int(txid)))
            self.issued[int(ts)] = (int(txid), [int(s) for s in shards],
                                    _int_map(prev), 0.0)
            if txid:
                self.txid_index[int(txid)] = int(ts)

    def entry_after(self, shard: int, after_ts: int):
        """The earliest issued (ts, txid) on ``shard`` with ts > after_ts —
        the txn a wedged chain is waiting for."""
        with self._lock:
            for ts, txid in self.chain.get(int(shard), ()):
                if ts > after_ts:
                    return ts, txid
            return None


class ClusterMember:
    """One member of a DC.  Its node's tables live on ``device`` ("cuda"
    by default; "cpu" only when asked), recovery included."""

    def __init__(self, cfg: AntidoteConfig, dc_id: int, member_id: int,
                 n_members: int, log_dir: Optional[str] = None,
                 host: str = "127.0.0.1", shards=None,
                 recover: bool = False, meta=None, device="cuda"):
        self.cfg = cfg
        self.dc_id = dc_id
        self.member_id = member_id
        self.n_members = n_members
        modular = set(owned_shards(cfg, member_id, n_members))
        self.shards = set(modular if shards is None else shards)
        if n_members > 1 and self.shards and self.shards != modular:
            raise ValueError(
                "multi-member DCs boot with the modular shard layout "
                "(shard s owned by member s % n_members, or an empty set "
                "for a live-joining member); ownership then moves only "
                "through the live join/leave protocol so every member's "
                "shard map stays consistent")
        #: shard -> owning member id (the riak_core ring analogue) and the
        #: single routing truth: modular at boot, then moved by live
        #: join/leave.  ``n_members`` is the member-id-space BOUND (max
        #: assigned id + 1), not a live count.  A live-joining member (an
        #: explicit EMPTY set) boots with a guess of the CURRENT layout,
        #: modular over the pre-join count: epoch-guarded refreshes never
        #: downgrade an entry, so a guess of the future layout would route
        #: to not-yet-owners for the whole join; ``live_join`` then
        #: seeds the real map (``m_seed_map``)
        layout_n = n_members
        if shards is not None and not self.shards and n_members > 1:
            layout_n = n_members - 1
        self.shard_map: Dict[int, int] = {
            s: s % layout_n for s in range(cfg.n_shards)}
        for s in self.shards:
            self.shard_map[s] = member_id
        #: per-shard ownership version: every completed move bumps it
        #: (recovered from a directory whose history holds moves)
        self.shard_epoch: Dict[int, int] = {
            s: 0 for s in range(cfg.n_shards)}
        #: member ids that live-left this cluster (durable): never reused
        self.departed: set = set()
        self.node = AntidoteNode(cfg, dc_id=dc_id, log_dir=log_dir,
                                 recover=recover, meta=meta, device=device)
        self._coordinator = None
        #: sequencer lives on member 0 only
        self.seq = Sequencer() if member_id == 0 else None
        #: peer member_id -> RpcClient
        self.peers: Dict[int, RpcClient] = {}
        #: peer member_id -> last gossiped [n_shards, D] clock rows (only
        #: the peer's owned rows are meaningful)
        self.peer_clocks: Dict[int, np.ndarray] = {}
        # reentrant: m_commit holds it while its apply fires the inter-DC
        # commit listeners, whose heartbeat path re-enters
        # prepared_on_shard for the safe-time check
        self._lock = threading.RLock()
        #: (key, bucket) -> txid holding the prepare lock
        self.prepared: Dict[Tuple[Any, str], int] = {}
        #: txid -> (effects, [keys], snapshot own lane) between prepare
        #: and commit
        self.staged: Dict[int, Tuple[list, list, Optional[int]]] = {}
        #: (key, bucket) -> own-lane ts of its last commit (cert table)
        self.last_commit: Dict[Tuple[Any, str], int] = {}
        #: shards mid-move (exported, not yet relinquished): prepares and
        #: reads refuse retryably so the in-flight package stays exact.
        #: Volatile on purpose: a crash clears it and reopens the shard
        #: (ownership flips durably only at the relinquish)
        self.moving: set = set()
        #: shard mid-move -> (log generation, listing of the log directory)
        #: the export took: the relinquish deletes the shard's files
        #: without a second listing of a 2048-shard directory, unless a
        #: checkpoint rotated the log in between
        self._export_files: Dict[int, tuple] = {}
        #: serializes imports (taken before the commit lock): a package
        #: resent while the first delivery is still sealing waits for it
        #: and finds the shard owned
        self._import_lock = threading.Lock()
        #: per owned shard: last own-DC ts applied (chain frontier)
        self.applied_ts: Dict[int, int] = {s: 0 for s in self.shards}
        #: per shard: {prev_ts: (ts, effects, commit_vc)} awaiting chain
        self.chain_wait: Dict[int, Dict[int, tuple]] = {
            s: {} for s in self.shards}
        #: commit listeners (the inter-DC egress seam): (effects, vc, origin)
        self.on_commit: List = []
        #: live-move seams for the inter-DC plane, filled by
        #: ``attach_interdc``: export_extras(shard) dicts merge into a
        #: handoff package's "x" namespace, on_shard_import(shard, extras)
        #: installs them at the destination, on_shard_relinquish(shard)
        #: clears the source's chain state.  Their callers are the shard
        #: moves of the live membership
        self.export_extras: List = []
        self.on_shard_import: List = []
        self.on_shard_relinquish: List = []
        #: txid -> (vc_wire, prev_wire) of applied commits (takeover polls)
        self.committed_txns: "OrderedDict[int, tuple]" = OrderedDict()
        #: txids barred from committing pending a takeover decision
        self.blocked_txns: set = set()
        #: txids resolved-aborted by takeover (bounded)
        self.aborted_txns: "OrderedDict[int, bool]" = OrderedDict()
        #: txid -> monotonic stage time (stale-prepare sweeps)
        self.staged_at: Dict[int, float] = {}
        #: (key, bucket, tentative VC bytes, txid) -> (folded state
        #: tensors, n, prefix digest) — incremental overlay folds
        self._overlay_fold_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        #: durable prepare log (staged txns + sequencer ledger).  Honors
        #: cfg.sync_log like the shard WALs: fsync-per-commit off by
        #: default (bounded loss on power failure, none on process kill)
        self._prep_wal: Optional[ShardWAL] = None
        self._prep_dir = log_dir
        self._prep_appends = 0
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, "prepare.wal")
            fresh = not os.path.exists(path)
            self._prep_wal = ShardWAL(path, sync_on_commit=cfg.sync_log)
            if fresh and not recover:
                # durable boot layout: recovery derives ownership from THIS
                # and the own-event trail, never from the member count
                # passed at recover time
                self._prep_append({"ev": "boot_layout", "txid": 0,
                                   "n": int(n_members),
                                   "member": int(member_id),
                                   "shards": sorted(int(s)
                                                    for s in self.shards)})
        self._seq_cache = 0
        self._seq_cache_at = 0.0
        #: recovery's parts (seconds): the prepare log's fold and the
        #: re-applied commits; the store's replay is the node's
        self.recovery_s: Dict[str, float] = {}
        if recover:
            t0 = time.perf_counter()
            pending = self._recover_prepare_log(log_dir)
            # chain frontier = last own-DC ts applied per shard (the WAL
            # replay rebuilt applied_vc; the own lane only advances by
            # applied own-DC commits, so its value IS the frontier)
            for s in self.shards:
                self.applied_ts[s] = int(
                    self.node.store.applied_vc[s, self.dc_id])
            t1 = time.perf_counter()
            self._replay_recovered_commits(pending)
            self.recovery_s = {"prepare_log": t1 - t0,
                               "reapplied": time.perf_counter() - t1}
        self._set_shards(self.shards)
        # the membership rides in every checkpoint image this member's node
        # publishes (informational: the prepare log stays the authoritative
        # ownership record at recovery)
        self.node.checkpoint_extras_providers["membership"] = (
            self._checkpoint_membership)
        self.rpc = RpcServer(host=host)
        for name in HANDLERS:
            self.rpc.register(name, getattr(self, name))

    def _set_shards(self, shards) -> None:
        """Replace the owned set and its mask (copy-on-write: lock-free
        readers keep iterating the set they took)."""
        owned = np.zeros(self.cfg.n_shards, bool)
        owned[sorted(int(s) for s in shards)] = True
        self.shards = set(int(s) for s in shards)
        self._owned = owned

    def _checkpoint_membership(self) -> dict:
        """Membership snapshot for the checkpoint image (called under the
        commit lock by the checkpointer's stamp barrier)."""
        with self._lock:
            return {
                "member_id": int(self.member_id),
                "n_members": int(self.n_members),
                "shards": sorted(int(s) for s in self.shards),
                "shard_map": {str(s): int(o)
                              for s, o in self.shard_map.items()},
                "shard_epoch": {str(s): int(e)
                                for s, e in self.shard_epoch.items()},
                "departed": sorted(int(m) for m in self.departed),
            }

    @property
    def _xlock(self):
        """Cross-plane writer lock (the node's reentrant commit lock).

        The store tolerates exactly one writer at a time, and a clustered
        member has two writer planes: own commits (RPC server threads,
        ``m_commit``/``m_forget_txn``) and remote inter-DC ingress (the
        fabric pump's gate drain, which already serializes under
        ``node.txm.commit_lock``).  Every member path that mutates store
        state takes THIS lock first, then ``self._lock`` — the one order
        (nothing takes the commit lock while holding the member lock), so
        a takeover never deadlocks against a drain."""
        return self.node.txm.commit_lock

    def coordinator(self):
        """This member's own transaction coordinator (lazily built to
        avoid an import cycle)."""
        if self._coordinator is None:
            from antidote_tpu_torch.cluster.coordinator import ClusterNode

            self._coordinator = ClusterNode(self)
        return self._coordinator

    # ------------------------------------------------------------------
    # durable prepare log
    # ------------------------------------------------------------------
    def _prep_append(self, rec: dict) -> None:
        if self._prep_wal is not None:
            self._prep_wal.append(rec)
            self._prep_wal.commit()
            self._prep_appends += 1
            if self._prep_appends >= _LEDGER_CAP * 2:
                self._compact_prepare_log()

    def _compact_prepare_log(self) -> None:
        """Rewrite prepare.wal from live state: the membership, the
        sequencer ledger, undecided preps and the outcome tails.  Bounds
        disk use and recovery replay time to O(in-flight + LEDGER_CAP),
        not O(all txns ever)."""
        with self._lock:
            path = os.path.join(self._prep_dir, "prepare.wal")
            tmp = path + ".tmp"
            if os.path.exists(tmp):
                os.remove(tmp)  # reclaim-ok: stale compaction temp from
                # a crashed rewrite; the live prepare.wal is untouched
            w = ShardWAL(tmp, sync_on_commit=False)
            # MEMBERSHIP STATE FIRST: without it a member would recover
            # with the modular guess of its recover-time count
            w.append({"ev": "boot_layout", "txid": 0,
                      "n": int(self.n_members),
                      "member": int(self.member_id),
                      "shards": sorted(int(s) for s in self.shards)})
            for s in range(self.cfg.n_shards):
                w.append({"ev": "own", "txid": 0, "shard": int(s),
                          "owner": int(self.shard_map.get(s, 0)),
                          "epoch": int(self.shard_epoch.get(s, 0))})
            w.append({"ev": "members", "txid": 0, "n": int(self.n_members)})
            for mid in sorted(self.departed):
                w.append({"ev": "departed", "txid": 0, "member": int(mid)})
            if self.seq is not None:
                for ts, (txid, shards, prev, _) in self.seq.issued.items():
                    w.append({"ev": "seq", "ts": int(ts), "txid": int(txid),
                              "shards": shards, "prev": _int_map(prev)})
            for txid, (effects, _, snap_own) in self.staged.items():
                rec = {"ev": "prep", "txid": int(txid),
                       "effs": [eff_to_wire(e) for e in effects]}
                if snap_own is not None:
                    rec["snap"] = int(snap_own)
                w.append(rec)
            for txid, (vc, prev) in self.committed_txns.items():
                w.append({"ev": "commit", "txid": int(txid), "vc": vc,
                          "prev": _int_map(prev)})
            for txid in self.aborted_txns:
                w.append({"ev": "abort", "txid": int(txid)})
            w.commit()
            w.sync()
            w.close()
            self._prep_wal.close()
            os.replace(tmp, path)
            self._prep_wal = ShardWAL(path, sync_on_commit=self.cfg.sync_log)
            self._prep_appends = 0

    def _recover_prepare_log(self, log_dir: Optional[str]) -> list:
        """Fold prepare.wal: staged-but-undecided txns come back with their
        prepared locks; decided txns restore the outcome tables; sequencer
        issues rebuild the ts ledger (member 0); the membership records
        (``boot_layout``, and the live moves' ``own``, ``members`` and
        ``departed``) restore ownership.

        Returns the committed txns in log order WITHOUT dropping their
        staged effects — a crash may have landed between the durable
        commit record and the store apply, so the caller re-applies any
        whose chain frontier shows them unapplied
        (:meth:`_replay_recovered_commits`)."""
        pending: list = []
        if log_dir is None:
            return pending
        path = os.path.join(log_dir, "prepare.wal")
        if not os.path.exists(path):
            return pending
        for rec in replay(path):
            ev = rec.get("ev")
            txid = int(rec.get("txid", 0))
            if ev == "prep":
                effects = [eff_from_wire(w) for w in rec["effs"]]
                keys = [(e.key, e.bucket) for e in effects]
                snap = rec.get("snap")
                self.staged[txid] = (effects, keys,
                                     None if snap is None else int(snap))
                self.staged_at[txid] = 0.0  # older than any sweep grace
                for dk in keys:
                    self.prepared[dk] = txid
            elif ev == "commit":
                prev = _int_map(rec["prev"])
                self.committed_txns[txid] = (rec["vc"], prev)
                pending.append((txid, rec["vc"], prev))
            elif ev == "abort":
                self._drop_staged(txid)
                self.aborted_txns[txid] = True
            elif ev == "seq" and self.seq is not None:
                self.seq.restore_issue(rec["ts"], txid, rec["shards"],
                                       rec["prev"])
            elif ev == "boot_layout":
                # authoritative starting ownership (own events below
                # adjust it); a record without the explicit set predates
                # it — modular(n) then
                n0 = int(rec["n"])
                booted = rec.get("shards")
                self.shards = (set(int(s) for s in booted)
                               if booted is not None
                               else set(owned_shards(self.cfg,
                                                     self.member_id, n0)))
                # a joiner booted empty guessed the PRE-join layout (its
                # seeded entries ride as own records below); the JAX
                # member recovers modular over the post-join count, which
                # strands every unmoved epoch-0 entry on a wrong owner
                layout_n = (n0 - 1 if booted is not None and not booted
                            and n0 > 1 else n0)
                self.shard_map = {s: s % layout_n
                                  for s in range(self.cfg.n_shards)}
                for s in self.shards:
                    self.shard_map[s] = self.member_id
                self.shard_epoch = {s: 0 for s in range(self.cfg.n_shards)}
                self.applied_ts = {s: 0 for s in self.shards}
                self.chain_wait = {s: {} for s in self.shards}
            elif ev == "own":
                # a live ownership change (durable: a member crashing
                # mid-move rejoins with the moved layout)
                s, owner = int(rec["shard"]), int(rec["owner"])
                self.shard_map[s] = owner
                self.shard_epoch[s] = int(rec.get(
                    "epoch", self.shard_epoch.get(s, 0) + 1))
                if owner == self.member_id:
                    self.shards.add(s)
                    self.applied_ts.setdefault(s, 0)
                    self.chain_wait.setdefault(s, {})
                else:
                    self.shards.discard(s)
                    self.applied_ts.pop(s, None)
                    self.chain_wait.pop(s, None)
            elif ev == "members":
                # monotone on replay too
                self.n_members = max(self.n_members, int(rec["n"]))
            elif ev == "departed":
                self.departed.add(int(rec["member"]))
        self._trim_ledgers()
        return pending

    def _replay_recovered_commits(self, pending: list) -> None:
        """Finish commits whose durable decision preceded the crash but
        whose effects never reached the store (still staged + frontier
        below their ts).  Shards already at or past the ts are skipped —
        their effects were applied and WAL-replayed."""
        for txid, vc, prev in pending:
            if txid not in self.staged:
                continue  # applied before the crash (or compacted)
            ts = int(np.asarray(vc)[self.dc_id])
            effects, keys, snap_own = self.staged.pop(txid)
            # snap_own None = a record predating overlay stamping: its
            # effects carry no tentative dots, nothing to rewrite
            if snap_own is not None and snap_own + 1 != ts:
                self._restamp(effects, snap_own, ts)
            by_shard: Dict[int, list] = {}
            for eff in effects:
                _, shard, _ = self.node.store.locate(eff.key, eff.type_name,
                                                     eff.bucket)
                if shard in self.shards and self.applied_ts[shard] < ts:
                    by_shard.setdefault(shard, []).append(eff)
            cvc = np.asarray(vc, np.int32)
            self._chain_apply([(shard, int(prev.get(shard, 0)), ts, effs,
                                cvc) for shard, effs in by_shard.items()])
            for dk in keys:
                if self.prepared.get(dk) == txid:
                    del self.prepared[dk]
                self.last_commit[dk] = max(self.last_commit.get(dk, 0), ts)
            self.staged_at.pop(txid, None)

    def _restamp(self, effects, snap_own: int, ts: int) -> None:
        """Rewrite tentative own dots (overlay stamp = snapshot+1) to the
        real commit ts."""
        for eff in effects:
            eff.eff_a, eff.eff_b = get_type(eff.type_name).restamp_own_dots(
                self.cfg, eff.eff_a, eff.eff_b, self.dc_id, snap_own + 1, ts)

    def _drop_staged(self, txid: int) -> None:
        self.staged_at.pop(txid, None)
        staged = self.staged.pop(txid, None)
        if staged is not None:
            for dk in staged[1]:
                if self.prepared.get(dk) == txid:
                    del self.prepared[dk]

    def _trim_ledgers(self) -> None:
        while len(self.committed_txns) > _LEDGER_CAP:
            self.committed_txns.popitem(last=False)
        while len(self.aborted_txns) > _LEDGER_CAP:
            self.aborted_txns.popitem(last=False)

    # ------------------------------------------------------------------
    def connect(self, member_id: int, host: str, port: int) -> None:
        self.peers[member_id] = RpcClient(host, port)

    @property
    def address(self) -> Tuple[str, int]:
        return (self.rpc.host, self.rpc.port)

    # ------------------------------------------------------------------
    # owner-side handlers (RPC server threads; the member lock serializes
    # them against each other)
    # ------------------------------------------------------------------
    def m_ready(self) -> bool:
        return True

    def prepared_on_shard(self, shard: int) -> bool:
        """Any prepared-but-uncommitted txn touching one of my keys on
        ``shard`` (gates the inter-DC safe time)."""
        with self._lock:
            keys = list(self.prepared)
        return any(key_to_shard(k, b, self.cfg.n_shards) == shard
                   for k, b in keys)

    def m_seq(self, shards, txid: int = 0) -> Tuple[int, Dict[int, int]]:
        return self.seq_ts(shards, txid)

    def seq_ts(self, shards, txid: int = 0) -> Tuple[int, Dict[int, int]]:
        """Issue a commit ts + per-shard prev chain, durably ledgered —
        every coordinator comes through here so takeover can find the txn
        behind any issued ts.  The member lock serializes the ledger append
        with the other prepare-log writers and keeps 'seq' records in ts
        order."""
        seq = self._sequencer()
        with self._lock:
            if txid and txid in seq.resolutions:
                # the stale-prepare sweep already decided this txn's fate
                # (its coordinator stalled before sequencing, then woke):
                # a ts now would open a hole the sticky ts=0 resolution
                # could never close
                raise RuntimeError(
                    f"abort: txn {txid} was resolved by takeover before "
                    "sequencing")
            ts, prev = seq.next_ts(shards, txid)
            prev_wire = _int_map(prev)
            self._prep_append({"ev": "seq", "ts": ts, "txid": int(txid),
                               "shards": [int(s) for s in shards],
                               "prev": prev_wire})
        return ts, prev_wire

    def m_seq_counter(self) -> int:
        return self._sequencer().counter

    def _sequencer(self) -> Sequencer:
        """This member's sequencer; a sequencer-only handler called on
        another member (a misrouted RPC) is refused."""
        if self.seq is None:
            raise RuntimeError(f"member {self.member_id} is not the "
                               "sequencer (member 0)")
        return self.seq

    def m_clocks(self) -> list:
        """My owned shards' applied clock rows: [(shard, [D])]."""
        self.advance_idle_shards()
        vc = self.node.store.applied_vc
        return [(s, [int(x) for x in vc[s]]) for s in sorted(self.shards)]

    def invalidate_seq_cache(self) -> None:
        """Force the next ``_seq_counter`` to refresh from the sequencer
        (after a certification abort: the conflict proves the frontier
        moved past our cached view)."""
        self._seq_cache_at = 0.0

    def _seq_counter(self) -> int:
        """The DC timestamp frontier (locally for the sequencer, a cached
        RPC otherwise)."""
        if self.seq is not None:
            return self.seq.counter
        now = time.monotonic()
        if now - self._seq_cache_at > 0.2 and 0 in self.peers:
            try:
                self._seq_cache = int(self.peers[0].call("m_seq_counter"))
                self._seq_cache_at = now
            except (OSError, RuntimeError):
                pass  # stale is safe: the frontier only lags
        return self._seq_cache

    def advance_idle_shards(self) -> None:
        """Own-lane safe-time advance for idle owned shards: with no
        prepared or chain-buffered txn touching a shard, every issued ts
        is already applied there (prepare precedes sequencing), so its
        own-lane clock may claim the sequencer frontier — what lets the
        aggregated stable snapshot progress past untouched shards.  A
        wedged shard (prepared, or a link buffered behind a hole) does not
        advance until takeover drains it."""
        ctr = self._seq_counter()
        if ctr == 0:
            return
        with self._lock:
            idle = self._owned.copy()
            idle[[s for s, w in self.chain_wait.items() if w]] = False
            idle[[key_to_shard(k, b, self.cfg.n_shards)
                  for k, b in self.prepared]] = False
            col = self.node.store.applied_vc[:, self.dc_id]
            np.maximum(col, ctr, out=col, where=idle)

    def m_read_values(self, objects, read_vc, overlays=None) -> list:
        """Owner read: values at ``read_vc`` for my keys.

        ``overlays`` (aligned with ``objects``; None entries = plain)
        carries a coordinator txn's own pending effects for each object —
        read-your-writes in open cluster transactions: the owner reads the
        base state at the snapshot, folds the txn's effects eagerly and
        returns the overlaid value.

        Before reading, each involved shard waits until its own-lane clock
        can safely claim ``read_vc[own]`` — an in-flight commit below that
        ts would otherwise make the snapshot observe a txn partially."""
        objs = [(freeze_key(k), t, b) for k, t, b in objects]
        read_vc = np.asarray(read_vc, np.int32)
        want = int(read_vc[self.dc_id])
        shards = {key_to_shard(k, b, self.cfg.n_shards) for k, _, b in objs}
        for s in shards:
            self._check_owner(s)
        self._wait_read_safe(shards, want)
        with self._lock:
            if not overlays or not any(overlays):
                vals = self.node.store.read_values(objs, read_vc)
            else:
                vals = self._read_values_overlaid(objs, read_vc, overlays)
        return [_wire_value(v) for v in vals]

    def _overlay_state(self, key, type_name, bucket, state, read_vc,
                       overlay) -> dict:
        """Fold a txn's pending effect wires onto a host state (the
        overlay at the owner: ``overlay_effects``, on the store's device
        through the type's batched apply, or on the host for a type with
        a host twin).  The tentative own-lane stamp is read_vc[own]+1 =
        snapshot+1 — the value m_commit's restamp rewrites to the real
        commit ts.

        ``overlay`` is the incremental form ``{"n": prefix_len, "d":
        prefix_digest, "effs": [new wires], "nd": digest after, "txid"}``
        — the coordinator ships only the effects the owner has not folded
        yet.  An owner without the cached prefix raises
        ``overlay-resync`` and the coordinator re-sends in full."""
        store = self.node.store
        ent = store.locate(key, type_name, bucket, create=False)
        cfg_k = store.table(ent[0]).cfg if ent else self.cfg
        tvc = np.asarray(read_vc, np.int32).copy()
        tvc[self.dc_id] += 1
        if not isinstance(overlay, dict):
            raise TypeError("overlay must be the incremental dict form "
                            "{'n', 'd', 'effs', 'nd'}")
        ck = (key, bucket, tvc.tobytes(), int(overlay.get("txid", 0)))
        cached = self._overlay_fold_cache.get(ck)
        n0, d0 = int(overlay["n"]), int(overlay["d"])
        wires, nd = overlay["effs"], int(overlay["nd"])
        n_total = n0 + len(wires)
        if cached is not None and cached[1] == n_total and cached[2] == nd:
            # idempotent re-send (the same object twice in one batch)
            return host_state(cached[0])
        if n0 != 0:
            if cached is None or cached[1:3] != (n0, d0):
                raise RuntimeError(
                    "overlay-resync: owner has no matching overlay prefix "
                    f"for {key!r} (have "
                    f"{None if cached is None else cached[1:3]}, want "
                    f"({n0}, {d0}))")
            state = cached[0]
        effs = [eff_from_wire(w) for w in wires]
        for eff in effs:
            # the txn's blob payloads travel with its effects; the owner
            # interns them before value decode resolves
            for h, data in eff.blob_refs:
                store.blobs.intern_bytes(h, data)
        state = overlay_effects(get_type(type_name), cfg_k, state, effs, tvc,
                                self.dc_id, store.device, fresh=n0 == 0)
        self._overlay_fold_cache[ck] = (state, n_total, nd)
        while len(self._overlay_fold_cache) > 512:
            self._overlay_fold_cache.popitem(last=False)
        return host_state(state)

    def _read_values_overlaid(self, objs, read_vc, overlays) -> list:
        store = self.node.store
        plain = [i for i, ov in enumerate(overlays) if not ov]
        laid = [i for i, ov in enumerate(overlays) if ov]
        vals: list = [None] * len(objs)
        if plain:
            pv = store.read_values([objs[i] for i in plain], read_vc)
            for i, v in zip(plain, pv):
                vals[i] = v
        states = store.read_states([objs[i] for i in laid], read_vc)
        for i, state in zip(laid, states):
            key, type_name, bucket = objs[i]
            state = self._overlay_state(key, type_name, bucket, state,
                                        read_vc, overlays[i])
            ent = store.locate(key, type_name, bucket, create=False)
            cfg_k = store.table(ent[0]).cfg if ent else self.cfg
            vals[i] = get_type(type_name).value(state, store.blobs, cfg_k)
        return vals

    def _wait_read_safe(self, shards, want_ts: int) -> None:
        """Wait until every shard of ``shards`` has applied its own lane up
        to ``want_ts`` (one idle advance a round for them all)."""
        # the requested own-lane ts was derived from the sequencer
        # (stable/session/frontier), so it IS a frontier lower bound:
        # adopt it instead of waiting out the cache-refresh window
        if self.seq is None and want_ts > self._seq_cache:
            self._seq_cache = want_ts
        deadline = time.monotonic() + READ_SAFE_TIMEOUT_S
        while True:
            self.advance_idle_shards()
            for shard in shards:
                if shard not in self.shards:
                    # a live move took the shard mid-wait: its frozen
                    # clock would never reach want_ts — the retryable
                    # error instead of a 30 s timeout
                    self._check_owner(shard)
            col = self.node.store.applied_vc[:, self.dc_id]
            behind = [s for s in shards if int(col[s]) < want_ts]
            if not behind:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"shard {behind[0]} own-lane stuck below {want_ts} "
                    "(in-flight commit never arrived?)")
            time.sleep(0.001)

    def m_downstream(self, key, type_name, bucket, op, read_vc,
                     overlay=None) -> list:
        """Generate downstream effects for a state-dependent op at my
        replica of the key, with the coordinator txn's pending effects for
        it overlaid (observed-remove must see same-txn adds).  A
        counter_b decrement or transfer runs its escrow guard here, against
        the owner's replica: the lane must be this DC's and hold the
        rights; first-committer-wins certification closes the race
        between the check and the commit."""
        key = freeze_key(key)
        op = _freeze_op(op)
        ty = get_type(type_name)
        read_vc = np.asarray(read_vc, np.int32)
        # same in-flight-commit gate as m_read_values: a downstream
        # generated from a snapshot missing a committed-but-unapplied op
        # would break observed-remove semantics
        shard = key_to_shard(key, bucket, self.cfg.n_shards)
        self._check_owner(shard)
        self._wait_read_safe((shard,), int(read_vc[self.dc_id]))
        with self._lock:
            store = self.node.store
            state = store.read_states([(key, type_name, bucket)], read_vc)[0]
            if overlay:
                state = self._overlay_state(key, type_name, bucket, state,
                                            read_vc, overlay)
            if type_name == "counter_b" and op[0] in ("decrement",
                                                      "transfer"):
                self._escrow_guard(ty, state, key, bucket, op)
            ent = store.locate(key, type_name, bucket, create=False)
            cfg_k = store.table(ent[0]).cfg if ent else self.cfg
            effs = ty.downstream(op, state, store.blobs, cfg_k)
        return [eff_to_wire(Effect(key, type_name, bucket, a, b, refs))
                for a, b, refs in effs]

    def _escrow_guard(self, ty, state, key, bucket, op) -> None:
        """Refuse (as an ``abort:`` error) a counter_b spend on another
        DC's lane or past the rights this lane holds."""
        amount, src_lane = op[1][0], op[1][-1]
        if src_lane != self.dc_id:
            raise RuntimeError(
                f"abort: counter_b {op[0]} must spend this DC's lane "
                f"{self.dc_id}, not {src_lane}")
        bcm = self.node.txm.bcounters
        try:
            bcm.check_decrement(ty, state, key, bucket, amount)
        except NoPermissionsError as e:
            if op[0] == "transfer":
                bcm.satisfied(key, bucket)
            raise RuntimeError(f"abort: {e}") from e
        bcm.satisfied(key, bucket)

    def m_process_transfer(self, key, bucket, amount: int, to_dc: int
                           ) -> int:
        """Grant up to ``amount`` counter_b rights to ``to_dc`` from this
        DC's lane — the clustered granter: runs at the key's owner member
        and commits the transfer through the DC sequencer (this member's
        coordinator), so the grant is certified like any other txn."""
        key = freeze_key(key)
        ty = get_type("counter_b")
        with self._lock:
            state = self.node.store.read_states(
                [(key, "counter_b", bucket)],
                self.node.store.dc_max_vc())[0]
        if state is None:
            return 0
        grant = min(int(amount), ty.local_rights(state, self.dc_id))
        if grant <= 0:
            return 0
        try:
            self.coordinator().update_objects([
                (key, "counter_b", bucket,
                 ("transfer", (grant, int(to_dc), self.dc_id)))])
        except AbortError:
            return 0  # lost a race for the rights; the requester retries
        return grant

    # ------------------------------------------------------------------
    # live membership (the riak_core staged join/leave and ownership
    # handoff): shards move one at a time between members while the DC
    # serves — a move refuses new work on that one shard with retryable
    # "busy"/"not_owner" errors, never the cluster
    # ------------------------------------------------------------------
    def _check_owner(self, shard: int) -> None:
        if shard not in self.shards:
            raise RuntimeError(
                f"not_owner: shard {shard} owner "
                f"{self.shard_map.get(shard, -1)} "
                f"(asked member {self.member_id})")
        if shard in self.moving:
            # exported, not yet relinquished: new work would make the
            # in-flight package stale — retryable for the import's round
            # trip
            raise RuntimeError(f"busy: shard {shard} mid-move")

    def m_shard_map(self) -> dict:
        """{shard: [owner, epoch]} — epochs count completed moves."""
        return {int(s): [int(m), int(self.shard_epoch.get(int(s), 0))]
                for s, m in self.shard_map.items()}

    def m_membership(self) -> dict:
        """The member-id bound, the live member ids this member knows
        (self + wired peers) and the durable departed-id set."""
        with self._lock:
            return {"n_members": int(self.n_members),
                    "members": sorted({self.member_id, *self.peers}),
                    "departed": sorted(int(m) for m in self.departed)}

    def m_join_begin(self, new_id: int, new_addr, n_members_new: int
                     ) -> bool:
        """Learn a joining member: wire its RPC and grow the id-space
        bound (durable ``members`` record).  Ownership is untouched —
        shards move one by one afterwards."""
        with self._lock:
            self.n_members = max(self.n_members, int(n_members_new))
            if new_id != self.member_id and new_id not in self.peers:
                self.connect(int(new_id), new_addr[0], int(new_addr[1]))
            self._prep_append({"ev": "members", "txid": 0,
                               "n": int(self.n_members)})
        return True

    def m_seed_map(self, entries, n_members: Optional[int] = None) -> bool:
        """Adopt an authoritative map snapshot ``{shard: [owner, epoch]}``
        (``live_join`` seeds the joiner, whose boot-time modular guess
        may predate earlier joins and leaves).  Entries at or above the
        local epoch are adopted for shards not owned here — an equal-epoch
        entry from a live member is at least as right as any guess, and a
        moved shard always carries a strictly higher epoch.  Each change is
        a durable ``own`` record: a joiner crashing mid-join recovers the
        seeded layout."""
        with self._lock:
            if n_members is not None:
                self.n_members = max(self.n_members, int(n_members))
            for s, ent in entries.items():
                s = int(s)
                owner, epoch = int(ent[0]), int(ent[1])
                if s in self.shards or epoch < self.shard_epoch.get(s, 0):
                    continue
                if (self.shard_map.get(s) == owner
                        and self.shard_epoch.get(s, 0) == epoch):
                    continue
                self.shard_map[s] = owner
                self.shard_epoch[s] = epoch
                self._prep_append({"ev": "own", "txid": 0, "shard": s,
                                   "owner": owner, "epoch": epoch})
        return True

    def m_set_owner(self, shard: int, owner: int,
                    n_members: Optional[int] = None,
                    epoch: Optional[int] = None) -> bool:
        """Record a completed move (the mover's broadcast to the members
        neither side of it).  A broadcast older than what this member
        knows (its epoch) is a no-op: replays and races never resurrect a
        previous owner.  The id-space bound only grows."""
        with self._lock:
            shard, owner = int(shard), int(owner)
            if n_members is not None:
                self.n_members = max(self.n_members, int(n_members))
            if epoch is not None and int(epoch) < self.shard_epoch.get(
                    shard, 0):
                return True  # stale replay of an older move
            self.shard_map[shard] = owner
            if epoch is not None:
                self.shard_epoch[shard] = int(epoch)
            if owner != self.member_id and shard in self.shards:
                self._set_shards(self.shards - {shard})
            self._prep_append({"ev": "own", "txid": 0, "shard": shard,
                               "owner": owner,
                               "epoch": int(self.shard_epoch.get(shard, 0))})
        return True

    def m_export_shard(self, shard: int, target: int) -> bytes:
        """Phase 1 of a move: package a COPY of the shard and mark it
        mid-move.

        Refuses (``busy``, retryable) while a staged txn or a chain hole
        touches the shard — the prepare-to-commit window pins ownership,
        so no coordinator chases a staged txn across members.  Nothing is
        dropped here: new prepares and reads of the shard get ``busy``
        until :meth:`m_relinquish_shard` (after the target confirmed the
        import) or :meth:`m_cancel_export`; a crash of the mover in between
        leaves the source the owner of the only live copy (a restart
        clears the volatile mark).  Both locks are held, so the package,
        its ``applied_ts``, its ``owner_epoch`` (the epoch the move will
        have) and the planes' ``export_extras`` are one cut."""
        from antidote_tpu_torch.store import handoff

        shard, target = int(shard), int(target)
        with self._xlock, self._lock:
            if shard not in self.shards:
                # not _check_owner: a shard mid-move is still owned here,
                # and the mover's retry may re-export it
                raise RuntimeError(
                    f"not_owner: shard {shard} owner "
                    f"{self.shard_map.get(shard, -1)}")
            n = self.cfg.n_shards
            for txid, st in self.staged.items():
                if any(key_to_shard(e.key, e.bucket, n) == shard
                       for e in st[0]):
                    raise RuntimeError(
                        f"busy: txn {txid} staged on shard {shard}")
            if self.chain_wait.get(shard):
                raise RuntimeError(f"busy: chain holes on shard {shard}")
            log_ = self.node.store.log
            listed = (None if log_ is None
                      else (log_.gen, segment_index(log_.dir)))
            pkg = handoff.export_shard(
                self.node.store, shard,
                segments=None if listed is None else listed[1])
            self._export_files[shard] = listed
            pkg["applied_ts"] = int(self.applied_ts.get(shard, 0))
            pkg["owner_epoch"] = int(self.shard_epoch.get(shard, 0)) + 1
            for fn in self.export_extras:
                pkg.setdefault("x", {}).update(fn(shard))
            # the package's plain lists (a compacted source ships its
            # whole blob dictionary) cross the wire as one msgpack node
            # each, decoded by either package's unpack
            for name in ("blobs", "directory", "log"):
                pkg[name] = handoff.opaque(pkg[name])
            data = handoff.pack(pkg)
            self.moving.add(shard)
        return data

    def m_relinquish_shard(self, shard: int, target: int) -> int:
        """Phase 2 of a move: the import at ``target`` is confirmed — drop
        the source copy and durably record the new owner.  Idempotent (a
        repeat after the mover's retry changes nothing, but its hooks re-run:
        the retry may exist because a hook failed after the durable
        flip).  The ``on_shard_relinquish`` hooks run under the commit
        lock, outside the member lock, serialized against the inter-DC
        drain.  Returns the move's epoch for the mover's broadcast."""
        from antidote_tpu_torch.store import handoff

        shard, target = int(shard), int(target)
        with self._xlock:
            with self._lock:
                self.moving.discard(shard)
                dup = shard not in self.shards
                if dup:
                    epoch = int(self.shard_epoch.get(shard, 0))
                else:
                    # the target's gossip may not carry the shard yet:
                    # keep this member's view of its clock row where the
                    # export left it (the target starts from that row),
                    # so the aggregated stable snapshot never goes back
                    peer = self.peer_clocks.setdefault(
                        target, np.zeros((self.cfg.n_shards,
                                          self.cfg.max_dcs), np.int32))
                    np.maximum(peer[shard],
                               self.node.store.applied_vc[shard],
                               out=peer[shard])
                    log_ = self.node.store.log
                    gen, index = (self._export_files.pop(shard, None)
                                  or (None, None))
                    if log_ is None or gen != log_.gen:
                        index = None
                    handoff.drop_shard(self.node.store, shard, index)
                    self._set_shards(self.shards - {shard})
                    self.shard_map[shard] = target
                    epoch = int(self.shard_epoch.get(shard, 0)) + 1
                    self.shard_epoch[shard] = epoch
                    self.applied_ts.pop(shard, None)
                    self.chain_wait.pop(shard, None)
                    self._prep_append({"ev": "own", "txid": 0,
                                       "shard": shard, "owner": target,
                                       "epoch": epoch})
            # queued remote txns for a shard this member no longer holds
            # must never apply to the dropped slice
            for fn in self.on_shard_relinquish:
                fn(shard)
            if not dup:
                _count_shard_move("relinquish")
        return epoch

    def m_cancel_export(self, shard: int) -> bool:
        """Abort phase 1 (the import failed for good, or a mover cleans
        up after a crashed one): reopen the shard.  Nothing was dropped."""
        with self._lock:
            self.moving.discard(int(shard))
            self._export_files.pop(int(shard), None)
        return True

    def m_import_shard(self, data: bytes) -> bool:
        """Install a moved shard and take ownership.  Idempotent: a
        re-sent package for a shard already owned installs nothing, but
        the ``on_shard_import`` hooks re-run (the resend may exist because
        a hook failed on the first delivery; adopting is monotone).

        Three steps under the import lock: the package's data on the
        device (under both locks); for a package from a compacted source,
        the local checkpoint that covers its rows (``seal_import``, which
        takes the commit lock only for its capture); then the ownership
        and its durable ``own`` record.  The shard serves here only after
        the seal, and the source relinquishes only after this returns.  A
        failed install or seal drops what it installed before the error
        goes back to the mover, which resends the same package or cancels
        the export (the source then serves and commits on): nothing of a
        failed import is left to be taken for a later one."""
        from antidote_tpu_torch.store import handoff

        pkg = handoff.unpack(bytes(data))
        shard = int(pkg["shard"])
        with self._import_lock:
            with self._xlock, self._lock:
                dup = shard in self.shards
                if not dup:
                    try:
                        self.node.install_handoff(pkg)
                    except BaseException:
                        handoff.drop_shard(self.node.store, shard)
                        raise
            if not dup and pkg.get("compacted"):
                try:
                    self.node.seal_import()
                except BaseException:
                    with self._xlock, self._lock:
                        handoff.drop_shard(self.node.store, shard)
                    raise
            with self._xlock:
                # the ownership and the planes' adoption in one section of
                # the commit lock: the inter-DC drain sees the shard owned
                # only with its chain state in place
                if not dup:
                    self._take_shard_locked(shard, pkg)
                extras = pkg.get("x", {})
                for fn in self.on_shard_import:
                    fn(shard, extras)
        if not dup:
            _count_shard_move("import")
        return True

    def _take_shard_locked(self, shard: int, pkg: dict) -> None:
        """Take ownership of an installed package's shard (the caller
        holds the commit lock), with certification continuity: each
        moved key's last own-lane commit is its head clock's own lane,
        read from the package's host copy of the clocks (one array a
        table)."""
        with self._lock:
            self._set_shards(self.shards | {shard})
            self.shard_map[shard] = self.member_id
            self.shard_epoch[shard] = int(pkg.get(
                "owner_epoch", self.shard_epoch.get(shard, 0) + 1))
            self.applied_ts[shard] = int(pkg.get("applied_ts", 0))
            self.chain_wait[shard] = {}
            own = {tname: np.asarray(tb["head_vc"])[:, self.dc_id]
                   for tname, tb in pkg["tables"].items()}
            for key, bucket, tname, row in pkg["directory"]:
                lane = int(own[tname][row])
                if lane:
                    dk = (freeze_key(key), bucket)
                    self.last_commit[dk] = max(self.last_commit.get(dk, 0),
                                               lane)
            self._prep_append({"ev": "own", "txid": 0, "shard": shard,
                               "owner": self.member_id,
                               "epoch": int(self.shard_epoch[shard])})

    def m_forget_member(self, member_id: int, n_members_new: int) -> bool:
        """Drop a departed member (live leave): close its peer client and
        drop its gossip rows; durable ``members`` and ``departed``
        records.  The id-space bound only grows, so a departed id is
        never handed out again."""
        with self._lock:
            member_id = int(member_id)
            self.n_members = max(self.n_members, int(n_members_new))
            # departed before the client closes: a coordinator whose call
            # dies with it reads the failure as the member's not_owner
            self.departed.add(member_id)
            cli = self.peers.pop(member_id, None)
            if cli is not None:
                cli.close()
            self.peer_clocks.pop(member_id, None)
            self._prep_append({"ev": "members", "txid": 0,
                               "n": int(self.n_members)})
            self._prep_append({"ev": "departed", "txid": 0,
                               "member": member_id})
        return True

    def m_prepare(self, txid: int, effs_wire: list, snap_own: int) -> bool:
        """Certify + lock this txn's keys on my shards (first-committer-
        wins against ``snap_own``), durably staged.  Raises on conflict
        (the RPC surfaces it as an error reply)."""
        effects = [eff_from_wire(w) for w in effs_wire]
        with self._lock:
            for eff in effects:
                self._check_owner(
                    key_to_shard(eff.key, eff.bucket, self.cfg.n_shards))
                dk = (eff.key, eff.bucket)
                holder = self.prepared.get(dk)
                if holder is not None and holder != txid:
                    raise RuntimeError(
                        f"abort: key {eff.key!r} prepared by txn {holder}")
                if self.last_commit.get(dk, 0) > snap_own:
                    raise RuntimeError(
                        f"abort: certification conflict on {eff.key!r}")
                # type-binding check HERE, not at apply: a key bound to a
                # different CRDT type must fail as a clean prepare abort —
                # discovered at commit it would poison the ts chain
                try:
                    self.node.store.locate(eff.key, eff.type_name,
                                           eff.bucket, create=False)
                except TypeError as e:
                    raise RuntimeError(f"abort: {e}") from e
            keys = []
            for eff in effects:
                dk = (eff.key, eff.bucket)
                self.prepared[dk] = txid
                keys.append(dk)
            self.staged[txid] = (effects, keys, int(snap_own))
            self.staged_at[txid] = time.monotonic()
            self._prep_append({"ev": "prep", "txid": int(txid),
                               "effs": effs_wire, "snap": int(snap_own)})
        return True

    def m_abort(self, txid: int) -> bool:
        with self._lock:
            if txid in self.staged:
                self._prep_append({"ev": "abort", "txid": int(txid)})
            self._drop_staged(txid)
        return True

    def m_commit(self, txid: int, commit_vc, prev_by_shard,
                 resolved: bool = False) -> bool:
        """Apply a staged txn at ts = commit_vc[own]; my shards' slices
        apply in ts order via the sequencer's per-shard chain.

        ``resolved`` marks a takeover-driven apply: it may pass a block
        barrier.  A normal commit for a blocked or resolved-aborted txid
        is refused — the door the takeover shut on a zombie coordinator."""
        commit_vc = np.asarray(commit_vc, np.int32)
        ts = int(commit_vc[self.dc_id])
        # an applied commit proves the sequencer reached ts: advance the
        # cached frontier so idle-shard advance need not wait for it
        if self.seq is None and ts > self._seq_cache:
            self._seq_cache = ts
        with self._xlock, self._lock:
            if txid in self.aborted_txns:
                raise RuntimeError(
                    f"abort: txn {txid} was resolved-aborted by takeover")
            if not resolved and txid in self.blocked_txns:
                raise RuntimeError(
                    f"abort: txn {txid} is blocked pending takeover")
            effects, keys, snap_own = self.staged.pop(txid, (None, None, 0))
            if effects is None:
                return True  # duplicate commit
            self.staged_at.pop(txid, None)
            self.blocked_txns.discard(txid)
            if snap_own is not None and snap_own + 1 != ts:
                self._restamp(effects, snap_own, ts)
            vc_wire = [int(x) for x in commit_vc]
            prev_wire = _int_map(prev_by_shard)
            self._prep_append({"ev": "commit", "txid": int(txid),
                               "vc": vc_wire, "prev": prev_wire})
            self.committed_txns[txid] = (vc_wire, prev_wire)
            self._trim_ledgers()
            by_shard: Dict[int, list] = {}
            for eff in effects:
                _, shard, _ = self.node.store.locate(eff.key, eff.type_name,
                                                     eff.bucket)
                by_shard.setdefault(shard, []).append(eff)
            self._chain_apply([
                (shard, prev_wire.get(shard, 0), ts, effs, commit_vc)
                for shard, effs in by_shard.items()])
            for dk in keys:
                if self.prepared.get(dk) == txid:
                    del self.prepared[dk]
                self.last_commit[dk] = ts
        return True

    # ------------------------------------------------------------------
    # coordinator-crash takeover
    # ------------------------------------------------------------------
    def m_txn_status(self, txid: int) -> list:
        """What this member knows about a txn (takeover poll)."""
        with self._lock:
            ent = self.committed_txns.get(txid)
            if ent is not None:
                return ["committed", ent[0], _int_map(ent[1])]
            if txid in self.aborted_txns:
                return ["aborted"]
            if txid in self.staged:
                return ["staged"]
            return ["unknown"]

    def m_block_txn(self, txid: int) -> list:
        """Block barrier: unless already committed here, bar the txid from
        committing until the takeover decision lands.  Returns the
        pre-block status so the resolver can detect a commit that raced
        in."""
        with self._lock:
            st = self.m_txn_status(txid)
            if st[0] != "committed":
                self.blocked_txns.add(txid)
            return st

    def m_forget_txn(self, txid: int, ts: int, shards, prev_by_shard
                     ) -> bool:
        """Apply a takeover ABORT decision: release the txn's staged
        write-set + locks and close its hole in my owned shards' ts chains
        (a no-op link, so successors drain)."""
        prev_by_shard = _int_map(prev_by_shard)
        with self._xlock, self._lock:
            self.blocked_txns.discard(txid)
            if txid not in self.aborted_txns:
                self.aborted_txns[txid] = True
                self._trim_ledgers()
                if txid in self.staged:
                    self._prep_append({"ev": "abort", "txid": int(txid)})
                self._drop_staged(txid)
            self._chain_apply([
                (int(s), prev_by_shard.get(int(s), 0), int(ts), [], None)
                for s in shards
                if int(s) in self.shards and self.applied_ts[int(s)] < int(ts)
            ])
        return True

    def m_resolve_chain(self, shard: int, after_ts: int,
                        grace_s: float = 0.0) -> Optional[list]:
        """Takeover (on the sequencer member only): decide the fate of the
        txn holding the earliest unapplied ts on ``shard``.

        Decision rule: if ANY member applied it, the txn is committed —
        return its commit VC + chains so stuck members can finish the
        fan-out (atomicity).  Otherwise, after ``grace_s`` since issue,
        block the txid at every reachable member (a late coordinator's
        commit now refuses), re-check for a commit that raced in, and
        failing that abort it everywhere.  Decisions are sticky."""
        seq = self._sequencer()
        ent = seq.entry_after(int(shard), int(after_ts))
        if ent is None:
            return None
        ts, txid = ent
        prior = seq.resolutions.get(txid)
        if prior is not None:
            if prior[0] == "abort" and int(prior[2]) != ts:
                # stale-aborted before sequencing, yet a racing coordinator
                # still got a ts (defence in depth beside the seq_ts
                # refusal): close the hole at the REAL ts
                issued = seq.issued.get(ts)
                if issued is not None:
                    _, tx_shards, prev, _ = issued
                    self._broadcast("m_forget_txn", txid, ts, tx_shards,
                                    _int_map(prev))
                return ["abort", int(txid), int(ts)]
            return list(prior)
        issued = seq.issued.get(ts)
        if issued is None:
            # the ledger GC'd beneath a very old hole: nothing left to
            # learn, and an abort with an empty shard set is unsafe
            raise RuntimeError(
                f"ts {ts} missing from sequencer ledger (GC'd); manual "
                "intervention required")
        _, tx_shards, prev, t_issued = issued
        dec = self._decide(txid, ts, tx_shards, prev, t_issued, grace_s)
        if dec[0] != "wait":
            seq.resolutions[txid] = tuple(dec)
            seq.trim_resolutions()
            if dec[0] == "commit":
                # complete the dead coordinator's fan-out: every member
                # holding the staged write-set applies it now
                self._broadcast("m_commit", txid, dec[2], _int_map(dec[3]),
                                True)
        return dec

    def _broadcast(self, method: str, *args) -> None:
        """Apply a takeover decision here and at every peer; a peer that
        cannot be reached learns it when it resolves after rejoining."""
        try:
            getattr(self, method)(*args)
        except (OSError, RuntimeError, ValueError):
            log.warning("takeover: local %s%r failed", method, args[:1],
                        exc_info=True)
        for mid, cli in list(self.peers.items()):
            try:
                cli.call(method, *args)
            except (OSError, RuntimeError) as e:
                log.warning("takeover: %s of txn %d at member %d failed: %s",
                            method, args[0], mid, e)

    def _poll(self, method: str, txid: int) -> Dict[int, list]:
        out = {self.member_id: getattr(self, method)(txid)}
        for mid, cli in list(self.peers.items()):
            try:
                out[mid] = cli.call(method, txid)
            except (OSError, RuntimeError):
                out[mid] = ["unreachable"]
        return out

    def _decide(self, txid, ts, tx_shards, prev, t_issued,
                grace_s) -> list:
        """Takeover decision.  SAFETY RULE: a prepared participant may only
        be aborted when every owner of the txn's shards is reachable and
        reports not-committed — an unreachable owner may have applied and
        logged the commit just before dying, and aborting behind its back
        would diverge on rejoin (the 2PC blocking window; the reference
        rides it out the same way by restarting the node).  The block
        barrier shuts the door on a zombie coordinator racing the abort."""
        involved = {self.shard_map.get(int(s), int(s) % self.n_members)
                    for s in tx_shards}

        def committed_or_wait(statuses):
            for st in statuses.values():
                if st[0] == "committed":
                    return ["commit", int(txid), st[1], st[2]]
            if any(statuses.get(mid, ["unreachable"])[0] == "unreachable"
                   for mid in involved):
                return ["wait", int(txid)]  # blocking: the owner may rejoin
            return None

        dec = committed_or_wait(self._poll("m_txn_status", txid))
        if dec is not None:
            return dec
        if time.monotonic() - t_issued < grace_s:
            return ["wait", int(txid)]
        # block barrier everywhere, then re-check for a raced-in commit
        dec = committed_or_wait(self._poll("m_block_txn", txid))
        if dec is not None:
            return dec
        self._broadcast("m_forget_txn", txid, ts, tx_shards, _int_map(prev))
        return ["abort", int(txid), int(ts)]

    def m_txn_sequenced(self, txid: int) -> bool:
        return int(txid) in self._sequencer().txid_index

    def m_resolve_stale_txn(self, txid: int) -> list:
        """Takeover for a txn whose coordinator died BEFORE sequencing: its
        prepared locks would otherwise be held forever (no ts, so no chain
        hole for m_resolve_chain to find).  Runs on the sequencer: if the
        txid was never issued a ts — checked again after the block
        barrier, so a racing coordinator that sequences late finds its
        commit refused — abort it everywhere."""
        self._sequencer()
        txid = int(txid)
        prior = self.seq.resolutions.get(txid)
        if prior is not None:
            return list(prior)
        if txid in self.seq.txid_index:
            return ["sequenced", self.seq.txid_index[txid]]
        for st in self._poll("m_block_txn", txid).values():
            if st[0] == "committed":
                return ["commit", txid, st[1], st[2]]
        if txid in self.seq.txid_index:
            return ["sequenced", self.seq.txid_index[txid]]
        self._broadcast("m_forget_txn", txid, 0, [], {})
        dec = ["abort", txid, 0]
        self.seq.resolutions[txid] = tuple(dec)
        self.seq.trim_resolutions()
        return dec

    def sweep_stale_prepared(self, grace_s: float = 30.0) -> int:
        """Release prepared locks of txns staged longer than ``grace_s``
        whose coordinator never reached the sequencer.  Sequenced txns are
        left to :meth:`resolve_wedged` (the chain protocol owns them).
        Returns the number of txns resolved away."""
        now = time.monotonic()
        with self._lock:
            stale = [txid for txid, t in self.staged_at.items()
                     if now - t >= grace_s]
        n = 0
        for txid in stale:
            if self.seq is not None:
                dec = self.m_resolve_stale_txn(txid)
            else:
                dec = self.peers[0].call("m_resolve_stale_txn", txid)
            if dec[0] == "abort":
                n += 1
        return n

    def resolve_wedged(self, grace_s: float = 0.0, max_rounds: int = 64
                       ) -> int:
        """Settle every unapplied issued ts on my owned shards via the
        sequencer's takeover protocol.  Returns the number of decisions
        applied.  Any member may call this (on a timer, on a stuck-read
        timeout, or after a rejoin)."""
        applied = 0
        for _ in range(max_rounds):
            progress = False
            for s in sorted(self.shards):
                frontier = int(self.applied_ts[s])
                if self.seq is not None:
                    dec = self.m_resolve_chain(s, frontier, grace_s)
                else:
                    dec = self.peers[0].call("m_resolve_chain", s, frontier,
                                             grace_s)
                if dec is None or dec[0] == "wait":
                    continue
                if dec[0] == "commit":
                    _, txid, vc, prevw = dec
                    self.m_commit(int(txid), vc, _int_map(prevw),
                                  resolved=True)
                elif dec[0] == "abort" and self.applied_ts[s] < int(dec[2]):
                    # m_forget_txn already ran here via the broadcast;
                    # re-apply locally in case we were unreachable then
                    _, txid, ts = dec
                    issued = (self.seq.issued.get(int(ts))
                              if self.seq is not None else None)
                    shards_ = issued[1] if issued else [s]
                    prev_ = issued[2] if issued else {s: self.applied_ts[s]}
                    self.m_forget_txn(int(txid), int(ts), shards_, prev_)
                if int(self.applied_ts[s]) > frontier:
                    applied += 1
                    progress = True
            if not progress:
                break
        return applied

    def _chain_apply(self, links) -> None:
        """``links``: [(shard, prev, ts, effects, commit_vc)], at most one
        per shard.  A link applies once its shard's own-lane chain reaches
        ``prev`` and is buffered until then (commits arrive out of ts
        order from concurrent coordinators).  The ready links of different
        shards apply as ONE grouped store append, then the buffered
        successors they unblock, round by round: per shard the order is
        the chain's, and shards share no keys.  A link without effects is
        a takeover's no-op: it only advances the frontier."""
        ready = []
        for shard, prev, ts, effects, commit_vc in links:
            if shard not in self.chain_wait:
                raise RuntimeError(
                    f"commit ts {ts} for unowned shard {shard} at member "
                    f"{self.member_id} (owned {sorted(self.shards)}, map "
                    f"{self.shard_map.get(shard)}) — protocol violation")
            if self.applied_ts[shard] < prev:
                self.chain_wait[shard][prev] = (ts, effects, commit_vc)
            else:
                ready.append((shard, ts, effects, commit_vc))
        while ready:
            self._apply_now(ready)
            ready = [(s,) + self.chain_wait[s].pop(self.applied_ts[s])
                     for s, *_ in ready
                     if self.applied_ts[s] in self.chain_wait[s]]

    def _apply_now(self, links) -> None:
        """Apply ready links as one grouped store append, then publish
        them.  Every link's shard clock moves before the first message
        goes out, so while more than one link publishes, the listeners
        send no safe-time ping (``txm._publishing_group``): a ping between
        them would claim a later link's ts before its message, and the
        subscribers would drop that message as a duplicate (the JAX
        member applies and publishes link by link).  The deferred pings
        go out at the next tick or commit."""
        groups = [(effs, [vc] * len(effs), [self.dc_id] * len(effs))
                  for _, _, effs, vc in links if effs]
        if groups:
            self.node.store.apply_effect_groups(groups)
        for shard, ts, _, _ in links:
            self.applied_ts[shard] = ts
        txm = self.node.txm
        outer = txm._publishing_group
        txm._publishing_group = outer or len(groups) > 1
        try:
            for _, _, effs, vc in links:
                if effs:
                    for listener in self.on_commit:
                        listener(effs, vc, self.dc_id)
        finally:
            txm._publishing_group = outer

    # ------------------------------------------------------------------
    # stable-time aggregation (stable-time gossip between members)
    # ------------------------------------------------------------------
    def refresh_peer_clocks(self) -> None:
        for mid, cli in list(self.peers.items()):
            try:
                rows = cli.call("m_clocks")
            except (OSError, RuntimeError):
                # unreachable peer: keep its last gossiped rows; staleness
                # is safe (mins only lag)
                continue
            if not rows:
                continue
            idx = np.asarray([s for s, _ in rows], np.int64)
            vals = np.asarray([r for _, r in rows], np.int32)
            with self._lock:
                if mid not in self.peers:
                    # forgotten while the call was in flight (a live
                    # leave): its rows must not come back
                    continue
                mat = self.peer_clocks.get(mid)
                if mat is None:
                    mat = np.zeros((self.cfg.n_shards, self.cfg.max_dcs),
                                   np.int32)
                    self.peer_clocks[mid] = mat
                mat[idx] = np.maximum(mat[idx], vals)

    def clock_matrix(self) -> np.ndarray:
        """The DC's full (shards x D) applied matrix: my owned rows live,
        the other rows from gossip (one masked max per peer)."""
        mat = self.node.store.applied_vc.copy()
        foreign = ~self._owned[:, None]
        # a snapshot of the rows without the member lock: gossip only
        # raises them, so a stale or half-raised row only lags (mins lag)
        for peer in list(self.peer_clocks.values()):
            np.maximum(mat, peer, out=mat, where=foreign)
        return mat

    def stable_vc(self) -> np.ndarray:
        """DC stable snapshot = entry-wise min over every member's shard
        rows, through ``stable_min_of`` on the member's device."""
        self.advance_idle_shards()
        return stable_min_of(self.clock_matrix(), self.node.store.device)

    def close(self) -> None:
        """Stop serving and close the logs (a clean shutdown; a crash is
        closing the RPC server and dropping the member)."""
        self.rpc.close()
        for cli in list(self.peers.values()):
            cli.close()
        if self._prep_wal is not None:
            self._prep_wal.close()
        if self.node.store.log is not None:
            self.node.close()


def _wire_value(v):
    """Client values over msgpack: map dicts have tuple keys."""
    if isinstance(v, dict):
        return {"__map__": [[list(k), _wire_value(x)] for k, x in v.items()]}
    if isinstance(v, (list, tuple)):
        return [_wire_value(x) for x in v]
    return v


def unwire_value(v):
    if isinstance(v, dict) and "__map__" in v:
        return {(freeze_key(k[0]), k[1]): unwire_value(x)
                for k, x in v["__map__"]}
    if isinstance(v, list):
        return [unwire_value(x) for x in v]
    return v


def _freeze_op(op):
    """Ops over msgpack come back as lists; freeze to the tuple shapes the
    type layer expects."""
    if isinstance(op, list):
        return tuple(_freeze_op(x) for x in op)
    return op
