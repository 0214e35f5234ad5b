"""Durable op log: per-shard WALs + op-id chains + recovery replay.

The logging layer (the reference's ``logging_vnode``): effects are logged
(with their blob payloads) before the device tables observe them,
per-(shard, origin-DC) op-ids chain monotonically for gap detection (the
reference's #op_number scheme), and recovery replays every shard's log to
rebuild tables, clocks and op-id counters.  The directory layout, the
metadata file and the record fields are the JAX package's, so a directory
written by either package opens in the other.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import msgpack
import numpy as np

from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.log.wal import (
    FsyncTicket,
    GroupFsyncCoordinator,
    ShardWAL,
    pack_frames,
    ready_ticket,
    replay,
    replay_segments,
    wholly_below,
)

__all__ = ["LogManager", "SegmentedShardWAL", "ShardWAL", "FsyncTicket",
           "replay", "replay_segments", "shard_segment_paths",
           "gen_segment_paths", "wholly_below"]

_META_FILE = "antidote_meta.json"


class LogDirMismatch(RuntimeError):
    """The log directory was written under a different deployment shape."""


def load_dir_meta(directory: str) -> Optional[dict]:
    """The {n_shards, max_dcs} a log directory was created with, or None
    for a fresh/legacy directory."""
    path = os.path.join(directory, _META_FILE)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise LogDirMismatch(
            f"log dir metadata {path!r} is unreadable ({e}); if a crash "
            "truncated it, restore it as "
            '{"n_shards": N, "max_dcs": D, "version": 1} matching the '
            "directory's original deployment shape"
        ) from e


def _set_dir_meta_key(directory: str, key: str, value) -> None:
    """Atomically (write-temp + fsync + rename) set one key in a log
    dir's metadata file."""
    path = os.path.join(directory, _META_FILE)
    meta = load_dir_meta(directory) or {}
    meta[key] = value
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())  # fsync-ok: dir-meta atomic replace, not a
        # log append — the group-fsync policy governs record durability
    os.replace(tmp, path)


def mark_dir_retired(directory: str, by_epoch: int) -> None:
    """Stamp a log dir as superseded by a membership-layout change.

    Offline resize moves every shard's data into the NEW layout's dirs;
    an old-dir member booted afterwards would serve (and extend!) a
    stale copy of shards that now have different owners — a split-brain
    the riak_core ring epoch prevents in the reference.  Retired dirs
    refuse to boot until an operator consciously clears the stamp."""
    _set_dir_meta_key(directory, "retired_by_layout_epoch", int(by_epoch))


def stamp_layout_epoch(directory: str, epoch: int) -> None:
    """Record the membership-layout epoch a dir belongs to."""
    _set_dir_meta_key(directory, "layout_epoch", int(epoch))


def _validate_dir(cfg: AntidoteConfig, directory: str) -> None:
    """First boot stamps the deployment shape into the log directory;
    every later boot validates it.  Booting a WAL directory with a
    different shard count would silently strand or mis-route committed
    data, and a different max_dcs would mis-lane every recovered clock —
    the riak_core ring metadata persisted next to the data guards the
    reference against the same operator error ."""
    meta = load_dir_meta(directory)
    if meta is not None:
        retired = meta.get("retired_by_layout_epoch")
        if retired is not None:
            raise LogDirMismatch(
                f"log dir {directory!r} was retired by membership-layout "
                f"epoch {retired} (its shards moved to the new layout's "
                "dirs at resize); booting it would serve and extend a "
                "stale pre-resize copy.  If this is intentional "
                "(restoring a backup), delete the "
                "'retired_by_layout_epoch' key from antidote_meta.json."
            )
        if (meta["n_shards"] != cfg.n_shards
                or meta["max_dcs"] != cfg.max_dcs):
            raise LogDirMismatch(
                f"log dir {directory!r} was created with n_shards="
                f"{meta['n_shards']}, max_dcs={meta['max_dcs']}; booting "
                f"with n_shards={cfg.n_shards}, max_dcs={cfg.max_dcs} "
                "would lose or corrupt committed data.  Use the recorded "
                "shape (or reshard via store.handoff.reshard into a new "
                "directory)."
            )
        return
    # legacy dir (pre-metadata build): shard files are created eagerly, so
    # their count IS the shape it was written with — any mismatch (shrink
    # OR grow) mis-routes recovered keys; a max_dcs mismatch is visible in
    # the clock width of any logged record
    shard_files = {
        int(m.group(1))
        for f in os.listdir(directory)
        if (m := re.fullmatch(r"shard_(\d+)\.wal", f))
    }
    if shard_files and shard_files != set(range(cfg.n_shards)):
        raise LogDirMismatch(
            f"legacy log dir {directory!r} holds shard files "
            f"{sorted(shard_files)} — written with n_shards="
            f"{len(shard_files)}, not {cfg.n_shards}"
        )
    for p in sorted(shard_files):
        for rec in replay(os.path.join(directory, f"shard_{p}.wal")):
            if len(rec["vc"]) != cfg.max_dcs:
                raise LogDirMismatch(
                    f"legacy log dir {directory!r} records carry "
                    f"{len(rec['vc'])}-lane clocks — written with "
                    f"max_dcs={len(rec['vc'])}, not {cfg.max_dcs}"
                )
            break  # one record per shard suffices
    # adopt: stamp the shape atomically (a crash mid-write must not leave
    # a truncated file that poisons every later boot)
    tmp = os.path.join(directory, _META_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"n_shards": cfg.n_shards, "max_dcs": cfg.max_dcs,
                   "version": 1}, f)
        f.flush()
        os.fsync(f.fileno())  # fsync-ok: dir-meta atomic adopt (see above)
    os.replace(tmp, os.path.join(directory, _META_FILE))


_SEGMENT_FILE = re.compile(r"shard_(\d+)\.s.*\.wal")


def _configured_paths(directory: str, shard: int,
                      n_segments: int) -> List[str]:
    """A shard's generation-0 segment files (``shard_P.wal`` +
    ``shard_P.sN.wal``), whether or not they exist yet."""
    return [os.path.join(directory, f"shard_{shard}.wal")] + [
        os.path.join(directory, f"shard_{shard}.s{i}.wal")
        for i in range(1, max(1, n_segments))
    ]


def segment_index(directory: str) -> Dict[int, List[str]]:
    """shard -> its ``shard_P.s*.wal`` files on disk, from ONE directory
    listing (a glob a shard lists the whole directory each time: at 2048
    shards that was 8M entries scanned to open or recover a log)."""
    out: Dict[int, List[str]] = {}
    for name in os.listdir(directory):
        m = _SEGMENT_FILE.fullmatch(name)
        if m:
            out.setdefault(int(m.group(1)), []).append(
                os.path.join(directory, name))
    return out


def shard_segment_paths(directory: str, shard: int, n_segments: int,
                        index: Dict[int, List[str]]) -> List[str]:
    """Every segment file a shard's records may live in: the configured
    segment set UNION whatever extra ``shard_P.sN.wal`` files exist on
    disk (including checkpoint-generation files ``shard_P.sN.gG.wal``) —
    a directory written with more segments (or a different generation)
    and opened with fewer must still replay everything.  ``index`` is the
    directory's :func:`segment_index`, listed once for a pass over many
    shards."""
    paths = _configured_paths(directory, shard, n_segments)
    return paths + sorted(set(index.get(shard, ())) - set(paths))


def gen_segment_paths(directory: str, shard: int, n_segments: int,
                      gen: int) -> List[str]:
    """The ACTIVE segment file set of one shard at checkpoint generation
    ``gen``.  Generation 0 is the classic layout (``shard_P.wal`` +
    ``shard_P.sN.wal``); each checkpoint stamp rotates every shard onto a
    fresh generation's files (``shard_P.sN.gG.wal``), freezing the old
    ones so the post-publish reclaim can delete them wholesale once their
    records are covered by the image."""
    if gen == 0:
        return _configured_paths(directory, shard, n_segments)
    return [
        os.path.join(directory, f"shard_{shard}.s{i}.g{gen}.wal")
        for i in range(max(1, n_segments))
    ]


class SegmentedShardWAL:
    """One shard's WAL split over N parallel append segments.

    Segment 0 keeps the classic ``shard_P.wal`` path (a 1-segment log
    is byte-compatible with the pre-segmentation layout); segments 1..N
    live at ``shard_P.sN.wal``.  A commit group's records append to the
    CURRENT segment; the commit barrier rotates, so the group-fsync
    coordinator syncs one segment while the next group appends to its
    neighbor.  Records carry a per-shard append sequence (``"q"``,
    minted by LogManager) so recovery can merge segments back into
    exact commit order (:func:`~antidote_tpu_torch.log.wal.replay_segments`)."""

    def __init__(self, directory: str, shard: int, n_segments: int = 1,
                 sync_on_commit: bool = False):
        self.shard = shard
        self.dir = directory
        self.n_segments = max(1, int(n_segments))
        self.segs = [
            ShardWAL(p, sync_on_commit=sync_on_commit)
            for p in _configured_paths(directory, shard, self.n_segments)
        ]
        self._cur = 0

    def swap_generation(self, gen: int) -> List[ShardWAL]:
        """Rotate onto generation ``gen``'s fresh segment files (the
        checkpoint stamp's WAL barrier: all records appended so far stay
        in the now-frozen old files, every later record lands in the new
        ones).  Caller must hold the commit lock — no append may race
        the swap.  Returns the retired segments; the caller drains the
        fsync coordinator before closing them."""
        old = self.segs
        self.segs = [
            ShardWAL(p, sync_on_commit=self.sync_on_commit)
            for p in gen_segment_paths(self.dir, self.shard,
                                       self.n_segments, gen)
        ]
        self._cur = 0
        return old

    @property
    def current(self) -> ShardWAL:
        return self.segs[self._cur]

    @property
    def sync_on_commit(self) -> bool:
        return self.segs[0].sync_on_commit

    def rotate(self) -> None:
        if self.n_segments > 1:
            self._cur = (self._cur + 1) % self.n_segments

    # -- single-segment conveniences (tests, handoff) -------------------
    def append(self, record: dict) -> None:
        self.current.append(record)

    def tell(self) -> int:
        return self.current.tell()

    def rollback_to(self, off: int) -> None:
        self.current.rollback_to(off)

    def set_sync(self, sync: bool) -> None:
        for s in self.segs:
            s.set_sync(sync)

    def probe(self) -> None:
        """Probe EVERY segment file's volume (a per-file fault must keep
        the node read-only, not flap out via a healthy sibling)."""
        for s in self.segs:
            s.probe()

    def commit(self) -> None:
        for s in self.segs:
            s.commit()

    def close(self) -> None:
        for s in self.segs:
            s.close()


class LogManager:
    def __init__(self, cfg: AntidoteConfig, directory: str,
                 sync_on_commit: Optional[bool] = None,
                 segments: Optional[int] = None):
        self.cfg = cfg
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        _validate_dir(cfg, directory)
        sync = cfg.sync_log if sync_on_commit is None else sync_on_commit
        self.n_segments = max(1, int(
            getattr(cfg, "wal_segments", 1) if segments is None else segments
        ))
        self.wals = [
            SegmentedShardWAL(directory, p, self.n_segments,
                              sync_on_commit=sync)
            for p in range(cfg.n_shards)
        ]
        #: per-(shard, origin) monotone op-id chain
        self.op_ids = np.zeros((cfg.n_shards, cfg.max_dcs), np.int64)
        #: per-shard append sequence — total order across a shard's
        #: segments (stamped as ``"q"``; recovery merges by it)
        self.seqs = np.zeros(cfg.n_shards, np.int64)
        # --- checkpoint floors -------------------------------
        #: per-shard append-sequence floor: records with q ≤ floor are
        #: covered by the loaded/published checkpoint image and are
        #: SKIPPED by every replay (they may or may not still exist on
        #: disk — reclaim deletes whole files once all their records are
        #: below the floor, so presence is never load-bearing)
        self.floor_seqs = np.zeros(cfg.n_shards, np.int64)
        #: per-(shard, origin) count of replication txn GROUPS below the
        #: floor — the base the inter-DC chain positions resume from
        #: (pub_opid for the own lane, last_seen for remote lanes); a
        #: catch-up below this base is below the compaction horizon
        self.chain_floor = np.zeros((cfg.n_shards, cfg.max_dcs), np.int64)
        #: active checkpoint generation: each checkpoint stamp rotates
        #: every shard onto generation-suffixed segment files so the old
        #: ones freeze and become deletable wholesale after publish
        self.gen = 0
        #: rotated-out segments awaiting the post-publish drain + close
        self._retired: List[ShardWAL] = []
        #: per-shard truncation epoch (durable in antidote_meta.json):
        #: bumped by truncate_shard so a checkpoint image written BEFORE
        #: a shard was relinquished can never resurrect it at recovery
        meta = load_dir_meta(directory) or {}
        self.shard_resets: Dict[int, int] = {
            int(k): int(v)
            for k, v in (meta.get("shard_resets") or {}).items()
        }
        #: blob handles already persisted per shard (avoid re-writing bytes)
        self._blob_seen = [set() for _ in range(cfg.n_shards)]
        #: group-fsync coordinator: commit barriers under sync_log=true
        #: submit their dirty segments and wait on the covering ticket
        self._fsync = GroupFsyncCoordinator(on_batch=self._fsync_batch)
        #: metrics hook — called with barriers-covered-per-fsync-pass
        #: (AntidoteNode points it at antidote_wal_fsync_batch.observe)
        self.on_fsync_batch = None

    def _fsync_batch(self, n: int) -> None:
        cb = self.on_fsync_batch
        if cb is not None:
            cb(n)

    def _mint_payload(self, shard: int, key, type_name: str, bucket: str,
                      eff_a, eff_b, commit_vc, origin: int,
                      blob_refs) -> Tuple[int, List[int], bytes]:
        """Mint the next op-id + append sequence and build the packed
        record payload.  MUTATES op_ids/seqs/_blob_seen — callers must
        snapshot those for rollback.  Returns (opid, new blob hashes,
        payload bytes)."""
        self.op_ids[shard, origin] += 1
        opid = int(self.op_ids[shard, origin])
        self.seqs[shard] += 1
        blobs = [
            (int(h), bytes(data))
            for h, data in blob_refs
            if h not in self._blob_seen[shard]
        ]
        new_hashes = [h for h, _ in blobs]
        for h in new_hashes:
            self._blob_seen[shard].add(h)
        payload = msgpack.packb({
            "k": key,
            "b": bucket,
            "t": type_name,
            "a": np.asarray(eff_a, np.int64).tobytes(),
            "eb": np.asarray(eff_b, np.int32).tobytes(),
            "vc": [int(x) for x in np.asarray(commit_vc)],
            "o": int(origin),
            "id": opid,
            "q": int(self.seqs[shard]),
            "bl": blobs,
        }, use_bin_type=True)
        return opid, new_hashes, payload

    def log_effect(self, shard: int, key, type_name: str, bucket: str,
                   eff_a: np.ndarray, eff_b: np.ndarray, commit_vc, origin: int,
                   blob_refs=()) -> int:
        """Append one effect record; returns its op-id in the
        (shard, origin) chain.  A failed append rolls the op-id chain,
        append sequence and blob-dedup memory back (the WAL itself heals
        its torn frame), so a refused write never leaves a permanent
        op-id GAP for egress to publish."""
        opid, new_hashes, payload = self._mint_payload(
            shard, key, type_name, bucket, eff_a, eff_b, commit_vc,
            origin, blob_refs)
        try:
            self.wals[shard].current.append_packed(pack_frames([payload]))
        except BaseException:
            self.op_ids[shard, origin] -= 1
            self.seqs[shard] -= 1
            for h in new_hashes:
                self._blob_seen[shard].discard(h)
            raise
        return opid

    def log_effects(self, entries) -> None:
        """Append one commit group's records, atomically with respect to
        FAILURE: an OSError on a later record (ENOSPC mid-group) rolls
        every touched WAL, op-id chain and blob-dedup entry back to the
        pre-group state.  Without this, a NACKed group left a durable
        prefix that recovery replay resurrected — writes the clients
        were told failed came back locally (and were never published
        inter-DC, so DCs diverged).

        The group's records reach each touched shard's current segment
        as ONE pre-framed buffer + ONE write (the measured per-append
        floor was ctypes/syscall round trips, not bytes).

        ``entries``: iterable of ``log_effect`` argument tuples
        ``(shard, key, type_name, bucket, eff_a, eff_b, commit_vc,
        origin, blob_refs)``."""
        op_snap = self.op_ids.copy()
        seq_snap = self.seqs.copy()
        added: List[Tuple[int, int]] = []  # (shard, blob hash) logged
        per_shard: Dict[int, List[bytes]] = {}
        try:
            for (shard, key, tname, bucket, ea, eb, vc, origin,
                 brefs) in entries:
                _, new_hashes, payload = self._mint_payload(
                    shard, key, tname, bucket, ea, eb, vc, origin, brefs)
                added.extend((shard, h) for h in new_hashes)
                per_shard.setdefault(shard, []).append(payload)
            offs: Dict[int, Tuple[ShardWAL, int]] = {}
            try:
                for shard, payloads in per_shard.items():
                    seg = self.wals[shard].current
                    offs[shard] = (seg, seg.tell())
                    seg.append_packed(pack_frames(payloads))
            except BaseException:
                for seg, off in offs.values():
                    try:
                        seg.rollback_to(off)
                    except OSError:
                        pass  # the disk is failing; replay's CRC guard
                        # still stops at whatever half-frame remains
                raise
        except BaseException:
            self.op_ids[:] = op_snap
            self.seqs[:] = seq_snap
            for s, h in added:
                self._blob_seen[s].discard(h)
            raise

    def log_effect_groups(self, groups: Sequence) -> List[Optional[Exception]]:
        """Log a MERGED commit batch — several independent sub-groups
        (one per source transaction/connection), each failure-atomic on
        its own.  Fast path: the whole merged batch
        appends as one packed buffer per touched segment; if anything
        fails, everything rolls back and the sub-groups retry
        INDIVIDUALLY, so exactly the failing sub-group(s) are NACKed
        while siblings land durably.  Returns one ``None`` (logged) or
        ``Exception`` (NACKed, fully rolled back) per sub-group."""
        from antidote_tpu_torch import faults as _faults

        groups = [list(g) for g in groups]
        # fast path: the whole merged batch as one packed buffer per
        # touched segment.  Skipped while a fault injector is armed —
        # a one-shot injected append fault must fire against exactly
        # one sub-group (deterministic chaos), not be consumed by the
        # merged attempt and then masked by the per-group redo below.
        if len(groups) > 1 and _faults.get_injector() is None:
            try:
                self.log_effects([e for g in groups for e in g])
                return [None] * len(groups)
            except Exception:
                pass  # fully rolled back; isolate the refusal per group
        errors: List[Optional[Exception]] = []
        for g in groups:
            try:
                self.log_effects(g)
            except Exception as e:
                errors.append(e)
            else:
                errors.append(None)
        return errors

    def set_sync(self, sync: bool) -> None:
        """Runtime fsync-on-commit toggle (the reference's
        ``logging_vnode:set_sync_log``)."""
        for w in self.wals:
            w.set_sync(sync)

    def barrier_async(self, shards) -> FsyncTicket:
        """Deferred commit barrier: flush each touched shard's current
        segment, rotate it, and — under sync_log=true — submit the
        dirty segments to the group-fsync coordinator.  The returned
        ticket completes when the covering fsync does (immediately under
        sync_log=false); acks must not release before ``ticket.wait()``
        returns."""
        to_sync: List[ShardWAL] = []
        for p in set(int(s) for s in shards):
            w = self.wals[p]
            cur = w.current
            if cur.sync_on_commit and cur.pending_bytes:
                to_sync.append(cur)
            else:
                cur.commit()
            w.rotate()
        if not to_sync:
            return ready_ticket()
        return self._fsync.submit(to_sync)

    def commit_barrier(self, shards) -> None:
        """Blocking barrier (legacy callers: remote ingress, handoff,
        readiness probes).  Routed through the coordinator so a barrier
        racing a deferred one coalesces into the same fsync pass."""
        self.barrier_async(shards).wait()

    def segment_depths(self) -> List[int]:
        """Unsynced bytes per segment INDEX, aggregated across shards
        (the antidote_wal_segment_depth gauge)."""
        out = [0] * self.n_segments
        for w in self.wals:
            for i, s in enumerate(w.segs):
                out[i] += s.pending_bytes
        return out

    def probe_append(self) -> None:
        """Raise while ANY shard's WAL appends would still fail
        (degraded-mode recovery probe — see ShardWAL.probe).  Every
        shard (and every segment) is probed: a failure scoped to one
        file (bad block, per-file fault rule) must keep the node
        read-only, not flap it out on a healthy sibling's success."""
        for w in self.wals:
            w.probe()

    # ------------------------------------------------------------------
    # checkpoint floors & truncation
    # ------------------------------------------------------------------
    def chain_base(self, shard: int, origin: int) -> int:
        """Replication txn groups below the compaction floor for one
        (shard, origin) chain — where opid/last_seen numbering resumes."""
        return int(self.chain_floor[shard, origin])

    def set_floor(self, floors, chain_floor) -> None:
        """Install a checkpoint's per-shard floors: every replay from now
        on skips records at or below them (they are covered by the
        image).  Caller holds the commit lock when the store is live."""
        self.floor_seqs = np.asarray(floors, np.int64).copy()
        self.chain_floor = np.asarray(chain_floor, np.int64).copy()
        # fresh appends must mint sequences above everything the image
        # covers even before any tail record is replayed
        np.maximum(self.seqs, self.floor_seqs, out=self.seqs)

    def segment_paths(self, shard: int,
                      index: Optional[Dict[int, List[str]]] = None
                      ) -> List[str]:
        """``shard_segment_paths`` of one shard of this log.  A pass over
        many shards lists the directory once (:func:`segment_index`) and
        hands the listing to each call; a lone call lists it itself."""
        if index is None:
            index = segment_index(self.dir)
        return shard_segment_paths(self.dir, shard, self.n_segments, index)

    def rotate_generation(self) -> List[ShardWAL]:
        """Swap every shard onto a fresh segment-file generation (the
        checkpoint stamp's WAL barrier).  Caller must hold the commit
        lock.  The retired segments are queued for the post-publish
        drain+close in :meth:`reclaim_below`; returns them for tests."""
        self.gen += 1
        out: List[ShardWAL] = []
        for w in self.wals:
            out.extend(w.swap_generation(self.gen))
        self._retired.extend(out)
        return out

    def adopt_shard_resets(self, resets: Dict[int, int]) -> None:
        """Durably REPLACE the per-shard truncation epochs with another
        replica's (follower image bootstrap): the installed
        image carries the OWNER's reset epochs, and keeping the
        follower's own (bumped by its pre-bootstrap truncations) would
        make a later :func:`~antidote_tpu_torch.log.checkpoint.install_image`
        of a LOCAL checkpoint drop every shard as stale.  Only valid
        right after the local image set was discarded — the epochs exist
        to fence exactly those images."""
        self.shard_resets = {int(k): int(v) for k, v in resets.items()}
        _set_dir_meta_key(self.dir, "shard_resets",
                          {str(k): v for k, v in self.shard_resets.items()})

    def set_chain_floor(self, shard: int, counts) -> None:
        """Install one shard's replication-group base counts (handoff
        from a compacted source: the package carries the source's chain
        floor so the importer's WAL-derived opid numbering continues the
        true chain instead of restarting at the tail count)."""
        self.chain_floor[shard] = np.maximum(
            self.chain_floor[shard], np.asarray(counts, np.int64))

    def drain_retired(self) -> None:
        """Drain the group-fsync coordinator and close rotated-out
        segment handles.  Runs after a publish (reclaim) AND after a
        FAILED checkpoint attempt — repeated failures must not
        accumulate open fds (sync on a closed segment is a no-op, so a
        straggler barrier that raced the rotation stays safe; the files
        themselves stay on disk until a published floor covers them)."""
        retired, self._retired = self._retired, []
        if not retired:
            return
        try:
            self._fsync.submit(list(retired)).wait()
        except Exception:
            pass  # frozen files owe no further durability here
        for s in retired:
            s.close()

    def reclaim_below(self, floors) -> int:
        """Delete WAL files wholly covered by a PUBLISHED checkpoint
        (every record's append sequence ≤ the shard's floor, verified by
        scan — the guarded truncation API; nothing in this package may
        raw-unlink a WAL file).  Active segments are never candidates.
        Returns bytes reclaimed.  Crash-safe at any point: deletion only
        removes records every replay already skips via the floor filter,
        so a SIGKILL mid-reclaim leaves a byte-identical recovery."""
        from antidote_tpu_torch import faults as _faults

        floors = np.asarray(floors, np.int64)
        self.drain_retired()
        reclaimed = 0
        index = segment_index(self.dir)
        for shard in range(self.cfg.n_shards):
            floor = int(floors[shard])
            if floor <= 0:
                continue
            active = set(gen_segment_paths(self.dir, shard,
                                           self.n_segments, self.gen))
            for path in self.segment_paths(shard, index):
                if path in active or not os.path.exists(path):
                    continue
                d = _faults.hit("wal.truncate_below",
                                key=os.path.basename(path))
                if d is not None:
                    if d.action == "delay" and d.arg:
                        time.sleep(float(d.arg))
                    elif d.action in ("error", "io_error", "enospc"):
                        raise IOError(
                            f"injected fault: wal.truncate_below {path}")
                if not wholly_below(path, floor):
                    continue  # still carries post-floor records
                size = os.path.getsize(path)
                os.remove(path)  # reclaim-ok: guarded — scan proved every
                # record ≤ the published checkpoint floor
                reclaimed += size
        return reclaimed

    def truncate_shards(self, shards) -> None:
        """:meth:`truncate_shard` of every shard in ``shards``, on one
        listing of the directory and one durable write of the truncation
        epochs (a follower's reinstall wipes every shard of its log)."""
        shards = list(shards)
        index = segment_index(self.dir)
        for shard in shards:
            self.truncate_shard(shard, index, write_resets=False)
        _set_dir_meta_key(self.dir, "shard_resets",
                          {str(k): v for k, v in self.shard_resets.items()})

    def truncate_shard(self, shard: int,
                       index: Optional[Dict[int, List[str]]] = None,
                       write_resets: bool = True) -> None:
        """Discard one shard's log — ALL its segments, including frozen
        checkpoint generations (post-handoff cleanup: the records now
        live in the receiver's chain).  ``index`` is a listing of the
        directory taken at this generation (no file of a shard is created
        without a rotation), else the directory is listed here.  Resets
        the shard's op-id chains,
        append sequence, compaction floors and blob-dedup memory along
        with the files, and durably bumps the shard's truncation epoch
        so a checkpoint image written before this call can never
        resurrect the relinquished shard at recovery (``write_resets``
        False leaves that write to the caller: :meth:`truncate_shards`)."""
        sync = self.wals[shard].sync_on_commit
        self.wals[shard].close()
        # retired (previous-generation) segments of THIS shard lose their
        # files below; close them now and forget them
        prefix = os.path.join(self.dir, f"shard_{shard}.")
        for s in [s for s in self._retired if s.path.startswith(prefix)]:
            s.close()
            self._retired.remove(s)
        for path in self.segment_paths(shard, index):
            if os.path.exists(path):
                os.remove(path)  # reclaim-ok: whole-shard handoff drop —
                # the records live on at the new owner
        self.wals[shard] = SegmentedShardWAL(
            self.dir, shard, self.n_segments, sync_on_commit=sync
        )
        if self.gen:
            for s in self.wals[shard].swap_generation(self.gen):
                s.close()
        self.op_ids[shard] = 0
        self.seqs[shard] = 0
        self.floor_seqs[shard] = 0
        self.chain_floor[shard] = 0
        self._blob_seen[shard].clear()
        self.shard_resets[shard] = self.shard_resets.get(shard, 0) + 1
        if write_resets:
            _set_dir_meta_key(
                self.dir, "shard_resets",
                {str(k): v for k, v in self.shard_resets.items()})

    def replay_shard(self, shard: int, floor: Optional[int] = None,
                     index: Optional[Dict[int, List[str]]] = None
                     ) -> Iterator[dict]:
        """Replay one shard's records in exact append order, merged
        across its segments by the ``"q"`` sequence.  Records at or
        below the shard's checkpoint floor are SKIPPED — they are
        covered by the checkpoint image (whether their file was already
        reclaimed or not), so recovery is load-image + this tail.
        Legacy records (no ``"q"``) predate any checkpoint and are
        skipped whenever a floor is set.  ``floor`` overrides the live
        one — callers that pair it with :meth:`chain_base` (catch-up
        serving on fabric threads) snapshot both under the commit lock
        so a concurrent publish can't split them.  Side effect: the
        shard's append-sequence counter resumes past every replayed
        record, so a recovered node's fresh appends never reuse a
        sequence (recovery always replays every shard).  ``index`` is
        :meth:`segment_paths`'s: a pass over every shard lists the
        directory once."""
        if floor is None:
            floor = int(self.floor_seqs[shard])
        for rec in replay_segments(self.segment_paths(shard, index)):
            q = rec.get("q")
            if q is not None and q > self.seqs[shard]:
                self.seqs[shard] = int(q)
            if floor and (q is None or int(q) <= floor):
                continue
            yield rec

    def replay_key(self, shard: int, key, bucket: str) -> List[dict]:
        """Scan one shard's log for a key's ops (the reference's whole-log
        scan + filter)."""
        from antidote_tpu_torch.store.kv import freeze_key

        return [
            r for r in self.replay_shard(shard)
            if freeze_key(r["k"]) == key and r["b"] == bucket
        ]

    def close(self) -> None:
        self._fsync.close()
        for s in self._retired:
            s.close()
        self._retired = []
        for w in self.wals:
            w.close()
