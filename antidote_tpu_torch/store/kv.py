"""KVStore — the sharded object store over per-type device tables.

One KVStore instance is one replica ("DC"): it owns all shards locally.
Keys are ``(key, bucket)`` pairs bound to a CRDT type on first use.  The
store routes keys to (shard, row) slots, promotes set keys that outgrow
their element slots to wider tier tables, applies commit batches to the
tables, serves batched reads, and keeps the per-shard applied clocks whose
min is the DC's stable snapshot.

Reads run on two planes beside the locked one:

  * the decoded-value cache: a LATEST read's decoded value per key, valid
    for any read VC that dominates the store's applied max at fill time;
    every applied write invalidates its key (and the parent maps of a
    field or membership key);
  * serving epochs: ``publish_serving_epoch`` freezes every table's head
    into its serving double buffer at a snapshot clock E; readers pin an
    epoch and gather from its frozen slots with no lock while commits
    advance the live heads (``epoch_read_launch`` never syncs the device,
    ``epoch_read_finish`` materializes); a hot-key snapshot cache keeps
    decoded values per epoch and revalidates them across publishes that
    did not touch their rows.

With a durable log attached (``log=``, a ``log.LogManager``), every
commit group is logged before any table observes it, failure-atomically
per sub-group, and ``apply_effect_groups`` hands back the group-fsync
ticket the acknowledgement waits on; ``recover`` rebuilds the tables from
the log, and reads below the device's retained coverage replay it
(``_replay_read_many``, with its fold ladder).  With a cold tier attached
(``self.cold``, ``store/coldtier.py``) the device holds a bounded resident
set: a key evicted to its checkpoint sidecar has no directory entry, the
locked path faults it back in, and the lock-free planes hand it to the
locked path.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from antidote_tpu_torch.config import AntidoteConfig, resolve_device
from antidote_tpu_torch.crdt import get_type, is_type
from antidote_tpu_torch.crdt.base import RESOLVE_OVERFLOW
from antidote_tpu_torch.crdt.blob import BlobStore
from antidote_tpu_torch.materializer import cuda_kernels
from antidote_tpu_torch.materializer import fold as fold_mod
from antidote_tpu_torch.materializer import longlog
from antidote_tpu_torch.store import router
from antidote_tpu_torch.store.router import shard_batch, shard_of
from antidote_tpu_torch.store.typed_table import TypedTable

BoundObject = Tuple[Any, str, str]  # (key, type_name, bucket)

#: below this many clock rows the host numpy min beats a device round trip
_KERNEL_MIN_ROWS = 2048

# ---------------------------------------------------------------------------
# slot tiers — the overflow escape hatch
#
# A key that outgrows its slot budget is PROMOTED to a wider-slot sibling
# table (slot widths x4 per tier) BEFORE any op would be dropped.  The tier
# rides in the table name ("set_aw#2").
# ---------------------------------------------------------------------------
_TIER_SCALE = 4
_MAX_TIER = 8  # 4^8 = 65536x the base slot width


def split_tier(tname: str) -> Tuple[str, int]:
    """"set_aw#2" -> ("set_aw", 2); bare names are tier 0."""
    base, _, t = tname.partition("#")
    return base, int(t) if t else 0


def tiered_name(base: str, tier: int) -> str:
    return base if tier == 0 else f"{base}#{tier}"


def scaled_cfg(cfg: AntidoteConfig, tier: int) -> AntidoteConfig:
    """The config a tier table sizes its slotted state (and slot-scaled
    effect lanes, e.g. register_mv observed ids) from."""
    if tier == 0:
        return cfg
    s = _TIER_SCALE ** tier
    return dataclasses.replace(cfg, set_slots=cfg.set_slots * s,
                               mv_slots=cfg.mv_slots * s,
                               rga_slots=cfg.rga_slots * s)


def stable_min_of(clock_rows: np.ndarray, device) -> np.ndarray:
    """Entry-wise min over a clock matrix int32[N, D] — the stable-time
    merge for any collection of per-shard / per-member clocks.  Below
    ``_KERNEL_MIN_ROWS`` rows the host numpy min stays; larger matrices
    (a cluster's members x shards) go to ``device`` and through the
    ``stable_min`` wrapper: its kernel on a CUDA device, its plain version
    on the CPU."""
    clock_rows = np.asarray(clock_rows)
    if clock_rows.shape[0] < _KERNEL_MIN_ROWS:
        return clock_rows.min(axis=0)
    x = torch.from_numpy(np.ascontiguousarray(clock_rows, np.int32))
    return cuda_kernels.stable_min(x.to(device)).cpu().numpy()


def _canon(v: Any) -> Any:
    """Canonical msgpack-able form of a client-visible value for digesting:
    dicts become pair lists sorted by their packed keys (msgpack maps can't
    carry tuple keys, and dict order is insertion order), numpy scalars
    become Python numbers — so two replicas holding the same logical value
    hash identically, in either package."""
    if isinstance(v, dict):
        import msgpack as _mp

        pairs = [[_canon(k), _canon(x)] for k, x in v.items()]
        pairs.sort(key=lambda p: _mp.packb(p[0], use_bin_type=True,
                                           default=repr))
        return ["\x00map", pairs]
    if isinstance(v, (list, tuple)):
        return [_canon(x) for x in v]
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


#: keys a digest reads per batch (one resolved read per table a chunk)
DIGEST_CHUNK = 4096


def digest_objects(store: "KVStore", dks) -> list:
    """``(key, base type, bucket)`` for each directory or cold key of
    ``dks``, in the digest's canonical order (packed ``[key, bucket,
    type]``).  A cold key's type comes from its cold ref: nothing is
    faulted in here."""
    import msgpack as _mp

    objs = []
    cold = store.cold
    for dk in dks:
        ent = store.directory.get(dk)
        if ent is not None:
            tname = ent[0]
        elif cold is not None and dk in cold.refs:
            tname = cold.refs[dk].tname
        else:
            continue  # removed concurrently
        objs.append((dk[0], split_tier(tname)[0], dk[1]))
    objs.sort(key=lambda o: _mp.packb([o[0], o[2], o[1]],
                                      use_bin_type=True, default=repr))
    return objs


def shard_digest(store: "KVStore", shard: int) -> str:
    """Content digest of one shard's materialized state at its CURRENT
    applied clock — the divergence-detection primitive of the follower
    read tier.  Hashes the clock, then every key of the shard (resident
    and cold, sorted canonically) with its decoded client-visible value at
    ``applied_vc[shard]``: values, not raw rows, so slot-tier promotion
    timing and row allocation order (which legitimately differ between a
    replica applying commit batches and one applying drain batches) do not
    matter.  Equal clocks mean equal applied prefixes, so the digests MUST
    match; a mismatch is silent corruption.  Equal to the JAX package's
    digest string for string.  Caller holds the commit lock."""
    import hashlib

    import msgpack as _mp

    dks = list(store.directory.shard_keys(shard))
    if store.cold is not None:
        dks += list(store.cold.shard_cold_keys(shard))
    objs = digest_objects(store, dks)
    vc = store.applied_vc[shard]
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(vc, dtype=np.int64).tobytes())
    # chunked resolved reads: cold keys fault in chunk by chunk, and the
    # read's post-batch eviction keeps the resident budget
    for lo in range(0, len(objs), DIGEST_CHUNK):
        chunk = objs[lo:lo + DIGEST_CHUNK]
        vals = store.read_values_resolved(chunk, vc)
        for (key, tname, bucket), v in zip(chunk, vals):
            h.update(_mp.packb([_canon(key), bucket, tname, _canon(v)],
                               use_bin_type=True, default=repr))
    return h.hexdigest()


def freeze_key(key: Any) -> Any:
    """Normalize a key after wire or log deserialization: msgpack returns
    tuples as lists, but directory keys must be hashable."""
    if isinstance(key, list):
        return tuple(freeze_key(k) for k in key)
    return key


class ShardDirectory(dict):
    """``(key, bucket) -> (tiered_name, shard, row)`` with a lazily built
    per-shard key index, maintained by every ``[dk] = ent`` / ``pop`` /
    ``del`` once built."""

    __slots__ = ("_by_shard",)

    def __init__(self, items=()):
        super().__init__(items)
        self._by_shard = None

    def __setitem__(self, dk, ent):
        idx = self._by_shard
        if idx is not None:
            old = dict.get(self, dk)
            if old is not None and old[1] != ent[1]:
                idx.get(old[1], set()).discard(dk)
            idx.setdefault(ent[1], set()).add(dk)
        dict.__setitem__(self, dk, ent)

    def __delitem__(self, dk):
        ent = dict.pop(self, dk)
        if self._by_shard is not None:
            self._by_shard.get(ent[1], set()).discard(dk)

    def pop(self, dk, *default):
        if self._by_shard is not None and dk in self:
            self._by_shard.get(dict.__getitem__(self, dk)[1],
                               set()).discard(dk)
        return dict.pop(self, dk, *default)

    def update(self, *a, **kw):
        self._by_shard = None
        dict.update(self, *a, **kw)

    def clear(self):
        dict.clear(self)
        self._by_shard = {}

    def shard_keys(self, shard: int):
        """The shard's directory keys (copy before mutating the directory
        while iterating)."""
        if self._by_shard is None:
            idx: Dict[int, set] = {}
            for dk, ent in self.items():
                idx.setdefault(ent[1], set()).add(dk)
            self._by_shard = idx
        return self._by_shard.get(shard, frozenset())


def key_to_shard(key: Any, bucket: str, n_shards: int) -> int:
    """Key→shard map: integer keys mod n_shards, other keys by XXH64."""
    return shard_of(key, bucket, n_shards)


def _pad_lane(x, width: int, dtype) -> np.ndarray:
    """Zero-pad an effect lane to a (wider) tier's width."""
    x = np.asarray(x, dtype)
    if x.shape[0] == width:
        return x
    assert x.shape[0] < width, (x.shape, width)
    out = np.zeros((width,), dtype)
    out[: x.shape[0]] = x
    return out


def effect_from_rec(rec: dict) -> "Effect":
    """Decode one WAL record (``LogManager``'s record dict) back into an
    Effect — the single place that knows the record's lane encoding."""
    return Effect(
        freeze_key(rec["k"]), rec["t"], rec["b"],
        np.frombuffer(rec["a"], np.int64),
        np.frombuffer(rec["eb"], np.int32),
        [(h, d) for h, d in rec.get("bl", [])],
    )


class Effect:
    """One downstream effect bound to a key — the unit the op rings hold
    and the log stores."""

    __slots__ = ("key", "type_name", "bucket", "eff_a", "eff_b", "blob_refs")

    def __init__(self, key, type_name, bucket, eff_a, eff_b, blob_refs=()):
        self.key = key
        self.type_name = type_name
        self.bucket = bucket
        self.eff_a = eff_a
        self.eff_b = eff_b
        self.blob_refs = list(blob_refs)


_ROW_GROUPS = ("snap", "head")
_ROW_ARRAYS = ("snap_vc", "snap_seq", "ops_a", "ops_b", "ops_vc",
               "ops_origin", "head_vc")


def _move_row(src: TypedTable, dst: TypedTable, shard: int, row: int,
              new_row: int, seq_shift: int) -> None:
    """Move one key's whole device state (head, snapshot versions, op ring)
    into a wider-slot table, zero-padding the widened axes (zeros are empty
    slots), and clear the source row.  Version seqs renumber above every
    seq of the destination so the per-key newest-version order survives.
    Both tables are placed alike, so the shard's rows share a device."""
    src_a, dst_a = src.shard_arrays(shard), dst.shard_arrays(shard)

    def embed(x_src, x_dst):
        out = x_dst[new_row]
        out.zero_()
        out[tuple(slice(0, s) for s in x_src.shape[1:])] = x_src[row]
        x_src[row] = 0

    for grp in _ROW_GROUPS:
        for f, x in src_a[grp].items():
            embed(x, dst_a[grp][f])
    for name in _ROW_ARRAYS:
        embed(src_a[name], dst_a[name])
    seq = dst_a["snap_seq"][new_row]
    seq[seq > 0] += seq_shift


#: distinct miss marker (None is a legitimate cached value)
_CACHE_MISS = object()

#: composite-key namespaces (``crdt/maps.py`` field_key/member_key): an
#: effect on a derived key also invalidates the PARENT map's cached value
_DERIVED_NS = ("\x00mapfield", "\x00mapmember")


def _copy_out(v):
    """Deep-copy a cached value's containers on the way out — clients may
    mutate what they are handed at any nesting level (nested maps hand out
    inner dicts), and a shared container would poison the cache."""
    if type(v) is list:
        return [_copy_out(x) for x in v]
    if type(v) is dict:
        return {k: _copy_out(x) for k, x in v.items()}
    return v


class ServingEpoch:
    """One published store-wide serving snapshot.

    ``vc`` is the snapshot clock E: every applied op is ≤ E entry-wise,
    and every op applied after publication is invisible at E (local
    commits mint own-lane counters above E).  ``tables`` maps tiered
    table names to frozen serving slots (head, head_vc, cap) exact at E;
    ``used_rows`` snapshots row allocation, so rows born after publication
    read as bottom; ``promoted`` collects keys moved to another tier after
    publication (their frozen location went stale: readers fall back).
    ``touched`` maps table names to the rows re-frozen at THIS publish
    (None = full copy or unknown) — the snapshot cache's revalidation
    evidence.

    Readers pin the epoch (under the store's epoch lock) for the lifetime
    of a launch + finish, so a later publish never rewrites slots a
    lock-free gather still reads."""

    __slots__ = ("id", "vc", "mut_epoch", "tables", "used_rows", "touched",
                 "promoted", "pins", "applied")

    def __init__(self, id_, vc, mut_epoch, tables, used_rows, touched,
                 applied=None):
        self.id = id_
        self.vc = vc
        self.mut_epoch = mut_epoch
        self.tables = tables
        self.used_rows = used_rows
        self.touched = touched
        self.promoted: set = set()
        self.pins = 0
        #: the per-shard applied-clock cut at capture (i32[n_shards, D]):
        #: a follower's session gate checks it covers a token on the
        #: shards a read touches (the cross-shard max ``vc`` may claim it)
        self.applied = applied


class _EpochReadPending:
    """A launched epoch read batch: decoded values filled so far and the
    device handles of its per-table gathers (nothing materialized)."""

    __slots__ = ("ep", "objects", "vals", "launches", "store")

    def __init__(self, ep, objects, vals, launches, store=None):
        self.ep = ep
        self.objects = objects
        self.vals = vals
        self.launches = launches
        #: the store that launched it (a follower's repair may swap the
        #: node's store between the launch and the finish)
        self.store = store


class KVStore:
    def __init__(self, cfg: AntidoteConfig, device="cuda", log=None,
                 sharding=None):
        self.cfg = cfg
        #: the placement of every table over a device mesh
        #: (``parallel.shard_axis_sharding``) or None; the store's own
        #: device is then the mesh's first
        self.sharding = sharding
        self.device = (resolve_device(device) if sharding is None
                       else sharding.devices[0])
        #: the mesh serving plane (``parallel.MeshServingPlane``), attached
        #: by ``MeshServingPlane.attach``; stable time and the giant-key
        #: fold route through it
        self.mesh = None
        # the native router routes every key this store binds: a library
        # that cannot be built fails the construction, never a later write
        router.load()
        #: the durable log (``log.LogManager``) or None: when set, effects
        #: are logged (with blob payloads) before the tables observe them
        self.log = log
        #: records replayed by the last ``recover`` (tail-only under a
        #: checkpoint floor)
        self.last_recovery_records = 0
        self.tables: Dict[str, TypedTable] = {}
        self.directory: Dict[Tuple[Any, str], Tuple[str, int, int]] = (
            ShardDirectory())
        self.blobs = BlobStore()
        # per-shard applied VC (partition clock) — the min over shards is
        # the DC's stable snapshot
        self.applied_vc = np.zeros((cfg.n_shards, cfg.max_dcs), np.int32)
        #: per-type cached bottom (never-written) resolved view
        self._bottom_cache: Dict[str, Dict[str, np.ndarray]] = {}
        #: keys promoted to a wider slot tier
        self.promotions = 0
        #: type_name -> whether the type has slot accounting
        self._slotted: Dict[str, bool] = {}
        #: per-strategy replay-path fold tallies (``_fold_over_ring``);
        #: ``materializer_status`` reads them
        self.replay_fold_dispatches: Dict[str, int] = {}
        #: NodeMetrics (attached by AntidoteNode) or None
        self.metrics = None
        #: decoded-value cache: (key, bucket) -> (value, fill_vc tuple).
        #: An entry is valid for any read VC that dominates the store's
        #: applied max at fill time (then latest == cached); every write
        #: to the key invalidates it.  LRU-bounded.
        self._value_cache: "OrderedDict[Tuple[Any, str], tuple]" = (
            OrderedDict())
        self._value_cache_cap = 65536
        self._value_cache_lock = threading.Lock()
        #: bumped at BOTH ends of every apply batch (with ``_mutating``
        #: covering the window between): a fill racing a commit is dropped
        #: whether it captured its epoch before the apply or mid-apply
        self.mutation_epoch = 0
        self._mutating = False
        # --- serving epochs + hot-key snapshot cache --------------------
        #: the last published store-wide serving snapshot
        self.serving_epoch: Optional[ServingEpoch] = None
        self._serving_seq = 0
        #: retired epochs whose reader pins have not drained: a publish
        #: may rewrite spare slots only once this is pin-free (pruned to
        #: pinned entries at every publish)
        self._epoch_graveyard: List[ServingEpoch] = []
        self._epoch_lock = threading.Lock()
        #: hot-key snapshot cache: (key, bucket) -> (epoch id, location,
        #: decoded value); an entry from an older epoch revalidates iff
        #: its row was re-frozen by no publish since.  LRU-bounded.
        self.snapshot_cache: "OrderedDict[Tuple[Any, str], tuple]" = (
            OrderedDict())
        self.snapshot_cache_cap = 65536
        self._snapshot_cache_lock = threading.Lock()
        #: publish history: epoch id -> {tname: frozenset of re-frozen
        #: (shard, row) | None = full copy}; ``_EPOCH_HISTORY`` entries
        self._epoch_touch_log: "OrderedDict[int, dict]" = OrderedDict()
        #: decoded bottom (never-written) value per type
        self._bottom_values: Dict[str, Any] = {}
        #: (key, bucket) pairs written, born or promoted since the last
        #: checkpoint capture — the delta link's dirty-key window.  None =
        #: overflow past the cap: the next stamp must rebase
        self.ckpt_dirty_keys: "set | None" = set()
        #: blob hashes interned in the same window (their WAL records fall
        #: below the link's floor, so the link must carry them); None =
        #: overflow
        self._ckpt_dirty_blobs: "set | None" = set()
        #: (type name, eff_a length, eff_b length) -> the smallest slot
        #: tier whose effect lanes fit (``_tier_for_lanes``, memoized: the
        #: commit path asks once per effect)
        self._lane_tier: Dict[Tuple[str, int, int], int] = {}
        #: the cold tier (``store/coldtier.ColdTier``) when the store may
        #: hold more keys than its resident budget (AntidoteNode attaches
        #: it); None = every key stays on the device
        self.cold = None
        #: keys EVICTED to the cold tier since the last checkpoint capture:
        #: dk -> sidecar coordinates (the delta link records the transition
        #: so that a composed recovery re-registers them cold instead of
        #: resurrecting a row that was since reused)
        self._ckpt_evicted: Dict[Tuple[Any, str], tuple] = {}
        #: the native front end's mirror (``proto/native_frontend``) — the
        #: C++ serving loop's epoch-stamped copy of the snapshot cache.
        #: Wired by the protocol server when native whole-batch serving
        #: is on; pushed from the fill / invalidate / drop paths below so
        #: the native plane never serves a value Python would not.
        self.native_mirror = None
        #: the divergence tree (``store/merkle.MerkleIndex``), built on
        #: the first anti-entropy query; applies mark their keys' leaves
        self.merkle = None

    #: dirty-key windows past this size stop tracking (rebase instead)
    _CKPT_KEYS_CAP = 262144

    def note_ckpt_dirty(self, dk) -> None:
        ks = self.ckpt_dirty_keys
        if ks is not None:
            ks.add(dk)
            if len(ks) > self._CKPT_KEYS_CAP:
                self.ckpt_dirty_keys = None

    def note_ckpt_dirty_many(self, dks) -> None:
        """``note_ckpt_dirty`` of a batch (the window only grows, so one
        cap check after the update decides as one per key would)."""
        ks = self.ckpt_dirty_keys
        if ks is not None:
            ks.update(dks)
            if len(ks) > self._CKPT_KEYS_CAP:
                self.ckpt_dirty_keys = None

    def mark_epoch_fallback(self, dk) -> None:
        """Make every live serving epoch fall back to the locked path for
        one key (a frozen slot may hold the row's previous tenant): the
        row-reuse discipline of tier promotion, cold eviction and cold
        fault-in."""
        self.mark_epoch_fallback_many((dk,))

    def mark_epoch_fallback_many(self, dks) -> None:
        """``mark_epoch_fallback`` of a batch (one lock acquisition)."""
        with self._epoch_lock:
            eps = list(self._epoch_graveyard)
            if self.serving_epoch is not None:
                eps.append(self.serving_epoch)
        for e in eps:
            e.promoted.update(dks)
        nm = self.native_mirror
        if nm is not None:
            # an epoch-ineligible key: the native mirror must miss too
            for dk in dks:
                nm.invalidate(dk[0], dk[1])

    def drop_cached_value(self, dk) -> None:
        """Invalidate both decoded-value caches for one key (an eviction:
        the cached decode may outlive the device row)."""
        self.drop_cached_values((dk,))

    def drop_cached_values(self, dks) -> None:
        """``drop_cached_value`` of a batch (one acquisition of each
        cache's lock)."""
        with self._value_cache_lock:
            for dk in dks:
                self._value_cache.pop(dk, None)
        with self._snapshot_cache_lock:
            for dk in dks:
                self.snapshot_cache.pop(dk, None)
        nm = self.native_mirror
        if nm is not None:
            for dk in dks:
                nm.invalidate(dk[0], dk[1])

    def materializer_status(self) -> dict:
        """Which fold strategies the serving and replay paths dispatched
        (per-strategy totals over every table)."""
        per_table: Dict[str, int] = {}
        for t in self.tables.values():
            for k, n in t.fold_dispatches.items():
                per_table[k] = per_table.get(k, 0) + n
        out = {"fold_chunk": int(self.cfg.fold_chunk),
               "serving_folds": per_table,
               "replay_folds": dict(self.replay_fold_dispatches)}
        if self.mesh is not None:
            out["giant_folds"] = self.mesh.giant_folds
        return out

    def _is_slotted(self, type_name: str) -> bool:
        hit = self._slotted.get(type_name)
        if hit is None:
            hit = get_type(type_name).slot_capacity(self.cfg) is not None
            self._slotted[type_name] = hit
        return hit

    # ------------------------------------------------------------------
    def table(self, tname: str) -> TypedTable:
        """Table for a (possibly tiered) name; tier tables are built with
        x4-per-tier slot widths and start small (few keys ever promote)."""
        t = self.tables.get(tname)
        if t is None:
            base, tier = split_tier(tname)
            n_rows = None if tier == 0 else max(
                self.cfg.keys_per_table // (_TIER_SCALE ** tier), 16
            )
            t = TypedTable(get_type(base), scaled_cfg(self.cfg, tier),
                           n_rows=n_rows, device=self.device,
                           metrics=self.metrics, sharding=self.sharding)
            # out-of-band mutations (row growth) invalidate the table's
            # frozen slots; the store-wide epoch that references them
            # must die with them
            t.on_serving_invalidate = self.drop_serving_epoch
            self.tables[tname] = t
        if t.metrics is None and self.metrics is not None:
            t.metrics = self.metrics  # metrics attach after construction
        return t

    def locate(self, key, type_name: str, bucket: str, create: bool = True):
        """(tiered_name, shard, row) for a bound object; allocates on first
        use.  The first element names the table (base type + slot tier)."""
        dk = (key, bucket)
        hit = self.directory.get(dk)
        if hit is not None:
            if split_tier(hit[0])[0] != type_name:
                raise TypeError(
                    f"key {key!r} bucket {bucket!r} already bound to {hit[0]}, "
                    f"not {type_name}"
                )
            return hit
        if self.cold is not None and self.cold.is_cold(dk):
            # a cold key: fault its row back in through the locked path (a
            # typed ColdMiss past the rate cap, never bottom)
            hit = self.cold.fault_in(dk)
            if split_tier(hit[0])[0] != type_name:
                raise TypeError(
                    f"key {key!r} bucket {bucket!r} already bound to "
                    f"{hit[0]}, not {type_name}")
            return hit
        if not create:
            return None
        shard = key_to_shard(key, bucket, self.cfg.n_shards)
        row = self._alloc_row(self.table(type_name), shard, dk)
        ent = (type_name, shard, row)
        self.directory[dk] = ent
        self.note_ckpt_dirty(dk)
        if self.cold is not None:
            self.cold.note_birth(dk)
        return ent

    def _alloc_row(self, t: TypedTable, shard: int, dk) -> int:
        """A row of ``t`` for a key born into it.  A row the cold tier
        freed still holds its previous tenant's bytes in the frozen slot
        of any live serving epoch, so a key born on one is marked for the
        locked path on every live epoch before the directory binds it."""
        reused = bool(t.free_rows.get(shard))
        row = t.alloc_row(shard)
        if reused:
            self.mark_epoch_fallback(dk)
        return row

    def locate_many(self, objects: Sequence[BoundObject]) -> None:
        """Pre-bind a batch of objects (one routing pass for the unseen
        keys); later ``locate`` calls are dict hits."""
        missing = [
            (key, type_name, bucket)
            for key, type_name, bucket in objects
            if (key, bucket) not in self.directory
        ]
        if not missing:
            return
        if self.cold is not None:
            still = []
            for key, type_name, bucket in missing:
                if self.cold.is_cold((key, bucket)):
                    self.cold.fault_in((key, bucket))
                else:
                    still.append((key, type_name, bucket))
            missing = still
            if not missing:
                return
        shards = shard_batch([m[0] for m in missing], [m[2] for m in missing],
                             self.cfg.n_shards)
        for (key, type_name, bucket), shard in zip(missing, shards):
            dk = (key, bucket)
            if dk in self.directory:  # duplicate within the batch
                continue
            row = self._alloc_row(self.table(type_name), int(shard), dk)
            self.directory[dk] = (type_name, int(shard), int(row))
            self.note_ckpt_dirty(dk)
            if self.cold is not None:
                self.cold.note_birth(dk)

    # ------------------------------------------------------------------
    def apply_effects(self, effects: Sequence[Effect],
                      commit_vcs: Sequence[np.ndarray],
                      origins: Sequence[int]) -> None:
        """Apply a commit-ordered batch of effects: ``effects[i]`` committed
        with clock ``commit_vcs[i]`` from DC ``origins[i]``.

        Blocking form: ONE failure-atomic group — a WAL refusal raises
        before any table mutates, and the commit barrier (fsync under
        sync_log=true) completes before the device apply."""
        errors, _ = self.apply_effect_groups(
            [(list(effects), list(commit_vcs), list(origins))],
            defer_sync=False)
        if errors[0] is not None:
            raise errors[0]

    def apply_effect_groups(self, groups, defer_sync: bool = True):
        """Apply a merged commit batch — several sub-groups ``(effects,
        commit_vcs, origins)``, one per source transaction, in commit
        order — as ONE grouped append per touched table.  Each sub-group
        is failure-atomic on its own: one whose WAL append is refused is
        rolled back alone, and its siblings still log and apply.  The
        mutation epoch is bumped on both sides (value-cache fills racing
        it are dropped).

        Returns ``(errors, ticket)``: one ``None`` or ``Exception`` per
        sub-group, and — with ``defer_sync`` and a log — the group-fsync
        ticket acknowledgements must wait on (None when nothing was
        logged; the fsync runs concurrently with the device apply)."""
        self._mutating = True
        self.mutation_epoch += 1
        try:
            return self._apply_effect_groups_inner(groups, defer_sync)
        finally:
            self.mutation_epoch += 1
            self._mutating = False

    def _tier_for_lanes(self, ty, len_a: int, len_b: int) -> int:
        """Smallest tier whose effect-lane widths fit the given lanes
        (register_mv observed-id lanes scale with the origin's tier)."""
        for tier in range(_MAX_TIER):
            cfg_t = scaled_cfg(self.cfg, tier)
            if (len_a <= ty.eff_a_width(cfg_t)
                    and len_b <= ty.eff_b_width(cfg_t)):
                return tier
        raise OverflowError(
            f"{ty.name}: effect lanes ({len_a}, {len_b}) exceed every slot "
            f"tier up to {_MAX_TIER}")

    def _apply_effect_groups_inner(self, groups, defer_sync):
        effects = [e for g in groups for e in g[0]]
        self.locate_many([(e.key, e.type_name, e.bucket) for e in effects])
        nm = self.native_mirror
        if nm is not None:
            # EAGER native-mirror invalidation, under the commit lock,
            # BEFORE any table observes the effects: the C++ loop can at
            # worst keep serving the pre-commit value at the current
            # epoch stamp (what the Python cache serves until the next
            # publish), never a torn one — the ordering that makes
            # advance()'s re-stamping sound
            for dk in {(e.key, e.bucket) for e in effects}:
                nm.invalidate(dk[0], dk[1])
        # ---- overflow escape hatch: promote BEFORE anything can drop.
        # Aggregate each key's worst-case fresh-slot demand (and the tier
        # its effect lanes need: a replayed or remote effect of a promoted
        # key is wider); keys whose conservative bound would exceed
        # capacity migrate to a wider tier now, so the fold below never
        # meets a full slot table.
        demand: Dict[Tuple[Any, str], int] = {}
        need: Dict[Tuple[Any, str], int] = {}
        lane_tier = self._lane_tier
        for eff in effects:
            if not self._is_slotted(eff.type_name):
                continue
            d = get_type(eff.type_name).slot_demand(eff.eff_a, eff.eff_b)
            lk = (eff.type_name, len(eff.eff_a), len(eff.eff_b))
            need_t = lane_tier.get(lk)
            if need_t is None:
                need_t = lane_tier[lk] = self._tier_for_lanes(
                    get_type(eff.type_name), lk[1], lk[2])
            dk = (eff.key, eff.bucket)
            # the key's current tier matters only for lanes past tier 0
            if need_t and need_t > split_tier(self.directory[dk][0])[1]:
                need[dk] = max(need.get(dk, 0), need_t)
            elif not d:
                continue
            demand[dk] = demand.get(dk, 0) + d
        for dk, d in demand.items():
            tname_t, shard, row = self.directory[dk]
            t = self.table(tname_t)
            need_t = need.get(dk, 0)
            if ((not need_t or need_t <= split_tier(tname_t)[1])
                    and t.slots_ub[shard, row] + d
                    <= t.ty.slot_capacity(t.cfg)):
                t.slots_ub[shard, row] += d
            else:
                self._promote_key(dk, extra_demand=d, min_tier=need_t)
        # per-sub-group record build; blob interning rides along, and each
        # sub-group's rows are staged per table (and its keys, with the
        # parent maps a field write invalidates) for the survivors' apply
        logging = self.log is not None
        to_log: List[List[tuple]] = []
        staged: List[tuple] = []
        for effs, vcs, orgs in groups:
            entries: List[tuple] = []
            rows_by_table: Dict[str, list] = {}
            dks: List[Tuple[Any, str]] = []
            parents: List[Tuple[Any, str]] = []
            touched: List[Tuple[Any, str]] = []
            for eff, vc_, org in zip(effs, vcs, orgs):
                tname_t, shard, row = self.locate(eff.key, eff.type_name,
                                                  eff.bucket)
                for h, data in eff.blob_refs:
                    self.blobs.intern_bytes(h, data)
                    bl = self._ckpt_dirty_blobs
                    if bl is not None:
                        bl.add(h)
                        if len(bl) > self._CKPT_KEYS_CAP:
                            self._ckpt_dirty_blobs = None
                if logging:
                    entries.append((shard, eff.key, eff.type_name,
                                    eff.bucket, eff.eff_a, eff.eff_b, vc_,
                                    org, eff.blob_refs))
                dks.append((eff.key, eff.bucket))
                touched.append((eff.key, eff.bucket))
                # a field or membership write kills the parent map's
                # assembled value (recursively for nested maps)
                k = eff.key
                while (type(k) is tuple and len(k) >= 2
                       and k[0] in _DERIVED_NS):
                    k = k[1]
                    parents.append((k, eff.bucket))
                    touched.append((k, eff.bucket))
                rows_by_table.setdefault(tname_t, []).append(
                    (shard, row, eff.eff_a, eff.eff_b, vc_, org))
            to_log.append(entries)
            staged.append((rows_by_table, dks, parents, touched))
        # durability first: log (with blob payloads) before any table
        # observes the batch, failure-atomically per sub-group
        errors: List[Optional[Exception]] = [None] * len(groups)
        if logging and any(to_log):
            errors = self.log.log_effect_groups(to_log)
        # survivors only: cache invalidation, device apply, clocks
        by_table: Dict[str, list] = {}
        written: List[Tuple[Any, str]] = []
        inval: List[Tuple[Any, str]] = []
        lru: List[Tuple[Any, str]] = []
        for (rows_by_table, dks, parents, touched), err in zip(staged,
                                                               errors):
            if err is not None:
                continue
            for tname_t, items in rows_by_table.items():
                by_table.setdefault(tname_t, []).extend(items)
            written.extend(dks)
            inval.extend(parents)
            lru.extend(touched)
        self.note_ckpt_dirty_many(written)
        mk = self.merkle
        if mk is not None:
            for dk in written:
                mk.mark(self.directory[dk][1], dk)
        ticket = None
        if logging and written:
            # group fsync: deferred acks wait on the ticket after the
            # commit lock releases, so the fsync overlaps the device apply
            # below; the blocking form (recovery, ``apply_effects``) keeps
            # the barrier before the apply
            ticket = self.log.barrier_async(
                {x[0] for items in by_table.values() for x in items})
            if not defer_sync:
                ticket.wait()
                ticket = None
        if written:
            # one locked sweep per batch, not one acquisition per effect
            with self._value_cache_lock:
                for dk in written:
                    self._value_cache.pop(dk, None)
                for dk in inval:
                    self._value_cache.pop(dk, None)
        clocks = []
        for tname_t, items in by_table.items():
            t = self.table(tname_t)
            aw = t.ty.eff_a_width(t.cfg)
            bw = t.ty.eff_b_width(t.cfg)
            shards = np.asarray([x[0] for x in items], np.int64)
            vcs_ = np.stack([np.asarray(x[4], np.int32) for x in items])
            t.append(
                shards,
                np.asarray([x[1] for x in items], np.int64),
                np.stack([_pad_lane(x[2], aw, np.int64) for x in items]),
                np.stack([_pad_lane(x[3], bw, np.int32) for x in items]),
                vcs_,
                np.asarray([x[5] for x in items], np.int32),
            )
            clocks.append((shards, vcs_))
        # only after every append succeeded may the partition clocks claim
        # these commits (the stable snapshot must never dominate unapplied
        # ops)
        for shards, vcs_ in clocks:
            np.maximum.at(self.applied_vc, shards, vcs_)
        if self.cold is not None and lru:
            # the write-LRU touch (each key and the parent maps it
            # invalidates, in commit order), then bounded budget
            # enforcement, both under the caller's commit lock
            self.cold.note_writes(lru)
            self.cold.maybe_evict()
        return errors, ticket

    # ------------------------------------------------------------------
    # serving epochs (lock-split reads)
    # ------------------------------------------------------------------
    def pin_serving_epoch(self) -> Optional[ServingEpoch]:
        """Grab and pin the current serving epoch (None when none is
        published).  The pin keeps a later publish from rewriting frozen
        slots a lock-free gather still reads; release it with
        :meth:`unpin_serving_epoch` once the batch is materialized."""
        with self._epoch_lock:
            ep = self.serving_epoch
            if ep is not None:
                ep.pins += 1
            return ep

    def unpin_serving_epoch(self, ep: ServingEpoch) -> None:
        with self._epoch_lock:
            ep.pins -= 1

    def drop_serving_epoch(self) -> None:
        """Retire the current epoch without a successor (out-of-band table
        mutation): lock-free reads fall back to the locked path until the
        next publish."""
        with self._epoch_lock:
            ep = self.serving_epoch
            if ep is not None:
                self.serving_epoch = None
                self._epoch_graveyard.append(ep)
        nm = self.native_mirror
        if nm is not None:
            nm.reset()  # no epoch, no native serving until the next advance

    def publish_serving_epoch(self, vc: np.ndarray) -> str:
        """Publish a new store-wide serving snapshot at clock ``vc``.

        Caller must hold the commit lock (``vc`` and the frozen heads must
        be captured with no concurrent apply).  Dirty tables are re-frozen
        — by an in-place scatter of the rows written since their spare
        slot's freeze where that slot may be rewritten (cost ∝ rows
        written, not table size), by a copy on the first two freezes or
        after invalidation.  Returns "published", "noop" (the epoch is
        already current) or "deferred" (a reader still pins a retired
        epoch whose slot the freeze would rewrite; retried on the next
        publish)."""
        cur = self.serving_epoch
        if cur is not None and cur.mut_epoch == self.mutation_epoch:
            # no data applied since: only safe-time pings advanced the
            # applied clocks, and the frozen slots still hold every
            # applied op — refresh the epoch's applied cut, which a
            # follower's session gate trusts (not the cross-shard max vc)
            cur.applied = self.applied_vc.copy()
            return "noop"
        m = self.metrics
        with self._epoch_lock:
            can_donate = all(e.pins == 0 for e in self._epoch_graveyard)
            if can_donate:
                # unpinned retired epochs are unreachable (readers only
                # ever pin the current one): their slots may be rewritten
                self._epoch_graveyard.clear()
        slots: Dict[str, dict] = {}
        used: Dict[str, np.ndarray] = {}
        touched: Dict[str, Any] = {}
        for tname, t in self.tables.items():
            # write windows frozen by EARLIER attempts that then deferred
            # stay in this epoch's touched set, or cache entries would
            # revalidate across those writes
            pend = t._pending_touched
            if t.serving_slot() is None or t.serving_dirty():
                # a PARTIAL earlier publish (a defer mid-loop) can leave
                # the LIVE epoch on this table's spare slot: rewriting it
                # would change what lock-free gathers read, and waiting
                # can never free it — rebuild by copy
                spare_live = (cur is not None
                              and cur.tables.get(tname) is t.serving_spare())
                res = t.freeze_serving(can_donate and not spare_live,
                                       force_copy=spare_live)
                if res is None:
                    if m is not None:
                        m.epoch_publish.inc(mode="defer")
                    return "deferred"
                _slot, mode, tch, rows, shard_rows = res
                tch = None if (tch is None or pend is None) else tch | pend
                t._pending_touched = tch
                touched[tname] = tch
                if m is not None:
                    m.epoch_publish.inc(mode=mode)
                    m.epoch_rows.inc(rows, mode=mode)
                    if self.mesh is not None:
                        # the per-shard publish count: a scatter re-froze
                        # exactly the dirty shards' rows, a copy every row
                        # of every shard
                        sr = (shard_rows if shard_rows is not None
                              else {s: t.n_rows
                                    for s in range(self.cfg.n_shards)})
                        for s, n in sr.items():
                            m.mesh_publish.inc(n, shard=s)
            else:
                touched[tname] = pend  # clean since the last success
            slots[tname] = t.serving_slot()
            used[tname] = t.used_rows.copy()
        self._serving_seq += 1
        ep = ServingEpoch(self._serving_seq, np.asarray(vc, np.int32),
                          self.mutation_epoch, slots, used, touched,
                          applied=self.applied_vc.copy())
        with self._epoch_lock:
            old = self.serving_epoch
            self.serving_epoch = ep
            self._epoch_graveyard = [e for e in self._epoch_graveyard
                                     if e.pins > 0]
            if old is not None:
                self._epoch_graveyard.append(old)
        with self._snapshot_cache_lock:
            self._epoch_touch_log[ep.id] = touched
            while len(self._epoch_touch_log) > self._EPOCH_HISTORY:
                self._epoch_touch_log.popitem(last=False)
        for t in self.tables.values():
            t._pending_touched = frozenset()  # this epoch carries them
        if m is not None:
            m.serving_epoch_id.set(ep.id)
        return "published"

    # ------------------------------------------------------------------
    # hot-key snapshot cache
    # ------------------------------------------------------------------
    #: publish-history retention (epochs): an entry older than this many
    #: publishes can no longer prove itself untouched and misses
    _EPOCH_HISTORY = 256

    def epoch_cache_read(self, objects: Sequence[BoundObject],
                         ep: ServingEpoch):
        """Whole-batch fast path: decoded values for every object from the
        snapshot cache and per-type bottoms alone — no device work, no
        lock.  Returns None as soon as any object needs a gather or the
        locked path (only a whole-batch success counts its hits)."""
        vals: List[Any] = []
        n_hits = 0
        nm = self.native_mirror
        for key, type_name, bucket in objects:
            if not is_type(type_name):
                return None
            if getattr(get_type(type_name), "composite", False):
                return None
            dk = (key, bucket)
            hit = self.snapshot_cache_get(dk, ep, type_name, count=False)
            if hit is not _CACHE_MISS:
                vals.append(hit)
                n_hits += 1
                continue
            # the directory BEFORE the promoted check: a promotion marks
            # ep.promoted and THEN flips the directory, so a reader that
            # sees the flipped entry also sees the mark
            ent = self.directory.get(dk)
            if dk in ep.promoted:
                return None
            if ent is None:
                if self.cold is not None and self.cold.is_cold(dk):
                    return None  # a cold key: the locked path faults it in
                bottom = self._bottom_value(type_name)
                if nm is not None:
                    # teach the native mirror the bottom: its first write
                    # invalidates eagerly, so serving it at ep is exactly
                    # what this path serves
                    nm.fill(key, bucket, type_name, bottom, ep.id)
                vals.append(bottom)
                continue
            tname_t, shard, row = ent
            ur = ep.used_rows.get(tname_t)
            if (split_tier(tname_t)[0] == type_name and ur is not None
                    and row >= ur[shard]):
                bottom = self._bottom_value(type_name)  # born after E
                if nm is not None:
                    nm.fill(key, bucket, type_name, bottom, ep.id)
                vals.append(bottom)
                continue
            return None  # needs a frozen-head gather or the locked path
        if self.metrics is not None:
            if n_hits:
                self.metrics.snapshot_cache.inc(n_hits, event="hit")
            self.metrics.serving_reads.inc(len(vals), path="cache")
        return vals

    def snapshot_cache_get(self, dk, ep: ServingEpoch,
                           type_name: Optional[str] = None,
                           count: bool = True):
        """Cached decoded value for ``dk`` at epoch ``ep``, or the miss
        marker.  An entry stamped with an older epoch revalidates (and is
        re-stamped) when the publish history proves its row untouched by
        EVERY publish since; a written key's entry misses, and so does one
        older than the history or spanning a full-copy publish.
        ``type_name``, when given, must match the entry's bound type: a
        wrong-type read takes the miss path so the locked plane raises
        its TypeError.  ``count=False`` suppresses the hit/miss
        counters."""
        m = self.metrics if count else None
        with self._snapshot_cache_lock:
            ent = self.snapshot_cache.get(dk)
            if ent is not None:
                eid, loc, value = ent
                if (type_name is not None and loc is not None
                        and split_tier(loc[0])[0] != type_name):
                    ent = None
            if ent is not None:
                ok = eid == ep.id
                if (not ok and eid < ep.id and loc is not None
                        and dk not in ep.promoted):
                    tname, shard, row = loc
                    log_ = self._epoch_touch_log
                    for e in range(eid + 1, ep.id + 1):
                        tl = log_.get(e)
                        tch = None if tl is None else tl.get(tname)
                        if tch is None or (shard, row) in tch:
                            break  # gap / full copy / row re-frozen
                    else:
                        self.snapshot_cache[dk] = (ep.id, loc, value)
                        ok = True
                        nm = self.native_mirror
                        if nm is not None:
                            # re-prove the entry to the native mirror too
                            # (its advance() only carries entries stamped
                            # with the previous epoch; the touch-log walk
                            # bridges longer gaps)
                            nm.fill(dk[0], dk[1], split_tier(loc[0])[0],
                                    value, ep.id)
                if ok:
                    self.snapshot_cache.move_to_end(dk)
                    if m is not None:
                        m.snapshot_cache.inc(event="hit")
                    return _copy_out(value)
        if m is not None:
            m.snapshot_cache.inc(event="miss")
        return _CACHE_MISS

    def snapshot_cache_fill(self, dk, ep: ServingEpoch, loc, value) -> None:
        with self._snapshot_cache_lock:
            self.snapshot_cache[dk] = (ep.id, loc, _copy_out(value))
            while len(self.snapshot_cache) > self.snapshot_cache_cap:
                self.snapshot_cache.popitem(last=False)
                if self.metrics is not None:
                    self.metrics.snapshot_cache.inc(event="evict")
        nm = self.native_mirror
        if nm is not None:
            # stamped with the epoch the value was READ at: the C++ side
            # keeps a fill that lands after its key's invalidation from
            # being carried past that epoch
            nm.fill(dk[0], dk[1], split_tier(loc[0])[0], value, ep.id)

    def _bottom_value(self, type_name: str):
        """Decoded client-visible value of a never-written key."""
        hit = self._bottom_values.get(type_name)
        if hit is None:
            ty = get_type(type_name)
            hit = ty.value(ty.bottom(self.cfg), self.blobs, self.cfg)
            self._bottom_values[type_name] = hit
        return _copy_out(hit)

    # ------------------------------------------------------------------
    # epoch reads: launch (never syncs the device) + finish (materializes
    # and decodes)
    # ------------------------------------------------------------------
    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        """A host array on the store's device without a stream sync: on
        a card through pinned memory and an asynchronous copy."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def epoch_read_launch(self, objects: Sequence[BoundObject],
                          ep: ServingEpoch):
        """Resolve a batch of bound objects at epoch ``ep`` with no lock
        and no device sync: snapshot-cache hits and bottom values fill
        immediately; the misses are grouped per table into frozen-slot
        gather + resolve launches whose device handles ride in the
        returned pending object.  Returns (pending, fallback_idx): objects
        that cannot be served at the epoch (composite maps, promoted keys,
        type clashes, tables with no frozen slot) are listed for the
        caller's locked path."""
        n = len(objects)
        vals: List[Any] = [None] * n
        fallback: List[int] = []
        need: Dict[str, list] = {}
        m = self.metrics
        n_cached = 0
        for i, (key, type_name, bucket) in enumerate(objects):
            ty = get_type(type_name) if is_type(type_name) else None
            if ty is None or getattr(ty, "composite", False):
                fallback.append(i)
                continue
            dk = (key, bucket)
            hit = self.snapshot_cache_get(dk, ep, type_name)
            if hit is not _CACHE_MISS:
                vals[i] = hit
                n_cached += 1
                continue
            ent = self.directory.get(dk)
            if ent is None:
                if self.cold is not None and self.cold.is_cold(dk):
                    fallback.append(i)  # faulted in by the locked path
                    continue
                vals[i] = self._bottom_value(type_name)
                continue
            if dk in ep.promoted:
                fallback.append(i)
                continue
            tname_t, shard, row = ent
            if split_tier(tname_t)[0] != type_name:
                fallback.append(i)  # type clash: the locked path raises
                continue
            slot = ep.tables.get(tname_t)
            ur = ep.used_rows.get(tname_t)
            if slot is None or ur is None:
                fallback.append(i)
                continue
            if row >= ur[shard]:
                vals[i] = self._bottom_value(type_name)  # born after E
                continue
            need.setdefault(tname_t, []).append((i, shard, row))
        if m is not None and n_cached:
            m.serving_reads.inc(n_cached, path="cache")
        launches = []
        for tname_t, items in need.items():
            t = self.table(tname_t)
            slot = ep.tables[tname_t]
            # every frozen row is fresh at E by construction (frozen
            # head_vc ≤ cap ≤ E): no freshness check
            if t.placed:
                # a placed table: every block gathers its own rows from
                # its own slice of the frozen slot, on its own device
                ss = np.asarray([s for _i, s, _r in items], np.int64)
                rr = np.asarray([r for _i, _s, r in items], np.int64)
                if self.mesh is None:
                    resolved = t.routed_gather(slot["head"],
                                               slot["head_vc"], ss, rr)
                else:
                    resolved = self.mesh.epoch_gather(
                        t, slot["head"], slot["head_vc"], ss, rr)
            else:
                idx = self._to_device(
                    np.asarray([(s, r) for _i, s, r in items], np.int64).T)
                resolved = t.latest_resolved_flat(
                    slot["head"], slot["head_vc"], idx[0], idx[1])
            launches.append((tname_t, items, resolved))
            if m is not None:
                m.serving_reads.inc(len(items), path="gather")
        return (_EpochReadPending(ep, objects, vals, launches, self),
                fallback)

    def epoch_read_finish(self, pending: _EpochReadPending) -> List[Any]:
        """Materialize and decode a launched epoch read batch (the ONLY
        stage that may block on the device) and back-fill the snapshot
        cache.  Returns the decoded values in object order (entries of
        objects the launch rerouted stay None)."""
        ep = pending.ep
        vals = pending.vals
        for tname_t, items, resolved in pending.launches:
            t = self.table(tname_t)
            ty = t.ty
            host = {f: x.cpu().numpy() for f, x in resolved.items()}
            has_resolve = ty.resolve_spec(t.cfg) is not None
            slot = ep.tables[tname_t]
            for j, (i, shard, row) in enumerate(items):
                view = {f: x[j] for f, x in host.items()}
                if has_resolve:
                    v = ty.value_from_resolved(view, self.blobs, t.cfg)
                    if v is RESOLVE_OVERFLOW:
                        # a truncated top-count view: re-gather this one
                        # key's full frozen state (rare)
                        full = t.row_state(slot["head"], shard, row)
                        v = ty.value(full, self.blobs, t.cfg)
                else:
                    v = ty.value(view, self.blobs, t.cfg)
                vals[i] = v
                key, _tn, bucket = pending.objects[i]
                self.snapshot_cache_fill((key, bucket), ep,
                                         (tname_t, shard, row), v)
        return vals

    # ------------------------------------------------------------------
    # decoded-value cache
    # ------------------------------------------------------------------
    def value_cache_get(self, key, bucket, read_vc_tuple):
        """Cached decoded value, or the miss marker.  Valid iff the read
        VC dominates the fill clock (then the unchanged key's latest state
        IS the cached one)."""
        with self._value_cache_lock:
            ent = self._value_cache.get((key, bucket))
            if ent is None:
                return _CACHE_MISS
            value, fill_vc = ent
            if all(r >= f for r, f in zip(read_vc_tuple, fill_vc)):
                self._value_cache.move_to_end((key, bucket))
                return _copy_out(value)
        return _CACHE_MISS

    def value_cache_bulk_get(self, objects, read_vc_tuple):
        """One-pass cache probe for a batch: (values, miss_idx).  When the
        read VC covers the store's current applied max, every present
        entry is valid (entries always hold their key's latest value): one
        comparison for the whole batch instead of one per entry."""
        cache = self._value_cache
        out: List[Any] = [None] * len(objects)
        miss: List[int] = []
        if all(r >= f for r, f in zip(read_vc_tuple,
                                      self.applied_vc.max(axis=0))):
            with self._value_cache_lock:
                for j, (key, _t, bucket) in enumerate(objects):
                    ent = cache.get((key, bucket))
                    if ent is None:
                        miss.append(j)
                    else:
                        cache.move_to_end((key, bucket))
                        out[j] = _copy_out(ent[0])
            return out, miss
        for j, (key, _t, bucket) in enumerate(objects):
            hit = self.value_cache_get(key, bucket, read_vc_tuple)
            if hit is _CACHE_MISS:
                miss.append(j)
            else:
                out[j] = hit
        return out, miss

    def value_cache_fill(self, key, bucket, value, fill_vc_tuple,
                         epoch: int) -> None:
        """Record a LATEST-read decode.  ``fill_vc_tuple`` must be the
        store's applied max captured BEFORE the read and ``epoch`` the
        mutation epoch at the same point: a commit in between drops the
        fill instead of caching a value that claims coverage it lacks."""
        if epoch != self.mutation_epoch or self._mutating:
            return
        # own a copy: the caller's value goes to the client, who may
        # mutate it
        with self._value_cache_lock:
            self._value_cache[(key, bucket)] = (_copy_out(value),
                                                fill_vc_tuple)
            while len(self._value_cache) > self._value_cache_cap:
                self._value_cache.popitem(last=False)

    def applied_max_tuple(self) -> tuple:
        return tuple(int(x) for x in self.applied_vc.max(axis=0))

    # ------------------------------------------------------------------
    def _promote_key(self, dk, extra_demand: int = 0,
                     min_tier: int = 0) -> None:
        """Migrate one key to a wider-slot tier table (at least
        ``min_tier``), exactly — before the batch that would overflow
        applies, so no op is ever dropped."""
        tname_t, shard, row = self.directory[dk]
        base, tier = split_tier(tname_t)
        ty = get_type(base)
        t_old = self.table(tname_t)
        head_state = t_old.row_state(None, shard, row)
        used = ty.used_slots(head_state)
        if (min_tier <= tier
                and used + extra_demand <= ty.slot_capacity(t_old.cfg)):
            # the conservative bound went stale (add/remove churn): the key
            # fits its current tier — re-tighten the bound in place
            t_old.slots_ub[shard, row] = used + extra_demand
            return
        new_tier = max(tier + 1, min_tier)
        while ty.slot_capacity(scaled_cfg(self.cfg, new_tier)) < (
                used + extra_demand):
            new_tier += 1
            if new_tier > _MAX_TIER:
                raise OverflowError(
                    f"{base} key {dk!r}: {used + extra_demand} slots exceed "
                    f"the widest tier ({_MAX_TIER})"
                )
        dst_name = tiered_name(base, new_tier)
        t_new = self.table(dst_name)
        new_row = t_new.alloc_row(shard)
        _move_row(t_old, t_new, shard, row, new_row, t_new.next_seq)
        t_new.next_seq += int(t_old.next_seq)
        t_new.n_ops[shard, new_row] = t_old.n_ops[shard, row]
        t_new.slots_ub[shard, new_row] = used + extra_demand
        t_new.max_abs_delta = max(t_new.max_abs_delta, t_old.max_abs_delta)
        np.maximum(t_new.max_commit_vc, t_old.max_commit_vc,
                   out=t_new.max_commit_vc)
        t_old.n_ops[shard, row] = 0
        t_old.slots_ub[shard, row] = 0
        # both tables mutated outside the append path: their table epochs
        # would serve the pre-promotion (old table) or bottom (new table)
        # row — drop them.  The serving double buffer survives: the move
        # touches exactly two rows, both marked dirty (re-frozen at the
        # next publish), and the promoted mark makes epoch readers fall
        # back for this key meanwhile
        t_old.epochs.clear()
        t_new.epochs.clear()
        t_old.note_serving_touch(np.asarray([shard]), np.asarray([row]))
        t_new.note_serving_touch(np.asarray([shard]), np.asarray([new_row]))
        # mark the key on every live epoch BEFORE the directory flips: a
        # lock-free epoch reader that sees the new entry also sees the
        # mark and falls back
        self.mark_epoch_fallback(dk)
        self.directory[dk] = (dst_name, shard, new_row)
        self.note_ckpt_dirty(dk)
        self.promotions += 1

    # ------------------------------------------------------------------
    def _group_by_table(self, objects, out, missing):
        """Locate a batch of objects: never-written keys get
        ``missing(type_name)`` in ``out``; the rest are grouped as
        tiered_name -> [(object index, shard, row)]."""
        by_table: Dict[str, list] = {}
        for i, (key, type_name, bucket) in enumerate(objects):
            ent = self.locate(key, type_name, bucket, create=False)
            if ent is None:
                out[i] = missing(type_name)
                continue
            tname_t, shard, row = ent
            by_table.setdefault(tname_t, []).append((i, shard, row))
        return by_table

    def read_states(self, objects: Sequence[BoundObject],
                    read_vc: np.ndarray) -> List[Dict[str, np.ndarray]]:
        """Materialized per-key host states for a batch of bound objects at
        one read VC (grouped by table into batched device folds)."""
        read_vc = np.asarray(read_vc, np.int32)
        out: List[Any] = [None] * len(objects)
        by_table = self._group_by_table(
            objects, out, lambda tn: get_type(tn).bottom(self.cfg))
        for tname_t, items in by_table.items():
            t = self.table(tname_t)
            shards = np.asarray([x[1] for x in items], np.int64)
            rows = np.asarray([x[2] for x in items], np.int64)
            vcs = np.broadcast_to(read_vc, (len(items), read_vc.shape[-1]))
            # head gather; exact for rows whose head VC ≤ read VC
            state, fresh = t.read_latest(shards, rows, vcs)
            stale = np.nonzero(~fresh)[0]
            if len(stale):
                s2, _, complete = t.read(shards[stale], rows[stale],
                                         vcs[stale])
                for f in state:
                    state[f][stale] = s2[f]
                if not complete.all():
                    # below the retained device coverage: replay the log,
                    # one scan per shard
                    for shard, wants in self._wants_by_shard(
                            objects, items, tname_t,
                            stale[~complete]).items():
                        reps = self._replay_read_many(shard, wants, read_vc)
                        for j, rep_ in reps.items():
                            for f in state:
                                state[f][j] = rep_[f]
            for j, (i, _, _) in enumerate(items):
                out[i] = {f: x[j] for f, x in state.items()}
        if self.cold is not None:
            # a read batch that faulted cold rows in can overshoot the
            # resident budget; reads never evict mid-batch (a row located
            # earlier in the batch must survive its gather), so here,
            # with everything on the host, the budget is enforced again
            self.cold.maybe_evict()
        return out

    def _bottom_resolved(self, type_name: str) -> Dict[str, np.ndarray]:
        """The resolved view of a never-written key (constant per type)."""
        hit = self._bottom_cache.get(type_name)
        if hit is None:
            ty = get_type(type_name)
            zero = {f: torch.as_tensor(x, device=self.device)[None]
                    for f, x in ty.bottom(self.cfg).items()}
            if ty.resolve_spec(self.cfg) is not None:
                zero = ty.resolve(self.cfg, zero)
            hit = {f: x[0].cpu().numpy() for f, x in zero.items()}
            self._bottom_cache[type_name] = hit
        return {f: x.copy() for f, x in hit.items()}

    def read_resolved(self, objects: Sequence[BoundObject],
                      read_vc: np.ndarray,
                      full_out: Optional[Dict[int, dict]] = None
                      ) -> List[Dict[str, np.ndarray]]:
        """Serving path: batched reads with DEVICE value resolution — one
        freshness check + versioned fold of the stale rows + resolve per
        touched table (``TypedTable.read_resolved``); only the compact view
        crosses to the host.  Types without a ``resolve_spec`` return their
        full state.  Rows below the device's coverage are rebuilt by a log
        replay; with ``full_out``, their full states are recorded there by
        object index (and returned unresolved), so a caller that may need
        the full state never pays a second log scan."""
        read_vc = np.asarray(read_vc, np.int32)
        out: List[Any] = [None] * len(objects)
        by_table = self._group_by_table(objects, out, self._bottom_resolved)
        for tname_t, items in by_table.items():
            t = self.table(tname_t)
            shards = np.asarray([x[1] for x in items], np.int64)
            rows = np.asarray([x[2] for x in items], np.int64)
            vcs = np.broadcast_to(read_vc, (len(items), read_vc.shape[-1]))
            resolved, _, complete = t.read_resolved(shards, rows, vcs)
            for j, (i, _, _) in enumerate(items):
                out[i] = {f: x[j] for f, x in resolved.items()}
            if not complete.all():
                # below the retained device coverage: replay the log, one
                # scan per shard, and resolve the rebuilt states
                for shard, wants in self._wants_by_shard(
                        objects, items, tname_t,
                        np.nonzero(~complete)[0]).items():
                    reps = self._replay_read_many(shard, wants, read_vc)
                    if full_out is not None:
                        for j, rep_ in reps.items():
                            full_out[items[j][0]] = rep_
                            out[items[j][0]] = rep_
                        continue
                    js = list(reps)
                    states = {f: torch.as_tensor(
                        np.stack([reps[j][f] for j in js]),
                        device=self.device) for f in reps[js[0]]}
                    view = t._resolve(states)
                    view = {f: x.cpu().numpy() for f, x in view.items()}
                    for n, j in enumerate(js):
                        out[items[j][0]] = {f: x[n] for f, x in view.items()}
        if self.cold is not None:
            self.cold.maybe_evict()  # post-batch only, as in read_states
        return out

    def read_values(self, objects: Sequence[BoundObject],
                    read_vc: np.ndarray) -> List[Any]:
        """Client-visible values (Type:value per object)."""
        states = self.read_states(objects, read_vc)
        return [
            get_type(type_name).value(states[i], self.blobs, self.cfg)
            for i, (_, type_name, _) in enumerate(objects)
        ]

    def read_values_resolved(self, objects: Sequence[BoundObject],
                             read_vc: np.ndarray) -> List[Any]:
        """``read_values`` through the serving path's device resolve: one
        ``read_resolved`` per table (a ``set_aw`` batch is one
        ``orset_resolve`` launch, not one host decode of a full state per
        key); a view truncated past ``resolve_top`` re-reads its full
        state, and a row the log replay rebuilt decodes directly."""
        replayed: Dict[int, Dict[str, Any]] = {}
        resolved = self.read_resolved(objects, read_vc, full_out=replayed)
        vals: List[Any] = [None] * len(objects)
        refetch = []
        for j, (_key, tname, _bucket) in enumerate(objects):
            ty = get_type(tname)
            if j in replayed or ty.resolve_spec(self.cfg) is None:
                vals[j] = ty.value(replayed.get(j, resolved[j]),
                                   self.blobs, self.cfg)
                continue
            v = ty.value_from_resolved(resolved[j], self.blobs, self.cfg)
            if v is RESOLVE_OVERFLOW:
                refetch.append(j)
            else:
                vals[j] = v
        if refetch:
            states = self.read_states([objects[j] for j in refetch], read_vc)
            for j, st in zip(refetch, states):
                vals[j] = get_type(objects[j][1]).value(st, self.blobs,
                                                        self.cfg)
        return vals

    @staticmethod
    def _wants_by_shard(objects, items, tname_t, idxs) -> Dict[int, list]:
        """The replay requests of a table batch's incomplete rows, grouped
        by shard: shard -> [(batch index, key, tiered name, bucket)]."""
        by_shard: Dict[int, list] = {}
        for j in idxs:
            i, shard, _row = items[int(j)]
            key, _t, bucket = objects[i]
            by_shard.setdefault(int(shard), []).append(
                (int(j), key, tname_t, bucket))
        return by_shard

    def _replay_read_many(self, shard: int, wants, read_vc):
        """Rebuild several keys' states at ``read_vc`` from one scan of the
        shard's durable log.  ``wants`` = [(result index, key, tiered name,
        bucket)]; each state is rebuilt at the key's CURRENT tier width
        (wide enough for every logged effect: the live store promoted
        before any wide effect applied).  Returns result index -> host
        state."""
        if self.log is None:
            raise RuntimeError(
                f"incomplete read for {[w[1] for w in wants]!r} and no log "
                "attached: read VC below retained snapshot coverage")
        if (int(self.log.floor_seqs[shard]) > 0
                or self.log.chain_floor[shard].any()):
            # the shard's log was compacted below a checkpoint floor: the
            # prefix this rebuild needs is in the image (heads, not per-op
            # history), so a tail-only replay would silently miss the
            # pre-checkpoint ops.  Surface the horizon instead.
            raise RuntimeError(
                f"read below the compaction horizon for "
                f"{[w[1] for w in wants]!r}: shard {shard}'s log is "
                "checkpoint-truncated and no longer holds history below "
                "the checkpoint stamp")
        read_vc = np.asarray(read_vc, np.int32)
        index = {}
        ops: Dict[int, list] = {}
        for j, key, tname_t, bucket in wants:
            base, tier = split_tier(tname_t)
            index[(key, bucket)] = (j, get_type(base),
                                    scaled_cfg(self.cfg, tier))
            ops[j] = []
        # one host pass over the shard's log: each wanted key's visible
        # effects in commit order
        for rec in self.log.replay_shard(shard):
            hit = index.get((freeze_key(rec["k"]), rec["b"]))
            if hit is None:
                continue
            j, ty, cfg_t = hit
            vc_ = np.asarray(rec["vc"], np.int32)
            if not (vc_ <= read_vc).all():
                continue
            ops[j].append((
                _pad_lane(np.frombuffer(rec["a"], np.int64),
                          ty.eff_a_width(cfg_t), np.int64),
                _pad_lane(np.frombuffer(rec["eb"], np.int32),
                          ty.eff_b_width(cfg_t), np.int32),
                vc_, rec["o"]))
        out = {}
        for (key, bucket), (j, ty, cfg_t) in index.items():
            recs = ops[j]
            if not recs:
                out[j] = ty.bottom(cfg_t)
                continue
            t0 = time.monotonic()
            state, strategy = self._fold_over_ring(
                ty, cfg_t, np.stack([r[0] for r in recs]),
                np.stack([r[1] for r in recs]),
                np.stack([r[2] for r in recs]),
                np.asarray([r[3] for r in recs], np.int32), read_vc)
            out[j] = {f: x.cpu().numpy() for f, x in state.items()}
            self._observe_fold(strategy, ty.name, time.monotonic() - t0)
        return out

    def _fold_over_ring(self, ty, cfg_t, ops_a, ops_b, ops_vc, ops_origin,
                        read_vc):
        """Fold one host-assembled op log (leading axis L, from the bottom
        state) with the strategy its shape earns; returns (device state of
        one key, strategy name).  Each array reaches the device in ONE
        copy.  The ladder:

        * ``assoc`` — an assoc-safe log (``ty.supports_assoc``, and for
          ``set_aw`` an all-adds log; the bottom base satisfies
          ``assoc_bottom_only``): one masked reduction over the op axis;
        * ``long`` — an order-sensitive log over ``fold_chunk`` ops: the
          chunked serial fold, zero-padded to a chunk multiple (pad slots
          sit at index ≥ n_ops, so the inclusion mask drops them);
        * ``serial`` — a short order-sensitive log: the plain masked fold.

        Above them, ``mesh_assoc``: an assoc-safe log of at least
        ``fold_chunk`` ops with a mesh plane attached folds with its op
        axis split over the plane's devices
        (``MeshServingPlane.fold_giant_key``)."""
        dev = self.device
        length = ops_vc.shape[0]
        chunk = max(int(self.cfg.fold_chunk), 2)
        assoc_ok = ty.supports_assoc and (
            not ty.assoc_add_only or not (ops_b[:, 0] == 1).any())
        if assoc_ok and self.mesh is not None and length >= chunk:
            state, _ = self.mesh.fold_giant_key(
                ty, cfg_t, ty.bottom(cfg_t), ops_a, ops_b, ops_vc,
                ops_origin, np.int32(length),
                np.zeros(self.cfg.max_dcs, np.int32), read_vc)
            return state, "mesh_assoc"
        if not assoc_ok and length > chunk:
            pad = (-length) % chunk

            def padl(x):
                return np.concatenate(
                    [x, np.zeros((pad,) + x.shape[1:], x.dtype)])

            ops_a, ops_b = padl(ops_a), padl(ops_b)
            ops_vc, ops_origin = padl(ops_vc), padl(ops_origin)

        def batch(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=dev)[None]

        state0 = {f: torch.as_tensor(x, device=dev)[None]
                  for f, x in ty.bottom(cfg_t).items()}
        args = (state0, batch(ops_a), batch(ops_b), batch(ops_vc),
                batch(ops_origin),
                torch.full((1,), length, dtype=torch.int32, device=dev),
                torch.zeros((1, self.cfg.max_dcs), dtype=torch.int32,
                            device=dev),
                batch(read_vc))
        if assoc_ok:
            state, _ = longlog.assoc_fold(ty, cfg_t, *args)
            strategy = "assoc"
        elif length > chunk:
            state, _ = longlog.fold_long(ty, cfg_t, *args, chunk=chunk)
            strategy = "long"
        else:
            state, _ = fold_mod.fold_batch(ty, cfg_t, *args)
            strategy = "serial"
        return {f: x[0] for f, x in state.items()}, strategy

    def _observe_fold(self, strategy: str, tname: str,
                      seconds: float) -> None:
        """Tally a replay-path fold dispatch (host dict + metrics)."""
        self.replay_fold_dispatches[strategy] = (
            self.replay_fold_dispatches.get(strategy, 0) + 1)
        m = self.metrics
        if m is not None:
            m.fold_dispatch.inc(strategy=strategy)
            m.fold_seconds.observe(seconds, strategy=strategy, type=tname)

    # ------------------------------------------------------------------
    # recovery
    # ------------------------------------------------------------------
    #: records applied per recovery batch
    RECOVERY_BATCH = 4096

    def recover(self, track_origin: Optional[int] = None) -> Dict:
        """Rebuild tables, clocks, blobs and op-id chains from the log (the
        tail above the checkpoint floor once an image is installed).  With
        ``track_origin``, returns {(key, bucket): last commit counter at
        that origin}, the certification table's rebuild."""
        assert self.log is not None
        last_commit: Dict = {}
        self.last_recovery_records = 0
        saved_cap = None
        if self.cold is not None:
            # the replay is operator-paced: a fault-rate cap sized for
            # client traffic must not refuse the tail's own fault-ins (the
            # node would fail to boot at the same record forever)
            saved_cap, self.cold.fault_rate_cap = (
                self.cold.fault_rate_cap, 0.0)
        try:
            self._recover_inner(track_origin, last_commit)
        finally:
            if saved_cap is not None:
                self.cold.fault_rate_cap = saved_cap
        return last_commit

    def _recover_inner(self, track_origin, last_commit) -> None:
        from antidote_tpu_torch.log import segment_index

        segments = segment_index(self.log.dir)
        for shard in range(self.cfg.n_shards):
            batch: List[Effect] = []
            vcs: List[np.ndarray] = []
            orgs: List[int] = []
            for rec in self.log.replay_shard(shard, index=segments):
                self.last_recovery_records += 1
                eff = effect_from_rec(rec)
                for h, data in eff.blob_refs:
                    self.blobs.intern_bytes(h, data)
                    # already durable: never re-log these payloads
                    self.log._blob_seen[shard].add(h)
                    # ... but a delta link stamped before any fresh write
                    # covers this record with its floor, so it must carry
                    # the payload (the JAX package loses it there)
                    bl = self._ckpt_dirty_blobs
                    if bl is not None:
                        bl.add(h)
                        if len(bl) > self._CKPT_KEYS_CAP:
                            self._ckpt_dirty_blobs = None
                eff.blob_refs = []
                batch.append(eff)
                vcs.append(np.asarray(rec["vc"], np.int32))
                orgs.append(int(rec["o"]))
                self.log.op_ids[shard, rec["o"]] = max(
                    self.log.op_ids[shard, rec["o"]], rec["id"])
                if track_origin is not None and rec["o"] == track_origin:
                    last_commit[(freeze_key(rec["k"]), rec["b"])] = int(
                        rec["vc"][track_origin])
                if len(batch) >= self.RECOVERY_BATCH:
                    self._apply_recovered(batch, vcs, orgs)
                    batch, vcs, orgs = [], [], []
            if batch:
                self._apply_recovered(batch, vcs, orgs)

    def _apply_recovered(self, batch, vcs, orgs) -> None:
        log, self.log = self.log, None  # never re-log during replay
        try:
            self.apply_effects(batch, vcs, orgs)
        finally:
            self.log = log

    # ------------------------------------------------------------------
    def stable_vc(self) -> np.ndarray:
        """DC-wide stable snapshot = entry-wise min of per-shard clocks; on
        a mesh plane, ``stable_min`` on each block's clock rows on its
        device, then the min over the blocks (``MeshServingPlane``).  The
        plane is handed this store's OWN clocks: across a follower
        reinstall a lock-free start on the old store still reads the old
        store's clocks."""
        if self.mesh is not None:
            return self.mesh.stable_vc(self.applied_vc)
        return stable_min_of(self.applied_vc, self.device)

    def dc_max_vc(self) -> np.ndarray:
        """Entry-wise max of per-shard clocks — the freshest local view."""
        return self.applied_vc.max(axis=0)
