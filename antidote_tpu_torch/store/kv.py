"""KVStore — the sharded object store over per-type device tables.

One KVStore instance is one replica ("DC"): it owns all shards locally.
Keys are ``(key, bucket)`` pairs bound to a CRDT type on first use.  The
store routes keys to (shard, row) slots, promotes set keys that outgrow
their element slots to wider tier tables, applies commit batches to the
tables, serves batched reads, and keeps the per-shard applied clocks whose
min is the DC's stable snapshot.

This slice keeps everything in memory: the durable log (and with it the
replay fallback for reads below retained coverage), serving epochs, the
value caches and the cold tier are later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from antidote_tpu_torch.config import AntidoteConfig, resolve_device
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.crdt.blob import BlobStore
from antidote_tpu_torch.materializer import cuda_kernels
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


def freeze_key(key: Any) -> Any:
    """Normalize a key after wire deserialization: msgpack returns tuples
    as lists, but directory keys must be hashable."""
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


class Effect:
    """One downstream effect bound to a key — the unit the op rings hold."""

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
    seq of the destination so the per-key newest-version order survives."""

    def embed(x_src, x_dst):
        out = x_dst[shard, new_row]
        out.zero_()
        out[tuple(slice(0, s) for s in x_src.shape[2:])] = x_src[shard, row]
        x_src[shard, row] = 0

    for grp in _ROW_GROUPS:
        for f, x in getattr(src, grp).items():
            embed(x, getattr(dst, grp)[f])
    for name in _ROW_ARRAYS:
        embed(getattr(src, name), getattr(dst, name))
    seq = dst.snap_seq[shard, new_row]
    seq[seq > 0] += seq_shift


class KVStore:
    def __init__(self, cfg: AntidoteConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
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
                           n_rows=n_rows, device=self.device)
            self.tables[tname] = t
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
        if not create:
            return None
        shard = key_to_shard(key, bucket, self.cfg.n_shards)
        row = self.table(type_name).alloc_row(shard)
        ent = (type_name, shard, row)
        self.directory[dk] = ent
        return ent

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
        shards = shard_batch([m[0] for m in missing], [m[2] for m in missing],
                             self.cfg.n_shards)
        for (key, type_name, bucket), shard in zip(missing, shards):
            dk = (key, bucket)
            if dk in self.directory:  # duplicate within the batch
                continue
            row = self.table(type_name).alloc_row(int(shard))
            self.directory[dk] = (type_name, int(shard), int(row))

    # ------------------------------------------------------------------
    def apply_effects(self, effects: Sequence[Effect],
                      commit_vcs: Sequence[np.ndarray],
                      origins: Sequence[int]) -> None:
        """Apply a commit-ordered batch of effects: ``effects[i]`` committed
        with clock ``commit_vcs[i]`` from DC ``origins[i]``."""
        self.apply_effect_groups(
            [(list(effects), list(commit_vcs), list(origins))])

    def apply_effect_groups(self, groups) -> None:
        """Apply a merged commit batch — several sub-groups ``(effects,
        commit_vcs, origins)``, one per source transaction, in commit
        order — as ONE grouped append per touched table."""
        effects = [e for g in groups for e in g[0]]
        self.locate_many([(e.key, e.type_name, e.bucket) for e in effects])
        # ---- overflow escape hatch: promote BEFORE anything can drop.
        # Aggregate each key's worst-case fresh-slot demand; keys whose
        # conservative bound would exceed capacity migrate to a wider tier
        # now, so the fold below never meets a full slot table.
        demand: Dict[Tuple[Any, str], int] = {}
        for eff in effects:
            if not self._is_slotted(eff.type_name):
                continue
            d = get_type(eff.type_name).slot_demand(eff.eff_a, eff.eff_b)
            if d:
                dk = (eff.key, eff.bucket)
                demand[dk] = demand.get(dk, 0) + d
        for dk, d in demand.items():
            tname_t, shard, row = self.directory[dk]
            t = self.table(tname_t)
            if t.slots_ub[shard, row] + d <= t.ty.slot_capacity(t.cfg):
                t.slots_ub[shard, row] += d
            else:
                self._promote_key(dk, extra_demand=d)
        by_table: Dict[str, list] = {}
        touched = []
        for effs, vcs, orgs in groups:
            for eff, vc_, org in zip(effs, vcs, orgs):
                tname_t, shard, row = self.locate(eff.key, eff.type_name,
                                                  eff.bucket)
                for h, data in eff.blob_refs:
                    self.blobs.intern_bytes(h, data)
                by_table.setdefault(tname_t, []).append(
                    (shard, row, eff.eff_a, eff.eff_b, vc_, org))
                touched.append((shard, np.asarray(vc_, np.int32)))
        for tname_t, items in by_table.items():
            t = self.table(tname_t)
            aw = t.ty.eff_a_width(t.cfg)
            bw = t.ty.eff_b_width(t.cfg)
            t.append(
                np.asarray([x[0] for x in items], np.int64),
                np.asarray([x[1] for x in items], np.int64),
                np.stack([_pad_lane(x[2], aw, np.int64) for x in items]),
                np.stack([_pad_lane(x[3], bw, np.int32) for x in items]),
                np.stack([np.asarray(x[4], np.int32) for x in items]),
                np.asarray([x[5] for x in items], np.int32),
            )
        # only after every append succeeded may the partition clocks claim
        # these commits (the stable snapshot must never dominate unapplied
        # ops)
        for shard, vc_ in touched:
            np.maximum(self.applied_vc[shard], vc_,
                       out=self.applied_vc[shard])

    # ------------------------------------------------------------------
    def _promote_key(self, dk, extra_demand: int = 0) -> None:
        """Migrate one key to a wider-slot tier table, exactly — before the
        batch that would overflow applies, so no op is ever dropped."""
        tname_t, shard, row = self.directory[dk]
        base, tier = split_tier(tname_t)
        ty = get_type(base)
        t_old = self.table(tname_t)
        head_state = {f: x[shard, row].cpu().numpy()
                      for f, x in t_old.head.items()}
        used = ty.used_slots(head_state)
        if used + extra_demand <= ty.slot_capacity(t_old.cfg):
            # the conservative bound went stale (add/remove churn): the key
            # fits its current tier — re-tighten the bound in place
            t_old.slots_ub[shard, row] = used + extra_demand
            return
        new_tier = tier + 1
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
        np.maximum(t_new.max_commit_vc, t_old.max_commit_vc,
                   out=t_new.max_commit_vc)
        t_old.n_ops[shard, row] = 0
        t_old.slots_ub[shard, row] = 0
        self.directory[dk] = (dst_name, shard, new_row)
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
                    self._replay_read_many([objects[items[j][0]]
                                            for j in stale[~complete]])
            for j, (i, _, _) in enumerate(items):
                out[i] = {f: x[j] for f, x in state.items()}
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
                      read_vc: np.ndarray) -> List[Dict[str, np.ndarray]]:
        """Serving path: batched reads with DEVICE value resolution — one
        freshness check + versioned fold of the stale rows + resolve per
        touched table (``TypedTable.read_resolved``); only the compact view
        crosses to the host.  Types without a ``resolve_spec`` return their
        full state."""
        read_vc = np.asarray(read_vc, np.int32)
        out: List[Any] = [None] * len(objects)
        by_table = self._group_by_table(objects, out, self._bottom_resolved)
        for tname_t, items in by_table.items():
            t = self.table(tname_t)
            shards = np.asarray([x[1] for x in items], np.int64)
            rows = np.asarray([x[2] for x in items], np.int64)
            vcs = np.broadcast_to(read_vc, (len(items), read_vc.shape[-1]))
            resolved, _, complete = t.read_resolved(shards, rows, vcs)
            if not complete.all():
                self._replay_read_many([objects[items[j][0]] for j in
                                        np.nonzero(~complete)[0]])
            for j, (i, _, _) in enumerate(items):
                out[i] = {f: x[j] for f, x in resolved.items()}
        return out

    def read_values(self, objects: Sequence[BoundObject],
                    read_vc: np.ndarray) -> List[Any]:
        """Client-visible values (Type:value per object)."""
        states = self.read_states(objects, read_vc)
        return [
            get_type(type_name).value(states[i], self.blobs, self.cfg)
            for i, (_, type_name, _) in enumerate(objects)
        ]

    def _replay_read_many(self, objects) -> None:
        """Rows read below the retained device coverage need a replay of
        the durable log, which this slice does not port."""
        raise RuntimeError(
            f"incomplete read for {[o[0] for o in objects]!r} and no log "
            "attached: read VC below retained snapshot coverage"
        )

    # ------------------------------------------------------------------
    def stable_vc(self) -> np.ndarray:
        """DC-wide stable snapshot = entry-wise min of per-shard clocks."""
        return stable_min_of(self.applied_vc, self.device)

    def dc_max_vc(self) -> np.ndarray:
        """Entry-wise max of per-shard clocks — the freshest local view."""
        return self.applied_vc.max(axis=0)
