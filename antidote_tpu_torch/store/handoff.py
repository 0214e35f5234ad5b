"""Shard handoff and resharding, and the wire form of store packages.

A shard is a slice of the per-type device tables plus its WAL, so moving
one between replicas is three batched moves:

  * ``export_shard``: copy one shard's rows off the device into a
    serializable package (tables + directory + clocks + WAL records);
  * ``import_shard``: scatter a package into a destination replica (one
    slice assignment a tensor), re-chain the WAL;
  * ``drop_shard``: zero the source slice after a successful move.

``reshard`` rebuilds a replica onto another shard count: every key is
re-routed in one ``shard_batch`` pass and every table moves with one
gather and one scatter a tensor, no per-key work.

The wire form is the JAX package's (msgpack; ``{"__nd": True, "d": dtype,
"s": shape, "b": bytes}`` for an array, ``{"__mp": bytes}`` for a
pre-packed plain value), so checkpoint images and handoff packages written
by either package decode in the other.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any, Dict, List, Optional

import msgpack
import numpy as np
import torch

from antidote_tpu_torch.store.kv import KVStore, effect_from_rec, freeze_key
from antidote_tpu_torch.store.router import shard_batch
from antidote_tpu_torch.store.typed_table import ROW_TENSORS as _ROW_ARRAYS
from antidote_tpu_torch.store.typed_table import _take


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def _table_slice(t, shard: int, used: int) -> Dict[str, Any]:
    # the shard's rows on the device of its block
    a = t.shard_arrays(shard)
    return {
        "snap": {f: _host(x[:used]) for f, x in a["snap"].items()},
        "snap_vc": _host(a["snap_vc"][:used]),
        "snap_seq": _host(a["snap_seq"][:used]),
        "ops_a": _host(a["ops_a"][:used]),
        "ops_b": _host(a["ops_b"][:used]),
        "ops_vc": _host(a["ops_vc"][:used]),
        "ops_origin": _host(a["ops_origin"][:used]),
        "n_ops": t.n_ops[shard, :used].copy(),
        "head": {f: _host(x[:used]) for f, x in a["head"].items()},
        "head_vc": _host(a["head_vc"][:used]),
        # host-tracked serving gates (table-wide, conservative): the
        # importer inherits them, or the provably-fresh fast path would
        # trust stale bounds
        "max_abs_delta": int(t.max_abs_delta),
        "max_commit_vc": t.max_commit_vc.copy(),
        "slots_ub": t.slots_ub[shard, :used].copy(),
    }


def export_shard(store: KVStore, shard: int, include_log: bool = True,
                 segments: Optional[Dict[int, List[str]]] = None
                 ) -> Dict[str, Any]:
    """Package one shard of a replica for transfer: a dict of host arrays
    and metadata (``pack``/``unpack`` turn it into wire bytes).  An export
    of many shards passes one listing of the log directory as ``segments``
    (``log.segment_index``)."""
    if store.cold is not None:
        # a whole-shard export works on device state: every cold key of the
        # shard faults back in first (operator-paced: no rate cap)
        store.cold.fault_in_shard(int(shard))
    with_log = include_log and store.log is not None
    # a checkpoint-truncated source: the ride-along log is only the tail
    # above the compaction floor.  A shard whose rows came from an image
    # alone (a resize's new member after a checkpointed source) has a
    # floor of 0 and no records, but its chain floor counts the history
    # the image covers (the JAX package tests the floor only, so such a
    # shard's package is refused by a durable importer)
    compacted = bool(with_log and (
        int(store.log.floor_seqs[int(shard)]) > 0
        or store.log.chain_floor[int(shard)].any()))
    pkg: Dict[str, Any] = {
        "shard": int(shard),
        "applied_vc": store.applied_vc[shard].copy(),
        "tables": {},
        "directory": [],
        "log": [],
        "compacted": compacted,
        # per-origin replication-group counts below the source's floor:
        # the importer seeds its chain numbering from here
        "chain_floor": (store.log.chain_floor[int(shard)].tolist()
                        if compacted else None),
        # with the FULL log riding along, its records carry every payload
        # the shard references; without one (or with only a compacted
        # tail) the whole content-addressed dict ships
        "blobs": [] if (with_log and not compacted) else [
            (int(h), bytes(d)) for h, d in store.blobs._by_handle.items()
        ],
    }
    for tname, t in store.tables.items():
        used = int(t.used_rows[shard])
        if used == 0:
            continue
        sl = _table_slice(t, shard, used)
        sl["used"] = used
        sl["next_seq"] = int(t.next_seq)
        pkg["tables"][tname] = sl
    for key, bucket in sorted(store.directory.shard_keys(shard), key=repr):
        tname, _s, row = store.directory[(key, bucket)]
        pkg["directory"].append((key, bucket, tname, int(row)))
    if with_log:
        pkg["log"] = list(store.log.replay_shard(shard, index=segments))
    return pkg


def import_shard(store: KVStore, pkg: Dict[str, Any],
                 shard: Optional[int] = None) -> None:
    """Merge an exported shard into ``store`` at ``shard`` (default: the
    package's own index).  Imported rows go after the destination's rows
    (into an empty shard: one home per ring epoch); the directory re-binds
    keys to their new (shard, row) homes.  A key collision, a destination
    shard that holds rows, or a package without log records for a durable
    destination raises before anything is mutated."""
    dst = int(pkg["shard"] if shard is None else shard)
    for key, bucket, _, _ in pkg["directory"]:
        dk = (freeze_key(key), bucket)
        if dk in store.directory:
            raise ValueError(
                f"import_shard: {dk!r} already bound on this replica")
    # exclusive ownership: merging two partial copies of the same
    # (origin, shard) replication chains would break the duplicate
    # suppression, which trusts the shard's applied clocks
    for tname, t in store.tables.items():
        if t.used_rows[dst] > 0:
            raise ValueError(
                f"import_shard: destination shard {dst} already holds "
                f"{int(t.used_rows[dst])} {tname!r} rows; hand off into an "
                "empty shard (exclusive ownership per ring epoch)")
    if (store.log is not None and pkg["tables"] and not pkg["log"]
            and not pkg.get("compacted")):
        raise ValueError(
            "import_shard: this replica is durable (WAL attached) but the "
            "package carries no log records — the imported rows could "
            "never recover and their blob payloads would be lost on "
            "re-export; export with include_log=True from a logged source")
    bases: Dict[str, int] = {}
    for tname, sl in pkg["tables"].items():
        t = store.table(tname)
        used = int(sl["used"])
        base = int(t.used_rows[dst])
        while base + used > t.n_rows:
            t._grow()
        bases[tname] = base
        end = base + used
        # the imported rows join the checkpoint window the out-of-band
        # install below would otherwise void, so a delta link after the
        # import covers them (a window a growth already voided stays so)
        window = t._ckpt_dirty
        # the destination shard's rows, on the device of its block
        a = t.shard_arrays(dst)

        def put(x, arr):
            x[base:end] = torch.as_tensor(np.asarray(arr), device=x.device)

        for f in a["snap"]:
            put(a["snap"][f], sl["snap"][f])
            put(a["head"][f], sl["head"][f])
        # renumber snapshot sequence ids above everything local so the
        # per-key newest-version order is preserved
        seq = np.asarray(sl["snap_seq"], np.int64)
        seq = np.where(seq > 0, seq + t.next_seq, 0)
        t.next_seq += int(sl["next_seq"])
        for name in _ROW_ARRAYS:
            put(a[name], seq if name == "snap_seq" else sl[name])
        t.invalidate_epochs()  # out-of-band mutation: frozen copies stale
        if window is not None:
            window.update((dst, r) for r in range(base, end))
            t._ckpt_dirty = window
        t.n_ops[dst, base:end] = sl["n_ops"]
        # packages without the slot bound get the conservative default
        # (capacity): the next add promotes rather than risking a drop
        cap = t.ty.slot_capacity(t.cfg)
        t.slots_ub[dst, base:end] = np.asarray(
            sl.get("slots_ub", np.full(used, cap or 0, np.int32)), np.int32)
        t.used_rows[dst] = end
        t.max_abs_delta = max(t.max_abs_delta,
                              int(sl.get("max_abs_delta", 2**62)))
        np.maximum(
            t.max_commit_vc,
            np.asarray(sl.get("max_commit_vc",
                              np.full_like(t.max_commit_vc, 2**31 - 1)),
                       np.int32),
            out=t.max_commit_vc)
    dks = []
    for key, bucket, tname, row in pkg["directory"]:
        dk = (freeze_key(key), bucket)
        store.directory[dk] = (tname, dst, bases[tname] + int(row))
        dks.append(dk)
    store.note_ckpt_dirty_many(dks)
    hashes = []
    for h, data in pkg.get("blobs", []):
        store.blobs.intern_bytes(int(h), bytes(data))
        hashes.append(int(h))
    np.maximum(store.applied_vc[dst], pkg["applied_vc"],
               out=store.applied_vc[dst])
    if pkg.get("chain_floor") and store.log is not None:
        # a compacted source: continue the replication chains where the
        # source's checkpoint image left them
        store.log.set_chain_floor(dst, pkg["chain_floor"])
    for rec in pkg["log"]:
        # the ride-along WAL records carry this shard's blob bytes
        eff = effect_from_rec(rec)
        for h, data in eff.blob_refs:
            store.blobs.intern_bytes(int(h), bytes(data))
            hashes.append(int(h))
        if store.log is not None:
            store.log.log_effect(
                dst, eff.key, eff.type_name, eff.bucket, eff.eff_a,
                eff.eff_b, np.asarray(rec["vc"], np.int32), int(rec["o"]),
                blob_refs=eff.blob_refs)
    if pkg["log"] and store.log is not None:
        store.log.commit_barrier([dst])
    bl = store._ckpt_dirty_blobs
    if bl is not None:
        bl.update(hashes)
        if len(bl) > store._CKPT_KEYS_CAP:
            store._ckpt_dirty_blobs = None
    if store.merkle is not None:
        store.merkle.mark_all(dst)


def drop_shard(store: KVStore, shard: int,
               segments: Optional[Dict[int, List[str]]] = None) -> None:
    """Clear a shard after a successful handoff (source side): its rows,
    directory entries, clock, cold refs and log (``segments``: a listing
    of the log directory at the log's current generation, as the export
    took it)."""
    if store.cold is not None:
        # the cold refs travel with the shard (the export faulted them
        # in); local refs must not linger
        store.cold.drop_shard(shard)
    for t in store.tables.values():
        if int(t.used_rows[shard]):
            a = t.shard_arrays(shard)
            for grp in ("snap", "head"):
                for x in a[grp].values():
                    x.zero_()
            for name in _ROW_ARRAYS:
                a[name].zero_()
            t.invalidate_epochs()
            t.n_ops[shard] = 0
            t.slots_ub[shard] = 0
        t.used_rows[shard] = 0
        t.free_rows.pop(shard, None)  # rows restart from 0
    for dk in list(store.directory.shard_keys(shard)):
        del store.directory[dk]
    store.applied_vc[shard] = 0
    if store.merkle is not None:
        store.merkle.mark_all(shard)
    if store.log is not None:
        # the moved records must not resurrect here on the next recover
        store.log.truncate_shard(shard, segments)


def assert_replication_quiescent(store: KVStore, my_dc: int,
                                 replica=None) -> None:
    """Refuse to reshard a replica with replication in flight.

    Re-chaining splits the per-(origin, shard) opid chains; a remote
    transaction buffered or gated when the chains renumber would be
    dropped as a duplicate afterwards.  Quiescence means: no gated or
    pending remote transactions (``replica``, an inter-DC replica), and
    every remote origin's lane equal across all shard clocks — an unequal
    lane is a remote commit some shards applied and others did not (or a
    safe-time ping still in the fabric)."""
    if replica is not None:
        stuck = ([k for k, q in replica.gate.items() if len(q) > 0]
                 + [k for k, buf in replica.pending.items() if len(buf) > 0])
        if stuck:
            raise RuntimeError(
                f"reshard with replication in flight: gated/pending remote "
                f"txns on (origin, shard) chains {sorted(set(stuck))}; "
                "pump the fabric to quiescence first")
    vc = store.applied_vc
    for lane in range(store.cfg.max_dcs):
        if lane == my_dc:
            continue  # the local lane legitimately differs per shard
        if not (vc[:, lane] == vc[0, lane]).all():
            raise RuntimeError(
                f"reshard with replication in flight: origin lane {lane} "
                f"differs across shards ({vc[:, lane].tolist()}); drain "
                "replication (pump + heartbeats) to quiescence first")


def reshard(store: KVStore, new_cfg, log=None, my_dc: Optional[int] = None,
            replica=None) -> KVStore:
    """Rebuild a replica onto a different shard count (ring resize).

    ``new_cfg`` may differ from ``store.cfg`` only in ``n_shards``.  Every
    key re-routes in one ``shard_batch`` pass; each table moves with one
    gather and one scatter a tensor on the store's device.  Returns the new
    store (the old one keeps its tables).  Replication must be quiescent:
    pass ``replica`` (and/or ``my_dc``) to have that asserted
    (:func:`assert_replication_quiescent`) and to hold the replica's
    ingress barrier for the duration — without it a remote transaction
    delivered on a fabric thread mid-copy would land in the old store and
    be lost.  Cold keys are faulted in first: the directory the move walks
    holds resident keys only.  A placed store's new tables keep its
    placement when the new shard count divides over its devices, and fall
    back to one block on the placement's first device otherwise (logged),
    as the JAX package falls back to its default placement."""
    old_cfg = store.cfg
    assert new_cfg.max_dcs == old_cfg.max_dcs
    assert new_cfg.ops_per_key == old_cfg.ops_per_key
    assert new_cfg.snap_versions == old_cfg.snap_versions
    if replica is not None and my_dc is None:
        my_dc = replica.dc_id
    barrier = (replica.ingress_barrier() if replica is not None
               else contextlib.nullcontext())
    with barrier:
        if my_dc is not None:
            assert_replication_quiescent(store, my_dc, replica)
        return _reshard_locked(store, new_cfg, log)


def _reshard_locked(store: KVStore, new_cfg, log) -> KVStore:
    if store.cold is not None:
        for s in range(store.cfg.n_shards):
            store.cold.fault_in_shard(s)
    sharding = store.sharding
    if sharding is not None and new_cfg.n_shards % sharding.mesh.size:
        logging.getLogger(__name__).warning(
            "reshard to n_shards=%d is not divisible by the mesh "
            "'%s' axis (%d): new store falls back to default device "
            "placement", new_cfg.n_shards, sharding.mesh.axis_names[0],
            sharding.mesh.size)
        sharding = None
    new = KVStore(new_cfg, device=store.device, log=log, sharding=sharding)
    items = list(store.directory.items())
    new_shards = shard_batch([dk[0] for dk, _ in items],
                             [dk[1] for dk, _ in items], new_cfg.n_shards)
    by_type: Dict[str, List] = {}
    for i, (dk, (tname, s, row)) in enumerate(items):
        by_type.setdefault(tname, []).append((dk, s, row, int(new_shards[i])))
    for tname, ents in by_type.items():
        src = store.tables[tname]
        dst = new.table(tname)
        old_s = np.asarray([e[1] for e in ents], np.int64)
        old_r = np.asarray([e[2] for e in ents], np.int64)
        ns = np.asarray([e[3] for e in ents], np.int64)
        # contiguous rows per new shard
        nr = np.empty(len(ents), np.int64)
        for p in range(new_cfg.n_shards):
            m = ns == p
            cnt = int(m.sum())
            if cnt == 0:
                continue
            base = int(dst.used_rows[p])
            while base + cnt > dst.n_rows:
                dst._grow()
            nr[m] = base + np.arange(cnt)
            dst.used_rows[p] = base + cnt
        # one gather a source block, scattered into the destination blocks
        # its rows land on (each on the destination block's device)
        for sblk, ssel, sls in src._route(old_s):
            si, ri = sblk.idx_async(sls), sblk.idx_async(_take(old_r, ssel))
            sub_ns, sub_nr = _take(ns, ssel), _take(nr, ssel)
            for dblk, dsel, dls in dst._route(sub_ns):
                di = dblk.idx_async(dls)
                dr = dblk.idx_async(_take(sub_nr, dsel))
                pick = None if dsel is None else sblk.idx_async(dsel)

                def move(x_src, x_dst):
                    g = x_src[si, ri]
                    if pick is not None:
                        g = g[pick]
                    x_dst[di, dr] = g.to(x_dst.device)

                for f in dblk.snap:
                    move(sblk.snap[f], dblk.snap[f])
                    move(sblk.head[f], dblk.head[f])
                for name in _ROW_ARRAYS:
                    move(getattr(sblk, name), getattr(dblk, name))
        dst.n_ops[ns, nr] = src.n_ops[old_s, old_r]
        dst.slots_ub[ns, nr] = src.slots_ub[old_s, old_r]
        dst.next_seq = max(dst.next_seq, src.next_seq)
        dst.max_abs_delta = max(dst.max_abs_delta, src.max_abs_delta)
        np.maximum(dst.max_commit_vc, src.max_commit_vc,
                   out=dst.max_commit_vc)
        for i, (dk, _, _, _) in enumerate(ents):
            new.directory[dk] = (tname, int(ns[i]), int(nr[i]))
    # every commit applied on the old ring is applied on the new one: seed
    # every new shard with the DC-wide applied merge so the stable snapshot
    # (the min over shards) never regresses
    new.applied_vc[:] = store.applied_vc.max(axis=0)
    new.blobs = store.blobs
    # re-chain the durable log onto the new ring
    if log is not None and store.log is not None:
        from antidote_tpu_torch.log import segment_index

        segments = segment_index(store.log.dir)
        for s in range(store.cfg.n_shards):
            for rec in store.log.replay_shard(s, index=segments):
                eff = effect_from_rec(rec)
                ent = new.directory.get((eff.key, eff.bucket))
                if ent is None:
                    continue
                log.log_effect(
                    ent[1], eff.key, eff.type_name, eff.bucket, eff.eff_a,
                    eff.eff_b, np.asarray(rec["vc"], np.int32),
                    int(rec["o"]), blob_refs=eff.blob_refs)
        log.commit_barrier(range(new_cfg.n_shards))
    return new


def opaque(obj: Any) -> Dict[str, Any]:
    """Pre-pack a large plain-data value (no ndarrays inside) so
    :func:`pack`/:func:`unpack`'s recursive walk crosses it as ONE node: a
    million-entry directory list costs one C-speed msgpack pass instead of
    millions of Python calls."""
    return {"__mp": msgpack.packb(obj, use_bin_type=True)}


def pack(pkg: Dict[str, Any]) -> bytes:
    """Encode a package (nested dicts/lists, numpy arrays, plain data)."""

    def enc(x):
        if isinstance(x, np.ndarray):
            return {"__nd": True, "d": str(x.dtype), "s": list(x.shape),
                    "b": x.tobytes()}
        if isinstance(x, dict):
            return {k: enc(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [enc(v) for v in x]
        return x

    return msgpack.packb(enc(pkg), use_bin_type=True)


def unpack(data: bytes) -> Dict[str, Any]:
    """Decode :func:`pack`'s output (arrays come back owned and writable)."""

    def dec(x):
        if isinstance(x, dict):
            if x.get("__nd"):
                return np.frombuffer(x["b"], x["d"]).reshape(x["s"]).copy()
            if x.get("__mp") is not None:
                return msgpack.unpackb(x["__mp"], raw=False,
                                       strict_map_key=False)
            return {k: dec(v) for k, v in x.items()}
        if isinstance(x, list):
            return [dec(v) for v in x]
        return x

    return dec(msgpack.unpackb(data, raw=False, strict_map_key=False))
