"""Checkpointed fast restart: VC-stamped images of the whole store, delta
chains, WAL tail truncation, crash-safe compaction.

A checkpointer streams an atomically published image of the store — per
table the heads over the used rows, the slot bounds and serving gates, the
directory, blob payloads, op-id chains, certification stamps, commit
counters — stamped with the applied vector clock and each shard's WAL
append sequence ``q`` (the *floor*).  Recovery is load-image + replay of
only the WAL tail above the floor; WAL files wholly below the floor are
reclaimed through the guarded ``LogManager.reclaim_below``, which bounds
WAL growth under a sustained write storm.  Between full images, *delta*
links carry only the rows and keys dirtied since their parent.

The image format is the JAX package's (``store/handoff.pack``, the same
field names and dtypes), so a directory written by either package recovers
in the other.

Crash safety: a SIGKILL at ANY point recovers the same state as a
never-checkpointed replay.

  * the stamp is captured under the commit lock (a short barrier: the
    device head copies are *issued* there on the table's stream, and
    copied to the host outside it), so the image is a consistent cut;
  * the image is written to a temp dir, fsynced through the group-fsync
    coordinator, and published by one atomic directory rename;
  * replay always skips records at or below the installed floor, so
    whether a below-floor file was deleted or not changes nothing;
  * reclaim runs only after publish and deletes only whole files whose
    every record a scan proves ≤ floor; a failed checkpoint (ENOSPC
    mid-image) aborts before the floor moves and never flips the store
    read-only.

With a cold tier attached (``store/coldtier.py``), every full image also
writes the cold sidecar ``cold.bin`` (the heads as fixed-stride columns
with a per-row CRC), carrying the still-cold keys' rows forward from their
old sidecars as an appendix; delta links record the keys evicted in their
window, so a composed recovery registers them cold again.

Fault sites: ``ckpt.write``, ``ckpt.fsync``, ``ckpt.rename`` here,
``wal.truncate_below`` in the reclaim.
"""

from __future__ import annotations

import errno
import json
import logging
import os
import re
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from antidote_tpu_torch import faults
from antidote_tpu_torch.log.wal import replay_segments
from antidote_tpu_torch.store.handoff import opaque, pack, unpack

log = logging.getLogger(__name__)

#: subdirectory of the log dir holding published images
CKPT_DIR = "checkpoints"
_CKPT_RE = re.compile(r"ckpt_(\d+)$")
#: image stream chunk (each chunk consults the ckpt.write fault site)
_CHUNK = 8 << 20

_IMAGE = "image.bin"
_MANIFEST = "manifest.json"


class CheckpointError(RuntimeError):
    """A checkpoint attempt failed (nothing was published or truncated;
    the store's durability state is untouched)."""


def checkpoint_root(log_dir: str) -> str:
    return os.path.join(log_dir, CKPT_DIR)


def has_checkpoints(log_dir: str) -> bool:
    """True when the directory holds at least one published checkpoint —
    such a dir carries committed data even if every WAL file was
    reclaimed, so boot paths must demand ``recover=True`` for it."""
    return bool(list_checkpoints(checkpoint_root(log_dir)))


def list_checkpoints(root: str) -> List[Tuple[int, str]]:
    """Published (id, path) pairs, oldest first (a directory without a
    manifest is not published)."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _CKPT_RE.fullmatch(name)
        if m and os.path.exists(os.path.join(root, name, _MANIFEST)):
            out.append((int(m.group(1)), os.path.join(root, name)))
    return sorted(out)


def load_manifest(path: str) -> Optional[dict]:
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def manifest_kind(manifest: dict) -> str:
    """"full" (a whole-store image) or "delta" (a parent-linked link);
    manifests without a kind are full images."""
    return str(manifest.get("kind", "full"))


def _load_verified(path: str, manifest: dict) -> Optional[dict]:
    """Read + CRC-verify + decode one published image or link, or None."""
    try:
        with open(os.path.join(path, _IMAGE), "rb") as f:
            data = f.read()
    except OSError:
        return None
    if (len(data) != int(manifest.get("image_bytes", -1))
            or (zlib.crc32(data) & 0xFFFFFFFF)
            != int(manifest.get("image_crc32", -1))):
        return None
    try:
        return unpack(data)
    except Exception:
        return None


def load_latest(log_dir: str) -> Optional[Tuple[dict, dict]]:
    """Newest FULL checkpoint whose image verifies, or None.  A corrupt
    newest image falls back to the next older one (the retention window
    is the recovery safety margin)."""
    for _id, path in reversed(list_checkpoints(checkpoint_root(log_dir))):
        manifest = load_manifest(path)
        if manifest is None or manifest_kind(manifest) != "full":
            continue
        image = _load_verified(path, manifest)
        if image is None:
            log.warning("checkpoint %s fails verification; falling back "
                        "to an older image", path)
            continue
        return image, manifest
    return None


def load_chain(log_dir: str):
    """The recovery composition: the newest verifiable FULL image plus
    every parent-linked, CRC-verified delta link published after it, in
    apply order.  The chain STOPS at the first missing, corrupt or
    mis-linked link — recovery then takes the good prefix and a longer WAL
    tail (reclaim never deletes records above the retained full images'
    floors).  Returns (image, manifest, [(delta, manifest)]) or None."""
    base = load_latest(log_dir)
    if base is None:
        return None
    image, manifest = base
    deltas: List[Tuple[dict, dict]] = []
    prev_id = int(manifest["id"])
    for id_, path in list_checkpoints(checkpoint_root(log_dir)):
        if id_ <= prev_id:
            continue
        man = load_manifest(path)
        if man is None or manifest_kind(man) != "delta":
            continue
        head = int(deltas[-1][1]["id"]) if deltas else prev_id
        if int(man.get("parent", -1)) != head:
            log.warning("checkpoint chain broken at link %d (parent %s "
                        "does not match the chain head); recovering from "
                        "the prefix + a longer WAL tail", id_,
                        man.get("parent"))
            break
        delta = _load_verified(path, man)
        if delta is None:
            log.warning("checkpoint chain link %d fails verification; "
                        "recovering from the prefix + a longer WAL tail",
                        id_)
            break
        deltas.append((delta, man))
    return image, manifest, deltas


def latest_image_meta(log_dir: str,
                      before_id: Optional[int] = None) -> Optional[dict]:
    """Shippable metadata of the newest published full image, from its
    manifest (the image is never decoded) — what an owner answers a
    follower's ``ckpt_meta`` with: ``{id, image_bytes, image_crc32,
    stamp_vc_max, created_at}``, plus, for an image with a cold sidecar,
    ``cold_keys``, ``cold_bytes``, ``cold_crc32`` and ``cold_manifest``
    (the follower fetches the sidecar only when it holds cold keys).
    ``before_id`` restricts to strictly older images: a follower whose
    fetch of the newest failed verification falls back through the
    retention window as owner-side recovery does."""
    for _id, path in reversed(list_checkpoints(checkpoint_root(log_dir))):
        if before_id is not None and _id >= int(before_id):
            continue
        manifest = load_manifest(path)
        if manifest is None or manifest_kind(manifest) != "full":
            continue  # delta links are not shippable on their own
        out = {"id": int(manifest["id"]),
               "image_bytes": int(manifest["image_bytes"]),
               "image_crc32": int(manifest["image_crc32"]),
               "stamp_vc_max": manifest.get("stamp_vc_max"),
               "created_at": manifest.get("created_at")}
        cold = manifest.get("cold")
        if cold is not None:
            out["cold_keys"] = int(manifest.get("cold_keys", 0))
            out["cold_bytes"] = int(cold["bytes"])
            out["cold_crc32"] = int(cold["crc32"])
            out["cold_manifest"] = cold
        return out
    return None


def image_path(log_dir: str, ckpt_id: int) -> str:
    """Path of a published image file by id."""
    return os.path.join(checkpoint_root(log_dir), f"ckpt_{int(ckpt_id)}",
                        _IMAGE)


def cold_path(log_dir: str, ckpt_id: int) -> str:
    """Path of a published cold sidecar by id."""
    from antidote_tpu_torch.store.coldtier import COLD_BIN

    return os.path.join(checkpoint_root(log_dir), f"ckpt_{int(ckpt_id)}",
                        COLD_BIN)


def discard_all(log_dir: str) -> int:
    """Delete EVERY published image under a log dir (and orphaned temp
    dirs); returns the number of images discarded."""
    root = checkpoint_root(log_dir)
    cks = list_checkpoints(root)
    for _id, path in cks:
        shutil.rmtree(path, ignore_errors=True)  # reclaim-ok: explicit
        # whole-image discard
    if os.path.isdir(root):
        for name in os.listdir(root):
            if name.startswith("tmp."):
                shutil.rmtree(os.path.join(root, name),
                              ignore_errors=True)  # reclaim-ok: orphaned
                # temp dir of a crashed writer
    return len(cks)


# ---------------------------------------------------------------------------
# image install (recovery side)
# ---------------------------------------------------------------------------
def _stale_shards(logm, image_resets: dict, n_shards: int) -> set:
    """Shards whose durable truncation epoch advanced past the image's: a
    shard relinquished after the stamp must not resurrect."""
    resets = {int(k): int(v) for k, v in (image_resets or {}).items()}
    return {s for s in range(n_shards)
            if logm.shard_resets.get(s, 0) > resets.get(s, 0)}


def _freeze_entries(entries):
    """Directory-style rows with list keys (msgpack's tuples) frozen."""
    from antidote_tpu_torch.store.kv import freeze_key

    return [(freeze_key(e[0]),) + tuple(e[1:]) for e in entries]


def install_image(store, txm, image: dict, shards=None) -> dict:
    """Install a full image into a FRESH store/manager pair (recovery's
    first phase; the WAL tail replays afterwards and skips everything the
    installed floor covers).  Each table's rows are assembled full-extent
    on the host and reach the store's device in one copy per tensor; one
    snapshot version is seeded from the head, so versioned reads at
    clocks ≥ a row's head_vc fold the (empty) ring on it exactly and reads
    below surface the compaction horizon.  Shards truncated after the
    stamp are dropped.  The image's ``cold_directory`` keys get NO device
    row: they come back in the summary for the caller's cold tier, which
    faults them in on demand.

    ``shards`` RESTRICTS the install to that shard set and MERGES onto
    what the store already holds instead of replacing it: the rows,
    directory entries, clocks, floors and blob sets of the other shards
    stay byte-intact (the composition primitive of a follower's
    bootstrap).  Returns a summary dict."""
    from antidote_tpu_torch.store.kv import freeze_key

    logm = store.log
    assert logm is not None, "checkpoint install needs the durable log"
    cfg = store.cfg
    if (int(image["n_shards"]) != cfg.n_shards
            or int(image["max_dcs"]) != cfg.max_dcs):
        raise CheckpointError(
            f"checkpoint image shape (n_shards={image['n_shards']}, "
            f"max_dcs={image['max_dcs']}) does not match the deployment "
            f"({cfg.n_shards}, {cfg.max_dcs})")
    stale = _stale_shards(logm, image.get("shard_resets"), cfg.n_shards)
    if stale:
        log.warning("checkpoint image predates truncation of shard(s) %s; "
                    "dropping them from the restore", sorted(stale))
    sl = sorted(stale)
    #: restricted-merge mode: the shard rows this install may touch
    rlist = (None if shards is None
             else sorted({int(s) for s in shards} - stale))
    floors = np.asarray(image["floor_seqs"], np.int64).copy()
    chains = np.asarray(image["chain_floor"], np.int64).copy()
    op_ids = np.asarray(image["op_ids"], np.int64).copy()
    stamp = np.asarray(image["stamp_vc"], np.int32).copy()
    for arr in (floors, chains, op_ids, stamp):
        arr[sl] = 0
    n_rows_installed = 0
    for tname, tb in image["tables"].items():
        t = store.table(tname)
        used = np.asarray(tb["used_rows"], np.int64).copy()
        head_vc = np.asarray(tb["head_vc"], np.int32).copy()
        head = {f: np.asarray(x).copy() for f, x in tb["head"].items()}
        slots_ub = np.asarray(tb["slots_ub"], np.int32).copy()
        used[sl] = 0
        head_vc[sl] = 0
        slots_ub[sl] = 0
        for x in head.values():
            x[sl] = 0
        u_cap = head_vc.shape[1]
        while u_cap > t.n_rows:
            t._grow()

        def full(name, src, field=None, snap_slot=False):
            if rlist is None:
                # the store is fresh (all-zero tables): zeros + one slice
                # assign on the host, then one copy to the device (one a
                # block for a placed table)
                arr = np.zeros(t.full_shape(name, field), src.dtype)
                if snap_slot:
                    arr[:, :u_cap, 0] = src
                else:
                    arr[:, :u_cap] = src
            else:
                # restricted merge: the other shards' rows stay intact
                arr = t.host_full(name, field).copy()
                if snap_slot:
                    arr[rlist, :u_cap, 0] = src[rlist]
                else:
                    arr[rlist, :u_cap] = src[rlist]
            t.put_full(name, arr, field)

        for f in list(t.blocks[0].head):
            full("head", head[f], f)
            full("snap", head[f], f, snap_slot=True)
        full("head_vc", head_vc)
        full("snap_vc", head_vc, snap_slot=True)
        seq_col = (np.arange(u_cap)[None, :] < used[:, None]).astype(np.int64)
        full("snap_seq", seq_col, snap_slot=True)
        t.next_seq = 2
        if rlist is None:
            t.used_rows[:] = used
            t.slots_ub[:, :u_cap] = slots_ub
            t.max_abs_delta = int(tb["max_abs_delta"])
        else:
            t.used_rows[rlist] = used[rlist]
            t.slots_ub[rlist, :u_cap] = slots_ub[rlist]
            t.max_abs_delta = max(t.max_abs_delta, int(tb["max_abs_delta"]))
            t.invalidate_epochs()  # out-of-band rows: frozen copies stale
        if stale or rlist is not None:
            # a dropped shard may have held the table-wide max commit VC
            # (a restricted merge folds its rows into the cap earlier
            # installs established)
            hv = head_vc if rlist is None else head_vc[rlist]
            mcv = (hv.reshape(-1, head_vc.shape[-1]).max(axis=0)
                   if hv.size else np.zeros(cfg.max_dcs, np.int32))
            if rlist is not None:
                mcv = np.maximum(mcv, np.asarray(t.max_commit_vc, np.int32))
            t.max_commit_vc = mcv.astype(np.int32)
        else:
            t.max_commit_vc = np.asarray(tb["max_commit_vc"],
                                         np.int32).copy()
        n_rows_installed += int(used.sum() if rlist is None
                                else used[rlist].sum())
    if rlist is not None:
        keep = set(rlist)
        directory = [e for e in image["directory"] if int(e[3]) in keep]
    else:
        directory = [e for e in image["directory"] if int(e[3]) not in stale]
    if directory:
        keys, buckets, tnames, shards_, rows = zip(*directory)
        if any(type(k) is list for k in keys):
            keys = tuple(freeze_key(k) for k in keys)
        store.directory.update(
            zip(zip(keys, buckets), zip(tnames, shards_, rows)))
    for h, data in image.get("blobs", []):
        store.blobs.intern_bytes(int(h), bytes(data))
    for s, hashes in enumerate(image.get("blob_seen", [])):
        if (s < cfg.n_shards and s not in stale
                and (rlist is None or s in rlist)):
            logm._blob_seen[s] = {int(h) for h in hashes}
    if rlist is None:
        np.maximum(store.applied_vc, stamp, out=store.applied_vc)
        np.maximum(logm.op_ids, op_ids, out=logm.op_ids)
        logm.set_floor(floors, chains)
    else:
        # merge only the restricted rows: the other shards' floors and
        # clocks survive this install untouched
        store.applied_vc[rlist] = np.maximum(store.applied_vc[rlist],
                                             stamp[rlist])
        logm.op_ids[rlist] = np.maximum(logm.op_ids[rlist], op_ids[rlist])
        fl = logm.floor_seqs.copy()
        ch = logm.chain_floor.copy()
        fl[rlist] = floors[rlist]
        ch[rlist] = chains[rlist]
        logm.set_floor(fl, ch)
    cold_entries = [e for e in image.get("cold_directory", []) or []
                    if int(e[3]) not in stale
                    and (rlist is None or int(e[3]) in rlist)]
    committed = image.get("committed_keys", [])
    if committed and not stale and rlist is None and not txm.committed_keys:
        # fresh manager, nothing dropped: bulk build
        ck, cb, cv = zip(*committed)
        if any(type(k) is list for k in ck):
            ck = tuple(freeze_key(k) for k in ck)
        txm.committed_keys.update(zip(zip(ck, cb), cv))
    else:
        for key, bucket, counter in committed:
            dk = (freeze_key(key), bucket)
            if dk in store.directory:
                txm.committed_keys[dk] = max(
                    txm.committed_keys.get(dk, 0), int(counter))
    if store.merkle is not None:
        for s in (range(cfg.n_shards) if rlist is None else rlist):
            store.merkle.mark_all(s)
    return {"id": int(image["id"]), "keys": len(directory),
            "rows": n_rows_installed, "tables": len(image["tables"]),
            "dropped_shards": sl, "restricted_to": rlist,
            "cold_directory": cold_entries}


def install_delta(store, txm, delta: dict) -> dict:
    """Overlay one delta link onto an installed parent: the keys the link
    records as EVICTED are registered cold again, the link's dirty rows'
    heads go into the tables (seeding one snapshot version each, as
    :func:`install_image` does), then the directory, certification and
    blob deltas apply, and floors, op-id chains and clocks advance to the
    link's stamp.  Returns a summary dict."""
    logm = store.log
    assert logm is not None, "delta install needs the durable log"
    cfg = store.cfg
    if (int(delta["n_shards"]) != cfg.n_shards
            or int(delta["max_dcs"]) != cfg.max_dcs):
        raise CheckpointError(
            f"chain link shape (n_shards={delta['n_shards']}) does not "
            f"match the deployment ({cfg.n_shards})")
    stale = _stale_shards(logm, delta.get("shard_resets"), cfg.n_shards)
    # evictions FIRST: the rows the link records as evicted were freed and
    # may be reused by the link's own row overlays below — clearing them
    # after the overlay would wipe the new tenants' state
    evicted = _freeze_entries([e for e in delta.get("cold_delta", [])
                               if int(e[3]) not in stale])
    if evicted and store.cold is None:
        # the chain recorded evictions but this boot has no cold tier
        # (restarted without a resident budget): attach one anyway —
        # dropping the keys' directory entries without registering their
        # sidecar refs would turn their reads into silent bottoms
        from antidote_tpu_torch.store.coldtier import ColdTier

        store.cold = ColdTier(store, budget=0,
                              lock=getattr(txm, "commit_lock", None))
    by_table: Dict[str, list] = {}
    for key, bucket, _tname, _shard, _srow in evicted:
        ent = store.directory.pop((key, bucket), None)
        if ent is not None:
            by_table.setdefault(ent[0], []).append(ent[1:])
    for tname, pairs in by_table.items():
        # one clear a table for the link's recorded evictions (in the
        # link's order, so the free lists come out as key-by-key clears
        # leave them); their sidecar coordinates ride in the same entries
        # and are registered just below
        store.table(tname).evict_rows(  # evict-ok: composing a recorded
            np.asarray([p[0] for p in pairs]),  # cold-tier eviction
            np.asarray([p[1] for p in pairs]))
    if store.cold is not None and evicted:
        src = delta.get("cold_src")
        store.cold.seed([list(e) for e in evicted],
                        src if src is not None else delta.get("parent"))
    n_rows = 0
    for tname, tb in delta["tables"].items():
        t = store.table(tname)
        keep = np.asarray([int(s) not in stale for s, _ in tb["rows"]],
                          bool)
        if not keep.any():
            continue
        pairs = np.asarray(tb["rows"], np.int64).reshape(-1, 2)[keep]
        ss, rr = pairs[:, 0], pairs[:, 1]
        while int(rr.max()) >= t.n_rows:
            t._grow()
        t.install_rows(ss, rr,
                       {f: np.asarray(x)[keep] for f, x in tb["head"].items()},
                       np.asarray(tb["head_vc"], np.int32)[keep])
        # overlaid rows are OCCUPIED now: pull them off the free lists the
        # eviction pass may have pushed them onto (a later alloc_row
        # handing one out again would double-bind the row)
        occupied: Dict[int, set] = {}
        for s_, r_ in zip(ss.tolist(), rr.tolist()):
            occupied.setdefault(s_, set()).add(r_)
        for s_, rows_set in occupied.items():
            free = t.free_rows.get(s_)
            if free:
                t.free_rows[s_] = [r for r in free if r not in rows_set]
        t.slots_ub[ss, rr] = np.asarray(tb["slots_ub"], np.int32)[keep]
        used = np.asarray(tb["used_rows"], np.int64).copy()
        used[sorted(stale)] = 0
        np.maximum(t.used_rows, used, out=t.used_rows)
        t.max_abs_delta = max(t.max_abs_delta, int(tb["max_abs_delta"]))
        np.maximum(t.max_commit_vc,
                   np.asarray(tb["max_commit_vc"], np.int32),
                   out=t.max_commit_vc)
        n_rows += len(ss)
    entries = _freeze_entries(delta.get("directory_delta", []))
    cold = store.cold
    for key, bucket, tname, shard, row in entries:
        if int(shard) in stale:
            continue
        dk = (key, bucket)
        store.directory[dk] = (tname, int(shard), int(row))
        if cold is not None and cold.is_cold(dk):
            # the link proves the key resident at its stamp: undo the cold
            # registration an earlier install seeded
            cold.cold_set.discard(dk)
            by_shard = cold.by_shard.get(int(shard))
            if by_shard is not None:
                by_shard.discard(dk)
    for key, bucket, counter in _freeze_entries(
            delta.get("committed_delta", [])):
        dk = (key, bucket)
        txm.committed_keys[dk] = max(txm.committed_keys.get(dk, 0),
                                     int(counter))
    for h, data in delta.get("blobs_delta", []):
        store.blobs.intern_bytes(int(h), bytes(data))
    for s, hashes in enumerate(delta.get("blob_seen", [])):
        if s < cfg.n_shards and s not in stale:
            logm._blob_seen[s] = {int(h) for h in hashes}
    floors = np.asarray(delta["floor_seqs"], np.int64).copy()
    chains = np.asarray(delta["chain_floor"], np.int64).copy()
    stamp = np.asarray(delta["stamp_vc"], np.int32).copy()
    op_ids = np.asarray(delta["op_ids"], np.int64).copy()
    for s in stale:
        floors[s] = logm.floor_seqs[s]
        chains[s] = logm.chain_floor[s]
        stamp[s] = 0
        op_ids[s] = 0
    np.maximum(store.applied_vc, stamp, out=store.applied_vc)
    np.maximum(logm.op_ids, op_ids, out=logm.op_ids)
    logm.set_floor(floors, chains)
    return {"id": int(delta["id"]), "parent": int(delta["parent"]),
            "rows": n_rows, "keys": len(entries), "evicted": len(evicted),
            "dropped_shards": sorted(stale)}


# ---------------------------------------------------------------------------
# checkpoint writer
# ---------------------------------------------------------------------------
class _ImageFsync:
    """Lets the image ride the WAL's group-fsync coordinator (one fsync
    stream for the whole process)."""

    def __init__(self, fileno: int, name: str):
        self._fileno = fileno
        self._name = name

    def sync(self) -> None:
        d = faults.hit("ckpt.fsync", key=self._name)
        if d is not None:
            if d.action == "delay" and d.arg:
                time.sleep(float(d.arg))
            elif d.action in ("error", "io_error", "enospc"):
                err = errno.ENOSPC if d.action == "enospc" else errno.EIO
                raise OSError(err, f"injected fault: ckpt.fsync {self._name}")
        os.fsync(self._fileno)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)  # the rename is durable only with its directory
    finally:
        os.close(fd)


def _faulted_write(f, data: bytes, name: str) -> None:
    """Stream ``data`` in chunks, consulting the ``ckpt.write`` fault site
    per chunk (delay holds the writer mid-stream; enospc/io_error abort)."""
    view = memoryview(data)
    for off in range(0, max(len(view), 1), _CHUNK):
        d = faults.hit("ckpt.write", key=name)
        if d is not None:
            if d.action == "delay" and d.arg:
                time.sleep(float(d.arg))
            elif d.action == "enospc":
                raise OSError(errno.ENOSPC,
                              f"injected fault: ckpt.write {name}")
            elif d.action in ("error", "io_error"):
                raise OSError(errno.EIO,
                              f"injected fault: ckpt.write {name}")
        f.write(view[off:off + _CHUNK])


def _host(x: torch.Tensor) -> np.ndarray:
    """A device copy taken at the stamp, on the host (outside the lock)."""
    return x.cpu().numpy()


class Checkpointer:
    """Background checkpoint writer for one node.

    ``checkpoint_now`` runs one cycle synchronously: stamp (a short
    commit-lock barrier), stream + atomic publish, floor install,
    retention, WAL reclaim.  ``start`` runs it every ``interval_s`` in a
    daemon thread (``request`` nudges an immediate run).  Failures never
    flip the store read-only and never truncate anything: they raise
    :class:`CheckpointError` (or are logged by the loop) and the next
    interval retries."""

    def __init__(self, store, txm, metrics=None, interval_s: float = 300.0,
                 retain: int = 2, rebase_every: int = 8,
                 scrub_every_s: float = 0.0):
        assert store.log is not None, "checkpointing needs a durable log"
        self.store = store
        self.txm = txm
        self.log = store.log
        self.metrics = metrics
        self.interval_s = float(interval_s)
        #: FULL images retained (delta links above the newest ride along)
        self.retain = max(1, int(retain))
        #: delta links between full rebases (0/1 = always full)
        self.rebase_every = max(0, int(rebase_every))
        #: background bit-rot scrub cadence (0 = disabled)
        self.scrub_every_s = float(scrub_every_s)
        #: bytes/second ceiling for scrub reads (never starve the WAL)
        self.scrub_bps = 64 << 20
        #: the next stamp must be a FULL rebase (a failed stamp consumed
        #: the dirty windows; a scrub found a corrupt image)
        self.force_rebase = False
        #: delta links since the last full image
        self.chain_len = 0
        #: seals since the last full image that published a delta link:
        #: the shards they imported are in no full image yet, and a
        #: follower bootstraps from full images only
        #: (``DCReplica._serve_ckpt_meta`` publishes one first)
        self.sealed_links = 0
        self.scrub_counts = {"ok": 0, "corrupt": 0}
        self._last_scrub = 0.0
        self.root = checkpoint_root(self.log.dir)
        #: name -> callable returning a msgpack-able blob captured under
        #: the commit lock (embedder state)
        self.extras_providers: Dict[str, Callable[[], Any]] = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        #: True while a generation rotation of a FAILED attempt is still
        #: unpublished: the retry reuses it instead of rotating again
        self._rotated_unpublished = False
        #: a checkpoint published by this writer since the log opened:
        #: every record above the floors was appended by this process
        self._published_here = False
        self.reclaimed_total = 0
        #: manifest of the last published checkpoint (seeded from disk)
        self.last: Optional[dict] = None
        self._next_id = 1
        cks = list_checkpoints(self.root)
        if cks:
            self._next_id = cks[-1][0] + 1
            self.last = load_manifest(cks[-1][1])
            for _id, path in cks:  # resume the chain position
                m = load_manifest(path)
                if m is not None:
                    self.chain_len = (0 if manifest_kind(m) == "full"
                                      else self.chain_len + 1)
        if store.cold is not None:
            # budget pressure nudges a stamp; a fault-in's CRC failure
            # forces a rebase (it re-reads every row and tombstones the
            # truly lost ones)
            store.cold.on_pressure = self.request
            store.cold.on_corrupt = self._on_cold_corrupt

    def _on_cold_corrupt(self) -> None:
        self.force_rebase = True
        self._wake.set()

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "Checkpointer":
        if self._thread is None and self.interval_s > 0:
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="antidote-checkpoint")
            self._thread.start()
        return self

    def request(self) -> None:
        """Nudge the loop to checkpoint as soon as possible."""
        self._wake.set()

    def stop(self) -> None:
        self._stop = True
        self._wake.set()
        th = self._thread
        if th is not None:
            th.join(timeout=30)

    def _loop(self) -> None:
        # two cadences share the loop: a stamp is taken only when ITS
        # deadline (or a request) is due, the scrub keeps its own rhythm
        last_ckpt = time.monotonic()
        self._last_scrub = time.monotonic()
        while not self._stop:
            wait = self.interval_s
            if self.scrub_every_s > 0:
                wait = min(wait, self.scrub_every_s)
            woke = self._wake.wait(timeout=wait)
            self._wake.clear()
            if self._stop:
                return
            now = time.monotonic()
            if woke or now - last_ckpt >= self.interval_s:
                last_ckpt = now
                try:
                    self.checkpoint_now()
                except CheckpointError as e:
                    log.warning("periodic checkpoint failed (will retry "
                                "on the next interval): %s", e)
                except Exception:
                    log.exception("periodic checkpoint failed "
                                  "unexpectedly")
            if (self.scrub_every_s > 0 and not self._stop
                    and time.monotonic() - self._last_scrub
                    >= self.scrub_every_s):
                self._last_scrub = time.monotonic()
                try:
                    self.scrub()
                except Exception:
                    log.exception("checkpoint scrub pass failed")

    # -- observability --------------------------------------------------
    def status(self) -> dict:
        last = self.last
        out = {
            "interval_s": self.interval_s,
            "retain": self.retain,
            "rebase_every": self.rebase_every,
            "chain_len": self.chain_len,
            "scrub": dict(self.scrub_counts),
            "reclaimed_bytes_total": self.reclaimed_total,
            "tail_records": int((self.log.seqs - self.log.floor_seqs).sum()),
        }
        if last is not None:
            out.update({
                "last_id": last.get("id"),
                "stamp_vc_max": last.get("stamp_vc_max"),
                "image_bytes": last.get("image_bytes"),
                "age_s": round(time.time() - last.get("created_at", 0), 1),
            })
            if self.metrics is not None:
                self.metrics.checkpoint_age.set(out["age_s"])
        return out

    # -- the cycle ------------------------------------------------------
    def _decide_full(self, full: Optional[bool]) -> bool:
        """Full rebase or delta link?  Forced rebases win; a delta needs a
        published parent, unbroken dirty windows, a chain shorter than
        ``rebase_every`` and no staged cold source waiting to be persisted
        locally."""
        if full is not None:
            return bool(full)
        if self.rebase_every <= 1 or self.chain_len + 1 >= self.rebase_every:
            return True
        return self._windows_broken()

    def _windows_broken(self) -> bool:
        """No delta link can cover the store: no published parent, a
        forced rebase, an overflowed or invalidated window, or a staged
        cold source waiting to be persisted locally."""
        if self.force_rebase or self.last is None:
            return True
        if (self.store.ckpt_dirty_keys is None
                or self.store._ckpt_dirty_blobs is None
                or self.txm.ckpt_dirty_committed is None):
            return True
        if any(t._ckpt_dirty is None for t in self.store.tables.values()):
            return True
        cold = self.store.cold
        return cold is not None and bool(cold._extra_sources)

    def _consume_windows_locked(self):
        """Consume every incremental window under the commit-lock barrier
        (both capture kinds reset them: the next window starts at this
        stamp).  Returns (dirty keys | None, evicted keys, blob hashes,
        committed delta)."""
        store, txm = self.store, self.txm
        dirty, store.ckpt_dirty_keys = store.ckpt_dirty_keys, set()
        evicted, store._ckpt_evicted = store._ckpt_evicted, {}
        blob_hashes, store._ckpt_dirty_blobs = store._ckpt_dirty_blobs, set()
        committed_dirty = txm.ckpt_dirty_committed
        txm.ckpt_dirty_committed = set()
        if blob_hashes is None or committed_dirty is None:
            dirty = None  # any overflowed window means a rebase
            blob_hashes = set()
            committed_dirty = set()
        committed = {}
        for dk in committed_dirty:
            v = txm.committed_keys.get(dk)
            if v is not None:
                committed[dk] = int(v)
        for t in store.tables.values():
            t.take_ckpt_dirty()
        return dirty, evicted, blob_hashes, committed

    def seal(self) -> dict:
        """A checkpoint covering what the store holds now, without
        rotating the WAL onto a new generation (the floors alone separate
        image from tail; a rotation opens a file a shard).  The chain
        cadence decides its kind as for any other stamp: a delta link of
        the dirty windows, or a full image when the windows cannot make
        one or the chain reached ``rebase_every`` — so a run of seals
        keeps the chain bounded.  What a shard import from a compacted
        source waits for."""
        man = self.checkpoint_now(rotate=False)
        if man["kind"] == "delta":
            self.sealed_links += 1
        return man

    def checkpoint_now(self, full: Optional[bool] = None,
                       rotate: bool = True) -> dict:
        with self._lock:
            t0 = time.monotonic()
            with self.txm.checkpoint_barrier:
                t_held = time.monotonic()
                want_full = self._decide_full(full)
                if want_full:
                    cap, frozen = self._capture_locked()
                else:
                    cap, frozen = self._capture_delta_locked()
                    if cap is None:
                        want_full = True
                        cap, frozen = self._capture_locked()
                if rotate:
                    self._rotate_locked()
                # without a rotation, after a checkpoint this writer
                # published, the records above the previous floors were
                # appended to the active segment files since then: the
                # chain scan reads those and lists no directory
                cap["active_only"] = (not rotate
                                      and not self._rotated_unpublished
                                      and self._published_here)
            barrier_s = time.monotonic() - t0
            held_s = time.monotonic() - t_held
            try:
                self._scan_chains(cap)
                if want_full:
                    path, manifest = self._write_atomic(cap, frozen)
                else:
                    path, manifest = self._write_atomic_delta(cap, frozen)
            except BaseException as e:
                # a failed checkpoint leaves the store EXACTLY as it was:
                # no floor movement, no truncation, no read-only flip.
                # Rotated-out segment handles close now (their files stay;
                # the retry reuses the rotated generation)
                self.log.drain_retired()
                self.force_rebase = True  # the consumed windows are gone
                if self.metrics is not None:
                    self.metrics.checkpoint_total.inc(status="error")
                if isinstance(e, CheckpointError):
                    raise
                raise CheckpointError(
                    f"checkpoint aborted, nothing published: {e}") from e
            with self.txm.checkpoint_barrier:
                self.log.set_floor(cap["floor_seqs"], cap["chain_floor"])
            self._rotated_unpublished = False
            if want_full:
                self.chain_len = 0
                self.sealed_links = 0
                self.force_rebase = False
                cold = self.store.cold
                if cold is not None:
                    # re-anchor every cold and evict ref onto the fresh
                    # image
                    cold.rebind(cap["id"], cap.get("resident_map") or {},
                                cap.get("cold_rebinds") or {},
                                cap.get("cold_lost") or set())
                    for token in list(cold._extra_sources):
                        cold.drop_source(token)  # staged import persisted
                reclaimed = self._retire_and_reclaim(cap)
            else:
                self.chain_len += 1
                reclaimed = 0
            self.reclaimed_total += reclaimed
            manifest["reclaimed_bytes"] = reclaimed
            self.last = manifest
            self._published_here = True
            if self.metrics is not None:
                kind = manifest["kind"]
                self.metrics.checkpoint_total.inc(status="ok")
                self.metrics.checkpoint_stamp.inc(kind=kind)
                self.metrics.checkpoint_stamp_rows.inc(manifest["n_rows"],
                                                       kind=kind)
                self.metrics.wal_reclaimed.inc(reclaimed)
                self.metrics.checkpoint_age.set(0.0)
            total_s = time.monotonic() - t0
            log.info("checkpoint %d (%s) published: %d keys, %d table rows, "
                     "%.1f MiB image, %.1f MiB WAL reclaimed (stamp barrier "
                     "%.0f ms, total %.2f s)", manifest["id"],
                     manifest["kind"], manifest["n_keys"],
                     manifest["n_rows"], manifest["image_bytes"] / 2**20,
                     reclaimed / 2**20, barrier_s * 1e3, total_s)
            return dict(manifest, barrier_ms=round(barrier_s * 1e3, 3),
                        held_ms=round(held_s * 1e3, 3),
                        total_s=round(total_s, 3))

    def _base_cap(self) -> Dict[str, Any]:
        store, txm, logm = self.store, self.txm, self.log
        cap: Dict[str, Any] = {
            "id": self._next_id,
            "n_shards": store.cfg.n_shards,
            "max_dcs": store.cfg.max_dcs,
            "stamp_vc": store.applied_vc.copy(),
            "commit_counter": int(txm.commit_counter),
            "op_ids": logm.op_ids.copy(),
            "prev_floor": logm.floor_seqs.copy(),
            "prev_chain_floor": logm.chain_floor.copy(),
            "blob_seen": [sorted(s) for s in logm._blob_seen],
            "shard_resets": dict(logm.shard_resets),
            "extras": {},
        }
        for name, provider in self.extras_providers.items():
            try:
                cap["extras"][name] = provider()
            except Exception:
                log.exception("checkpoint extras provider %r failed "
                              "(omitted from the image)", name)
        return cap

    def _rotate_locked(self) -> None:
        """Rotate the WAL onto a fresh segment generation (under the
        stamp barrier, after the capture) — unless a FAILED attempt
        already did and never published — so the floor cleanly separates
        image from tail.  Replays skip records at or below the floor
        either way, so a checkpoint without a rotation (``seal``) is just
        as recoverable."""
        if not self._rotated_unpublished:
            self.log.rotate_generation()
            self._rotated_unpublished = True

    def _stamp_floor_locked(self, cap: dict) -> None:
        """The capture's WAL floors (the append sequences at the cut)
        and its id."""
        cap["floor_seqs"] = self.log.seqs.copy()
        self._next_id += 1

    def _capture_locked(self):
        """The consistent cut, under the commit lock: host bookkeeping is
        copied and each table's heads are copied ON THE DEVICE
        (``TypedTable.copy_head``: issued on the table's stream, no host
        sync); the host copies run outside the lock."""
        store, txm = self.store, self.txm
        cap = self._base_cap()
        cap["committed_keys"] = dict(txm.committed_keys)
        cap["directory"] = dict(store.directory)
        cap["blobs"] = dict(store.blobs._by_handle)
        self._consume_windows_locked()  # a full image covers them
        if store.cold is not None:
            # the still-cold keys this image carries forward into its
            # sidecar appendix (their rows are read off the lock: a cold
            # row's sidecar bytes never change)
            cap["cold_manifest"] = store.cold.cold_manifest()
        frozen: Dict[str, dict] = {}
        for tname, t in store.tables.items():
            used = t.used_rows.copy()
            u_cap = int(used.max())
            if u_cap == 0:
                continue
            frozen[tname] = {
                "slot": t.copy_head(u_cap),
                "used": used,
                "slots_ub": t.slots_ub[:, :u_cap].copy(),
                "max_abs_delta": int(t.max_abs_delta),
                "max_commit_vc": t.max_commit_vc.copy(),
            }
        self._stamp_floor_locked(cap)
        return cap, frozen

    def _capture_delta_locked(self):
        """Delta-link capture: only the keys and rows dirtied since the
        parent link (device gathers issued under the lock, copied to the
        host outside it).  Returns (None, None) when the windows are
        unusable — the caller falls back to a full rebase."""
        store = self.store
        dirty, evicted, blob_hashes, committed = (
            self._consume_windows_locked())
        if dirty is None:
            return None, None
        anchor = store.cold.anchor if store.cold is not None else None
        cold_delta = []
        for dk, (tname, shard, srow, src) in evicted.items():
            if src != anchor or isinstance(src, str):
                return None, None  # an unanchored eviction: rebase
            cold_delta.append([dk[0], dk[1], tname, int(shard), int(srow)])
        cap = self._base_cap()
        cap["parent"] = int(self.last["id"])
        cap["cold_delta"] = cold_delta
        cap["cold_src"] = anchor
        cap["committed_delta"] = [[k, b, v]
                                  for (k, b), v in committed.items()]
        cap["blobs_delta"] = [[int(h), bytes(store.blobs._by_handle[h])]
                              for h in blob_hashes
                              if h in store.blobs._by_handle]
        by_table: Dict[str, list] = {}
        directory_delta = []
        for dk in dirty:
            ent = store.directory.get(dk)
            if ent is None:
                continue  # evicted after the write (rides cold_delta)
            by_table.setdefault(ent[0], []).append((ent[1], ent[2]))
            directory_delta.append([dk[0], dk[1], ent[0], int(ent[1]),
                                    int(ent[2])])
        cap["directory_delta"] = directory_delta
        frozen: Dict[str, dict] = {}
        for tname, items in by_table.items():
            t = store.tables[tname]
            ss = np.asarray([x[0] for x in items], np.int64)
            rr = np.asarray([x[1] for x in items], np.int64)
            frozen[tname] = {
                "rows": [[int(s), int(r)] for s, r in items],
                "slot": t.gather_rows(ss, rr),
                "slots_ub": t.slots_ub[ss, rr].copy(),
                "used_rows": t.used_rows.copy(),
                "max_abs_delta": int(t.max_abs_delta),
                "max_commit_vc": t.max_commit_vc.copy(),
            }
        self._stamp_floor_locked(cap)
        return cap, frozen

    def _scan_chains(self, cap: dict) -> None:
        """Replication txn-group counts at the new floor = counts at the
        previous floor + groups in the (prev, new] sequence window, by
        (origin, commit VC) identity."""
        from antidote_tpu_torch.log import segment_index

        logm = self.log
        chains = cap["prev_chain_floor"].copy()
        active = cap.get("active_only")
        segments = None if active else segment_index(logm.dir)
        for shard in range(cap["n_shards"]):
            lo = int(cap["prev_floor"][shard])
            hi = int(cap["floor_seqs"][shard])
            if hi <= lo:
                continue
            seen: set = set()
            paths = ([w.path for w in logm.wals[shard].segs] if active
                     else logm.segment_paths(shard, segments))
            for rec in replay_segments(paths):
                q = rec.get("q")
                if q is None:
                    if lo > 0:
                        continue  # legacy prefix already below prev floor
                elif q <= lo or q > hi:
                    continue
                ident = (int(rec["o"]), tuple(int(x) for x in rec["vc"]))
                if ident in seen:
                    continue
                seen.add(ident)
                chains[shard, int(rec["o"])] += 1
        cap["chain_floor"] = chains

    def _header(self, cap: dict, kind: Optional[str] = None) -> dict:
        out = {"version": 2}
        if kind is not None:
            out["kind"] = kind
        out.update({
            "id": cap["id"],
            "n_shards": cap["n_shards"],
            "max_dcs": cap["max_dcs"],
            "stamp_vc": cap["stamp_vc"],
            "commit_counter": cap["commit_counter"],
            "floor_seqs": cap["floor_seqs"],
            "chain_floor": cap["chain_floor"],
            "op_ids": cap["op_ids"],
            "shard_resets": {str(k): v
                             for k, v in cap["shard_resets"].items()},
        })
        return out

    def _manifest(self, cap: dict, data: bytes, kind: str, n_keys: int,
                  n_rows: int, tables) -> dict:
        return {
            "id": cap["id"],
            "kind": kind,
            "created_at": time.time(),
            "image_bytes": len(data),
            "image_crc32": zlib.crc32(data) & 0xFFFFFFFF,
            "n_keys": n_keys,
            "n_rows": n_rows,
            "tables": sorted(tables),
            "commit_counter": cap["commit_counter"],
            "stamp_vc_max": [int(x) for x in cap["stamp_vc"].max(axis=0)],
            "floor_seqs": [int(x) for x in cap["floor_seqs"]],
        }

    def _carry_cold(self, cap: dict, tables: Dict[str, dict]):
        """Build the sidecar's cold appendix: every still-cold key's row is
        read (in bulk, a column at a time) from its source sidecar,
        CRC-verified, and re-addressed after the new image's resident
        extent.  Unreadable rows are ``lost``: logged loudly, and
        tombstoned so their reads fail typed instead of serving bottom.
        Extends ``tables`` in place; returns (cold_directory entries,
        rebind map, lost set)."""
        cold_man = cap.get("cold_manifest") or {}
        cold_dir: list = []
        rebinds: Dict[Any, tuple] = {}
        lost: set = set()
        if not cold_man:
            return cold_dir, rebinds, lost
        cold = self.store.cold
        cfg = self.store.cfg
        for tname, by_shard in cold_man.items():
            # one bulk column load per (source, table)
            srcs = {src for items in by_shard.values()
                    for _dk, _sr, src in items}
            cols: Dict[Any, dict] = {}
            for src in srcs:
                sc = cold._sidecar(src)
                tman = sc.man["tables"][tname]
                cols[src] = {
                    "fields": {f: sc.read_column(tname, f)
                               for f in sorted(tman["fields"])},
                    "head_vc": sc.read_column(tname, "head_vc"),
                    "slots_ub": sc.read_column(tname, "slots_ub"),
                    "row_crc": sc.read_column(tname, "row_crc"),
                }
            tb = tables.get(tname)
            if tb is None:
                # every key of this table is cold: an empty resident block
                # with the source's shapes
                any_src = next(iter(cols.values()))
                p = cfg.n_shards
                tb = tables[tname] = {
                    "used_rows": np.zeros(p, np.int64),
                    "head": {f: np.zeros((p, 0) + x.shape[2:], x.dtype)
                             for f, x in any_src["fields"].items()},
                    "head_vc": np.zeros((p, 0, cfg.max_dcs), np.int32),
                    "slots_ub": np.zeros((p, 0), np.int32),
                    "max_abs_delta": 0,
                    "max_commit_vc": np.zeros(cfg.max_dcs, np.int32),
                }
            u_cap = tb["head_vc"].shape[1]
            c_max = max(len(items) for items in by_shard.values())
            p = tb["head_vc"].shape[0]
            ext = {
                "head": {f: np.zeros((p, u_cap + c_max) + x.shape[2:],
                                     x.dtype)
                         for f, x in tb["head"].items()},
                "head_vc": np.zeros((p, u_cap + c_max,
                                     tb["head_vc"].shape[2]), np.int32),
                "slots_ub": np.zeros((p, u_cap + c_max), np.int32),
            }
            for f, x in tb["head"].items():
                ext["head"][f][:, :u_cap] = x
            ext["head_vc"][:, :u_cap] = tb["head_vc"]
            ext["slots_ub"][:, :u_cap] = tb["slots_ub"]
            fields = sorted(ext["head"])
            for shard, items in by_shard.items():
                for src in {src for _dk, _sr, src in items}:
                    pos = [i for i, x in enumerate(items) if x[2] == src]
                    c = cols[src]
                    srows = np.asarray([items[i][1] for i in pos], np.int64)
                    got = {f: c["fields"][f][shard, srows] for f in fields}
                    hvc = np.ascontiguousarray(c["head_vc"][shard, srows],
                                               np.int32)
                    sub = np.ascontiguousarray(c["slots_ub"][shard, srows],
                                               np.int32)
                    # each row's bytes in the sidecar's CRC order: sorted
                    # fields, then head_vc, then slots_ub
                    rowmat = np.concatenate(
                        [np.ascontiguousarray(got[f]).reshape(len(pos), -1)
                         .view(np.uint8) for f in fields]
                        + [hvc.reshape(len(pos), -1).view(np.uint8),
                           sub.reshape(len(pos), -1).view(np.uint8)], axis=1)
                    want = c["row_crc"][shard, srows]
                    good = np.asarray(
                        [(zlib.crc32(rowmat[j].tobytes()) & 0xFFFFFFFF)
                         == int(want[j]) for j in range(len(pos))], bool)
                    new_rows = u_cap + np.asarray(pos, np.int64)
                    for f in fields:
                        ext["head"][f][shard, new_rows[good]] = got[f][good]
                    ext["head_vc"][shard, new_rows[good]] = hvc[good]
                    ext["slots_ub"][shard, new_rows[good]] = sub[good]
                    for j, i in enumerate(pos):
                        dk, srow, _src = items[i]
                        if not good[j]:
                            lost.add(dk)
                            log.error(
                                "cold carry-forward: row CRC mismatch for "
                                "%r (%s[%d,%d] of source %r): the key's "
                                "state is LOST to bit rot", dk, tname, shard,
                                srow, src)
                for i, (dk, _srow, _src) in enumerate(items):
                    if dk in lost:
                        continue
                    cold_dir.append([dk[0], dk[1], tname, int(shard),
                                     int(u_cap + i)])
                    rebinds[dk] = (tname, int(shard), int(u_cap + i))
            tb["head"] = ext["head"]
            tb["head_vc"] = ext["head_vc"]
            tb["slots_ub"] = ext["slots_ub"]
        return cold_dir, rebinds, lost

    def _write_atomic(self, cap: dict, frozen: dict) -> Tuple[str, dict]:
        tables: Dict[str, dict] = {}
        for tname, fz in frozen.items():
            head_cp, head_vc_cp = fz["slot"]
            tables[tname] = {
                "used_rows": fz["used"],
                "head": {f: _host(x) for f, x in head_cp.items()},
                "head_vc": _host(head_vc_cp),
                "slots_ub": fz["slots_ub"],
                "max_abs_delta": fz["max_abs_delta"],
                "max_commit_vc": fz["max_commit_vc"],
            }
        frozen.clear()  # release the device copies
        # the sidecar extends each table past its resident extent with the
        # carried-forward cold rows; the IMAGE keeps the resident slices
        # (recovery installs exactly those on the device)
        resident_caps = {tname: tb["head_vc"].shape[1]
                         for tname, tb in tables.items()}
        cold_dir, rebinds, lost = self._carry_cold(cap, tables)
        sidecar_tables = {
            tname: {"head": tb["head"], "head_vc": tb["head_vc"],
                    "slots_ub": tb["slots_ub"]}
            for tname, tb in tables.items()
        } if (self.store.cold is not None or cold_dir) else None
        if cold_dir:
            tables = {
                tname: dict(
                    tb,
                    head={f: x[:, :resident_caps.get(tname, 0)]
                          for f, x in tb["head"].items()},
                    head_vc=tb["head_vc"][:, :resident_caps.get(tname, 0)],
                    slots_ub=tb["slots_ub"][:, :resident_caps.get(tname, 0)],
                )
                for tname, tb in tables.items()
            }
        cap["resident_map"] = cap["directory"]
        cap["cold_rebinds"] = rebinds
        cap["cold_lost"] = lost
        image = self._header(cap)
        image.update({
            # opaque(): the big flat per-key lists cross msgpack in one
            # C-speed pass each
            "committed_keys": opaque([[k, b, int(v)] for (k, b), v
                                      in cap["committed_keys"].items()]),
            "directory": opaque([
                [key, bucket, tname, int(shard), int(row)]
                for (key, bucket), (tname, shard, row)
                in cap["directory"].items()]),
            "blobs": opaque([[int(h), bytes(d)]
                             for h, d in cap["blobs"].items()]),
            "blob_seen": opaque(cap["blob_seen"]),
            "cold_directory": opaque(cold_dir),
            "tables": tables,
            "extras": cap["extras"],
        })
        data = pack(image)
        manifest = self._manifest(
            cap, data, "full", len(cap["directory"]) + len(cold_dir),
            int(sum(int(t["used_rows"].sum()) for t in tables.values())),
            tables)
        manifest["cold_keys"] = len(cold_dir)
        return self._publish_dir(cap["id"], data, manifest, sidecar_tables)

    def _write_atomic_delta(self, cap: dict,
                            frozen: dict) -> Tuple[str, dict]:
        tables: Dict[str, dict] = {}
        n_rows = 0
        for tname, fz in frozen.items():
            head_cp, head_vc_cp = fz["slot"]
            tables[tname] = {
                "rows": fz["rows"],
                "head": {f: _host(x) for f, x in head_cp.items()},
                "head_vc": _host(head_vc_cp),
                "slots_ub": fz["slots_ub"],
                "used_rows": fz["used_rows"],
                "max_abs_delta": fz["max_abs_delta"],
                "max_commit_vc": fz["max_commit_vc"],
            }
            n_rows += len(fz["rows"])
        frozen.clear()
        link = self._header(cap, kind="delta")
        link["parent"] = cap["parent"]
        link.update({
            "directory_delta": opaque(cap["directory_delta"]),
            "committed_delta": opaque(cap["committed_delta"]),
            "blobs_delta": opaque(cap["blobs_delta"]),
            "blob_seen": opaque(cap["blob_seen"]),
            "cold_delta": opaque(cap["cold_delta"]),
            "cold_src": cap["cold_src"],
            "tables": tables,
            "extras": cap["extras"],
        })
        data = pack(link)
        manifest = self._manifest(cap, data, "delta",
                                  len(cap["directory_delta"]), n_rows,
                                  tables)
        manifest["parent"] = int(cap["parent"])
        return self._publish_dir(cap["id"], data, manifest)

    def _publish_dir(self, cap_id: int, data: bytes, manifest: dict,
                     sidecar_tables=None) -> Tuple[str, dict]:
        """Atomic publish: stream the image, the cold sidecar (when
        ``sidecar_tables`` is given) and the manifest into a temp dir,
        fsync through the group coordinator, one rename.  A failure at ANY
        point leaves the published set untouched."""
        from antidote_tpu_torch.store.coldtier import COLD_BIN, write_sidecar

        os.makedirs(self.root, exist_ok=True)
        tmp = os.path.join(self.root, f"tmp.{os.getpid()}.{cap_id}")
        final = os.path.join(self.root, f"ckpt_{cap_id}")
        name = f"ckpt_{cap_id}"
        try:
            shutil.rmtree(tmp, ignore_errors=True)  # reclaim-ok: stale
            # temp dir from a crashed writer, never a published image
            os.makedirs(tmp)
            with open(os.path.join(tmp, _IMAGE), "wb") as f:
                _faulted_write(f, data, name)
                f.flush()
                self.log._fsync.submit([_ImageFsync(f.fileno(), name)]).wait()
            if sidecar_tables is not None:
                d = faults.hit("ckpt.write", key=name)
                if d is not None:
                    if d.action == "delay" and d.arg:
                        time.sleep(float(d.arg))
                    elif d.action in ("error", "io_error", "enospc"):
                        raise OSError(
                            errno.ENOSPC if d.action == "enospc"
                            else errno.EIO,
                            f"injected fault: ckpt.write cold {name}")
                with open(os.path.join(tmp, COLD_BIN), "wb") as f:
                    cman = write_sidecar(f, sidecar_tables)
                    f.flush()
                    self.log._fsync.submit(
                        [_ImageFsync(f.fileno(), name)]).wait()
                cman["n_shards"] = self.store.cfg.n_shards
                manifest["cold"] = cman
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())  # the manifest must be durable before
                # the rename publishes the image
            _fsync_dir(tmp)
            d = faults.hit("ckpt.rename", key=name)
            if d is not None:
                if d.action == "delay" and d.arg:
                    time.sleep(float(d.arg))
                elif d.action in ("error", "io_error", "enospc"):
                    raise OSError(errno.EIO, "injected fault: ckpt.rename")
            os.rename(tmp, final)
            _fsync_dir(self.root)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)  # reclaim-ok: failed
            # attempt's temp dir; the published set is untouched
            raise
        return final, manifest

    def _retire_and_reclaim(self, cap: dict) -> int:
        """After a FULL publish: drop full images beyond the retention
        window and every delta link below the newest full, then reclaim
        WAL files wholly below the OLDEST RETAINED full image's floor (never
        a delta's, so a corrupt mid-chain link always falls back to full
        image + a longer tail).  Best-effort: a failure here never
        unpublishes the image."""
        reclaim_floors = np.asarray(cap["floor_seqs"], np.int64)
        try:
            published = [(i, p, m) for i, p in list_checkpoints(self.root)
                         if (m := load_manifest(p)) is not None]
            fulls = [x for x in published if manifest_kind(x[2]) == "full"]
            retained = fulls[-self.retain:]
            retained_ids = {i for i, _p, _m in retained}
            newest_full = retained[-1][0] if retained else -1
            for id_, path, m in published:
                if (id_ not in retained_ids if manifest_kind(m) == "full"
                        else id_ < newest_full):
                    shutil.rmtree(path, ignore_errors=True)  # reclaim-ok:
                    # beyond retention, or a link the rebase covers
            for name in os.listdir(self.root):
                if name.startswith("tmp."):
                    shutil.rmtree(os.path.join(self.root, name),
                                  ignore_errors=True)  # reclaim-ok:
                    # orphaned temp dir of a crashed or failed writer
            floors = [m["floor_seqs"] for _i, _p, m in retained
                      if m.get("floor_seqs") is not None]
            if floors:
                reclaim_floors = np.minimum.reduce(
                    [np.asarray(f, np.int64) for f in floors])
        except OSError:
            log.warning("checkpoint retention sweep failed", exc_info=True)
        try:
            return self.log.reclaim_below(reclaim_floors)
        except Exception:
            log.warning("WAL reclaim below the checkpoint floor failed "
                        "(will retry next checkpoint)", exc_info=True)
            return 0

    # -- background scrub -----------------------------------------------
    def _scrub_file(self, path: str, want_bytes: int, want_crc: int) -> bool:
        """Rate-limited whole-file CRC verification (off the lock)."""
        crc = 0
        n = 0
        t0 = time.monotonic()
        try:
            with open(path, "rb") as f:
                while chunk := f.read(_CHUNK):
                    crc = zlib.crc32(chunk, crc)
                    n += len(chunk)
                    budget = n / max(self.scrub_bps, 1)
                    spent = time.monotonic() - t0
                    if budget > spent:
                        time.sleep(min(budget - spent, 0.25))
        except OSError:
            return False
        return n == int(want_bytes) and (crc & 0xFFFFFFFF) == int(want_crc)

    def scrub(self) -> Dict[str, int]:
        """One bit-rot pass over every retained image and link: re-read
        and CRC-verify ``image.bin`` (and the cold sidecar where there is
        one).  A corrupt DELTA link is retired on the spot (the chain
        re-anchors on the prefix) and a rebase forced; a corrupt FULL image
        forces a rebase but stays published (its per-row CRCs still guard
        cold fault-ins)."""
        from antidote_tpu_torch.store.coldtier import COLD_BIN

        out = {"ok": 0, "corrupt": 0}
        for id_, path in list_checkpoints(self.root):
            m = load_manifest(path)
            if m is None:
                continue
            ok = self._scrub_file(os.path.join(path, _IMAGE),
                                  m.get("image_bytes", -1),
                                  m.get("image_crc32", -1))
            cold = m.get("cold")
            if ok and cold is not None:
                ok = self._scrub_file(os.path.join(path, COLD_BIN),
                                      cold.get("bytes", -1),
                                      cold.get("crc32", -1))
            result = "ok" if ok else "corrupt"
            out[result] += 1
            self.scrub_counts[result] = self.scrub_counts.get(result, 0) + 1
            if self.metrics is not None:
                self.metrics.checkpoint_scrub.inc(result=result)
            if ok:
                continue
            if manifest_kind(m) == "delta":
                log.error("scrub: chain link ckpt_%d is corrupt on disk; "
                          "retiring it and forcing a rebase", id_)
                shutil.rmtree(path, ignore_errors=True)  # reclaim-ok:
                # scrub-condemned link; the forced rebase re-covers it
            else:
                log.error("scrub: full image ckpt_%d is corrupt on disk; "
                          "forcing a rebase", id_)
            self.force_rebase = True
            self.request()
        return out
