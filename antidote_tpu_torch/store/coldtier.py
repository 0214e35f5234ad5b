"""Cold tier: a store larger than the card, behind the slot-tier ladder.

Rows untouched since the newest FULL checkpoint image are **evicted**: the
device copy is forgotten (the row zeroed in place through the guarded
:meth:`TypedTable.evict_rows` and pushed onto the per-shard free list for
reuse) while the image keeps the state; the next read or write **faults**
the row back in through the locked path.  Because the image already holds
VC-stamped heads per table, eviction writes nothing: it forgets the device
copy and keeps the floor.

The addressing side is the checkpoint's **cold sidecar** (``cold.bin``
beside ``image.bin``): the per-table head columns as raw fixed-stride
binaries with a per-row CRC, so a fault-in is a handful of ``pread`` calls,
never a whole-image decode.  :func:`write_sidecar` / :class:`Sidecar` own
the format, which is the JAX package's byte for byte; the checkpoint
writer emits it on every full stamp, carrying still-cold rows forward as
an appendix so retention never strands cold data.

Failure contract (no silent wrong read):

  * a fault-in past the fault-rate cap, behind an injected or real I/O
    error (site ``coldtier.fault``), or over a row that fails its CRC is
    refused with a typed :class:`~antidote_tpu_torch.overload.ColdMiss`
    carrying a retry hint; it is never served bottom;
  * a row verifiably lost on every retained image (bit rot found while a
    rebase carries it forward) is tombstoned: its reads raise a
    *permanent* ColdMiss naming the repair;
  * eviction only drops rows whose live ``head_vc`` equals the sidecar's
    stored stamp: a row written since the image is not evictable until
    the next stamp covers it.

``budget`` caps the store's RESIDENT device rows (the allocation
high-water mark minus freed rows).  Past it, the coldest eligible keys
(write-LRU) are evicted in bounded batches from the commit path; when
nothing is eligible the tier asks the checkpointer for a stamp instead of
refusing a write.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import zlib
from collections import OrderedDict
from itertools import islice
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from antidote_tpu_torch import faults
from antidote_tpu_torch.overload import ColdMiss, retry_hint_ms

log = logging.getLogger(__name__)

#: sidecar file name inside a published checkpoint directory
COLD_BIN = "cold.bin"


# ---------------------------------------------------------------------------
# sidecar format: raw fixed-stride columns + per-row CRC
# ---------------------------------------------------------------------------
def _row_bytes(spec: dict) -> int:
    return int(np.dtype(spec["dtype"]).itemsize
               * int(np.prod(spec["shape"], dtype=np.int64)))


def write_sidecar(fh, tables: Dict[str, dict]) -> dict:
    """Stream the cold sidecar of one full image and return its manifest
    block.  ``tables`` maps tiered table names to ``{"head": {field:
    arr[P, R, ...]}, "head_vc": arr[P, R, D], "slots_ub": arr[P, R]}`` host
    arrays (R = resident extent + cold appendix).  Each column is written
    contiguous in C order at a recorded offset; ``row_crc`` is crc32 over
    the row's concatenated column bytes (sorted field order, then head_vc,
    then slots_ub), the fault-in's integrity check."""
    manifest: Dict[str, Any] = {"tables": {}}
    off = 0
    crc_total = 0

    def emit(arr: np.ndarray) -> dict:
        nonlocal off, crc_total
        arr = np.ascontiguousarray(arr)
        data = arr.tobytes()
        fh.write(data)
        crc_total = zlib.crc32(data, crc_total)
        spec = {"off": off, "dtype": str(arr.dtype),
                "shape": list(arr.shape[2:])}
        off += len(data)
        return spec

    for tname in sorted(tables):
        tb = tables[tname]
        p, r = tb["head_vc"].shape[:2]
        cols = []  # per-row byte matrices for the CRC pass
        tman: Dict[str, Any] = {"rows": int(r), "fields": {}}
        for f in sorted(tb["head"]):
            arr = np.ascontiguousarray(tb["head"][f])
            tman["fields"][f] = emit(arr)
            cols.append(arr.reshape(p * r, -1).view(np.uint8))
        hvc = np.ascontiguousarray(tb["head_vc"], np.int32)
        tman["head_vc"] = emit(hvc)
        cols.append(hvc.reshape(p * r, -1).view(np.uint8))
        sub = np.ascontiguousarray(tb["slots_ub"], np.int32)
        tman["slots_ub"] = emit(sub)
        cols.append(sub.reshape(p * r, -1).view(np.uint8))
        rowmat = np.concatenate(cols, axis=1)
        crc = np.empty(p * r, np.uint32)
        for i in range(p * r):
            crc[i] = zlib.crc32(rowmat[i].tobytes()) & 0xFFFFFFFF
        tman["row_crc"] = emit(crc.reshape(p, r))
        manifest["tables"][tname] = tman
    manifest["bytes"] = off
    manifest["crc32"] = crc_total & 0xFFFFFFFF
    return manifest


class Sidecar:
    """pread-style reader over one published cold sidecar."""

    def __init__(self, path: str, manifest: dict):
        self.path = path
        self.man = manifest
        self._fd: Optional[int] = None

    def _fileno(self) -> int:
        if self._fd is None:
            self._fd = os.open(self.path, os.O_RDONLY)
        return self._fd

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def _pread(self, off: int, n: int) -> bytes:
        data = os.pread(self._fileno(), n, off)
        if len(data) != n:
            raise OSError(f"short sidecar read at {off} ({len(data)}/{n})")
        return data

    def _col_row(self, tman: dict, spec: dict, shard: int,
                 row: int) -> np.ndarray:
        rb = _row_bytes(spec)
        off = spec["off"] + (shard * tman["rows"] + row) * rb
        return np.frombuffer(self._pread(off, rb),
                             np.dtype(spec["dtype"])).reshape(spec["shape"])

    def read_row(self, tname: str, shard: int, row: int) -> dict:
        """One row's (head fields, head_vc, slots_ub), CRC-verified.
        Raises ValueError on a CRC mismatch (the caller types it)."""
        tman = self.man["tables"][tname]
        if not (0 <= row < tman["rows"]):
            raise ValueError(f"sidecar row {row} out of range for {tname}")
        parts: List[bytes] = []
        head = {}
        for f in sorted(tman["fields"]):
            arr = self._col_row(tman, tman["fields"][f], shard, row)
            head[f] = arr
            parts.append(arr.tobytes())
        hvc = self._col_row(tman, tman["head_vc"], shard, row)
        parts.append(hvc.tobytes())
        sub = self._col_row(tman, tman["slots_ub"], shard, row)
        parts.append(sub.tobytes())
        want = int(self._col_row(tman, tman["row_crc"], shard, row))
        got = zlib.crc32(b"".join(parts)) & 0xFFFFFFFF
        if got != want:
            raise ValueError(
                f"sidecar row CRC mismatch for {tname}[{shard},{row}] "
                f"({got:#x} != {want:#x}): bit rot on disk")
        return {"head": head, "head_vc": hvc, "slots_ub": int(sub)}

    def read_head_vc(self, tname: str, shard: int, row: int) -> np.ndarray:
        """Just the stored head_vc stamp (the evictability probe)."""
        tman = self.man["tables"][tname]
        return self._col_row(tman, tman["head_vc"], shard, row)

    def read_column(self, tname: str, name: str) -> np.ndarray:
        """One whole column ``[P, rows, ...]`` in a single bulk read (the
        rebase's carry-forward and the evictor's stamp probe: never
        per-row syscalls at scale).  ``name`` is a head field,
        ``"head_vc"``, ``"slots_ub"`` or ``"row_crc"``."""
        tman = self.man["tables"][tname]
        spec = (tman["fields"][name] if name in tman["fields"]
                else tman[name])
        rb = _row_bytes(spec)
        p = int(self.man["n_shards"])
        data = self._pread(spec["off"], rb * tman["rows"] * p)
        return np.frombuffer(data, np.dtype(spec["dtype"])).reshape(
            [p, tman["rows"]] + list(spec["shape"]))


# ---------------------------------------------------------------------------
# the tier
# ---------------------------------------------------------------------------
class ColdRef:
    """Where a key's head state lives on disk: (tiered table, shard,
    sidecar row) inside one retained full image (``src`` = the image id,
    or a string token for a staged sidecar source)."""

    __slots__ = ("tname", "shard", "srow", "src")

    def __init__(self, tname: str, shard: int, srow: int, src):
        self.tname = tname
        self.shard = int(shard)
        self.srow = int(srow)
        self.src = src

    def __repr__(self):
        return f"ColdRef({self.tname}, {self.shard}, {self.srow}, {self.src})"


#: candidate classes of one eviction scan (see ``ColdTier.evict_now``)
_PROBED, _GONE, _UNCOVERED, _CANDIDATE = range(4)


class ColdTier:
    """Per-store cold-tier manager (see the module docstring)."""

    #: rows evicted per commit-path cycle at most (bounds the lock hold)
    EVICT_BATCH = 4096
    #: LRU entries probed per cycle at most (skips are re-queued)
    SCAN_CAP = 16384

    def __init__(self, store, budget: int = 0,
                 fault_rate_cap: float = 0.0, lock=None):
        self.store = store
        #: resident device-row budget; 0 = unbounded (fault-in only)
        self.budget = int(budget)
        #: admitted fault-ins per second past which reads are refused
        #: with a typed ColdMiss (0 = unlimited)
        self.fault_rate_cap = float(fault_rate_cap)
        self.lock = lock if lock is not None else threading.RLock()
        #: dk -> ColdRef for every key a retained full image covers (cold
        #: keys authoritative; resident keys keep theirs as evict hints)
        self.refs: Dict[Tuple[Any, str], ColdRef] = {}
        #: keys currently COLD (no device row, no directory entry)
        self.cold_set: set = set()
        #: shard -> set of cold dks (handoff sweeps)
        self.by_shard: Dict[int, set] = {}
        #: write-LRU over RESIDENT keys (move_to_end on write and birth)
        self.lru: "OrderedDict[Tuple[Any, str], None]" = OrderedDict()
        #: keys whose sidecar rows are verifiably lost (typed-permanent)
        self.lost: set = set()
        #: the newest full image id refs were rebound to (evict anchor)
        self.anchor: Optional[int] = None
        #: extra sidecar sources: token -> Sidecar (staged imports)
        self._extra_sources: Dict[str, Sidecar] = {}
        self._sidecars: Dict[Any, Sidecar] = {}
        #: (src, tname) -> the sidecar's whole head_vc column, read once
        #: per anchor for the evictor's stamp probe (published sidecars
        #: never change; dropped with the sidecar cache at every rebind)
        self._stamp_cols: Dict[Tuple[Any, str], Optional[np.ndarray]] = {}
        #: keys probed NOT evictable against the current anchor (written
        #: since its stamp): within one anchor that never changes, so each
        #: is probed once, not every cycle
        self._probed_dirty: set = set()
        #: called when the budget cannot be met (checkpointer.request)
        self.on_pressure = None
        #: called when a fault-in caught on-disk corruption (scrub nudge)
        self.on_corrupt = None
        self.evictions = 0
        self.faults = 0
        self.refused = 0
        self._fault_window_t0 = time.monotonic()
        self._fault_window_n = 0
        self._fault_streak = 0
        #: resolved once: recovery's replay detaches ``store.log`` while
        #: it applies the tail, and fault-ins must keep working then
        self._log_dir: Optional[str] = (store.log.dir
                                        if store.log is not None else None)

    # -- metrics helpers ------------------------------------------------
    def _count(self, event: str, n: int = 1) -> None:
        m = getattr(self.store, "metrics", None)
        if m is not None:
            m.coldtier_events.inc(n, event=event)

    def _gauges(self) -> None:
        m = getattr(self.store, "metrics", None)
        if m is not None:
            m.coldtier_resident_rows.set(self.resident_rows())
            m.coldtier_cold_keys.set(len(self.cold_set))

    # -- sources --------------------------------------------------------
    def _sidecar(self, src) -> Sidecar:
        sc = self._sidecars.get(src)
        if sc is not None:
            return sc
        if isinstance(src, str):
            sc = self._extra_sources.get(src)
            if sc is None:
                raise ColdMiss(
                    f"cold source {src!r} is gone (staged import already "
                    "consumed); retry after the local rebase",
                    retry_after_ms=250)
        else:
            from antidote_tpu_torch.log import checkpoint as _ckpt

            if self._log_dir is None:
                assert self.store.log is not None, \
                    "cold tier needs a durable log dir"
                self._log_dir = self.store.log.dir
            root = _ckpt.checkpoint_root(self._log_dir)
            path = os.path.join(root, f"ckpt_{int(src)}")
            man = _ckpt.load_manifest(path)
            if man is None or "cold" not in man:
                raise ColdMiss(
                    f"checkpoint image ckpt_{src} (the cold anchor) is "
                    "no longer published; retry after the next rebase",
                    retry_after_ms=250)
            cman = dict(man["cold"])
            cman.setdefault("n_shards", self.store.cfg.n_shards)
            sc = Sidecar(os.path.join(path, COLD_BIN), cman)
        self._sidecars[src] = sc
        return sc

    def add_source(self, token: str, path: str, manifest: dict) -> None:
        """Register a staged sidecar source (a fetched owner sidecar,
        consumed by the next local rebase)."""
        cman = dict(manifest)
        cman.setdefault("n_shards", self.store.cfg.n_shards)
        self._extra_sources[token] = Sidecar(path, cman)

    def drop_source(self, token: str) -> None:
        sc = self._extra_sources.pop(token, None)
        if sc is not None:
            sc.close()
        self._sidecars.pop(token, None)

    def _drop_sidecar_cache(self) -> None:
        for sc in self._sidecars.values():
            sc.close()
        self._sidecars = {}
        self._stamp_cols = {}

    # -- bookkeeping hooks ---------------------------------------------
    def note_birth(self, dk) -> None:
        self.lru[dk] = None
        self.lru.move_to_end(dk)

    def note_writes(self, dks) -> None:
        lru = self.lru
        for dk in dks:
            lru[dk] = None
            lru.move_to_end(dk)

    def drop_shard(self, shard: int) -> None:
        """Forget a relinquished shard's cold refs (the rows now live at
        the handoff's receiver)."""
        with self.lock:
            for dk in self.by_shard.pop(int(shard), set()):
                self.cold_set.discard(dk)
                self.refs.pop(dk, None)
            for dk in [d for d, r in self.refs.items()
                       if r.shard == int(shard)]:
                self.refs.pop(dk, None)
                self.lru.pop(dk, None)

    def resident_rows(self) -> int:
        return sum(t.resident_rows() for t in self.store.tables.values())

    def is_cold(self, dk) -> bool:
        # lost keys stay "cold" forever: their fault-in raises the
        # typed-permanent ColdMiss — a directory miss must never decay
        # into a silent bottom read for a key that once held data
        return dk in self.cold_set or dk in self.lost

    def shard_cold_keys(self, shard: int):
        return self.by_shard.get(int(shard), frozenset())

    # -- rebind after a full publish ------------------------------------
    def rebind(self, ckpt_id: int, resident_map: Dict, cold_rebinds: Dict,
               lost: Optional[set] = None) -> None:
        """Re-anchor every ref onto the freshly published full image:
        ``resident_map`` maps resident-at-stamp dks to their image
        coordinates, ``cold_rebinds`` maps still-cold dks to their appendix
        coordinates.  Keys the new image could not carry (unreadable source
        rows) arrive in ``lost`` and are tombstoned: their reads go
        typed-permanent, never bottom."""
        with self.lock:
            for dk, (tname, shard, srow) in resident_map.items():
                self.refs[dk] = ColdRef(tname, shard, srow, ckpt_id)
            for dk, (tname, shard, srow) in cold_rebinds.items():
                self.refs[dk] = ColdRef(tname, shard, srow, ckpt_id)
            if lost:
                for dk in lost:
                    self.refs.pop(dk, None)
                    self.cold_set.discard(dk)
                    self.lost.add(dk)
                    for s in self.by_shard.values():
                        s.discard(dk)
                self._count("lost", len(lost))
                log.error(
                    "cold tier: %d key(s) LOST to sidecar bit rot during "
                    "the rebase; their reads now fail typed-permanent "
                    "(repair: re-bootstrap this store from a peer)",
                    len(lost))
            self.anchor = int(ckpt_id)
            self._probed_dirty.clear()  # fresh anchor: re-probe
            self._drop_sidecar_cache()
            self._gauges()

    def seed_hints(self, src) -> None:
        """After a full-image install (recovery): every resident key's
        directory entry IS its sidecar coordinate — register them as evict
        hints so the post-recovery budget pass and later commit-path
        eviction have candidates.  Rows later overlaid by chain links or
        the WAL tail fail the head_vc equality probe and stay resident."""
        with self.lock:
            for dk, ent in self.store.directory.items():
                self.refs[dk] = ColdRef(ent[0], ent[1], ent[2], src)
                self.lru[dk] = None
            if not isinstance(src, str):
                self.anchor = int(src)

    def seed(self, entries, src) -> None:
        """Register cold keys from a recovered or installed image's
        ``cold_directory`` (``entries``: [key, bucket, tname, shard, srow]
        rows; ``src``: the image id or a staged-source token)."""
        from antidote_tpu_torch.store.kv import freeze_key

        refs, by_shard = self.refs, self.by_shard
        with self.lock:
            for key, bucket, tname, shard, srow in entries:
                dk = (freeze_key(key), bucket)
                shard = int(shard)
                refs[dk] = ColdRef(tname, shard, srow, src)
                self.cold_set.add(dk)
                s = by_shard.get(shard)
                if s is None:
                    s = by_shard[shard] = set()
                s.add(dk)
            if not isinstance(src, str):
                self.anchor = int(src)
            self._gauges()

    def cold_manifest(self) -> Dict[str, Dict[int, list]]:
        """The rebase's carry-forward worklist, captured under the lock:
        {tiered name: {shard: [(dk, srow, src), ...]}} for every cold
        key."""
        out: Dict[str, Dict[int, list]] = {}
        for dk in self.cold_set:
            ref = self.refs[dk]
            out.setdefault(ref.tname, {}).setdefault(ref.shard, []).append(
                (dk, ref.srow, ref.src))
        return out

    # -- fault-in -------------------------------------------------------
    def _admit_fault(self) -> None:
        if self.fault_rate_cap <= 0:
            self._fault_streak = 0
            return
        now = time.monotonic()
        if now - self._fault_window_t0 >= 1.0:
            self._fault_window_t0 = now
            self._fault_window_n = 0
        if self._fault_window_n >= self.fault_rate_cap:
            self._fault_streak += 1
            self.refused += 1
            self._count("refused")
            raise ColdMiss(
                f"cold-tier fault rate cap ({self.fault_rate_cap}/s) "
                "exceeded; the key stays cold this round",
                retry_after_ms=retry_hint_ms(self._fault_streak))
        self._fault_window_n += 1
        self._fault_streak = 0

    def fault_in(self, dk, admit: bool = True):
        """Fault one cold key's device row back in; returns the fresh
        directory entry.  Takes the store's commit lock (the tier's
        re-entrant ``lock``).  On a CUDA store the row goes to the card or
        the call raises; nothing carries on elsewhere."""
        with self.lock:
            ent = self.store.directory.get(dk)
            if ent is not None:
                return ent  # raced: someone else faulted it in
            if dk in self.lost:
                raise ColdMiss(
                    f"cold key {dk!r}: its sidecar row was lost to bit "
                    "rot on every retained image — restore this store "
                    "from a peer", retry_after_ms=60000, permanent=True)
            ref = self.refs.get(dk)
            if ref is None or dk not in self.cold_set:
                raise KeyError(f"{dk!r} is not a cold key")
            if admit:
                self._admit_fault()
            d = faults.hit("coldtier.fault", key=ref.tname)
            if d is not None:
                if d.action == "delay" and d.arg:
                    time.sleep(float(d.arg))
                elif d.action in ("error", "io_error", "enospc"):
                    self.refused += 1
                    self._count("refused")
                    raise ColdMiss(
                        f"injected fault: coldtier.fault {dk!r}",
                        retry_after_ms=50)
            try:
                rowdata = self._sidecar(ref.src).read_row(
                    ref.tname, ref.shard, ref.srow)
            except ValueError as e:
                # on-disk corruption caught by the per-row CRC: a typed
                # refusal, and a nudge for a rebase (which re-reads every
                # row and tombstones the truly lost ones)
                self._count("crc_fail")
                cb = self.on_corrupt
                if cb is not None:
                    cb()
                raise ColdMiss(
                    f"cold fault-in for {dk!r} failed verification "
                    f"({e}); a rebase was requested — retry after it",
                    retry_after_ms=500) from e
            except OSError as e:
                self.refused += 1
                self._count("refused")
                raise ColdMiss(
                    f"cold fault-in for {dk!r} hit an I/O error ({e})",
                    retry_after_ms=100) from e
            t = self.store.table(ref.tname)
            row = t.alloc_row(ref.shard)
            t.install_rows(
                np.asarray([ref.shard]), np.asarray([row]),
                {f: x[None].copy() for f, x in rowdata["head"].items()},
                rowdata["head_vc"][None].copy())
            t.slots_ub[ref.shard, row] = rowdata["slots_ub"]
            # the (possibly reused) row must not serve from any frozen
            # epoch slot: the discipline of a tier promotion, marked
            # before the directory binds the key (a lock-free reader that
            # sees the entry also sees the mark)
            self.store.mark_epoch_fallback(dk)
            ent = (ref.tname, ref.shard, row)
            self.store.directory[dk] = ent
            self.cold_set.discard(dk)
            s = self.by_shard.get(ref.shard)
            if s is not None:
                s.discard(dk)
            self.note_birth(dk)
            self.store._ckpt_evicted.pop(dk, None)  # resident again
            self.faults += 1
            self._count("fault")
            self._gauges()
            return ent

    def fault_in_shard(self, shard: int) -> int:
        """Fault in every cold key of one shard (whole-shard paths: the
        handoff's export, a reshard).  Bypasses the rate cap: these are
        operator-paced."""
        n = 0
        for dk in list(self.shard_cold_keys(shard)):
            self.fault_in(dk, admit=False)
            n += 1
        return n

    # -- eviction -------------------------------------------------------
    def maybe_evict(self) -> int:
        """Commit-path budget enforcement: past the budget, evict the
        coldest ELIGIBLE keys (live head_vc equal to the anchor sidecar's
        stamp) in one bounded batch.  Returns rows evicted; cheap under
        the budget."""
        if self.budget <= 0:
            return 0
        over = self.resident_rows() - self.budget
        if over <= 0:
            return 0
        return self.evict_now(max_rows=min(over, self.EVICT_BATCH))

    def enforce_budget(self) -> int:
        """Evict in bounded batches until the budget holds or nothing more
        is eligible (recovery's post-install pass: a restart larger than
        the card must not serve with the whole image resident)."""
        total = 0
        while self.budget > 0:
            over = self.resident_rows() - self.budget
            if over <= 0:
                break
            n = self.evict_now(max_rows=min(over, self.EVICT_BATCH))
            total += n
            if n == 0:
                break  # everything left is dirty or uncovered
        return total

    def _stored_stamps(self, sc: Sidecar, tname: str):
        """The anchor sidecar's head_vc column of one table, read in one
        bulk pread and kept until the next rebind (None when unreadable:
        the per-row probe decides then)."""
        key = (self.anchor, tname)
        if key not in self._stamp_cols:
            try:
                self._stamp_cols[key] = sc.read_column(tname, "head_vc")
            except (OSError, ValueError, KeyError):
                self._stamp_cols[key] = None
        return self._stamp_cols[key]

    def _scan(self, keys):
        """LRU entries classified against the current directory, refs and
        anchor (no side effect): [(dk, class, ent, ref)]."""
        directory, refs, probed = (self.store.directory, self.refs,
                                   self._probed_dirty)
        out = []
        for dk in keys:
            if dk in probed:
                out.append((dk, _PROBED, None, None))
                continue
            ref = refs.get(dk)
            ent = directory.get(dk)
            if ent is None:
                out.append((dk, _GONE, None, None))
            elif (ref is None or ref.src != self.anchor
                  or ref.tname != ent[0] or ref.shard != ent[1]):
                out.append((dk, _UNCOVERED, ent, ref))
            else:
                out.append((dk, _CANDIDATE, ent, ref))
        return out

    def _evictable(self, sc: Sidecar, scan) -> Dict[Tuple[Any, str], bool]:
        """Each candidate's verdict: its live head_vc equals the anchor
        sidecar's stored stamp.  The live stamps come in one device gather
        and one host copy per table of the candidates' rows (not of the
        whole table), the stored ones from the sidecar's head_vc column."""
        by_table: Dict[str, list] = {}
        for dk, cls, ent, ref in scan:
            if cls == _CANDIDATE:
                by_table.setdefault(ent[0], []).append((dk, ent, ref))
        out: Dict[Tuple[Any, str], bool] = {}
        for tname, items in by_table.items():
            t = self.store.table(tname)
            live = t.head_vc_at([ent[1] for _dk, ent, _r in items],
                                [ent[2] for _dk, ent, _r in items])
            col = self._stored_stamps(sc, tname)
            if col is not None:
                rs = np.asarray([r.shard for _dk, _e, r in items], np.int64)
                rw = np.asarray([r.srow for _dk, _e, r in items], np.int64)
                inside = (rs < col.shape[0]) & (rw < col.shape[1])
                stored = col[np.where(inside, rs, 0), np.where(inside, rw, 0)]
                same = inside & (live == stored).all(axis=1)
            else:
                same = np.zeros(len(items), bool)
                for i, (_dk, _ent, ref) in enumerate(items):
                    try:
                        st_ = sc.read_head_vc(tname, ref.shard, ref.srow)
                    except (OSError, ValueError, KeyError):
                        continue
                    same[i] = np.array_equal(live[i], st_)
            for (dk, _ent, _ref), ok in zip(items, same.tolist()):
                out[dk] = ok
        return out

    def evict_now(self, max_rows: int = EVICT_BATCH) -> int:
        """Evict up to ``max_rows`` of the coldest eligible keys.  The scan
        visits the LRU in the reference's order and stops where it stops
        (``max_rows`` picked or ``SCAN_CAP`` visited), re-queueing probed
        and uncovered keys behind the hot end as it goes."""
        with self.lock:
            if self.anchor is None:
                cb = self.on_pressure
                if cb is not None:
                    cb()
                return 0
            try:
                sc = self._sidecar(self.anchor)
            except ColdMiss:
                return 0
            # the entries this cycle may visit, fixed before it re-queues
            # any; classified a chunk at a time (a cycle usually stops
            # after ``max_rows`` of them)
            keys = list(islice(self.lru, self.SCAN_CAP))
            picked: Dict[str, list] = {}  # tname -> [(dk, shard, row)]
            n_picked = 0
            chunk = max(int(max_rows), 256)
            for lo in range(0, len(keys), chunk):
                if n_picked >= max_rows:
                    break
                scan = self._scan(keys[lo:lo + chunk])
                ok = self._evictable(sc, scan)
                for dk, cls, ent, _ref in scan:
                    if n_picked >= max_rows:
                        break
                    if cls == _GONE:
                        self.lru.pop(dk, None)  # already gone or cold
                        continue
                    if cls == _CANDIDATE and ok[dk]:
                        picked.setdefault(ent[0], []).append(
                            (dk, ent[1], ent[2]))
                        n_picked += 1
                        continue
                    # probed dirty before, uncovered by the anchor (born
                    # or promoted since its stamp), or written since it:
                    # not evictable against this anchor; re-queue behind
                    # the hot end so the scan makes progress
                    if cls != _PROBED:
                        self._probed_dirty.add(dk)
                    self.lru.move_to_end(dk)
            evicted = 0
            store = self.store
            for tname, items in picked.items():
                t = store.table(tname)
                t.evict_rows(np.asarray([x[1] for x in items]),
                             np.asarray([x[2] for x in items]))
                dks = [x[0] for x in items]
                for dk, shard, _row in items:
                    ref = self.refs[dk]
                    store.directory.pop(dk, None)
                    self.lru.pop(dk, None)
                    self.cold_set.add(dk)
                    self.by_shard.setdefault(shard, set()).add(dk)
                    # the transition for the incremental chain: a composed
                    # recovery must re-register the key cold instead of
                    # resurrecting the (now reusable) row
                    store._ckpt_evicted[dk] = (
                        ref.tname, ref.shard, ref.srow, ref.src)
                store.mark_epoch_fallback_many(dks)
                store.drop_cached_values(dks)
                evicted += len(items)
            if evicted:
                self.evictions += evicted
                self._count("evict", evicted)
                self._gauges()
            if self.resident_rows() > self.budget and evicted < max_rows:
                # could not reach the budget (everything hot or dirty):
                # ask for a stamp so the next cycle has coverage
                cb = self.on_pressure
                if cb is not None:
                    cb()
            return evicted

    # -- observability --------------------------------------------------
    def status(self) -> dict:
        return {
            "budget": self.budget,
            "resident_rows": self.resident_rows(),
            "cold_keys": len(self.cold_set),
            "lost_keys": len(self.lost),
            "anchor_image": self.anchor,
            "evictions": self.evictions,
            "faults": self.faults,
            "refused": self.refused,
            "fault_rate_cap": self.fault_rate_cap,
        }


__all__ = ["ColdTier", "ColdRef", "Sidecar", "write_sidecar", "COLD_BIN"]
