"""Per-type sharded device table: key slots, snapshot versions, op rings.

Layout per type (P shards, N key slots, V versions, K ring slots, D lanes),
the JAX package's layout as torch tensors on one device:

  snap[f]     : [P, N, V, *field_shape]   materialized snapshot fields
  snap_vc     : int32[P, N, V, D]         snapshot clocks
  snap_seq    : int64[P, N, V]            insertion sequence (0 = empty)
  ops_a       : int64[P, N, K, A]         effect payload lanes
  ops_b       : int32[P, N, K, B]
  ops_vc      : int32[P, N, K, D]         commit-augmented op clocks
  ops_origin  : int32[P, N, K]            origin DC lane
  head[f]     : [P, N, *field_shape]      state at each key's full history
  head_vc     : int32[P, N, D]
  n_ops       : host numpy int32[P, N]    valid ring prefix length

The host API is flat — (shards[M], rows[M], ...) — and indexes the tensors
with (shard, row) pairs directly; the JAX package's padded [P, M'] routing
and batch buckets only bounded XLA compiles, and the port runs eagerly.

Commits append to the ring and fold the new slots onto the head, so reads
at a VC that dominates a row's head VC are pure gathers.  A ring about to
overflow is GC'd first: the head is copied into a new snapshot version
(evicting the oldest) and the ring restarts.  Reads below the head fold the
ring over the newest snapshot version the read VC dominates; reads below
the retained coverage are flagged *incomplete* for the caller's log replay.

Two kinds of frozen (head, head_vc) copies let reads run beside writes:

  * ``epochs`` — whole-head copies (``publish_epoch``, at most
    ``_EPOCH_CAP``), rung 2 of the serving read's ladder: a read pinned
    at an epoch's cap is a pure gather from it;
  * the serving double buffer (``freeze_serving``) — two alternating
    copies the store's serving epochs gather from, refreshed by scattering
    only the rows appended since the spare slot's freeze.

Updates are in place (the JAX package donates buffers to the same effect).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from antidote_tpu_torch.clock import orddict
from antidote_tpu_torch.clock import vector as vc
from antidote_tpu_torch.config import AntidoteConfig, resolve_device
from antidote_tpu_torch.crdt.base import CRDTType
from antidote_tpu_torch.materializer import cuda_kernels
from antidote_tpu_torch.materializer import fold as fold_mod
from antidote_tpu_torch.materializer import longlog


class TypedTable:
    """Host handle for one CRDT type's sharded device tensors."""

    def __init__(self, ty: CRDTType, cfg: AntidoteConfig,
                 n_rows: int | None = None, n_shards: int | None = None,
                 device="cuda", metrics=None):
        self.ty = ty
        self.cfg = cfg
        self.device = resolve_device(device)
        #: NodeMetrics (or None): fold dispatches land in its counter
        self.metrics = metrics
        #: per-strategy serving-fold dispatch counts
        self.fold_dispatches: Dict[str, int] = {}
        self.n_rows = n_rows or cfg.keys_per_table
        self.n_shards = n_shards or cfg.n_shards
        self.used_rows = np.zeros((self.n_shards,), np.int64)
        #: per-shard reusable rows freed by the cold tier's guarded evict
        #: (``store/coldtier.py``): ``alloc_row`` pops here before it
        #: advances the high-water mark, which keeps device residency
        #: bounded under a keyspace larger than the card.  ``used_rows``
        #: stays the row extent's high-water mark (freed rows below it
        #: hold zeros)
        self.free_rows: Dict[int, list] = {}
        self.next_seq = 1
        #: host-tracked bound on |eff_a lane 0| over every appended effect.
        #: The port's ``counter_fold`` sums in int64 and needs no gate; the
        #: value rides in checkpoint images, where the JAX package gates
        #: its int32 Pallas counter fold on it after a restore
        self.max_abs_delta = 0
        #: host-tracked entry-wise max over all appended commit VCs: a read
        #: VC dominating it makes EVERY row fresh (no fold, no device sync)
        self.max_commit_vc = np.zeros((cfg.max_dcs,), np.int32)
        d, v, k = cfg.max_dcs, cfg.snap_versions, cfg.ops_per_key
        a, b = ty.eff_a_width(cfg), ty.eff_b_width(cfg)
        p, n = self.n_shards, self.n_rows
        spec = ty.state_spec(cfg)

        def mk(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self.snap = {f: mk((p, n, v) + s, dt) for f, (s, dt) in spec.items()}
        self.snap_vc = mk((p, n, v, d), torch.int32)
        self.snap_seq = mk((p, n, v), torch.int64)
        self.ops_a = mk((p, n, k, a), torch.int64)
        self.ops_b = mk((p, n, k, b), torch.int32)
        self.ops_vc = mk((p, n, k, d), torch.int32)
        self.ops_origin = mk((p, n, k), torch.int32)
        self.head = {f: mk((p, n) + s, dt) for f, (s, dt) in spec.items()}
        self.head_vc = mk((p, n, d), torch.int32)
        self.n_ops = np.zeros((p, n), np.int32)  # host-authoritative
        #: host-side conservative bound on per-key used element slots —
        #: drives tier promotion (KVStore._promote_key); only over-counts
        self.slots_ub = np.zeros((p, n), np.int32)
        #: published table epochs: frozen (head, head_vc) copies with the
        #: max commit VC at publish time (``cap``); see publish_epoch
        self.epochs: list = []
        self._epoch_uses = 0
        #: serves that missed both gather rungs of the read ladder
        self.slow_serves = 0
        # --- the serving double buffer: two alternating frozen (head,
        # head_vc) slots for the store's serving epochs
        self._serving = [None, None]
        self._serving_cur = 0
        #: (shard, row) pairs appended since the current / spare slot's
        #: freeze; None = unbounded (past the cap, or invalidated): the
        #: next freeze of that slot must copy
        self._serving_dirty: "set | None" = set()
        self._serving_spare_dirty: "set | None" = None
        #: called (no args) when an out-of-band mutation invalidates the
        #: frozen slots — the KVStore points it at its serving-epoch drop
        self.on_serving_invalidate = None
        self._serving_conservative = False
        #: write windows of freezes whose store-wide publish deferred:
        #: the next successful epoch's touched set must carry them
        self._pending_touched: "frozenset | None" = frozenset()
        #: the staging buffers of a one-row install (``_row_stage``)
        self._stage = None
        #: (shard, row) pairs written since the last CHECKPOINT capture —
        #: the delta link's dirty window (independent of the serving
        #: windows above).  None = untracked (past the cap, or an
        #: out-of-band mutation): the next stamp must be a full rebase
        self._ckpt_dirty: "set | None" = set()

    #: checkpoint dirty windows larger than this stop tracking: a delta
    #: link carrying most of the table costs what a rebase costs
    _CKPT_DIRTY_CAP = 262144

    def take_ckpt_dirty(self) -> "set | None":
        """Consume the checkpoint dirty window (under the commit lock, by
        the stamp capture): the (shard, row) set written since the last
        capture, or None when a rebase is required; the window restarts
        empty either way."""
        out = self._ckpt_dirty
        self._ckpt_dirty = set()
        return out

    # ------------------------------------------------------------------
    # the serving double buffer (the store's lock-split epoch reads)
    # ------------------------------------------------------------------
    #: dirty sets past this size stop tracking rows; the next freeze
    #: copies.  The JAX package's cap, kept so that publish modes and
    #: touched sets match it; on an NVIDIA H100 80GB HBM3 at 700 W and 1M
    #: keys a scatter of ~7,800 rows is host-bound and already slower than
    #: the whole copy (``PERF.md``, the serving phase)
    _SERVING_DIRTY_CAP = 8192

    def note_serving_touch(self, shards, rows) -> None:
        """Record appended rows for the incremental serving freeze and the
        incremental checkpoint stamp (separate windows, separate
        consumers)."""
        if (self._serving_dirty is None and self._serving_spare_dirty is None
                and self._ckpt_dirty is None):
            return  # every window untracked until its next consumer
        pairs = list(zip(np.asarray(shards).tolist(),
                         np.asarray(rows).tolist()))
        for attr, cap in (("_serving_dirty", self._SERVING_DIRTY_CAP),
                          ("_serving_spare_dirty", self._SERVING_DIRTY_CAP),
                          ("_ckpt_dirty", self._CKPT_DIRTY_CAP)):
            s = getattr(self, attr)
            if s is None:
                continue
            s.update(pairs)
            if len(s) > cap:
                setattr(self, attr, None)

    def serving_slot(self):
        """The current frozen serving slot (None before any freeze)."""
        return self._serving[self._serving_cur]

    def serving_spare(self):
        """The slot the NEXT freeze would overwrite — publishers check it
        against the live epoch's slots (scattering into a slot the current
        epoch still gathers from would change it under a reader)."""
        return self._serving[1 - self._serving_cur]

    def serving_dirty(self) -> bool:
        cur = self._serving[self._serving_cur]
        return cur is None or self._serving_dirty is None or bool(
            self._serving_dirty)

    def invalidate_serving(self) -> None:
        """Drop both frozen slots after an out-of-band table mutation (row
        growth).  The next freeze reports its write set as unknown
        (touched=None), so no cache entry revalidates across it."""
        self._serving = [None, None]
        self._serving_dirty = set()
        self._serving_spare_dirty = None
        self._serving_conservative = True
        # the checkpoint window did not see the out-of-band mutation
        # either: the next stamp must rebase
        self._ckpt_dirty = None
        cb = self.on_serving_invalidate
        if cb is not None:
            cb()

    def _frozen_copy(self):
        return ({f: x.clone() for f, x in self.head.items()},
                self.head_vc.clone())

    def freeze_serving(self, can_donate: bool, force_copy: bool = False):
        """Freeze the live head into the spare serving slot and make it
        current.  Returns (slot, mode, touched, rows): mode "scatter" (the
        ``rows`` rows appended since the spare's freeze are written into it
        in place) or "copy" (the whole head cloned).  ``touched`` is the
        frozenset of rows appended since the previous freeze (the snapshot
        cache's validity window; the scatter set spans two windows, one per
        slot), or None when unknown.

        Returns None when the freeze must be DEFERRED: the spare may still
        be read by a pinned epoch (``can_donate`` false).  ``force_copy``
        builds fresh tensors instead — required when the spare is the LIVE
        epoch's slot (waiting would never free it).

        Caller must hold the commit lock (no concurrent appends)."""
        spare_i = 1 - self._serving_cur
        spare = self._serving[spare_i]
        dirty = self._serving_spare_dirty
        if force_copy or spare is None or dirty is None:
            head, head_vc = self._frozen_copy()
            mode, rows = "copy", self.n_shards * self.n_rows
        elif not can_donate:
            return None
        else:
            # the spare's tensors are rewritten in place: index_put_ of
            # the dirty rows' live state (the JAX package donates them)
            pairs = sorted(dirty)
            ss = self._idx([p[0] for p in pairs])
            rr = self._idx([p[1] for p in pairs])
            head, head_vc = spare["head"], spare["head_vc"]
            for f, x in head.items():
                x[ss, rr] = self.head[f][ss, rr]
            head_vc[ss, rr] = self.head_vc[ss, rr]
            mode, rows = "scatter", len(pairs)
        slot = {"head": head, "head_vc": head_vc,
                "cap": self.max_commit_vc.copy()}
        if self._serving_conservative or self._serving_dirty is None:
            touched = None
            self._serving_conservative = False
        else:
            touched = frozenset(self._serving_dirty)
        self._serving[spare_i] = slot
        self._serving_cur = spare_i
        self._serving_spare_dirty = self._serving_dirty
        self._serving_dirty = set()
        return slot, mode, touched, rows

    # ------------------------------------------------------------------
    # table epochs (rung 2 of the serving read's ladder)
    # ------------------------------------------------------------------
    _EPOCH_CAP = 2

    def publish_epoch(self) -> None:
        """Freeze the current head as a table epoch.

        An epoch gather is an exact snapshot read: ``cap`` is the
        entry-wise max commit VC this table has absorbed at publish time,
        and appends are causally gated (an op from origin ``o`` carries a
        lane-``o`` stamp above every lane-``o`` value appended before), so
        an op appended AFTER publish is invisible at any read VC ``R ≤
        cap``, and a row whose frozen ``head_vc ≤ R`` serves exactly."""
        head, head_vc = self._frozen_copy()
        self._epoch_uses += 1
        self.epochs.append({
            "head": head,
            "head_vc": head_vc,
            "cap": self.max_commit_vc.copy(),
            "seq": self._epoch_uses,   # publish order (age)
            "used": self._epoch_uses,  # recency (eviction only)
        })
        if len(self.epochs) > self._EPOCH_CAP:
            victim = min(self.epochs, key=lambda e: e["used"])
            self.epochs = [e for e in self.epochs if e is not victim]

    def invalidate_epochs(self) -> None:
        """Drop every table epoch and the serving slots — after any
        out-of-band table mutation (row growth)."""
        self.epochs.clear()
        self.invalidate_serving()

    def _epoch_for(self, read_vcs: np.ndarray):
        """Oldest epoch whose cap dominates every read VC in the batch
        (oldest = closest above the pin = most rows frozen-fresh)."""
        best = None
        for e in self.epochs:
            if (read_vcs <= e["cap"]).all():
                if best is None or e["seq"] < best["seq"]:
                    best = e
        if best is not None:
            self._epoch_uses += 1
            best["used"] = self._epoch_uses
        return best

    # ------------------------------------------------------------------
    # row allocation / growth
    # ------------------------------------------------------------------
    def alloc_row(self, shard: int) -> int:
        free = self.free_rows.get(shard)
        if free:
            # an evicted row: the guarded evict zeroed its whole device
            # state, so the new tenant starts from bottom like a fresh
            # row (and the evictor marked it touched, so no frozen buffer
            # serves the previous tenant's bytes)
            return free.pop()
        if self.used_rows[shard] == self.n_rows:
            self._grow()
        r = int(self.used_rows[shard])
        self.used_rows[shard] += 1
        return r

    def resident_rows(self) -> int:
        """Device rows holding key state: the allocation high-water mark
        minus the freed (evicted, reusable) rows — what the cold tier's
        resident budget bounds."""
        return int(self.used_rows.sum()) - sum(
            len(v) for v in self.free_rows.values())

    def evict_rows(self, shards, rows) -> None:
        """The GUARDED device-row drop of the cold tier (nothing outside
        ``store/coldtier.py`` calls it without an ``# evict-ok:`` note):
        zero the rows' whole device state — head, snapshot versions, op
        ring — in place on the table's stream, and push them onto the
        per-shard free lists.  The caller owns the correctness obligations:
        a retained checkpoint sidecar covers the rows' state, the keys are
        unbound from the directory, and every live serving epoch falls
        back for them.  A head copy issued earlier on the same stream (a
        checkpoint stamp's clone) keeps the rows' bytes from before."""
        shards = np.asarray(shards, np.int64)
        rows = np.asarray(rows, np.int64)
        if len(rows) == 0:
            return
        ss, rr = self._idx_async(shards), self._idx_async(rows)
        for grp in (self.snap, self.head):
            for x in grp.values():
                x[ss, rr] = 0
        for name in ("snap_vc", "snap_seq", "ops_a", "ops_b", "ops_vc",
                     "ops_origin", "head_vc"):
            getattr(self, name)[ss, rr] = 0
        self.n_ops[shards, rows] = 0
        self.slots_ub[shards, rows] = 0
        for s, r in zip(shards.tolist(), rows.tolist()):
            self.free_rows.setdefault(s, []).append(r)
        # the cleared rows must not serve from a frozen serving slot (the
        # next publish re-freezes them), nor from a table epoch, which
        # would serve them for the row's next tenant
        self.note_serving_touch(shards, rows)
        self.epochs.clear()

    def _grow(self):
        add = self.n_rows

        def grow(x):
            return torch.cat(
                [x, x.new_zeros((x.shape[0], add) + tuple(x.shape[2:]))], 1)

        self.snap = {f: grow(x) for f, x in self.snap.items()}
        self.head = {f: grow(x) for f, x in self.head.items()}
        for name in ("snap_vc", "snap_seq", "ops_a", "ops_b", "ops_vc",
                     "ops_origin", "head_vc"):
            setattr(self, name, grow(getattr(self, name)))
        self.n_ops = np.pad(self.n_ops, ((0, 0), (0, add)))
        self.slots_ub = np.pad(self.slots_ub, ((0, 0), (0, add)))
        self.n_rows += add
        # frozen copies keep the old row extent: drop them.  The checkpoint
        # window survives: growth moves no row and changes no content
        ck = self._ckpt_dirty
        self.invalidate_epochs()
        self._ckpt_dirty = ck

    # ------------------------------------------------------------------
    # commit side
    # ------------------------------------------------------------------
    def _idx(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.int64), device=self.device)

    def append(self, shards, rows, eff_a, eff_b, vcs, origins):
        """Append a commit-ordered batch of effects.

        ``shards`` int64[M]; ``rows`` int64[M]; ``eff_a`` [M, A]; ``eff_b``
        [M, B]; ``vcs`` [M, D]; ``origins`` [M].  Ring overflow triggers a
        GC of the affected keys first."""
        shards = np.asarray(shards, np.int64)
        rows = np.asarray(rows, np.int64)
        m = len(rows)
        if m == 0:
            return
        eff_a = np.asarray(eff_a, np.int64)
        eff_b = np.asarray(eff_b, np.int32)
        vcs = np.asarray(vcs, np.int32)
        origins = np.asarray(origins, np.int32)
        k = self.cfg.ops_per_key
        # occurrence index of each (shard, row) within the batch
        combined = shards * np.int64(self.n_rows) + rows
        order = np.argsort(combined, kind="stable")
        sorted_c = combined[order]
        new_group = np.concatenate([[True], np.diff(sorted_c) != 0])
        group_start = np.nonzero(new_group)[0]
        group_of = np.cumsum(new_group) - 1
        occ = np.empty(m, np.int64)
        occ[order] = np.arange(m) - group_start[group_of]
        slots = self.n_ops[shards, rows] + occ
        over = slots >= k
        if over.any():
            uniq = np.unique(np.stack([shards[over], rows[over]], axis=1),
                             axis=0)
            self.gc(uniq[:, 0], uniq[:, 1])
            slots = self.n_ops[shards, rows] + occ
            if (slots >= k).any():
                # one batch carries more ops for a key than the ring holds:
                # split by per-key occurrence so each sub-batch fits, with
                # a GC between them — per-key commit order preserved
                chunk = occ // k
                for c in range(int(chunk.max()) + 1):
                    sel = chunk == c
                    self.append(shards[sel], rows[sel], eff_a[sel],
                                eff_b[sel], vcs[sel], origins[sel])
                return
        if eff_a.shape[1] > 0:
            self.max_abs_delta = max(self.max_abs_delta,
                                     int(np.abs(eff_a[:, 0]).max()))
        np.maximum(self.max_commit_vc, vcs.max(axis=0),
                   out=self.max_commit_vc)
        ss, rr, sl = self._idx(shards), self._idx(rows), self._idx(slots)
        dev = self.device
        self.ops_a[ss, rr, sl] = torch.as_tensor(eff_a, device=dev)
        self.ops_b[ss, rr, sl] = torch.as_tensor(eff_b, device=dev)
        self.ops_vc[ss, rr, sl] = torch.as_tensor(vcs, device=dev)
        self.ops_origin[ss, rr, sl] = torch.as_tensor(origins, device=dev)
        # fold the newly-appended ring slots of each touched key onto its
        # head: slots [n_ops, n_ops + count)
        first = order[new_group]
        counts = np.diff(np.append(group_start, m))
        us, ur = shards[first], rows[first]
        starts = self.n_ops[us, ur].astype(np.int64)
        self._head_update(us, ur, starts, starts + counts)
        np.add.at(self.n_ops, (shards, rows), 1)
        self.note_serving_touch(us, ur)

    def _head_update(self, shards, rows, starts, ends):
        """Apply ring slots [start, end) of each key onto its head state —
        the write-time fold that keeps hot reads pure gathers."""
        ss, rr = self._idx(shards), self._idx(rows)
        st, en = self._idx(starts), self._idx(ends)
        state = {f: x[ss, rr] for f, x in self.head.items()}
        hvc = self.head_vc[ss, rr]
        for slot in range(int(starts.min()), int(ends.max())):
            include = (st <= slot) & (slot < en)
            op_vc = self.ops_vc[ss, rr, slot]
            new = self.ty.apply(self.cfg, state, self.ops_a[ss, rr, slot],
                                self.ops_b[ss, rr, slot], op_vc,
                                self.ops_origin[ss, rr, slot])
            state = fold_mod.where_rows(include, new, state)
            hvc = torch.where(include[:, None], torch.maximum(hvc, op_vc),
                              hvc)
        for f, x in self.head.items():
            x[ss, rr] = state[f]
        self.head_vc[ss, rr] = hvc

    def gc(self, shards, rows):
        """Fold the given keys' rings into a fresh snapshot version: the
        head already is that fold, so it is copied over the oldest
        version; the rings restart empty."""
        shards = np.asarray(shards, np.int64)
        rows = np.asarray(rows, np.int64)
        count = len(rows)
        if count == 0:
            return
        ss, rr = self._idx(shards), self._idx(rows)
        seqs = torch.arange(self.next_seq, self.next_seq + count,
                            dtype=torch.int64, device=self.device)
        self.next_seq += count
        slot = orddict.insert_slot(self.snap_seq[ss, rr]).long()
        for f, x in self.snap.items():
            x[ss, rr, slot] = self.head[f][ss, rr]
        self.snap_vc[ss, rr, slot] = self.head_vc[ss, rr]
        self.snap_seq[ss, rr, slot] = seqs
        self.n_ops[shards, rows] = 0

    # ------------------------------------------------------------------
    # checkpoint capture and install
    # ------------------------------------------------------------------
    def _idx_async(self, x) -> torch.Tensor:
        """An int64 index tensor on the table's device with no host sync:
        on a card through pinned memory and an asynchronous copy."""
        t = torch.from_numpy(np.ascontiguousarray(x, np.int64))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def copy_head(self, n_rows: int):
        """Device copies of ``head`` and ``head_vc`` over the first
        ``n_rows`` rows of every shard: (fields, head_vc).  Issued on the
        table's stream with no host sync, so a checkpoint stamp can take
        them under the commit lock: a later in-place commit is queued
        behind the copies, and the host copy runs outside the lock."""
        return ({f: x[:, :n_rows].clone() for f, x in self.head.items()},
                self.head_vc[:, :n_rows].clone())

    def gather_rows(self, shards, rows):
        """Device copies of (head fields, head_vc) at the given (shard,
        row) pairs, with no host sync (the delta stamp's capture)."""
        ss = self._idx_async(shards)
        rr = self._idx_async(rows)
        return ({f: x[ss, rr] for f, x in self.head.items()},
                self.head_vc[ss, rr])

    def install_rows(self, shards, rows, head_rows, head_vc_rows) -> None:
        """Install per-row head states (a delta link's rows, a cold
        fault-in): set the head and seed ONE snapshot version from it, so
        versioned reads at clocks ≥ the row's head_vc fold the empty ring
        on this base exactly and reads below surface the compaction
        horizon.  The rows must be fresh or evict-cleared (empty ring).
        ``head_rows`` maps field -> [M, ...] host arrays."""
        shards = np.asarray(shards, np.int64)
        rows = np.asarray(rows, np.int64)
        m = len(rows)
        if m == 0:
            return
        hvc_rows = np.asarray(head_vc_rows, np.int32)
        if m == 1:
            self._install_one(int(shards[0]), int(rows[0]), head_rows,
                              hvc_rows[0])
        else:
            self._install_many(shards, rows, head_rows, hvc_rows)
        self.n_ops[shards, rows] = 0
        np.maximum(self.max_commit_vc, hvc_rows.max(axis=0),
                   out=self.max_commit_vc)
        self.note_serving_touch(shards, rows)
        self.epochs.clear()

    def _row_stage(self) -> dict:
        """Staging buffers for one row's install, built once: a host
        buffer (pinned on a card) laid out as the row's head fields, its
        head_vc and its sequence id at 8-byte aligned offsets, the device
        buffer it is copied to, and views of both."""
        st = self._stage
        if st is None:
            specs = [(f, x.dtype, tuple(x.shape[2:]))
                     for f, x in self.head.items()]
            specs += [("\0vc", torch.int32, (self.head_vc.shape[-1],)),
                      ("\0seq", torch.int64, ())]
            off, lay = 0, {}
            for name, dt, shape in specs:
                off = (off + 7) // 8 * 8
                one = torch.empty((), dtype=dt)
                n = int(np.prod(shape, dtype=np.int64)) * one.element_size()
                lay[name] = (off, n, dt, one.numpy().dtype, shape)
                off += n
            host = torch.zeros(max(off, 8), dtype=torch.uint8)
            on_card = self.device.type == "cuda"
            if on_card:
                host = host.pin_memory()
            dev = (torch.empty_like(host, device=self.device) if on_card
                   else host)
            hnp = host.numpy()
            st = self._stage = {
                "host": host, "dev": dev, "on_card": on_card,
                "event": torch.cuda.Event() if on_card else None,
                "np": {k: hnp[o:o + n].view(ndt).reshape(shape)
                       for k, (o, n, _dt, ndt, shape) in lay.items()},
                "view": {k: dev[o:o + n].view(dt).view(shape)
                         for k, (o, n, dt, _ndt, shape) in lay.items()}}
        return st

    def _install_one(self, s: int, r: int, head_rows, hvc) -> None:
        """One row (a cold fault-in): the row reaches the device in one
        copy through the staging buffers, and one multi-tensor copy writes
        every destination."""
        st = self._row_stage()
        if st["on_card"]:
            st["event"].synchronize()  # the last row's copy has read it
        hnp = st["np"]
        for f in self.head:
            hnp[f][...] = np.asarray(head_rows[f])[0]
        hnp["\0vc"][...] = hvc
        hnp["\0seq"][...] = self.next_seq
        self.next_seq += 1
        if st["on_card"]:
            st["dev"].copy_(st["host"], non_blocking=True)
            st["event"].record()
        v = st["view"]
        dst, src = [], []
        for f, x in self.head.items():
            dst += [x[s, r], self.snap[f][s, r, 0]]
            src += [v[f], v[f]]
        dst += [self.head_vc[s, r], self.snap_vc[s, r, 0],
                self.snap_seq[s, r, 0]]
        src += [v["\0vc"], v["\0vc"], v["\0seq"]]
        torch._foreach_copy_(dst, src)

    def _install_many(self, shards, rows, head_rows, hvc_rows) -> None:
        """Several rows (a delta link)."""
        m = len(rows)
        ss, rr = self._idx(shards), self._idx(rows)
        dev = self.device
        for f, x in self.head.items():
            v = torch.as_tensor(np.asarray(head_rows[f]), device=dev)
            x[ss, rr] = v
            self.snap[f][ss, rr, 0] = v
        hvc = torch.as_tensor(hvc_rows, device=dev)
        self.head_vc[ss, rr] = hvc
        self.snap_vc[ss, rr, 0] = hvc
        self.snap_seq[ss, rr, 0] = torch.arange(
            self.next_seq, self.next_seq + m, dtype=torch.int64, device=dev)
        self.next_seq += m

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------
    def _fold_strategy(self) -> str:
        """The ring fold for a read's stale rows: the hand-written kernel
        of the type where there is one (the plain version of the same
        function on a CPU table), then the monoid reduction for types
        whose delta is exact from an ARBITRARY base (the flags; sets are
        bottom-only, ``CRDTType.assoc_bottom_only``), else the generic
        serial fold.  ``counter_pn`` needs no delta-magnitude gate:
        ``counter_fold`` sums in int64 (the TPU kernel's int32 sum needed
        one)."""
        if self.ty.name == "set_aw":
            return "kernel_set_aw"
        if self.ty.name == "counter_pn":
            return "kernel_counter"
        if self.ty.supports_assoc and not self.ty.assoc_bottom_only:
            return "assoc"
        return "serial"

    def _count_dispatch(self, strategy: str, n: int = 1) -> None:
        self.fold_dispatches[strategy] = (
            self.fold_dispatches.get(strategy, 0) + n)
        m = getattr(self.metrics, "fold_dispatch", None)
        if m is not None:
            m.inc(n, strategy=strategy)

    def _fold_rows(self, shards, rows, read_vcs: torch.Tensor):
        """Versioned read of M rows: the newest retained snapshot version
        each read VC dominates becomes the base, and the ring is folded
        over it.  Returns (state [M, ...], applied int32[M], complete
        bool[M]); a row is complete iff its ring holds its whole history
        or the base is the newest version (the ring only holds ops after
        the newest version)."""
        ss, rr = self._idx(shards), self._idx(rows)
        m = len(shards)
        svc, sseq = self.snap_vc[ss, rr], self.snap_seq[ss, rr]
        idx, found = orddict.get_smaller(svc, sseq, read_vcs)
        idx = idx.long()
        take = torch.arange(m, device=self.device)
        base_vc = torch.where(found[:, None], svc[take, idx], 0)
        base = {f: x[ss, rr, idx] for f, x in self.snap.items()}
        base = fold_mod.where_rows(found, base,
                           {f: torch.zeros_like(x) for f, x in base.items()})
        newest = sseq.max(-1).values
        complete = (found & (sseq[take, idx] == newest)) | (newest == 0)
        n_ops = self.n_ops[shards, rows]
        # rings fill from slot 0 and restart at GC: fold only the prefix
        # the batch uses
        kmax = max(int(n_ops.max()), 1)
        n_ops = torch.as_tensor(n_ops, device=self.device)
        opa = self.ops_a[ss, rr, :kmax]
        opv = self.ops_vc[ss, rr, :kmax]
        strategy = self._fold_strategy()
        if strategy == "kernel_counter":
            cnt, applied = cuda_kernels.counter_fold(
                base["cnt"], opa[..., 0], opv, n_ops, base_vc, read_vcs)
            state = {"cnt": cnt}
        else:
            opb = self.ops_b[ss, rr, :kmax]
            opo = self.ops_origin[ss, rr, :kmax]
            if strategy == "kernel_set_aw":
                fold = cuda_kernels.set_aw_fold
            else:
                generic = (longlog.assoc_fold if strategy == "assoc"
                           else fold_mod.fold_batch)
                fold = lambda *a: generic(self.ty, self.cfg, *a)  # noqa: E731
            state, applied = fold(base, opa, opb, opv, opo, n_ops, base_vc,
                                  read_vcs)
        return state, applied, complete

    def _vcs(self, read_vcs) -> Tuple[np.ndarray, torch.Tensor]:
        read_vcs = np.array(read_vcs, np.int32)  # owned, writable copy
        return read_vcs, torch.as_tensor(read_vcs, device=self.device)

    def read_latest(self, shards, rows, read_vcs):
        """Head gather.  Returns host copies (state fields [M, ...], fresh
        [M]); a row is fresh iff head_vc ≤ its read VC — then the head IS
        the exact snapshot.  Stale rows must use :meth:`read`."""
        ss, rr = self._idx(shards), self._idx(rows)
        _, vcs_t = self._vcs(read_vcs)
        fresh = vc.le(self.head_vc[ss, rr], vcs_t)
        state = {f: x[ss, rr].cpu().numpy() for f, x in self.head.items()}
        return state, fresh.cpu().numpy()

    def read(self, shards, rows, read_vcs):
        """Versioned read of a flat batch at per-key read VCs (ring fold
        for every row).  Returns host copies (state fields [M, ...],
        n_applied [M], complete [M])."""
        shards = np.asarray(shards, np.int64)
        rows = np.asarray(rows, np.int64)
        _, vcs_t = self._vcs(read_vcs)
        state, applied, complete = self._fold_rows(shards, rows, vcs_t)
        return ({f: x.cpu().numpy() for f, x in state.items()},
                applied.cpu().numpy(), complete.cpu().numpy())

    def _gather(self, head, head_vc, ss, rr, vcs_t=None):
        """Gather M rows from one (head, head_vc) source — the live head, a
        table epoch or a serving slot — as device tensors, with no host
        sync: (state fields [M, ...], fresh bool[M] or None).  Freshness
        (the source head VC ≤ the read VC: then the gathered state IS the
        row's exact snapshot) is computed only when ``vcs_t`` is given."""
        state = {f: x[ss, rr] for f, x in head.items()}
        fresh = None if vcs_t is None else vc.le(head_vc[ss, rr], vcs_t)
        return state, fresh

    def _resolve(self, state):
        if self.ty.resolve_spec(self.cfg) is None:
            return state
        return self.ty.resolve(self.cfg, state)

    def latest_resolved_flat(self, head, head_vc, ss, rr):
        """Gather + resolve M rows that are fresh by construction (a read
        VC dominating the source's commits) from one (head, head_vc)
        source: resolved fields [M, ...] on the device, no host sync.
        Types without a ``resolve_spec`` return the full state."""
        return self._resolve(self._gather(head, head_vc, ss, rr)[0])

    def read_resolved_flat(self, shards, rows, read_vcs):
        """The serving read.  Returns (resolved fields [M, ...] on the
        table's device, fresh [M], complete [M] as host arrays), in input
        order.  For types without a ``resolve_spec`` the fields are the
        full state.  The ladder:

        1. the read VC dominates every commit → live head gather;
        2. the read VC is pinned exactly at a table epoch's cap → frozen
           head gather (writers advance the live head; pinned readers
           never see them);
        3. otherwise two-phase: gather (from the frozen epoch when one
           covers the VC, else the live head), check freshness on the
           host, and fold the ring ONLY for the stale remainder, merged
           over the gathered batch before the one resolve."""
        shards = np.asarray(shards, np.int64)
        rows = np.asarray(rows, np.int64)
        read_vcs, vcs_t = self._vcs(read_vcs)
        ss, rr = self._idx(shards), self._idx(rows)
        all_fresh = np.ones(len(rows), bool)
        if (read_vcs >= self.max_commit_vc).all():
            resolved = self.latest_resolved_flat(self.head, self.head_vc,
                                                 ss, rr)
            return resolved, all_fresh, all_fresh
        epoch = self._epoch_for(read_vcs)
        if epoch is not None and (read_vcs >= epoch["cap"]).all():
            # pinned at the cap: every frozen row has head_vc ≤ cap = R
            resolved = self.latest_resolved_flat(
                epoch["head"], epoch["head_vc"], ss, rr)
            return resolved, all_fresh, all_fresh
        self.slow_serves += 1
        src = (self.head, self.head_vc) if epoch is None else (
            epoch["head"], epoch["head_vc"])
        state, fresh_t = self._gather(*src, ss, rr, vcs_t)
        fresh = fresh_t.cpu().numpy()
        complete = fresh.copy()
        stale = np.nonzero(~fresh)[0]
        if len(stale):
            self._count_dispatch(self._fold_strategy())
            st = self._idx(stale)
            folded, _, comp = self._fold_rows(shards[stale], rows[stale],
                                              vcs_t[st])
            for f, x in state.items():
                x[st] = folded[f]
            complete[stale] = comp.cpu().numpy()
        return self._resolve(state), fresh, complete

    def read_resolved(self, shards, rows, read_vcs):
        """:meth:`read_resolved_flat` with the resolved fields copied to
        the host."""
        resolved, fresh, complete = self.read_resolved_flat(shards, rows,
                                                            read_vcs)
        return ({f: x.cpu().numpy() for f, x in resolved.items()}, fresh,
                complete)
