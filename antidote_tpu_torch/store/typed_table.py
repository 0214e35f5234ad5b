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

A table built with ``sharding`` (``parallel.shard_axis_sharding``: the JAX
package's ``NamedSharding`` over the shard axis) is PLACED: its tensors are
split into contiguous shard blocks, block ``b`` holding shards ``[b*spd,
(b+1)*spd)`` on the mesh's ``b``-th device (``blocks``).  Every operation
routes its (shard, row) pairs by block and runs on that block's device; a
read launches every block's gathers and folds before its first host copy
and hands its result back in input order (``BlockParts``).  The host
mirrors (``n_ops``, ``slots_ub``, ``used_rows``, ``free_rows``,
``max_commit_vc``) stay table-wide.  Without ``sharding`` the table is one
block over every shard, and ``snap``, ``head``, ``ops_a``, ... name its
tensors directly.

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

import contextlib
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


#: the per-row tensors besides the state field groups ``snap`` and ``head``
ROW_TENSORS = ("snap_vc", "snap_seq", "ops_a", "ops_b", "ops_vc",
               "ops_origin", "head_vc")
ROW_GROUPS = ("snap", "head")


def _take(x, sel):
    return x if sel is None else x[sel]


class BlockParts:
    """One logical tensor held as per-block device tensors (a placed
    table's read or capture): ``parts[i]`` holds the result's rows
    ``pos[i]``, or with ``pos`` None the parts concatenate in block order.
    ``cpu()`` assembles it on the host; no part crosses to another card."""

    def __init__(self, parts, pos=None, n=None):
        self.parts = list(parts)
        self.pos = pos
        self.n = n

    def numpy(self) -> np.ndarray:
        hs = [p.cpu().numpy() for p in self.parts]
        if self.pos is None:
            return np.concatenate(hs)
        out = np.empty((self.n,) + hs[0].shape[1:], hs[0].dtype)
        for pos, h in zip(self.pos, hs):
            out[pos] = h
        return out

    def cpu(self) -> torch.Tensor:
        return torch.from_numpy(self.numpy())


class Block:
    """One shard block of a table on one device: shards ``[off, off + n)``
    as local shards ``[0, n)`` of its tensors."""

    def __init__(self, i: int, device: torch.device, off: int, n: int):
        self.i, self.device, self.off, self.n = i, device, off, n
        #: the staging buffers of a one-row install (``_row_stage``)
        self.stage = None

    def idx(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.int64), device=self.device)

    def idx_async(self, x) -> torch.Tensor:
        """An int64 index tensor on the block's device with no host sync:
        on a card through pinned memory and an asynchronous copy."""
        t = torch.from_numpy(np.ascontiguousarray(x, np.int64))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)


def _one_block(name: str):
    """The unsharded table's tensor ``name`` (its one block's); a placed
    table holds its tensors by block and refuses the flat name."""

    def get(self):
        if self._spd is not None:
            raise TypeError(f"TypedTable.{name}: a placed table holds its "
                            "tensors by shard block (``blocks``)")
        return getattr(self.blocks[0], name)

    def put(self, value):
        if self._spd is not None:
            raise TypeError(f"TypedTable.{name}: a placed table holds its "
                            "tensors by shard block (``blocks``)")
        setattr(self.blocks[0], name, value)

    return property(get, put)


def fold_strategy(ty) -> str:
    """The ring fold for a read's stale rows: the hand-written kernel of
    the type where there is one (the plain version of the same function on
    a CPU table), then the monoid reduction for types whose delta is exact
    from an ARBITRARY base (the flags; sets are bottom-only,
    ``CRDTType.assoc_bottom_only``), else the generic serial fold.
    ``counter_pn`` needs no delta-magnitude gate: ``counter_fold`` sums in
    int64 (the TPU kernel's int32 sum needed one)."""
    if ty.name == "set_aw":
        return "kernel_set_aw"
    if ty.name == "counter_pn":
        return "kernel_counter"
    if ty.supports_assoc and not ty.assoc_bottom_only:
        return "assoc"
    return "serial"


def read_block(ty, cfg, src, ss, rr, n_ops, read_vcs, strategy: str):
    """Versioned read of M rows of one block (``src``: its snap, snap_vc,
    snap_seq and ops tensors; ``ss``/``rr`` index tensors on its device;
    ``n_ops`` the rows' host ring lengths): the newest retained snapshot
    version each read VC dominates becomes the base, and the ring is folded
    over it with ``strategy`` (``fold_strategy``).  Returns
    (state [M, ...], applied int32[M], complete bool[M]); a row is complete
    iff its ring holds its whole history or the base is the newest version
    (the ring only holds ops after the newest version)."""
    dev = ss.device
    m = ss.shape[0]
    svc, sseq = src.snap_vc[ss, rr], src.snap_seq[ss, rr]
    idx, found = orddict.get_smaller(svc, sseq, read_vcs)
    idx = idx.long()
    take = torch.arange(m, device=dev)
    base_vc = torch.where(found[:, None], svc[take, idx], 0)
    base = {f: x[ss, rr, idx] for f, x in src.snap.items()}
    base = fold_mod.where_rows(found, base,
                               {f: torch.zeros_like(x)
                                for f, x in base.items()})
    newest = sseq.max(-1).values
    complete = (found & (sseq[take, idx] == newest)) | (newest == 0)
    # rings fill from slot 0 and restart at GC: fold only the prefix the
    # batch uses
    kmax = max(int(n_ops.max()), 1)
    n_ops = torch.as_tensor(n_ops, device=dev)
    opa = src.ops_a[ss, rr, :kmax]
    opv = src.ops_vc[ss, rr, :kmax]
    if strategy == "kernel_counter":
        cnt, applied = cuda_kernels.counter_fold(
            base["cnt"], opa[..., 0], opv, n_ops, base_vc, read_vcs)
        state = {"cnt": cnt}
    else:
        opb = src.ops_b[ss, rr, :kmax]
        opo = src.ops_origin[ss, rr, :kmax]
        if strategy == "kernel_set_aw":
            fold = cuda_kernels.set_aw_fold
        else:
            generic = (longlog.assoc_fold if strategy == "assoc"
                       else fold_mod.fold_batch)
            fold = lambda *a: generic(ty, cfg, *a)  # noqa: E731
        state, applied = fold(base, opa, opb, opv, opo, n_ops, base_vc,
                              read_vcs)
    return state, applied, complete


class TypedTable:
    """Host handle for one CRDT type's sharded device tensors."""

    snap = _one_block("snap")
    snap_vc = _one_block("snap_vc")
    snap_seq = _one_block("snap_seq")
    ops_a = _one_block("ops_a")
    ops_b = _one_block("ops_b")
    ops_vc = _one_block("ops_vc")
    ops_origin = _one_block("ops_origin")
    head = _one_block("head")
    head_vc = _one_block("head_vc")

    def __init__(self, ty: CRDTType, cfg: AntidoteConfig,
                 n_rows: int | None = None, n_shards: int | None = None,
                 device="cuda", metrics=None, sharding=None):
        self.ty = ty
        self.cfg = cfg
        #: the placement (``parallel.shard_axis_sharding``) or None
        self.sharding = sharding
        self.device = (resolve_device(device) if sharding is None
                       else sharding.devices[0])
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
        #: shards a block (None: one block over every shard, unplaced)
        self._spd = None
        devices = [self.device]
        if sharding is not None:
            self._spd = sharding.shards_per_block(p)
            devices = list(sharding.devices)
        spd = self._spd or p
        #: the shard blocks, in shard order
        self.blocks = [Block(i, dev, i * spd, spd)
                       for i, dev in enumerate(devices)]
        for blk in self.blocks:
            def mk(shape, dtype):
                return torch.zeros(shape, dtype=dtype, device=blk.device)

            blk.snap = {f: mk((spd, n, v) + s, dt)
                        for f, (s, dt) in spec.items()}
            blk.snap_vc = mk((spd, n, v, d), torch.int32)
            blk.snap_seq = mk((spd, n, v), torch.int64)
            blk.ops_a = mk((spd, n, k, a), torch.int64)
            blk.ops_b = mk((spd, n, k, b), torch.int32)
            blk.ops_vc = mk((spd, n, k, d), torch.int32)
            blk.ops_origin = mk((spd, n, k), torch.int32)
            blk.head = {f: mk((spd, n) + s, dt)
                        for f, (s, dt) in spec.items()}
            blk.head_vc = mk((spd, n, d), torch.int32)
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
        #: (shard, row) pairs written since the last CHECKPOINT capture —
        #: the delta link's dirty window (independent of the serving
        #: windows above).  None = untracked (past the cap, or an
        #: out-of-band mutation): the next stamp must be a full rebase
        self._ckpt_dirty: "set | None" = set()

    #: checkpoint dirty windows larger than this stop tracking: a delta
    #: link carrying most of the table costs what a rebase costs
    _CKPT_DIRTY_CAP = 262144

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    @property
    def placed(self) -> bool:
        return self._spd is not None

    def _route(self, shards: np.ndarray):
        """(block, sel, local shards) for every block a batch of shard ids
        touches, ``sel`` the batch positions it holds (None: the whole
        batch in order — the unplaced table's one block)."""
        if self._spd is None:
            return ((self.blocks[0], None, shards),)
        if len(shards) == 0:
            return ((self.blocks[0], np.zeros(0, np.int64), shards),)
        bs = shards // self._spd
        out = []
        for i in np.unique(bs).tolist():
            sel = np.nonzero(bs == i)[0]
            blk = self.blocks[i]
            out.append((blk, sel, shards[sel] - blk.off))
        return out

    def place(self, sharding) -> None:
        """Move the table's tensors into ``sharding``'s blocks (None: one
        block over every shard on the current first device).  Frozen
        copies cut from the old placement die with it; the checkpoint
        window survives (placement moves no row and changes no content)."""
        old = self.blocks
        devices = ([self.device] if sharding is None
                   else list(sharding.devices))
        spd = (self.n_shards if sharding is None
               else sharding.shards_per_block(self.n_shards))

        def piece(get, lo, hi, dev):
            parts = []
            for ob in old:
                a, b = max(lo, ob.off), min(hi, ob.off + ob.n)
                if a < b:
                    parts.append(get(ob)[a - ob.off:b - ob.off].to(dev))
            return parts[0] if len(parts) == 1 else torch.cat(parts)

        blocks = []
        for i, dev in enumerate(devices):
            blk = Block(i, dev, i * spd, spd)
            lo, hi = blk.off, blk.off + spd
            for grp in ROW_GROUPS:
                setattr(blk, grp, {
                    f: piece(lambda ob, g=grp, f=f: getattr(ob, g)[f],
                             lo, hi, dev)
                    for f in getattr(old[0], grp)})
            for name in ROW_TENSORS:
                setattr(blk, name, piece(
                    lambda ob, n_=name: getattr(ob, n_), lo, hi, dev))
            blocks.append(blk)
        self.blocks = blocks
        self.sharding = sharding
        self._spd = None if sharding is None else spd
        self.device = devices[0]
        ck = self._ckpt_dirty
        self.invalidate_epochs()
        self._ckpt_dirty = ck

    def block_of(self, shard: int) -> Tuple[Block, int]:
        """(block, local shard) holding ``shard``."""
        if self._spd is None:
            return self.blocks[0], int(shard)
        blk = self.blocks[int(shard) // self._spd]
        return blk, int(shard) - blk.off

    def _on(self, blk: Block):
        """Tag the kernel launches of a placed table's block work."""
        if self._spd is None:
            return contextlib.nullcontext()
        return cuda_kernels.on_block(blk.i)

    def _merge(self, parts, n: int):
        """One result from per-block device results [(sel, tensor or
        field dict)]: the unplaced table's one tensor as is, else
        ``BlockParts`` in input order."""
        if self._spd is None:
            return parts[0][1]
        pos = [sel for sel, _ in parts]
        first = parts[0][1]
        if isinstance(first, dict):
            return {f: BlockParts([x[f] for _, x in parts], pos, n)
                    for f in first}
        return BlockParts([x for _, x in parts], pos, n)

    @staticmethod
    def _host_merge(parts, n: int) -> np.ndarray:
        """One host array in input order from per-block host arrays."""
        if len(parts) == 1 and parts[0][0] is None:
            return parts[0][1]
        first = parts[0][1]
        out = np.empty((n,) + first.shape[1:], first.dtype)
        for sel, x in parts:
            out[sel] = x
        return out

    def _at(self, head, head_vc, blk: Block):
        """A frozen (head, head_vc) source's tensors on ``blk`` (frozen
        copies of a placed table are per-block lists)."""
        if self._spd is None:
            return head, head_vc
        return head[blk.i], head_vc[blk.i]

    def shard_arrays(self, shard: int) -> dict:
        """Views of one shard's rows of every tensor ([N, ...], on the
        device of its block): ``snap`` and ``head`` as field dicts, the
        ``ROW_TENSORS`` by name.  Writes through them land in the table."""
        blk, ls = self.block_of(shard)
        out = {g: {f: x[ls] for f, x in getattr(blk, g).items()}
               for g in ROW_GROUPS}
        out.update({name: getattr(blk, name)[ls] for name in ROW_TENSORS})
        return out

    def full_shape(self, name: str, field: str | None = None) -> tuple:
        """The logical [P, N, ...] shape of tensor ``name`` (a field of the
        group ``name`` when ``field`` is given)."""
        x = getattr(self.blocks[0], name)
        x = x if field is None else x[field]
        return (self.n_shards,) + tuple(x.shape[1:])

    def host_full(self, name: str, field: str | None = None) -> np.ndarray:
        """Tensor ``name`` (or group field) whole, [P, N, ...], on the
        host."""
        hs = []
        for blk in self.blocks:
            x = getattr(blk, name)
            hs.append((x if field is None else x[field]).cpu().numpy())
        return hs[0] if len(hs) == 1 else np.concatenate(hs)

    def put_full(self, name: str, arr: np.ndarray,
                 field: str | None = None) -> None:
        """Replace tensor ``name`` (or group field) with a whole [P, N, ...]
        host array: one copy a block to its device."""
        for blk in self.blocks:
            x = getattr(blk, name)
            dst = x if field is None else x[field]
            part = arr if self._spd is None else arr[blk.off:blk.off + blk.n]
            new = torch.from_numpy(part).to(device=blk.device,
                                            dtype=dst.dtype)
            if field is None:
                setattr(blk, name, new)
            else:
                x[field] = new

    def head_vc_at(self, shards, rows) -> np.ndarray:
        """The head VCs of (shard, row) pairs on the host: one gather a
        block, each block's gather launched before the first host copy."""
        shards = np.asarray(shards, np.int64)
        rows = np.asarray(rows, np.int64)
        parts = []
        for blk, sel, ls in self._route(shards):
            ss, rr = blk.idx_async(ls), blk.idx_async(_take(rows, sel))
            parts.append((sel, blk.head_vc[ss, rr]))
        return self._host_merge([(sel, x.cpu().numpy())
                                 for sel, x in parts], len(rows))

    def row_state(self, head, shard: int, row: int) -> dict:
        """One row's state on the host, from a frozen head (a serving slot
        or table epoch) or, with ``head`` None, from the live head."""
        blk, ls = self.block_of(shard)
        if head is None:
            head = blk.head
        elif self._spd is not None:
            head = head[blk.i]
        return {f: x[ls, row].cpu().numpy() for f, x in head.items()}

    def routed_gather(self, head, head_vc, shards, rows):
        """The epoch plane's gather of a placed table: each block gathers
        and resolves its own rows from its own slice of a frozen (head,
        head_vc) source, with no host sync; the resolved fields come back
        as ``BlockParts`` in input order."""
        shards = np.asarray(shards, np.int64)
        rows = np.asarray(rows, np.int64)
        parts = []
        for blk, sel, ls in self._route(shards):
            idx = blk.idx_async(np.stack([ls, _take(rows, sel)]))
            h, hvc = self._at(head, head_vc, blk)
            with self._on(blk):
                parts.append((sel, self.latest_resolved_flat(h, hvc, idx[0],
                                                             idx[1])))
        return self._merge(parts, len(rows))

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
        """Clones of the live head: (fields, head_vc), per-block lists of
        them for a placed table."""
        if self._spd is None:
            return ({f: x.clone() for f, x in self.head.items()},
                    self.head_vc.clone())
        return ([{f: x.clone() for f, x in blk.head.items()}
                 for blk in self.blocks],
                [blk.head_vc.clone() for blk in self.blocks])

    def freeze_serving(self, can_donate: bool, force_copy: bool = False):
        """Freeze the live head into the spare serving slot and make it
        current.  Returns (slot, mode, touched, rows, shard_rows): mode
        "scatter" (the ``rows`` rows appended since the spare's freeze are
        written into it in place) or "copy" (the whole head cloned).
        ``touched`` is the frozenset of rows appended since the previous
        freeze (the snapshot cache's validity window; the scatter set spans
        two windows, one per slot), or None when unknown.  ``shard_rows``
        maps shard -> rows re-frozen in it for a placed table's scatter,
        which writes only the blocks that own dirty rows (the mesh plane's
        per-shard publish count); None for a copy and for an unplaced
        table.

        Returns None when the freeze must be DEFERRED: the spare may still
        be read by a pinned epoch (``can_donate`` false).  ``force_copy``
        builds fresh tensors instead — required when the spare is the LIVE
        epoch's slot (waiting would never free it).

        Caller must hold the commit lock (no concurrent appends)."""
        spare_i = 1 - self._serving_cur
        spare = self._serving[spare_i]
        dirty = self._serving_spare_dirty
        shard_rows = None
        if force_copy or spare is None or dirty is None:
            head, head_vc = self._frozen_copy()
            mode, rows = "copy", self.n_shards * self.n_rows
        elif not can_donate:
            return None
        else:
            # the spare's tensors are rewritten in place: index_put_ of
            # the dirty rows' live state (the JAX package donates them),
            # each block's rows on its own device
            pairs = sorted(dirty)
            shards = np.asarray([p[0] for p in pairs], np.int64)
            rows_ = np.asarray([p[1] for p in pairs], np.int64)
            head, head_vc = spare["head"], spare["head_vc"]
            for blk, sel, ls in self._route(shards):
                ss, rr = blk.idx(ls), blk.idx(_take(rows_, sel))
                h, hvc = self._at(head, head_vc, blk)
                for f, x in h.items():
                    x[ss, rr] = blk.head[f][ss, rr]
                hvc[ss, rr] = blk.head_vc[ss, rr]
            mode, rows = "scatter", len(pairs)
            if self._spd is not None:
                shard_rows = {}
                for sh in shards.tolist():
                    shard_rows[sh] = shard_rows.get(sh, 0) + 1
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
        return slot, mode, touched, rows, shard_rows

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
        for blk, sel, ls in self._route(shards):
            ss, rr = blk.idx_async(ls), blk.idx_async(_take(rows, sel))
            for grp in ROW_GROUPS:
                for x in getattr(blk, grp).values():
                    x[ss, rr] = 0
            for name in ROW_TENSORS:
                getattr(blk, name)[ss, rr] = 0
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

        # every block grows together: a row id means the same extent on
        # every block
        for blk in self.blocks:
            blk.snap = {f: grow(x) for f, x in blk.snap.items()}
            blk.head = {f: grow(x) for f, x in blk.head.items()}
            for name in ROW_TENSORS:
                setattr(blk, name, grow(getattr(blk, name)))
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
        for blk, sel, ls in self._route(shards):
            ss, rr = blk.idx(ls), blk.idx(_take(rows, sel))
            sl = blk.idx(_take(slots, sel))
            dev = blk.device
            blk.ops_a[ss, rr, sl] = torch.as_tensor(_take(eff_a, sel),
                                                    device=dev)
            blk.ops_b[ss, rr, sl] = torch.as_tensor(_take(eff_b, sel),
                                                    device=dev)
            blk.ops_vc[ss, rr, sl] = torch.as_tensor(_take(vcs, sel),
                                                     device=dev)
            blk.ops_origin[ss, rr, sl] = torch.as_tensor(
                _take(origins, sel), device=dev)
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
        for blk, sel, ls in self._route(shards):
            starts_b, ends_b = _take(starts, sel), _take(ends, sel)
            ss, rr = blk.idx(ls), blk.idx(_take(rows, sel))
            st, en = blk.idx(starts_b), blk.idx(ends_b)
            state = {f: x[ss, rr] for f, x in blk.head.items()}
            hvc = blk.head_vc[ss, rr]
            for slot in range(int(starts_b.min()), int(ends_b.max())):
                include = (st <= slot) & (slot < en)
                op_vc = blk.ops_vc[ss, rr, slot]
                new = self.ty.apply(self.cfg, state, blk.ops_a[ss, rr, slot],
                                    blk.ops_b[ss, rr, slot], op_vc,
                                    blk.ops_origin[ss, rr, slot])
                state = fold_mod.where_rows(include, new, state)
                hvc = torch.where(include[:, None],
                                  torch.maximum(hvc, op_vc), hvc)
            for f, x in blk.head.items():
                x[ss, rr] = state[f]
            blk.head_vc[ss, rr] = hvc

    def gc(self, shards, rows):
        """Fold the given keys' rings into a fresh snapshot version: the
        head already is that fold, so it is copied over the oldest
        version; the rings restart empty."""
        shards = np.asarray(shards, np.int64)
        rows = np.asarray(rows, np.int64)
        count = len(rows)
        if count == 0:
            return
        n0 = self.next_seq
        self.next_seq += count
        for blk, sel, ls in self._route(shards):
            ss, rr = blk.idx(ls), blk.idx(_take(rows, sel))
            # sequence ids in batch order, whatever block a row is on
            seqs = (torch.arange(n0, n0 + count, dtype=torch.int64,
                                 device=blk.device) if sel is None
                    else blk.idx(n0 + sel))
            slot = orddict.insert_slot(blk.snap_seq[ss, rr]).long()
            for f, x in blk.snap.items():
                x[ss, rr, slot] = blk.head[f][ss, rr]
            blk.snap_vc[ss, rr, slot] = blk.head_vc[ss, rr]
            blk.snap_seq[ss, rr, slot] = seqs
        self.n_ops[shards, rows] = 0

    # ------------------------------------------------------------------
    # checkpoint capture and install
    # ------------------------------------------------------------------
    def copy_head(self, n_rows: int):
        """Device copies of ``head`` and ``head_vc`` over the first
        ``n_rows`` rows of every shard: (fields, head_vc).  Issued on the
        table's stream with no host sync, so a checkpoint stamp can take
        them under the commit lock: a later in-place commit is queued
        behind the copies, and the host copy runs outside the lock.  A
        placed table's copies are ``BlockParts`` (one clone a block, in
        shard order)."""
        if self._spd is None:
            return ({f: x[:, :n_rows].clone() for f, x in self.head.items()},
                    self.head_vc[:, :n_rows].clone())
        return ({f: BlockParts([blk.head[f][:, :n_rows].clone()
                                for blk in self.blocks])
                 for f in self.blocks[0].head},
                BlockParts([blk.head_vc[:, :n_rows].clone()
                            for blk in self.blocks]))

    def gather_rows(self, shards, rows):
        """Device copies of (head fields, head_vc) at the given (shard,
        row) pairs, with no host sync (the delta stamp's capture)."""
        shards = np.asarray(shards, np.int64)
        rows = np.asarray(rows, np.int64)
        heads, hvcs = [], []
        for blk, sel, ls in self._route(shards):
            ss = blk.idx_async(ls)
            rr = blk.idx_async(_take(rows, sel))
            heads.append((sel, {f: x[ss, rr] for f, x in blk.head.items()}))
            hvcs.append((sel, blk.head_vc[ss, rr]))
        return self._merge(heads, len(rows)), self._merge(hvcs, len(rows))

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

    def _row_stage(self, blk: Block) -> dict:
        """Staging buffers for one row's install on ``blk``, built once a
        block: a host buffer (pinned on a card) laid out as the row's head
        fields, its head_vc and its sequence id at 8-byte aligned offsets,
        the device buffer it is copied to, and views of both."""
        st = blk.stage
        if st is None:
            specs = [(f, x.dtype, tuple(x.shape[2:]))
                     for f, x in blk.head.items()]
            specs += [("\0vc", torch.int32, (blk.head_vc.shape[-1],)),
                      ("\0seq", torch.int64, ())]
            off, lay = 0, {}
            for name, dt, shape in specs:
                off = (off + 7) // 8 * 8
                one = torch.empty((), dtype=dt)
                n = int(np.prod(shape, dtype=np.int64)) * one.element_size()
                lay[name] = (off, n, dt, one.numpy().dtype, shape)
                off += n
            host = torch.zeros(max(off, 8), dtype=torch.uint8)
            on_card = blk.device.type == "cuda"
            if on_card:
                host = host.pin_memory()
            dev = (torch.empty_like(host, device=blk.device) if on_card
                   else host)
            hnp = host.numpy()
            st = blk.stage = {
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
        blk, ls = self.block_of(s)
        st = self._row_stage(blk)
        if st["on_card"]:
            st["event"].synchronize()  # the last row's copy has read it
        hnp = st["np"]
        for f in blk.head:
            hnp[f][...] = np.asarray(head_rows[f])[0]
        hnp["\0vc"][...] = hvc
        hnp["\0seq"][...] = self.next_seq
        self.next_seq += 1
        if st["on_card"]:
            with torch.cuda.device(blk.device):
                st["dev"].copy_(st["host"], non_blocking=True)
                st["event"].record()
        v = st["view"]
        dst, src = [], []
        for f, x in blk.head.items():
            dst += [x[ls, r], blk.snap[f][ls, r, 0]]
            src += [v[f], v[f]]
        dst += [blk.head_vc[ls, r], blk.snap_vc[ls, r, 0],
                blk.snap_seq[ls, r, 0]]
        src += [v["\0vc"], v["\0vc"], v["\0seq"]]
        torch._foreach_copy_(dst, src)

    def _install_many(self, shards, rows, head_rows, hvc_rows) -> None:
        """Several rows (a delta link)."""
        m = len(rows)
        n0 = self.next_seq
        for blk, sel, ls in self._route(shards):
            ss, rr = blk.idx(ls), blk.idx(_take(rows, sel))
            dev = blk.device
            for f, x in blk.head.items():
                v = torch.as_tensor(_take(np.asarray(head_rows[f]), sel),
                                    device=dev)
                x[ss, rr] = v
                blk.snap[f][ss, rr, 0] = v
            hvc = torch.as_tensor(_take(hvc_rows, sel), device=dev)
            blk.head_vc[ss, rr] = hvc
            blk.snap_vc[ss, rr, 0] = hvc
            blk.snap_seq[ss, rr, 0] = (
                torch.arange(n0, n0 + m, dtype=torch.int64, device=dev)
                if sel is None else blk.idx(n0 + sel))
        self.next_seq += m

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------
    def _fold_strategy(self) -> str:
        return fold_strategy(self.ty)

    def _count_dispatch(self, strategy: str, n: int = 1) -> None:
        self.fold_dispatches[strategy] = (
            self.fold_dispatches.get(strategy, 0) + n)
        m = getattr(self.metrics, "fold_dispatch", None)
        if m is not None:
            m.inc(n, strategy=strategy)

    def _fold_block(self, blk: Block, ls, rows, read_vcs: torch.Tensor):
        """``read_block`` of M rows of ``blk`` (local shards ``ls``) at
        read VCs on its device."""
        ss, rr = blk.idx(ls), blk.idx(rows)
        n_ops = self.n_ops[ls + blk.off, rows]
        with self._on(blk):
            return read_block(self.ty, self.cfg, blk, ss, rr, n_ops,
                              read_vcs, self._fold_strategy())

    def read_latest(self, shards, rows, read_vcs):
        """Head gather.  Returns host copies (state fields [M, ...], fresh
        [M]); a row is fresh iff head_vc ≤ its read VC — then the head IS
        the exact snapshot.  Stale rows must use :meth:`read`."""
        shards = np.asarray(shards, np.int64)
        rows = np.asarray(rows, np.int64)
        read_vcs = np.array(read_vcs, np.int32)
        launched = []
        for blk, sel, ls in self._route(shards):
            ss, rr = blk.idx(ls), blk.idx(_take(rows, sel))
            vcs_t = torch.as_tensor(_take(read_vcs, sel), device=blk.device)
            fresh = vc.le(blk.head_vc[ss, rr], vcs_t)
            launched.append((sel, {f: x[ss, rr] for f, x in blk.head.items()},
                             fresh))
        n = len(rows)
        state = {f: self._host_merge([(sel, st[f].cpu().numpy())
                                      for sel, st, _ in launched], n)
                 for f in launched[0][1]}
        fresh = self._host_merge([(sel, fr.cpu().numpy())
                                  for sel, _, fr in launched], n)
        return state, fresh

    def read(self, shards, rows, read_vcs):
        """Versioned read of a flat batch at per-key read VCs (ring fold
        for every row).  Returns host copies (state fields [M, ...],
        n_applied [M], complete [M])."""
        shards = np.asarray(shards, np.int64)
        rows = np.asarray(rows, np.int64)
        read_vcs = np.array(read_vcs, np.int32)
        launched = []
        for blk, sel, ls in self._route(shards):
            vcs_t = torch.as_tensor(_take(read_vcs, sel), device=blk.device)
            launched.append((sel, self._fold_block(blk, ls, _take(rows, sel),
                                                   vcs_t)))
        n = len(rows)
        state = {f: self._host_merge([(sel, r[0][f].cpu().numpy())
                                      for sel, r in launched], n)
                 for f in launched[0][1][0]}
        return (state,
                self._host_merge([(sel, r[1].cpu().numpy())
                                  for sel, r in launched], n),
                self._host_merge([(sel, r[2].cpu().numpy())
                                  for sel, r in launched], n))

    def _gather(self, head, head_vc, ss, rr, vcs_t=None):
        """Gather M rows from one (head, head_vc) source of one block — the
        live head, a table epoch or a serving slot — as device tensors,
        with no host sync: (state fields [M, ...], fresh bool[M] or None).
        Freshness (the source head VC ≤ the read VC: then the gathered
        state IS the row's exact snapshot) is computed only when ``vcs_t``
        is given."""
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
        source of one block: resolved fields [M, ...] on its device, no
        host sync.  Types without a ``resolve_spec`` return the full
        state."""
        return self._resolve(self._gather(head, head_vc, ss, rr)[0])

    def read_resolved_flat(self, shards, rows, read_vcs):
        """The serving read.  Returns (resolved fields [M, ...] on the
        table's device — ``BlockParts`` for a placed table — fresh [M],
        complete [M] as host arrays), in input order.  For types without a
        ``resolve_spec`` the fields are the full state.  The ladder:

        1. the read VC dominates every commit → live head gather;
        2. the read VC is pinned exactly at a table epoch's cap → frozen
           head gather (writers advance the live head; pinned readers
           never see them);
        3. otherwise two-phase: gather (from the frozen epoch when one
           covers the VC, else the live head), check freshness on the
           host, and fold the ring ONLY for the stale remainder, merged
           over the gathered batch before the one resolve.

        Each step runs on every block the batch touches before the next
        step's first host copy."""
        shards = np.asarray(shards, np.int64)
        rows = np.asarray(rows, np.int64)
        read_vcs = np.array(read_vcs, np.int32)  # owned, writable copy
        n = len(rows)
        per = []
        for blk, sel, ls in self._route(shards):
            vcs_t = torch.as_tensor(_take(read_vcs, sel), device=blk.device)
            ss, rr = blk.idx(ls), blk.idx(_take(rows, sel))
            per.append((blk, sel, ls, vcs_t, ss, rr))
        all_fresh = np.ones(n, bool)
        src = None
        if not (read_vcs >= self.max_commit_vc).all():
            src = self._epoch_for(read_vcs)
            if src is None or not (read_vcs >= src["cap"]).all():
                return self._read_two_phase(per, src, rows, n)
            # pinned at the cap: every frozen row has head_vc ≤ cap = R
        resolved = []
        for blk, sel, _ls, _vcs, ss, rr in per:
            h, hvc = ((blk.head, blk.head_vc) if src is None else
                      self._at(src["head"], src["head_vc"], blk))
            with self._on(blk):
                resolved.append((sel, self.latest_resolved_flat(h, hvc, ss,
                                                                rr)))
        return self._merge(resolved, n), all_fresh, all_fresh

    def _read_two_phase(self, per, epoch, rows, n):
        """Rung 3 of :meth:`read_resolved_flat`."""
        self.slow_serves += 1
        gathered = []
        for blk, sel, _ls, vcs_t, ss, rr in per:
            src = ((blk.head, blk.head_vc) if epoch is None else
                   self._at(epoch["head"], epoch["head_vc"], blk))
            gathered.append(self._gather(*src, ss, rr, vcs_t))
        fresh_b = [fresh_t.cpu().numpy() for _, fresh_t in gathered]
        complete_b = [f.copy() for f in fresh_b]
        if any((~f).any() for f in fresh_b):
            self._count_dispatch(self._fold_strategy())
        folds = []
        for (blk, sel, ls, vcs_t, _ss, _rr), (state, _), fresh in zip(
                per, gathered, fresh_b):
            stale = np.nonzero(~fresh)[0]
            if not len(stale):
                folds.append(None)
                continue
            st = blk.idx(stale)
            folded, _, comp = self._fold_block(
                blk, ls[stale], _take(rows, sel)[stale], vcs_t[st])
            for f, x in state.items():
                x[st] = folded[f]
            folds.append((stale, comp))
        resolved = []
        for (blk, sel, *_), (state, _), complete, fold in zip(
                per, gathered, complete_b, folds):
            if fold is not None:
                complete[fold[0]] = fold[1].cpu().numpy()
            with self._on(blk):
                resolved.append((sel, self._resolve(state)))
        fresh = self._host_merge(
            [(p[1], f) for p, f in zip(per, fresh_b)], n)
        complete = self._host_merge(
            [(p[1], c) for p, c in zip(per, complete_b)], n)
        return self._merge(resolved, n), fresh, complete

    def read_resolved(self, shards, rows, read_vcs):
        """:meth:`read_resolved_flat` with the resolved fields copied to
        the host."""
        resolved, fresh, complete = self.read_resolved_flat(shards, rows,
                                                            read_vcs)
        return ({f: x.cpu().numpy() for f, x in resolved.items()}, fresh,
                complete)
