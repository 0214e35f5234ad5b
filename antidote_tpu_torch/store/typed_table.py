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


class TypedTable:
    """Host handle for one CRDT type's sharded device tensors."""

    def __init__(self, ty: CRDTType, cfg: AntidoteConfig,
                 n_rows: int | None = None, n_shards: int | None = None,
                 device="cuda"):
        self.ty = ty
        self.cfg = cfg
        self.device = resolve_device(device)
        #: per-strategy serving-fold dispatch counts
        self.fold_dispatches: Dict[str, int] = {}
        self.n_rows = n_rows or cfg.keys_per_table
        self.n_shards = n_shards or cfg.n_shards
        self.used_rows = np.zeros((self.n_shards,), np.int64)
        self.next_seq = 1
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

    # ------------------------------------------------------------------
    # row allocation / growth
    # ------------------------------------------------------------------
    def alloc_row(self, shard: int) -> int:
        if self.used_rows[shard] == self.n_rows:
            self._grow()
        r = int(self.used_rows[shard])
        self.used_rows[shard] += 1
        return r

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
    # reads
    # ------------------------------------------------------------------
    def _fold_strategy(self) -> str:
        """The ring fold for a read's stale rows: the hand-written kernel
        of the type where there is one (the plain version of the same
        function on a CPU table), the generic serial fold otherwise.
        ``counter_pn`` needs no delta-magnitude gate: ``counter_fold``
        sums in int64 (the TPU kernel's int32 sum needed one)."""
        if self.ty.name == "set_aw":
            return "kernel_set_aw"
        if self.ty.name == "counter_pn":
            return "kernel_counter"
        return "serial"

    def _count_dispatch(self, strategy: str) -> None:
        self.fold_dispatches[strategy] = (
            self.fold_dispatches.get(strategy, 0) + 1)

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
            fold = (cuda_kernels.set_aw_fold if strategy == "kernel_set_aw"
                    else lambda *a: fold_mod.fold_batch(self.ty, self.cfg, *a))
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

    def read_resolved_flat(self, shards, rows, read_vcs):
        """The serving read: head gather, freshness check, versioned ring
        fold of the stale rows only, device value resolution.  Returns
        (resolved fields [M, ...] on the table's device, fresh [M],
        complete [M] as host arrays), in input order.  For types without a
        ``resolve_spec`` the fields are the full state."""
        shards = np.asarray(shards, np.int64)
        rows = np.asarray(rows, np.int64)
        read_vcs, vcs_t = self._vcs(read_vcs)
        ss, rr = self._idx(shards), self._idx(rows)
        state = {f: x[ss, rr] for f, x in self.head.items()}
        if (read_vcs >= self.max_commit_vc).all():
            # the read VC dominates every commit: every row is fresh
            fresh = np.ones(len(rows), bool)
            complete = fresh
        else:
            fresh = vc.le(self.head_vc[ss, rr], vcs_t).cpu().numpy()
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
        if self.ty.resolve_spec(self.cfg) is not None:
            state = self.ty.resolve(self.cfg, state)
        return state, fresh, complete

    def read_resolved(self, shards, rows, read_vcs):
        """:meth:`read_resolved_flat` with the resolved fields copied to
        the host."""
        resolved, fresh, complete = self.read_resolved_flat(shards, rows,
                                                            read_vcs)
        return ({f: x.cpu().numpy() for f, x in resolved.items()}, fresh,
                complete)
