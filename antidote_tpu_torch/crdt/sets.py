"""Set CRDTs: set_aw (add-wins OR-set), set_rw (remove-wins), set_go.

Each key has ``E = cfg.set_slots`` element slots; a slot holds the
element's blob handle plus (set_aw, set_rw) two per-DC clock rows whose
comparison decides presence:

  * set_aw: present ⟺ ∃dc: add_vc[dc] > rm_vc[dc].  A remove's downstream
    observes the current add_vc, so concurrent adds — whose dot the remove
    could not have observed — survive.
  * set_rw: present ⟺ element exists ∧ some add ∧ add_vc ≥ rm_vc
    pointwise; an add's downstream observes the current rm_vc and covers
    it, so causally-past removes are overridden but concurrent removes
    win.
  * set_go: grow-only: a slot, once taken, never clears.

Effects apply in causal order, so an absent aw-element's slot can be
reclaimed by the next add: any later add is either causally after the
remove or concurrent with it, and present either way.  rw slots are
reclaimed only when fully empty, since a remove must out-survive
concurrent adds.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from antidote_tpu_torch.crdt.base import (CRDTType, Effect, TopCountResolved,
                                          compact_top, first_true, raise_lane,
                                          set_at, top_count_spec,
                                          warn_overflow_state)
from antidote_tpu_torch.crdt.blob import EMPTY_HANDLE


def _elem_effects(op, make):
    kind, arg = op
    if kind.endswith("_all"):
        return [make(v) for v in arg]
    return [make(arg)]


def _clock_slots_spec(cfg):
    """set_aw / set_rw state: element slots, each with an add and a
    remove clock row, and the count of ops dropped for lack of a slot."""
    e, d = cfg.set_slots, cfg.max_dcs
    return {
        "elems": ((e,), torch.int64),
        "addvc": ((e, d), torch.int32),
        "rmvc": ((e, d), torch.int32),
        "ovf": ((), torch.int32),
    }


def _dedup_window(w: int, hs, counts, rows=None):
    """Compress [B, L] handle sequences (possibly duplicated) into W-entry
    delta windows: first-occurrence-ordered distinct handles int64[B, W],
    per-handle summed ``counts`` int32[B, W], optional per-handle
    lane-maxed clock ``rows`` int32[B, W, D], and the op count that
    overflowed the window (``tail`` int32[B]) — the set types'
    associative-delta core.

    W passes, each claiming the sequence-FIRST unclaimed handle of every
    row and tagging all its occurrences with the window slot; ops whose
    handle never wins a slot keep the ``w`` sentinel and fall into
    ``tail``.  EMPTY_HANDLE marks a masked-out op."""
    valid = hs != EMPTY_HANDLE
    entry = torch.full(hs.shape, w, dtype=torch.int64, device=hs.device)
    remaining = valid
    elems_slots = []
    for slot in range(w):
        idx, any_left = first_true(remaining)  # first unclaimed position
        h = torch.where(any_left, hs.gather(-1, idx[:, None])[:, 0],
                        EMPTY_HANDLE)
        match = remaining & (hs == h[:, None])
        entry = torch.where(match, slot, entry)
        remaining = remaining & ~match
        elems_slots.append(h)
    elems = torch.stack(elems_slots, -1)
    # the sentinel column w collects the tail and the masked ops; dropped
    ent_idx = torch.where(valid, entry, w)
    cnt = counts.new_zeros((hs.shape[0], w + 1)).scatter_add_(
        1, ent_idx, counts)[:, :w]
    tail = torch.where(valid & (entry >= w), counts, 0).sum(
        -1, dtype=torch.int32)
    if rows is None:
        return elems, cnt, tail
    d = rows.shape[-1]
    vcs = rows.new_zeros((hs.shape[0], w + 1, d)).scatter_reduce_(
        1, ent_idx[..., None].expand(-1, -1, d), rows, "amax")[:, :w]
    return elems, cnt, tail, vcs


def _restamp_obs_row(eff_a, eff_b, my_dc, tentative_own, commit_own):
    """Rewrite the observed-VC row at eff_b[1:1+d] when its own lane
    carries the txn's tentative stamp (the observed-remove and remove-wins
    sets)."""
    if int(eff_b[1 + my_dc]) == tentative_own:
        eff_b = np.array(eff_b, copy=True)
        eff_b[1 + my_dc] = commit_own
    return eff_a, eff_b


class SetAW(TopCountResolved, CRDTType):
    """Add-wins OR-set.

    Effect lanes: eff_a = [handle]; eff_b = [kind(0=add,1=rm),
    observed_add_vc[0..D)] (observed row zero for adds).
    """

    name = "set_aw"
    commutative_blind = True
    type_id = 6
    # the ADD lane is a monoid: from a bottom base, an all-adds window
    # reduces to (first-occurrence handles, per-handle dot maxes) and
    # partial windows merge associatively.  Removes and warm bases are
    # order-sensitive (slot steals), so dispatchers gate on both flags.
    supports_assoc = True
    assoc_bottom_only = True
    assoc_add_only = True

    def eff_b_width(self, cfg):
        return 1 + cfg.max_dcs

    # -- associative add-lane fold over [B, L] windows ------------------
    # Exact from a bottom base, with no removes in the window, distinct
    # handles ≤ set_slots, and positive own commit dots.
    def delta_of_ops(self, cfg, ops_a, ops_b, ops_vc, ops_origin, mask):
        ok = mask & (ops_b[..., 0] == 0)  # defensive: adds only
        hs = torch.where(ok, ops_a[..., 0], EMPTY_HANDLE)
        origin = ops_origin.long()
        own = ops_vc.gather(-1, origin[..., None])[..., 0]
        onehot = torch.arange(cfg.max_dcs, device=ops_vc.device) \
            == origin[..., None]
        rows = torch.where(onehot & ok[..., None], own[..., None], 0)
        elems, cnt, tail, addvc = _dedup_window(
            cfg.set_slots, hs, ok.to(torch.int32), rows)
        return {"elems": elems, "counts": cnt, "addvc": addvc, "tail": tail}

    def delta_merge(self, a, b):
        w = a["elems"].shape[-1]
        elems, cnt, tail, addvc = _dedup_window(
            w, torch.cat([a["elems"], b["elems"]], -1),
            torch.cat([a["counts"], b["counts"]], -1),
            torch.cat([a["addvc"], b["addvc"]], -2))
        return {"elems": elems, "counts": cnt, "addvc": addvc,
                "tail": a["tail"] + b["tail"] + tail}

    def delta_apply(self, state, d):
        elems, addvc, rmvc = state["elems"], state["addvc"], state["rmvc"]
        ovf = state["ovf"] + d["tail"]
        for j in range(d["elems"].shape[-1]):
            h, cnt, row = d["elems"][:, j], d["counts"][:, j], d["addvc"][:, j]
            valid = h != EMPTY_HANDLE
            occupied = elems != EMPTY_HANDLE
            idx_match, has_match = first_true((elems == h[:, None])
                                              & occupied)
            present = (addvc > rmvc).any(-1) & occupied
            idx_free, has_free = first_true(~present)
            idx = torch.where(has_match, idx_match, idx_free)
            take = torch.arange(elems.shape[0], device=elems.device)
            keep = has_match[:, None]
            base_add = torch.where(keep, addvc[take, idx], 0)
            base_rm = torch.where(keep, rmvc[take, idx], 0)
            can = valid & (has_match | has_free)
            elems = set_at(elems, idx, h, can)
            addvc = set_at(addvc, idx, torch.maximum(base_add, row), can)
            rmvc = set_at(rmvc, idx, base_rm, can)
            ovf = ovf + torch.where(valid & ~can, cnt, 0)
        return {"elems": elems, "addvc": addvc, "rmvc": rmvc, "ovf": ovf}

    def state_spec(self, cfg):
        return _clock_slots_spec(cfg)

    def is_operation(self, op):
        return op[0] in ("add", "remove", "add_all", "remove_all")

    def require_state_downstream(self, op):
        return op[0] in ("remove", "remove_all", "reset")

    def downstream(self, op, state, blobs, cfg) -> List[Effect]:
        d = cfg.max_dcs
        bw = self.eff_b_width(cfg)
        kind = op[0]

        def make(value):
            h = blobs.intern(value)
            a = np.asarray([h], dtype=np.int64)
            b = np.zeros((bw,), dtype=np.int32)
            if kind.startswith("remove"):
                b[0] = 1
                hit = np.nonzero(np.asarray(state["elems"]) == h)[0]
                if hit.size:
                    b[1: 1 + d] = np.asarray(state["addvc"])[hit[0]]
            return (a, b, [(h, blobs.bytes_of(h))])

        return _elem_effects(op, make)

    def restamp_own_dots(self, cfg, eff_a, eff_b, my_dc, tentative_own,
                         commit_own):
        # the observed-VC row carries the txn's tentative own-lane stamp
        # when the remove observed the txn's own add
        return _restamp_obs_row(eff_a, eff_b, my_dc, tentative_own,
                                commit_own)

    def value(self, state, blobs, cfg):
        warn_overflow_state(self.name, state)
        elems = np.asarray(state["elems"])
        present = np.any(
            np.asarray(state["addvc"]) > np.asarray(state["rmvc"]), axis=-1
        ) & (elems != EMPTY_HANDLE)
        return sorted((blobs.resolve(int(h)) for h in elems[present]), key=repr)

    def resolve_spec(self, cfg):
        return top_count_spec(self.resolve_top)

    def resolve(self, cfg, state):
        """OR-set presence + top-K compaction: one ``orset_presence`` kernel
        launch on a CUDA state (``orset_resolve``), its plain version
        (presence, then ``compact_top``) on a CPU one."""
        from antidote_tpu_torch.materializer import cuda_kernels

        top, count = cuda_kernels.orset_resolve(
            state["elems"], state["addvc"], state["rmvc"], self.resolve_top)
        return {"top": top, "count": count, "ovf": state["ovf"]}

    def slot_capacity(self, cfg):
        return cfg.set_slots

    def slot_demand(self, eff_a, eff_b):
        return 1 if int(eff_b[0]) == 0 else 0  # adds may claim a slot

    def used_slots(self, state):
        # an add can reclaim any non-present slot (apply's free mask)
        present = np.any(
            np.asarray(state["addvc"]) > np.asarray(state["rmvc"]), axis=-1
        ) & (np.asarray(state["elems"]) != EMPTY_HANDLE)
        return int(present.sum())

    def apply(self, cfg, state, eff_a, eff_b, commit_vc, origin_dc):
        elems, addvc, rmvc = state["elems"], state["addvc"], state["rmvc"]
        d = addvc.shape[-1]
        rows = torch.arange(elems.shape[0], device=elems.device)
        h = eff_a[:, 0]
        is_rm = eff_b[:, 0] == 1
        obs = eff_b[:, 1: 1 + d]

        occupied = elems != EMPTY_HANDLE
        idx_match, has_match = first_true((elems == h[:, None]) & occupied)
        present = (addvc > rmvc).any(-1) & occupied
        idx_free, has_free = first_true(~present)

        # --- add: take the matching slot, else the first free slot, whose
        # rows start from zero; raise the origin lane to the commit stamp
        idx_add = torch.where(has_match, idx_match, idx_free)
        do_add = ~is_rm & (has_match | has_free)
        keep = has_match[:, None]
        row_add = torch.where(keep, addvc[rows, idx_add], 0)
        row_rm = torch.where(keep, rmvc[rows, idx_add], 0)
        origin = origin_dc.long()
        row_add[rows, origin] = torch.maximum(row_add[rows, origin],
                                              commit_vc[rows, origin])
        elems2, addvc2, rmvc2 = elems.clone(), addvc.clone(), rmvc.clone()
        elems2[rows, idx_add] = torch.where(do_add, h, elems[rows, idx_add])
        addvc2[rows, idx_add] = torch.where(do_add[:, None], row_add,
                                            addvc[rows, idx_add])
        rmvc2[rows, idx_add] = torch.where(do_add[:, None], row_rm,
                                           rmvc[rows, idx_add])

        # --- remove: raise the matching slot's rm row to the observed dots
        do_rm = (is_rm & has_match)[:, None]
        rm_row = torch.maximum(rmvc[rows, idx_match], obs)
        rmvc2[rows, idx_match] = torch.where(do_rm, rm_row,
                                             rmvc2[rows, idx_match])

        dropped = ~is_rm & ~(has_match | has_free)
        return {
            "elems": elems2,
            "addvc": addvc2,
            "rmvc": rmvc2,
            "ovf": state["ovf"] + dropped.to(torch.int32),
        }


class SetRW(TopCountResolved, CRDTType):
    """Remove-wins set.

    Effect lanes: eff_a = [handle]; eff_b = [kind(0=add,1=rm),
    observed_rm_vc[0..D)] (observed row zero for removes).
    """

    name = "set_rw"
    commutative_blind = True
    type_id = 7

    def eff_b_width(self, cfg):
        return 1 + cfg.max_dcs

    def state_spec(self, cfg):
        return _clock_slots_spec(cfg)

    def is_operation(self, op):
        return op[0] in ("add", "remove", "add_all", "remove_all")

    def require_state_downstream(self, op):
        return op[0] in ("add", "add_all")

    def downstream(self, op, state, blobs, cfg) -> List[Effect]:
        d = cfg.max_dcs
        bw = self.eff_b_width(cfg)
        kind = op[0]

        def make(value):
            h = blobs.intern(value)
            a = np.asarray([h], dtype=np.int64)
            b = np.zeros((bw,), dtype=np.int32)
            if kind.startswith("remove"):
                b[0] = 1
            else:
                hit = np.nonzero(np.asarray(state["elems"]) == h)[0]
                if hit.size:
                    b[1: 1 + d] = np.asarray(state["rmvc"])[hit[0]]
            return (a, b, [(h, blobs.bytes_of(h))])

        return _elem_effects(op, make)

    def restamp_own_dots(self, cfg, eff_a, eff_b, my_dc, tentative_own,
                         commit_own):
        return _restamp_obs_row(eff_a, eff_b, my_dc, tentative_own,
                                commit_own)

    def value(self, state, blobs, cfg):
        warn_overflow_state(self.name, state)
        elems = np.asarray(state["elems"])
        addvc, rmvc = np.asarray(state["addvc"]), np.asarray(state["rmvc"])
        present = ((elems != EMPTY_HANDLE) & np.any(addvc > 0, axis=-1)
                   & np.all(addvc >= rmvc, axis=-1))
        return sorted((blobs.resolve(int(h)) for h in elems[present]), key=repr)

    def resolve_spec(self, cfg):
        return top_count_spec(self.resolve_top)

    def resolve(self, cfg, state):
        elems, addvc, rmvc = state["elems"], state["addvc"], state["rmvc"]
        present = ((elems != EMPTY_HANDLE) & (addvc > 0).any(-1)
                   & (addvc >= rmvc).all(-1))
        top, count = compact_top(elems, present, self.resolve_top)
        return {"top": top, "count": count, "ovf": state["ovf"]}

    def slot_capacity(self, cfg):
        return cfg.set_slots

    def slot_demand(self, eff_a, eff_b):
        return 1  # adds and removes may both claim a slot (rw tombstones)

    def used_slots(self, state):
        # rw slots are reclaimed only when fully empty (apply's free mask)
        return int((np.asarray(state["elems"]) != EMPTY_HANDLE).sum())

    def apply(self, cfg, state, eff_a, eff_b, commit_vc, origin_dc):
        elems, addvc, rmvc = state["elems"], state["addvc"], state["rmvc"]
        d = addvc.shape[-1]
        rows = torch.arange(elems.shape[0], device=elems.device)
        h = eff_a[:, 0]
        is_rm = eff_b[:, 0] == 1
        free = elems == EMPTY_HANDLE
        idx_match, has_match = first_true((elems == h[:, None]) & ~free)
        idx_free, has_free = first_true(free)
        # adds and removes both take the matching slot, else the first
        # empty one (a remove creates its slot so it out-survives
        # concurrent adds)
        idx = torch.where(has_match, idx_match, idx_free)
        can = has_match | has_free
        keep = has_match[:, None]
        # add: cover the observed removes, stamp the own dot
        row_add = raise_lane(
            torch.maximum(torch.where(keep, addvc[rows, idx], 0),
                          eff_b[:, 1: 1 + d]), origin_dc, commit_vc)
        # remove: stamp the own dot on the rm row
        row_rm = raise_lane(torch.where(keep, rmvc[rows, idx], 0),
                            origin_dc, commit_vc)
        return {
            "elems": set_at(elems, idx, h, can),
            "addvc": set_at(addvc, idx, row_add, can & ~is_rm),
            "rmvc": set_at(rmvc, idx, row_rm, can & is_rm),
            "ovf": state["ovf"] + (~can).to(torch.int32),
        }


class SetGO(TopCountResolved, CRDTType):
    """Grow-only set: slots fill monotonically."""

    name = "set_go"
    commutative_blind = True
    type_id = 8
    # grow-only inserts from a bottom base are first-occurrence order —
    # the same delta-window monoid as set_aw's add lane, minus clocks
    supports_assoc = True
    assoc_bottom_only = True

    def state_spec(self, cfg):
        return {"elems": ((cfg.set_slots,), torch.int64),
                "ovf": ((), torch.int32)}

    # -- associative fold; exact from a bottom base with distinct handles
    # ≤ set_slots (see SetAW.delta_of_ops) ------------------------------
    def delta_of_ops(self, cfg, ops_a, ops_b, ops_vc, ops_origin, mask):
        hs = torch.where(mask, ops_a[..., 0], EMPTY_HANDLE)
        elems, cnt, tail = _dedup_window(cfg.set_slots, hs,
                                         mask.to(torch.int32))
        return {"elems": elems, "counts": cnt, "tail": tail}

    def delta_merge(self, a, b):
        w = a["elems"].shape[-1]
        elems, cnt, tail = _dedup_window(
            w, torch.cat([a["elems"], b["elems"]], -1),
            torch.cat([a["counts"], b["counts"]], -1))
        return {"elems": elems, "counts": cnt,
                "tail": a["tail"] + b["tail"] + tail}

    def delta_apply(self, state, d):
        elems = state["elems"]
        ovf = state["ovf"] + d["tail"]
        for j in range(d["elems"].shape[-1]):
            h, cnt = d["elems"][:, j], d["counts"][:, j]
            valid = h != EMPTY_HANDLE
            has_match = (elems == h[:, None]).any(-1)
            idx, has_free = first_true(elems == EMPTY_HANDLE)
            elems = set_at(elems, idx, h, valid & ~has_match & has_free)
            ovf = ovf + torch.where(valid & ~has_match & ~has_free, cnt, 0)
        return {"elems": elems, "ovf": ovf}

    def is_operation(self, op):
        return op[0] in ("add", "add_all")

    def downstream(self, op, state, blobs, cfg) -> List[Effect]:
        bw = self.eff_b_width(cfg)

        def make(value):
            h = blobs.intern(value)
            return (np.asarray([h], dtype=np.int64),
                    np.zeros((bw,), dtype=np.int32),
                    [(h, blobs.bytes_of(h))])

        return _elem_effects(op, make)

    def value(self, state, blobs, cfg):
        warn_overflow_state(self.name, state)
        elems = np.asarray(state["elems"])
        return sorted((blobs.resolve(int(h))
                       for h in elems[elems != EMPTY_HANDLE]), key=repr)

    def resolve_spec(self, cfg):
        return top_count_spec(self.resolve_top)

    def resolve(self, cfg, state):
        elems = state["elems"]
        top, count = compact_top(elems, elems != EMPTY_HANDLE,
                                 self.resolve_top)
        return {"top": top, "count": count, "ovf": state["ovf"]}

    def slot_capacity(self, cfg):
        return cfg.set_slots

    def slot_demand(self, eff_a, eff_b):
        return 1

    def used_slots(self, state):
        return int((np.asarray(state["elems"]) != EMPTY_HANDLE).sum())

    def apply(self, cfg, state, eff_a, eff_b, commit_vc, origin_dc):
        elems = state["elems"]
        h = eff_a[:, 0]
        has_match = (elems == h[:, None]).any(-1)
        idx, has_free = first_true(elems == EMPTY_HANDLE)
        return {
            "elems": set_at(elems, idx, h, ~has_match & has_free),
            "ovf": state["ovf"] + (~has_match & ~has_free).to(torch.int32),
        }
