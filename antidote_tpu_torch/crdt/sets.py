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

    def eff_b_width(self, cfg):
        return 1 + cfg.max_dcs

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

    def state_spec(self, cfg):
        return {"elems": ((cfg.set_slots,), torch.int64),
                "ovf": ((), torch.int32)}

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
