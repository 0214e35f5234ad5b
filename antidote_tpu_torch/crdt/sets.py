"""Set CRDTs.  This slice ports ``set_aw`` (the add-wins OR-set) only.

Each key has ``E = cfg.set_slots`` element slots; a slot holds the
element's blob handle plus two per-DC clock rows whose comparison decides
presence: present ⟺ ∃dc: add_vc[dc] > rm_vc[dc].  A remove's downstream
observes the current add_vc, so concurrent adds — whose dot the remove
could not have observed — survive.  Effects apply in causal order, so an
absent element's slot can be reclaimed by the next add: any later add is
either causally after the remove or concurrent with it, and present either
way.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from antidote_tpu_torch.crdt.base import (CRDTType, Effect, TopCountResolved,
                                          warn_overflow)
from antidote_tpu_torch.crdt.blob import EMPTY_HANDLE


def _elem_effects(op, make):
    kind, arg = op
    if kind.endswith("_all"):
        return [make(v) for v in arg]
    return [make(arg)]


def _first_true(mask):
    """(index of the first True along the last axis — 0 when none, as
    argmax gives —, whether any is True)."""
    return mask.to(torch.uint8).argmax(-1), mask.any(-1)


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
        e, d = cfg.set_slots, cfg.max_dcs
        return {
            "elems": ((e,), torch.int64),
            "addvc": ((e, d), torch.int32),
            "rmvc": ((e, d), torch.int32),
            "ovf": ((), torch.int32),  # adds dropped for lack of a free slot
        }

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
        # the observed-VC row at eff_b[1:1+d] carries the txn's tentative
        # own-lane stamp when the remove observed the txn's own add
        if int(eff_b[1 + my_dc]) == tentative_own:
            eff_b = np.array(eff_b, copy=True)
            eff_b[1 + my_dc] = commit_own
        return eff_a, eff_b

    def value(self, state, blobs, cfg):
        warn_overflow(self.name, int(np.asarray(state.get("ovf", 0))))
        elems = np.asarray(state["elems"])
        present = np.any(
            np.asarray(state["addvc"]) > np.asarray(state["rmvc"]), axis=-1
        ) & (elems != EMPTY_HANDLE)
        return sorted((blobs.resolve(int(h)) for h in elems[present]), key=repr)

    def resolve_spec(self, cfg):
        t = self.resolve_top
        return {"top": ((t,), torch.int64), "count": ((), torch.int32),
                "ovf": ((), torch.int32)}

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
        idx_match, has_match = _first_true((elems == h[:, None]) & occupied)
        present = (addvc > rmvc).any(-1) & occupied
        idx_free, has_free = _first_true(~present)

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
