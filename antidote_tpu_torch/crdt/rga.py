"""RGA — replicated growable array (sequence CRDT).

A sequence with insert-at-index and delete that converges under concurrent
edits by the RGA rule: an insert lands immediately right of its causal left
origin, skipping over any sibling whose insertion dot is larger.

Dense layout per key (S = cfg.rga_slots), kept in list order:

  uid   int64[S]  insertion dot = (commit ts at origin << 24) | (op seq
                  within the txn << 8) | origin — the op-seq lane keeps
                  uids unique when one txn inserts several elements
  elem  int64[S]  value handle (0 = empty slot)
  tomb  int32[S]  1 = deleted (tombstones keep their place)
  ovf   int32     inserts dropped for lack of slots

Occupied slots are a prefix.  An insert is one vectorized shift: find the
insert position p (the first slot right of the origin whose uid is smaller
than the new dot, or empty), then ``new[i] = old[i-1]`` for i > p.

Downstream maps a client index (over visible elements) to the origin uid,
so it needs the state.  Ops: ("insert", (index, value)), ("delete",
index), ("add_right", (origin_uid, value)) for replay.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from antidote_tpu_torch.crdt.base import (CRDTType, Effect, first_true,
                                          own_stamp, set_at,
                                          warn_overflow_state)

_INSERT, _DELETE = 0, 1
_HEAD_UID = 0  # insert at the very front
#: the uid layout gives the op seq 16 bits (bits 8-23)
_MAX_OPS_PER_KEY = (1 << 16) - 1


class RGA(CRDTType):
    name = "rga"
    type_id = 11

    def eff_a_width(self, cfg):
        return 2  # [elem handle | target uid, origin uid]

    def eff_b_width(self, cfg):
        return 2  # [kind, op seq within the txn]

    def stamp_op_seq(self, eff_a, eff_b, seq: int):
        # the seq lane disambiguates the uids of same-commit inserts; past
        # 16 bits it would overflow into the ts field and corrupt the uid
        # order, so refuse
        if seq > _MAX_OPS_PER_KEY:
            raise OverflowError(
                f"rga: a single transaction may issue at most "
                f"{_MAX_OPS_PER_KEY} operations per key (got op #{seq})")
        eff_b = np.array(eff_b, copy=True)
        eff_b[1] = seq
        return eff_a, eff_b

    def state_spec(self, cfg):
        s = cfg.rga_slots
        return {"uid": ((s,), torch.int64), "elem": ((s,), torch.int64),
                "tomb": ((s,), torch.int32), "ovf": ((), torch.int32)}

    def is_operation(self, op):
        kind = op[0]
        if kind == "insert":
            return isinstance(op[1], tuple) and len(op[1]) == 2
        if kind == "delete":
            return isinstance(op[1], int)
        return kind == "add_right"

    def require_state_downstream(self, op):
        return op[0] in ("insert", "delete")

    @staticmethod
    def _visible_positions(state):
        uid = np.asarray(state["uid"])
        tomb = np.asarray(state["tomb"])
        return np.nonzero((uid != 0) & (tomb == 0))[0], uid

    def downstream(self, op, state, blobs, cfg) -> List[Effect]:
        kind = op[0]
        b = np.zeros((self.eff_b_width(cfg),), np.int32)
        a = np.zeros((2,), np.int64)
        if kind == "delete":
            visible, uid = self._visible_positions(state)
            idx = op[1]
            if idx < 0 or idx >= len(visible):
                raise IndexError(f"rga delete index {idx} out of range")
            b[0] = _DELETE
            a[0] = uid[visible[idx]]
            return [(a, b, [])]
        if kind == "insert":
            idx, value = op[1]
            visible, uid = self._visible_positions(state)
            if idx < 0 or idx > len(visible):
                raise IndexError(f"rga insert index {idx} out of range")
            origin_uid = _HEAD_UID if idx == 0 else int(uid[visible[idx - 1]])
        else:  # add_right: an explicit origin uid (replay / wire form)
            origin_uid, value = op[1]
        h = blobs.intern(value)
        b[0] = _INSERT
        a[0] = h
        a[1] = origin_uid
        return [(a, b, [(h, blobs.bytes_of(h))])]

    def restamp_own_dots(self, cfg, eff_a, eff_b, my_dc, tentative_own,
                         commit_own):
        # a delete targets a uid in eff_a[0] (an insert's eff_a[0] is a
        # blob handle: never rewritten); an insert names its origin uid in
        # eff_a[1]
        def is_tent(u):
            return (u >> 24) == int(tentative_own) and (u & 0xFF) == my_dc

        def re(u):
            return (int(commit_own) << 24) | (u & 0xFFFFFF)

        is_delete = int(eff_b[0]) == _DELETE
        a0, a1 = int(eff_a[0]), int(eff_a[1])
        fix0 = is_delete and is_tent(a0)
        fix1 = (not is_delete) and is_tent(a1)
        if fix0 or fix1:
            eff_a = np.array(eff_a, copy=True)
            if fix0:
                eff_a[0] = re(a0)
            if fix1:
                eff_a[1] = re(a1)
        return eff_a, eff_b

    def slot_capacity(self, cfg):
        return cfg.rga_slots

    def slot_demand(self, eff_a, eff_b):
        return 1 if int(eff_b[0]) == _INSERT else 0

    def used_slots(self, state):
        # occupancy is a prefix (inserts shift right); tombstones keep
        # their slot
        return int((np.asarray(state["uid"]) != 0).sum())

    def value(self, state, blobs, cfg):
        warn_overflow_state(self.name, state)
        visible, _ = self._visible_positions(state)
        elems = np.asarray(state["elem"])
        return [blobs.resolve(int(elems[i])) for i in visible]

    def apply_host(self, cfg, state, eff_a, eff_b, commit_vc, origin_dc):
        """numpy twin of :meth:`apply` for one key, for the write-set
        overlay: a transaction's Nth insert costs a few array ops on the
        host instead of device launches.  Semantically identical to
        ``apply`` (held together on random op tapes in the tests)."""
        s = np.asarray(state["uid"]).shape[0]
        uid = np.asarray(state["uid"])
        elem = np.asarray(state["elem"])
        tomb = np.asarray(state["tomb"])
        ovf = np.asarray(state["ovf"])
        if int(eff_b[0]) == _DELETE:
            hit = np.nonzero(uid == int(eff_a[0]))[0]
            if hit.size:
                tomb = tomb.copy()
                tomb[hit[0]] = 1
            return {"uid": uid, "elem": elem, "tomb": tomb, "ovf": ovf}
        h = int(eff_a[0])
        origin_uid = int(eff_a[1])
        new_uid = ((int(commit_vc[origin_dc]) << 24)
                   | (int(eff_b[1]) << 8) | int(origin_dc))
        occupied = uid != 0
        if origin_uid == _HEAD_UID:
            idx_origin, origin_ok = -1, True
        else:
            o_hit = np.nonzero(uid == origin_uid)[0]
            origin_ok = bool(o_hit.size)
            idx_origin = int(o_hit[0]) if origin_ok else 0
        cand = np.nonzero((np.arange(s) > idx_origin)
                          & ((uid < new_uid) | ~occupied))[0]
        if not (origin_ok and cand.size and not occupied[s - 1]):
            return {"uid": uid, "elem": elem, "tomb": tomb,
                    "ovf": ovf + np.int32(1)}
        p = int(cand[0])

        def shifted(arr, newval):
            out = arr.copy()
            out[p + 1:] = arr[p:-1]
            out[p] = newval
            return out

        return {"uid": shifted(uid, new_uid), "elem": shifted(elem, h),
                "tomb": shifted(tomb, 0), "ovf": ovf}

    def apply(self, cfg, state, eff_a, eff_b, commit_vc, origin_dc):
        uid, elem, tomb = state["uid"], state["elem"], state["tomb"]
        s = uid.shape[-1]
        kind = eff_b[:, 0]
        pos = torch.arange(s, device=uid.device)

        # ---- delete: tombstone the target uid
        t_idx, t_hit = first_true(uid == eff_a[:, :1])
        tomb_d = set_at(tomb, t_idx, torch.ones_like(tomb[:, 0]), t_hit)

        # ---- insert (commit stamps are int32: widen before the shift)
        h, origin_uid = eff_a[:, 0], eff_a[:, 1]
        new_uid = ((own_stamp(commit_vc, origin_dc).long() << 24)
                   | (eff_b[:, 1].long() << 8) | origin_dc.long())
        occupied = uid != 0
        o_idx, o_hit = first_true(uid == origin_uid[:, None])
        at_head = origin_uid == _HEAD_UID
        # an origin never inserted (not under causal delivery) drops the op
        origin_ok = at_head | o_hit
        idx_origin = torch.where(at_head, -1, o_idx)
        # the RGA rule: first slot right of the origin whose uid is smaller
        # than the new dot, or empty
        cand = ((pos > idx_origin[:, None])
                & ((uid < new_uid[:, None]) | ~occupied))
        p, has_pos = first_true(cand)
        # the last slot free: the shift drops nothing
        can = origin_ok & has_pos & ~occupied[:, s - 1]

        def shifted(arr, newval):
            out = torch.where(pos < p[:, None], arr,
                              torch.where(pos == p[:, None], newval[:, None],
                                          arr.roll(1, -1)))
            return torch.where(can[:, None], out, arr)

        is_del = (kind == _DELETE)[:, None]
        return {
            "uid": torch.where(is_del, uid, shifted(uid, new_uid)),
            "elem": torch.where(is_del, elem, shifted(elem, h)),
            "tomb": torch.where(is_del, tomb_d,
                                shifted(tomb, torch.zeros_like(tomb[:, 0]))),
            "ovf": state["ovf"] + ((kind == _INSERT) & ~can).to(torch.int32),
        }
