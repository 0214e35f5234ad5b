"""Register CRDTs: register_lww and register_mv.

``register_lww`` is last-writer-wins on a wall-clock timestamp carried in
the downstream effect; ``register_mv`` is multi-value: an assign
overwrites exactly the entries observed at downstream time, and
concurrent assigns coexist.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from antidote_tpu_torch.crdt.base import (CRDTType, Effect, TopCountResolved,
                                          compact_top, first_true, own_stamp,
                                          pack_a, pack_b, set_at,
                                          top_count_spec, warn_overflow_state)
from antidote_tpu_torch.crdt.blob import EMPTY_HANDLE


def _now_micros() -> int:
    return time.time_ns() // 1000


class RegisterLWW(CRDTType):
    """state = (value handle, timestamp); effect = (handle, ts).  Ties on
    ts break on the handle so that replicas converge."""

    name = "register_lww"
    type_id = 4

    def eff_a_width(self, cfg):
        return 2  # handle, ts

    def state_spec(self, cfg):
        return {"val": ((), torch.int64), "ts": ((), torch.int64)}

    def is_operation(self, op):
        return op[0] == "assign"

    def downstream(self, op, state, blobs, cfg) -> List[Effect]:
        h = blobs.intern(op[1])
        return [(pack_a(h, _now_micros(), width=2),
                 pack_b([], width=self.eff_b_width(cfg)),
                 [(h, blobs.bytes_of(h))])]

    def value(self, state, blobs, cfg):
        return blobs.resolve(int(state["val"]))

    def resolve_spec(self, cfg):
        return {"value": ((), torch.int64)}

    def resolve(self, cfg, state):
        # the handle; the host resolves it to the payload
        return {"value": state["val"]}

    def value_from_resolved(self, resolved, blobs, cfg):
        return blobs.resolve(int(resolved["value"]))

    def apply(self, cfg, state, eff_a, eff_b, commit_vc, origin_dc):
        h, ts = eff_a[:, 0], eff_a[:, 1]
        newer = (ts > state["ts"]) | ((ts == state["ts"]) & (h > state["val"]))
        return {"val": torch.where(newer, h, state["val"]),
                "ts": torch.where(newer, ts, state["ts"])}


class RegisterMV(TopCountResolved, CRDTType):
    """Multi-value register.

    Each live entry has a unique id ``(commit ts at origin << 8) |
    origin``.  An assign's downstream captures the ids observed at
    generation time; apply removes exactly those entries and inserts the
    new one.  Two concurrent assigns do not observe each other, so both
    survive.

    Effect lanes: eff_a = [handle, obs_id[0..mv_slots)].
    """

    name = "register_mv"
    type_id = 5

    def eff_a_width(self, cfg):
        return 1 + cfg.mv_slots

    def state_spec(self, cfg):
        k = cfg.mv_slots
        return {"vals": ((k,), torch.int64), "ids": ((k,), torch.int64),
                "ovf": ((), torch.int32)}

    def is_operation(self, op):
        return op[0] == "assign"

    def require_state_downstream(self, op):
        return True

    def downstream(self, op, state, blobs, cfg) -> List[Effect]:
        h = blobs.intern(op[1])
        a = np.zeros((self.eff_a_width(cfg),), dtype=np.int64)
        a[0] = h
        obs = np.asarray(state["ids"], dtype=np.int64)
        a[1: 1 + obs.shape[0]] = obs
        return [(a, pack_b([], width=self.eff_b_width(cfg)),
                 [(h, blobs.bytes_of(h))])]

    def restamp_own_dots(self, cfg, eff_a, eff_b, my_dc, tentative_own,
                         commit_own):
        # eff_a[1:] are observed entry ids packed (ts << 8) | dc
        tent_id = (int(tentative_own) << 8) | my_dc
        obs = np.asarray(eff_a[1:], dtype=np.int64)
        if (obs == tent_id).any():
            eff_a = np.array(eff_a, copy=True)
            eff_a[1:][obs == tent_id] = (int(commit_own) << 8) | my_dc
        return eff_a, eff_b

    def value(self, state, blobs, cfg):
        warn_overflow_state(self.name, state)
        vals = np.asarray(state["vals"])
        ids = np.asarray(state["ids"])
        return sorted((blobs.resolve(int(v)) for v, i in zip(vals, ids)
                       if i != 0), key=repr)

    def resolve_spec(self, cfg):
        return top_count_spec(self.resolve_top)

    def resolve(self, cfg, state):
        top, count = compact_top(state["vals"], state["ids"] != 0,
                                 self.resolve_top)
        return {"top": top, "count": count, "ovf": state["ovf"]}

    def slot_capacity(self, cfg):
        return cfg.mv_slots

    def slot_demand(self, eff_a, eff_b):
        return 1  # each assign inserts one entry (after dropping observed)

    def used_slots(self, state):
        return int((np.asarray(state["ids"]) != 0).sum())

    def apply(self, cfg, state, eff_a, eff_b, commit_vc, origin_dc):
        vals, ids = state["vals"], state["ids"]
        k = ids.shape[-1]
        obs = eff_a[:, 1: 1 + k]
        new_id = ((own_stamp(commit_vc, origin_dc).long() << 8)
                  | origin_dc.long())
        # drop the observed entries ([B, k, k] id match)
        observed = ((ids[:, :, None] == obs[:, None, :]).any(-1)
                    & (ids != 0))
        ids1 = torch.where(observed, 0, ids)
        vals1 = torch.where(observed, EMPTY_HANDLE, vals)
        # insert the new entry into the first free slot (ids are unique:
        # commit stamps are unique per origin)
        slot, has_free = first_true(ids1 == 0)
        return {
            "vals": set_at(vals1, slot, eff_a[:, 0], has_free),
            "ids": set_at(ids1, slot, new_id, has_free),
            "ovf": state["ovf"] + (~has_free).to(torch.int32),
        }
