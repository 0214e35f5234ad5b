"""Flag CRDTs: flag_ew (enable-wins) and flag_dw (disable-wins).

The sets' dot pattern over a single implicit element:

  * flag_ew: enabled ⟺ ∃dc: en_vc[dc] > dis_vc[dc].  A disable observes the
    current enable dots and covers them; a concurrent enable survives.
  * flag_dw: enabled ⟺ enables exist ∧ en_vc ≥ dis_vc pointwise.  An enable
    covers the observed disables; a concurrent disable wins.

Both folds are elementwise clock maxima.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from antidote_tpu_torch.crdt.base import CRDTType, Effect, raise_lane

_ENABLE, _DISABLE = 0, 1


class _FlagBase(CRDTType):
    commutative_blind = True

    def eff_b_width(self, cfg):
        return 1 + cfg.max_dcs

    def state_spec(self, cfg):
        d = cfg.max_dcs
        return {"envc": ((d,), torch.int32), "disvc": ((d,), torch.int32)}

    def is_operation(self, op):
        return op[0] in ("enable", "disable", "reset")

    def _effect(self, kind: int, observed, cfg) -> Effect:
        d = cfg.max_dcs
        b = np.zeros((self.eff_b_width(cfg),), dtype=np.int32)
        b[0] = kind
        if observed is not None:
            b[1: 1 + d] = np.asarray(observed, dtype=np.int32)
        return (np.zeros((1,), dtype=np.int64), b, [])

    def resolve_spec(self, cfg):
        return {"value": ((), torch.int32)}

    def value_from_resolved(self, resolved, blobs, cfg):
        return bool(int(resolved["value"]))


class FlagEW(_FlagBase):
    name = "flag_ew"
    type_id = 9

    def require_state_downstream(self, op):
        return op[0] in ("disable", "reset")

    def downstream(self, op, state, blobs, cfg) -> List[Effect]:
        if op[0] == "enable":
            return [self._effect(_ENABLE, None, cfg)]
        # disable and reset both cover the observed enables
        return [self._effect(_DISABLE, state["envc"], cfg)]

    def value(self, state, blobs, cfg):
        return bool(np.any(np.asarray(state["envc"])
                           > np.asarray(state["disvc"])))

    def resolve(self, cfg, state):
        on = (state["envc"] > state["disvc"]).any(-1)
        return {"value": on.to(torch.int32)}

    def apply(self, cfg, state, eff_a, eff_b, commit_vc, origin_dc):
        envc, disvc = state["envc"], state["disvc"]
        en = (eff_b[:, 0] == _ENABLE)[:, None]
        dis_new = torch.maximum(disvc, eff_b[:, 1: 1 + envc.shape[-1]])
        return {
            "envc": torch.where(en, raise_lane(envc, origin_dc, commit_vc),
                                envc),
            "disvc": torch.where(en, disvc, dis_new),
        }


class FlagDW(_FlagBase):
    name = "flag_dw"
    type_id = 10

    def require_state_downstream(self, op):
        return op[0] == "enable"

    def downstream(self, op, state, blobs, cfg) -> List[Effect]:
        if op[0] == "enable":
            return [self._effect(_ENABLE, state["disvc"], cfg)]
        return [self._effect(_DISABLE, None, cfg)]

    def value(self, state, blobs, cfg):
        envc = np.asarray(state["envc"])
        disvc = np.asarray(state["disvc"])
        return bool(np.any(envc > 0) and np.all(envc >= disvc))

    def resolve(self, cfg, state):
        envc, disvc = state["envc"], state["disvc"]
        on = (envc > 0).any(-1) & (envc >= disvc).all(-1)
        return {"value": on.to(torch.int32)}

    def apply(self, cfg, state, eff_a, eff_b, commit_vc, origin_dc):
        envc, disvc = state["envc"], state["disvc"]
        en = (eff_b[:, 0] == _ENABLE)[:, None]
        en_new = raise_lane(
            torch.maximum(envc, eff_b[:, 1: 1 + envc.shape[-1]]), origin_dc,
            commit_vc)
        return {
            "envc": torch.where(en, en_new, envc),
            "disvc": torch.where(en, disvc,
                                 raise_lane(disvc, origin_dc, commit_vc)),
        }
