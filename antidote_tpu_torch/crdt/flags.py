"""Flag CRDTs: flag_ew (enable-wins) and flag_dw (disable-wins).

The sets' dot pattern over a single implicit element:

  * flag_ew: enabled ⟺ ∃dc: en_vc[dc] > dis_vc[dc].  A disable observes the
    current enable dots and covers them; a concurrent enable survives.
  * flag_dw: enabled ⟺ enables exist ∧ en_vc ≥ dis_vc pointwise.  An enable
    covers the observed disables; a concurrent disable wins.

Both folds are elementwise clock maxima: a monoid, so a window of ops
also reduces to one delta (``_FlagAssocMixin``).
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


def _origin_rows(ops_vc, ops_origin):
    """(one-hot origin lanes bool[..., D], each op's own commit stamp
    int32[...]) of a [B, L] op window."""
    d = ops_vc.shape[-1]
    origin = ops_origin.long()
    onehot = torch.arange(d, device=ops_vc.device) == origin[..., None]
    own = ops_vc.gather(-1, origin[..., None])[..., 0]
    return onehot, own


class _FlagAssocMixin:
    """Both flags fold by elementwise clock max — an associative,
    commutative monoid from ANY base, so the ring fold may reduce a
    window of ops at once (``materializer/longlog.assoc_fold``)."""

    supports_assoc = True

    def delta_merge(self, a, b):
        return {"envc": torch.maximum(a["envc"], b["envc"]),
                "disvc": torch.maximum(a["disvc"], b["disvc"])}

    def delta_apply(self, state, d):
        return self.delta_merge(state, d)

    @staticmethod
    def _lane_max(sel, rows):
        """Lane max over the op axis of the rows ``sel`` picks (zero
        elsewhere): int32[B, L, D] -> int32[B, D]."""
        return torch.where(sel[..., None], rows, 0).amax(-2)


class FlagEW(_FlagAssocMixin, _FlagBase):
    name = "flag_ew"
    type_id = 9

    def delta_of_ops(self, cfg, ops_a, ops_b, ops_vc, ops_origin, mask):
        d = cfg.max_dcs
        enable = ops_b[..., 0] == _ENABLE
        onehot, own = _origin_rows(ops_vc, ops_origin)
        en = torch.where(onehot, own[..., None], 0)
        return {"envc": self._lane_max(mask & enable, en),
                "disvc": self._lane_max(mask & ~enable, ops_b[..., 1:1 + d])}

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


class FlagDW(_FlagAssocMixin, _FlagBase):
    name = "flag_dw"
    type_id = 10

    def delta_of_ops(self, cfg, ops_a, ops_b, ops_vc, ops_origin, mask):
        d = cfg.max_dcs
        enable = ops_b[..., 0] == _ENABLE
        onehot, own = _origin_rows(ops_vc, ops_origin)
        stamp = torch.where(onehot, own[..., None], 0)
        en = torch.maximum(ops_b[..., 1:1 + d], stamp)
        return {"envc": self._lane_max(mask & enable, en),
                "disvc": self._lane_max(mask & ~enable, stamp)}

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
