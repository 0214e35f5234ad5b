"""Counter CRDTs.  This slice ports ``counter_pn`` only."""

from __future__ import annotations

from typing import List

import torch

from antidote_tpu_torch.crdt.base import CRDTType, Effect, pack_a, pack_b


class CounterPN(CRDTType):
    """Positive-negative counter: state = one int64; effect = signed delta.
    The fold is a masked sum (``cuda_kernels.counter_fold``)."""

    name = "counter_pn"
    commutative_blind = True
    type_id = 1

    def state_spec(self, cfg):
        return {"cnt": ((), torch.int64)}

    def is_operation(self, op):
        kind, arg = op
        return kind in ("increment", "decrement") and isinstance(arg, int)

    def downstream(self, op, state, blobs, cfg) -> List[Effect]:
        kind, n = op
        delta = n if kind == "increment" else -n
        return [(pack_a(delta, width=1),
                 pack_b([], width=self.eff_b_width(cfg)), [])]

    def value(self, state, blobs, cfg):
        return int(state["cnt"])

    def apply(self, cfg, state, eff_a, eff_b, commit_vc, origin_dc):
        return {"cnt": state["cnt"] + eff_a[:, 0]}

    def resolve_spec(self, cfg):
        return {"value": ((), torch.int64)}

    def resolve(self, cfg, state):
        return {"value": state["cnt"]}

    def value_from_resolved(self, resolved, blobs, cfg):
        return int(resolved["value"])
