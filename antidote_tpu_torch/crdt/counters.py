"""Counter CRDTs: counter_pn, counter_fat, counter_b.

``counter_pn`` is a plain PN counter; ``counter_fat`` a PN counter with
reset (per-DC lanes with reset epochs); ``counter_b`` the bounded (escrow)
counter: a rights matrix R and a used vector U, whose decrements the
transaction layer guards against the lane's held rights
(``txn/bcounter.py``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from antidote_tpu_torch.crdt.base import (CRDTType, Effect, lane_hit, pack_a,
                                          pack_b)


class CounterPN(CRDTType):
    """Positive-negative counter: state = one int64; effect = signed delta.
    The fold is a masked sum (``cuda_kernels.counter_fold``), so it is
    also a monoid: the assoc hooks sum in int64."""

    name = "counter_pn"
    commutative_blind = True
    type_id = 1
    supports_assoc = True

    def state_spec(self, cfg):
        return {"cnt": ((), torch.int64)}

    # -- associative fold over [B, L] op windows ------------------------
    def delta_of_ops(self, cfg, ops_a, ops_b, ops_vc, ops_origin, mask):
        return {"cnt": torch.where(mask, ops_a[..., 0], 0).sum(-1)}

    def delta_merge(self, a, b):
        return {"cnt": a["cnt"] + b["cnt"]}

    def delta_apply(self, state, d):
        return {"cnt": state["cnt"] + d["cnt"]}

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


class CounterFat(CRDTType):
    """PN counter with reset ("fat" counter).

    One accumulator lane per DC plus a per-lane epoch.  ``increment`` adds
    to the origin lane; ``reset`` subtracts the *observed* per-lane
    amounts and bumps the lane epoch, so a second reset that observed the
    same epoch is a no-op on that lane.  Increments concurrent with a
    reset land on top of the observed amount and survive.

    Effect lanes: eff_a = [inc_delta, observed_amt[0..D)];
    eff_b = [kind(0=inc,1=reset), observed_epoch[0..D)].
    """

    name = "counter_fat"
    commutative_blind = True
    type_id = 2

    def eff_a_width(self, cfg):
        return 1 + cfg.max_dcs

    def eff_b_width(self, cfg):
        return 1 + cfg.max_dcs

    def state_spec(self, cfg):
        d = cfg.max_dcs
        return {"amt": ((d,), torch.int64), "epoch": ((d,), torch.int32)}

    def is_operation(self, op):
        kind, arg = op
        if kind in ("increment", "decrement"):
            return isinstance(arg, int)
        return kind == "reset"

    def require_state_downstream(self, op):
        return op[0] == "reset"

    def downstream(self, op, state, blobs, cfg) -> List[Effect]:
        d = cfg.max_dcs
        a = np.zeros((self.eff_a_width(cfg),), dtype=np.int64)
        b = np.zeros((self.eff_b_width(cfg),), dtype=np.int32)
        kind, arg = op
        if kind in ("increment", "decrement"):
            a[0] = arg if kind == "increment" else -arg
            return [(a, b, [])]
        a[1: 1 + d] = np.asarray(state["amt"], dtype=np.int64)
        b[0] = 1
        b[1: 1 + d] = np.asarray(state["epoch"], dtype=np.int32)
        return [(a, b, [])]

    def restamp_own_dots(self, cfg, eff_a, eff_b, my_dc, tentative_own,
                         commit_own):
        # reset effects observe the per-lane epoch VC at eff_b[1:1+d]
        if int(eff_b[0]) == 1 and int(eff_b[1 + my_dc]) == tentative_own:
            eff_b = np.array(eff_b, copy=True)
            eff_b[1 + my_dc] = commit_own
        return eff_a, eff_b

    def value(self, state, blobs, cfg):
        return int(np.sum(np.asarray(state["amt"])))

    def resolve_spec(self, cfg):
        return {"value": ((), torch.int64)}

    def resolve(self, cfg, state):
        return {"value": state["amt"].sum(-1)}

    def value_from_resolved(self, resolved, blobs, cfg):
        return int(resolved["value"])

    def apply(self, cfg, state, eff_a, eff_b, commit_vc, origin_dc):
        amt, epoch = state["amt"], state["epoch"]
        d = amt.shape[-1]
        is_reset = (eff_b[:, 0] == 1)[:, None]
        inc_amt = torch.where(lane_hit(origin_dc, d), amt + eff_a[:, :1], amt)
        live = epoch == eff_b[:, 1: 1 + d]
        reset_amt = torch.where(live, amt - eff_a[:, 1: 1 + d], amt)
        reset_ep = torch.where(live, epoch + 1, epoch)
        return {"amt": torch.where(is_reset, reset_amt, inc_amt),
                "epoch": torch.where(is_reset, reset_ep, epoch)}


class CounterB(CRDTType):
    """Bounded (escrow) counter.

    State: rights matrix ``R[i, j]`` = rights minted at i (diagonal) or
    transferred from lane i to lane j, and ``U[i]`` = rights consumed by
    decrements at i.  value = Σ_i R[i,i] − Σ_i U[i]; rights held by lane
    i = R[i,i] + Σ_{j≠i} R[j,i] − Σ_{j≠i} R[i,j] − U[i].  Decrement
    safety (never below zero) is the transaction layer's escrow pass.

    Ops: ("increment", (n, dc)), ("decrement", (n, dc)),
    ("transfer", (n, to_dc, from_dc)).
    Effect lanes: eff_a = [n]; eff_b = [kind(0=inc,1=dec,2=xfer), src, dst].
    """

    name = "counter_b"
    type_id = 3

    def eff_b_width(self, cfg):
        return 3

    def state_spec(self, cfg):
        d = cfg.max_dcs
        return {"rights": ((d, d), torch.int64), "used": ((d,), torch.int64)}

    def is_operation(self, op):
        kind, arg = op
        if kind in ("increment", "decrement"):
            return isinstance(arg, tuple) and len(arg) == 2
        return kind == "transfer" and isinstance(arg, tuple) and len(arg) == 3

    def downstream(self, op, state, blobs, cfg) -> List[Effect]:
        bw = self.eff_b_width(cfg)
        kind, arg = op
        if kind == "transfer":
            n, to_dc, from_dc = arg
            lanes = [2, from_dc, to_dc]
        else:
            n, dc = arg
            lanes = [0 if kind == "increment" else 1, dc, dc]
        return [(pack_a(n, width=1), pack_b(lanes, width=bw), [])]

    def value(self, state, blobs, cfg):
        r = np.asarray(state["rights"])
        u = np.asarray(state["used"])
        return int(np.trace(r) - np.sum(u))

    def local_rights(self, state, dc: int) -> int:
        """Rights currently held by lane ``dc``."""
        r = np.asarray(state["rights"])
        u = np.asarray(state["used"])
        incoming = r[:, dc].sum() - r[dc, dc]
        outgoing = r[dc, :].sum() - r[dc, dc]
        return int(r[dc, dc] + incoming - outgoing - u[dc])

    def apply(self, cfg, state, eff_a, eff_b, commit_vc, origin_dc):
        rights, used = state["rights"], state["used"]
        d = used.shape[-1]
        n = eff_a[:, 0]
        kind = eff_b[:, 0]
        src, dst = lane_hit(eff_b[:, 1], d), lane_hit(eff_b[:, 2], d)
        nn = n[:, None, None]
        inc_r = rights + torch.where(src[:, :, None] & src[:, None], nn, 0)
        xfer_r = rights + torch.where(src[:, :, None] & dst[:, None], nn, 0)
        k3 = kind[:, None, None]
        return {
            "rights": torch.where(k3 == 0, inc_r,
                                  torch.where(k3 == 2, xfer_r, rights)),
            "used": torch.where((kind == 1)[:, None] & src,
                                used + n[:, None], used),
        }
