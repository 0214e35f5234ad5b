"""The CRDT type behaviour — the plugin boundary of the store.

The same contract as the JAX package's ``crdt/base.py``, in PyTorch:

  * per-key state is a dict of fixed-shape tensors (``state_spec``)
  * a *downstream effect* is a pair of fixed-width lanes
    ``(eff_a: int64[A], eff_b: int32[B])`` made on the host from the
    client op (and, for observed-remove semantics, the current state)
  * ``apply`` folds one effect per key into a BATCH of keys' states; the
    materializer loops it over the op ring (the JAX package vmaps a
    per-key function instead)
  * ``value`` decodes a host copy of one key's state into the client value

Effects, not ops, are what the store's op rings hold.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt.blob import BlobStore

# One downstream effect, host-side: (eff_a int64 lanes, eff_b int32 lanes,
# list of (handle, payload-bytes) the effect references).
Effect = Tuple[np.ndarray, np.ndarray, List[Tuple[int, bytes]]]


class CRDTType(abc.ABC):
    """Behaviour implemented by every CRDT type."""

    #: wire/type-registry name, e.g. "counter_pn"
    name: str
    #: stable small integer id (the JAX package's ids)
    type_id: int
    #: True when the fold is an associative+commutative monoid: the type
    #: also provides ``delta_of_ops``/``delta_merge``/``delta_apply``, so a
    #: long op log reduces to one masked delta (``materializer/longlog.py``)
    supports_assoc: bool = False
    #: the assoc fold is exact only from a BOTTOM base state: the delta
    #: window replays slot claims in sequence order, which matches
    #: ``apply`` only when every slot starts empty (sets).  Ring folds
    #: serve from an arbitrary GC'd base and must not route these types
    #: through ``assoc_fold``
    assoc_bottom_only: bool = False
    #: the assoc fold also needs an all-adds window (set_aw: an
    #: observed-remove is order-sensitive against the adds around it)
    assoc_add_only: bool = False
    #: True for op-based types whose BLIND effects commute: an update with
    #: no state-dependent downstream from a txn that read nothing needs no
    #: first-committer-wins certification (the write-plane bypass)
    commutative_blind: bool = False
    #: how many value lanes ``resolve`` compacts multi-element values into
    resolve_top = 4

    # ---- host side ----------------------------------------------------

    def eff_a_width(self, cfg: AntidoteConfig) -> int:
        """int64 lanes per effect."""
        return 1

    def eff_b_width(self, cfg: AntidoteConfig) -> int:
        """int32 lanes per effect (may depend on max_dcs)."""
        return 1

    @abc.abstractmethod
    def state_spec(self, cfg: AntidoteConfig) -> Dict[str, Tuple[tuple, Any]]:
        """name -> (per-key shape suffix, torch dtype) of the state tensors."""

    def bottom(self, cfg: AntidoteConfig) -> Dict[str, np.ndarray]:
        """Host copy of the never-written state (Type:new())."""
        return {
            f: torch.zeros(shape, dtype=dt).numpy()
            for f, (shape, dt) in self.state_spec(cfg).items()
        }

    @abc.abstractmethod
    def is_operation(self, op: Tuple[str, Any]) -> bool:
        """Type-check a client update."""

    def require_state_downstream(self, op: Tuple[str, Any]) -> bool:
        """Whether downstream generation needs the current snapshot."""
        return False

    @abc.abstractmethod
    def downstream(
        self,
        op: Tuple[str, Any],
        state: Dict[str, np.ndarray] | None,
        blobs: BlobStore,
        cfg: AntidoteConfig,
    ) -> List[Effect]:
        """Turn a client op into downstream effect(s); ``state`` is a host
        copy of the key's materialized state when
        ``require_state_downstream``."""

    @abc.abstractmethod
    def value(
        self, state: Dict[str, np.ndarray], blobs: BlobStore, cfg: AntidoteConfig
    ) -> Any:
        """Client-visible value of a host state copy."""

    def stamp_op_seq(self, eff_a, eff_b, seq: int):
        """Number an effect within its transaction (per key).  Types whose
        apply derives identity from the commit clock alone (rga uids)
        carry the sequence in an effect lane so that same-commit ops stay
        distinguishable.  Default: unchanged."""
        return eff_a, eff_b

    def restamp_own_dots(self, cfg: AntidoteConfig, eff_a, eff_b,
                         my_dc: int, tentative_own: int, commit_own: int):
        """Rewrite dots an effect observed from the txn's OWN uncommitted
        writes (stamped with the tentative own-lane ts) to the real commit
        ts.  Default: the effect observes no dots — unchanged."""
        return eff_a, eff_b

    # ---- device side ---------------------------------------------------

    @abc.abstractmethod
    def apply(self, cfg: AntidoteConfig, state: Dict[str, torch.Tensor],
              eff_a, eff_b, commit_vc, origin_dc) -> Dict[str, torch.Tensor]:
        """Fold one effect per key into a batch of states.

        ``state`` fields are ``[B, *field_shape]``; ``eff_a`` int64[B, A],
        ``eff_b`` int32[B, Bw], ``commit_vc`` int32[B, D], ``origin_dc``
        integer[B].  Returns new tensors; the inputs are not modified."""

    def resolve_spec(self, cfg: AntidoteConfig):
        """Layout of the compact resolved value view, or ``None`` when the
        type has no device resolution."""
        return None

    def resolve(self, cfg: AntidoteConfig, state: Dict[str, torch.Tensor]):
        """Batched device value resolution over ``[M, ...]`` states."""
        raise NotImplementedError(f"{self.name} has no device resolution")

    def value_from_resolved(self, resolved, blobs: BlobStore,
                            cfg: AntidoteConfig) -> Any:
        """Client value from ONE key's compact resolved view, or
        :data:`RESOLVE_OVERFLOW` when the view was truncated."""
        raise NotImplementedError(f"{self.name} has no resolved decoding")

    # ---- slot accounting (the tier-promotion escape hatch) -------------

    def slot_capacity(self, cfg: AntidoteConfig):
        """Max element slots a key holds at ``cfg``'s widths, or ``None``
        for unslotted types."""
        return None

    def slot_demand(self, eff_a, eff_b) -> int:
        """How many fresh slots this one effect may claim (host, 0/1)."""
        return 0

    def used_slots(self, state: Dict[str, np.ndarray]) -> int:
        """Exact count of slots an incoming add cannot claim."""
        return 0


#: sentinel: the compact resolved view was truncated; re-fetch full state
RESOLVE_OVERFLOW = object()


def warn_overflow(type_name: str, ovf: int, stacklevel: int = 3) -> None:
    """Surface element-slot exhaustion (the device apply dropped ``ovf``
    ops)."""
    if ovf > 0:
        import warnings

        warnings.warn(
            f"{type_name}: {ovf} op(s) dropped — cfg slots exhausted "
            "for this key; increase the slot budget (data until then is "
            "truncated)",
            RuntimeWarning,
            stacklevel=stacklevel,
        )


def warn_overflow_state(type_name: str, state) -> None:
    """Slot-exhaustion warning from a full host state copy (the
    resolved-view twin lives in :class:`TopCountResolved`)."""
    warn_overflow(type_name, int(np.asarray(state.get("ovf", 0))),
                  stacklevel=4)


def value_from_top(resolved, blobs: BlobStore, top: int):
    """Decode a ``{top, count}`` view: the packed handles' values sorted by
    repr, or RESOLVE_OVERFLOW when the true count exceeds ``top``."""
    count = int(resolved["count"])
    if count > top:
        return RESOLVE_OVERFLOW
    handles = np.asarray(resolved["top"]).reshape(-1)
    return sorted(
        (blobs.resolve(int(h)) for h in handles if h != 0), key=repr
    )


def top_count_spec(top: int):
    """The ``{top, count, ovf}`` resolved view of slotted multi-element
    types."""
    return {"top": ((top,), torch.int64), "count": ((), torch.int32),
            "ovf": ((), torch.int32)}


class TopCountResolved:
    """Mixin for slotted multi-element types whose compact view is
    ``{top, count, ovf}``."""

    def value_from_resolved(self, resolved, blobs, cfg):
        v = value_from_top(resolved, blobs, self.resolve_top)
        if v is not RESOLVE_OVERFLOW:
            warn_overflow(self.name, int(np.asarray(resolved.get("ovf", 0))))
        return v


def compact_top(elems, present, top: int):
    """Compact a slotted multi-element view: ``elems`` int64[..., E],
    ``present`` bool[..., E] → (the first ``top`` present elements in slot
    order, zero-padded, int64[..., top]; the true count int32[...]).

    The order is a STABLE sort of the absent flag, as in the JAX package
    (torch does not sort bool, hence the uint8 key)."""
    order = torch.argsort((~present).to(torch.uint8), dim=-1,
                          stable=True)[..., :top]
    kept = torch.where(present, elems, torch.zeros_like(elems))
    return torch.gather(kept, -1, order), present.sum(-1, dtype=torch.int32)


def first_true(mask):
    """(index of the first True along the last axis — 0 when there is
    none, as ``jnp.argmax`` of a bool row gives —, whether any is True).
    The argmax runs on uint8: CUDA has no argmax of bool."""
    return mask.to(torch.uint8).argmax(-1), mask.any(-1)


def lane_hit(idx, width: int):
    """bool[B, width]: the lane a per-row index names, with the JAX
    package's scatter semantics: a negative index wraps once, and an index
    still out of range names no lane (the update is dropped)."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + width, idx)
    return torch.arange(width, device=idx.device) == idx[:, None]


def own_stamp(commit_vc, origin_dc):
    """int32[B]: each row's commit clock at its origin lane."""
    return commit_vc.gather(1, origin_dc.long()[:, None])[:, 0]


def raise_lane(row, origin_dc, commit_vc):
    """``row.at[origin_dc].max(commit_vc[origin_dc])`` per batch row:
    ``row`` int32[B, D] with its origin lane raised to the commit stamp."""
    hit = lane_hit(origin_dc, row.shape[-1])
    return torch.where(hit, torch.maximum(
        row, own_stamp(commit_vc, origin_dc)[:, None]), row)


def set_at(x, idx, val, do):
    """``x.at[idx].set(val)`` per batch row where ``do``: ``x`` [B, S,
    ...], ``idx`` int[B] (in range), ``val`` [B, ...], ``do`` bool[B]."""
    hit = (torch.arange(x.shape[1], device=x.device) == idx[:, None]) \
        & do[:, None]
    hit = hit.view(hit.shape + (1,) * (x.dim() - 2))
    return torch.where(hit, val[:, None], x)


def pack_a(*vals: int, width: int) -> np.ndarray:
    out = np.zeros((width,), dtype=np.int64)
    for i, v in enumerate(vals):
        out[i] = v
    return out


def pack_b(vals: Sequence[int], width: int) -> np.ndarray:
    out = np.zeros((width,), dtype=np.int32)
    for i, v in enumerate(vals):
        out[i] = v
    return out
