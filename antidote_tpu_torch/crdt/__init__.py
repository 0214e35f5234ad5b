"""CRDT type registry.

``is_type`` answers for every type name the JAX package registers; this
slice ports ``counter_pn`` and ``set_aw``, and ``get_type`` of any other
known name raises ``NotImplementedError`` naming it.
"""

from __future__ import annotations

from typing import Dict

from antidote_tpu_torch.crdt.base import CRDTType
from antidote_tpu_torch.crdt.blob import BlobStore
from antidote_tpu_torch.crdt.counters import CounterPN
from antidote_tpu_torch.crdt.sets import SetAW

#: every type name of the store's capability surface
TYPE_NAMES = (
    "counter_pn", "counter_fat", "counter_b", "register_lww", "register_mv",
    "set_aw", "set_rw", "set_go", "flag_ew", "flag_dw", "rga", "map_go",
    "map_rr",
)

TYPES: Dict[str, CRDTType] = {t.name: t for t in (CounterPN(), SetAW())}


def is_type(name: str) -> bool:
    return name in TYPE_NAMES


def get_type(name: str) -> CRDTType:
    t = TYPES.get(name)
    if t is not None:
        return t
    if name in TYPE_NAMES:
        raise NotImplementedError(
            f"CRDT type {name!r} is not ported to antidote_tpu_torch yet")
    raise KeyError(name)


__all__ = ["TYPES", "TYPE_NAMES", "is_type", "get_type", "BlobStore",
           "CRDTType"]
