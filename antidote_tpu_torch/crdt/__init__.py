"""CRDT type registry: the store's 13 types under the JAX package's
``type_id``s.  Maps (``map_rr``/``map_go``) are composites over the device
types, expanded and assembled by the transaction layer."""

from __future__ import annotations

from typing import Dict

from antidote_tpu_torch.crdt.base import CRDTType
from antidote_tpu_torch.crdt.blob import BlobStore
from antidote_tpu_torch.crdt.counters import CounterB, CounterFat, CounterPN
from antidote_tpu_torch.crdt.flags import FlagDW, FlagEW
from antidote_tpu_torch.crdt.maps import MapGO, MapRR
from antidote_tpu_torch.crdt.registers import RegisterLWW, RegisterMV
from antidote_tpu_torch.crdt.rga import RGA
from antidote_tpu_torch.crdt.sets import SetAW, SetGO, SetRW

TYPES: Dict[str, CRDTType] = {
    t.name: t for t in (
        CounterPN(), CounterFat(), CounterB(), RegisterLWW(), RegisterMV(),
        SetAW(), SetRW(), SetGO(), FlagEW(), FlagDW(), RGA(), MapGO(),
        MapRR())
}
TYPE_NAMES = tuple(TYPES)
#: the composite (map) type names
COMPOSITE_NAMES = frozenset(
    n for n, t in TYPES.items() if getattr(t, "composite", False))


def is_type(name: str) -> bool:
    return name in TYPES


def get_type(name: str) -> CRDTType:
    return TYPES[name]


__all__ = ["TYPES", "TYPE_NAMES", "COMPOSITE_NAMES", "is_type", "get_type",
           "BlobStore", "CRDTType"]
