"""Carry store state across from the JAX package.

The counterpart of carrying weights across: a JAX ``TypedTable`` or
``KVStore`` hands over its arrays as numpy (under its own attribute
names) and these functions build the port's objects over the same state,
so both packages can be read side by side.  Only numpy crosses over;
nothing here imports the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.store.kv import KVStore, scaled_cfg, split_tier
from antidote_tpu_torch.store.typed_table import TypedTable

#: the table attributes that carry state, as named on both packages
TABLE_ARRAYS = ("snap", "snap_vc", "snap_seq", "ops_a", "ops_b", "ops_vc",
                "ops_origin", "n_ops", "head", "head_vc", "used_rows",
                "next_seq", "max_commit_vc")
_TENSORS = ("snap_vc", "snap_seq", "ops_a", "ops_b", "ops_vc", "ops_origin",
            "head_vc")


def table_arrays(table) -> Dict[str, Any]:
    """The state-carrying attributes of a table of either package as numpy
    (``snap``/``head`` as dicts of fields, ``next_seq`` an int); a placed
    port table's blocks come back assembled in shard order."""
    def host(x):
        if isinstance(x, torch.Tensor):
            return x.cpu().numpy()
        return np.array(x)

    out: Dict[str, Any] = {}
    placed = getattr(table, "placed", False)
    for name in TABLE_ARRAYS:
        if placed and name in ("snap", "head"):
            # a placed port table: its blocks assembled on the host
            out[name] = {f: table.host_full(name, f)
                         for f in table.blocks[0].head}
            continue
        if placed and name in _TENSORS:
            out[name] = table.host_full(name)
            continue
        x = getattr(table, name)
        out[name] = ({f: host(v) for f, v in x.items()}
                     if isinstance(x, dict) else host(x))
    out["next_seq"] = int(out["next_seq"])
    out["slots_ub"] = host(table.slots_ub)
    return out


def table_from_numpy(ty_name: str, cfg: AntidoteConfig,
                     arrays: Dict[str, Any], device="cuda") -> TypedTable:
    """A port ``TypedTable`` over a table's arrays (see ``TABLE_ARRAYS``;
    ``slots_ub`` is taken when present).  ``ty_name`` may carry a slot tier
    ("set_aw#1"); ``cfg`` is the store's base config."""
    base, tier = split_tier(ty_name)
    head_vc = np.asarray(arrays["head_vc"])
    t = TypedTable(get_type(base), scaled_cfg(cfg, tier),
                   n_rows=head_vc.shape[1], n_shards=head_vc.shape[0],
                   device=device)

    def dev(x):
        return torch.as_tensor(np.array(x), device=t.device)

    t.snap = {f: dev(x) for f, x in arrays["snap"].items()}
    t.head = {f: dev(x) for f, x in arrays["head"].items()}
    for name in _TENSORS:
        setattr(t, name, dev(arrays[name]))
    t.n_ops = np.array(arrays["n_ops"], np.int32)
    t.used_rows = np.array(arrays["used_rows"], np.int64)
    t.next_seq = int(arrays["next_seq"])
    t.max_commit_vc = np.array(arrays["max_commit_vc"], np.int32)
    if "slots_ub" in arrays:
        t.slots_ub = np.array(arrays["slots_ub"], np.int32)
    return t


def store_from_numpy(cfg: AntidoteConfig, tables: Dict[str, Dict[str, Any]],
                     directory: Dict[Tuple[Any, str], Tuple[str, int, int]],
                     applied_vc: np.ndarray, blobs: Dict[int, bytes],
                     device="cuda") -> KVStore:
    """A port ``KVStore`` over a store's state: ``tables`` maps each
    (tiered) table name to its arrays, ``directory`` is (key, bucket) ->
    (tiered name, shard, row), ``blobs`` handle -> payload bytes."""
    store = KVStore(cfg, device=device)
    for name, arrays in tables.items():
        store.tables[name] = table_from_numpy(name, cfg, arrays, device)
    store.directory.update(
        {dk: (str(e[0]), int(e[1]), int(e[2])) for dk, e in directory.items()})
    store.applied_vc = np.array(applied_vc, np.int32)
    for h, data in blobs.items():
        store.blobs.intern_bytes(int(h), data)
    return store
