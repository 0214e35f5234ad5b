"""Stable metadata: durable node KV + DC-wide broadcast.

The reference runs one ``stable_meta_data_server`` gen_server per node:
writes go to a local ETS + dets (disk) copy and are synchronously
broadcast to every node in the DC; ``broadcast_meta_data_merge`` folds a
user merge function over the existing value; on restart the table
reloads from dets.  ``dc_meta_data_utilities`` layers DC ids,
descriptors and env-var mirroring on top.

Here a ``MetaDataStore`` is the per-node server (msgpack file stands in
for dets) and ``MetaCluster`` is the intra-DC broadcast fabric (the Erlang
distribution layer between nodes of one DC).
"""

from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional

import msgpack


class MetaDataStore:
    """One node's durable metadata table."""

    def __init__(self, path: Optional[str] = None, node_id: int = 0):
        self.node_id = node_id
        self.path = path
        self._data: Dict[str, Any] = {}
        self._lock = threading.RLock()
        self._cluster: Optional["MetaCluster"] = None
        #: change listeners (key, value) -> None, fired on every local
        #: apply — the hook live components (log sync, cert flag) use to
        #: react to replicated flag flips without polling
        self._watchers: List[Callable[[str, Any], None]] = []
        if path is not None and os.path.exists(path) and os.path.getsize(path):
            # recover_meta_data_on_start (stable_meta_data_server.erl:140-162)
            with open(path, "rb") as f:
                self._data = msgpack.unpackb(f.read(), raw=False,
                                             strict_map_key=False)

    # ------------------------------------------------------------------
    def _persist(self) -> None:
        if self.path is None:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(msgpack.packb(self._data, use_bin_type=True))
            f.flush()
            os.fsync(f.fileno())  # fsync-ok: stable-meta atomic replace
            # (write-temp + rename), not a log append
        os.replace(tmp, self.path)

    # -- local table (read_meta_data / insert_meta_data) ---------------
    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            return self._data.get(key, default)

    def watch(self, fn: Callable[[str, Any], None]) -> None:
        """Register a change listener fired after every local apply."""
        self._watchers.append(fn)

    def put_local(self, key: str, value: Any) -> None:
        """Node-local insert without broadcast (the server's plain
        ``update_meta_data`` cast)."""
        with self._lock:
            self._data[key] = value
            self._persist()
        for fn in self._watchers:
            fn(key, value)

    # -- DC-wide broadcast (broadcast_meta_data, :116-118) -------------
    def put(self, key: str, value: Any) -> None:
        if self._cluster is None:
            self.put_local(key, value)
        else:
            self._cluster.broadcast(key, value)

    def put_merge(self, key: str, value: Any,
                  merge: Callable[[Any, Any], Any], default: Any) -> Any:
        """Merge-broadcast (broadcast_meta_data_merge, :130-135): every
        node folds ``merge(incoming, existing or default)``.  Returns this
        node's merged value."""
        if self._cluster is None:
            with self._lock:
                cur = self._data.get(key, default)
                self._data[key] = merge(value, cur)
                self._persist()
                return self._data[key]
        return self._cluster.broadcast_merge(key, value, merge, default,
                                             reply_to=self)

    def _apply_merge(self, key, value, merge, default):
        with self._lock:
            cur = self._data.get(key, default)
            self._data[key] = merge(value, cur)
            self._persist()
            merged = self._data[key]
        for fn in self._watchers:
            fn(key, merged)
        return merged

    # -- env mirroring (get_env_meta_data / store_env_meta_data,
    #    dc_meta_data_utilities.erl:79-104): flag lookup order is the
    #    replicated table first, then the process environment, then the
    #    provided default; first lookup seeds the table so the whole DC
    #    converges on one value.
    def get_env(self, name: str, default: Any = None) -> Any:
        key = f"env:{name}"
        with self._lock:
            if key in self._data:
                return self._data[key]
        val = os.environ.get(f"ANTIDOTE_{name.upper()}", None)
        if val is None:
            val = default
        else:
            val = _parse_env(val)
        self.put(key, val)
        return val

    def set_env(self, name: str, value: Any) -> None:
        """Replicated runtime flag flip (e.g. the reference's
        logging_vnode:set_sync_log)."""
        self.put(f"env:{name}", value)


def _parse_env(s: str) -> Any:
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(s)
    except ValueError:
        return s


class MetaCluster:
    """Synchronous intra-DC broadcast between the member nodes' stores —
    the role the Erlang distribution plays for stable_meta_data_server."""

    def __init__(self):
        self.members: List[MetaDataStore] = []

    def join(self, store: MetaDataStore) -> None:
        self.members.append(store)
        store._cluster = self
        # late joiner catches up from the first member's table
        if len(self.members) > 1:
            with self.members[0]._lock:
                snapshot = dict(self.members[0]._data)
            for k, v in snapshot.items():
                store.put_local(k, v)

    def broadcast(self, key: str, value: Any) -> None:
        for m in self.members:
            m.put_local(key, value)

    def broadcast_merge(self, key, value, merge, default,
                        reply_to: MetaDataStore):
        out = None
        for m in self.members:
            merged = m._apply_merge(key, value, merge, default)
            if m is reply_to:
                out = merged
        return out
