"""AntidoteNode — the public API facade: static and interactive
transactions over typed bound objects, hook registration and the metrics
registry, over one replica's TransactionManager + KVStore.

The node runs in memory: ``log_dir``, ``meta`` and handoff raise
``NotImplementedError`` until their slices land.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np

from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt import is_type
from antidote_tpu_torch.obs import (MetricsServer, NodeMetrics,
                                    install_error_monitor)
from antidote_tpu_torch.obs.server import DEFAULT_METRICS_PORT
from antidote_tpu_torch.store.kv import KVStore
from antidote_tpu_torch.txn.manager import (
    AbortError,
    Transaction,
    TransactionManager,
    Update,
)


class AntidoteNode:
    """One replica ("DC") of the store; ``dc_id`` is its clock lane.  Its
    tables live on ``device`` ("cuda" by default; "cpu" only when asked)."""

    def __init__(self, cfg: Optional[AntidoteConfig] = None, dc_id: int = 0,
                 cert: bool = True, log_dir: Optional[str] = None,
                 meta=None, device="cuda"):
        if log_dir is not None:
            raise NotImplementedError(
                "log_dir: the durable log is not ported yet (in-memory only)")
        if meta is not None:
            raise NotImplementedError("meta: the metadata store is not "
                                      "ported yet")
        self.cfg = cfg or AntidoteConfig()
        self.dc_id = dc_id
        self.store = KVStore(self.cfg, device=device)
        self.txm = TransactionManager(self.store, my_dc=dc_id, cert=cert)
        #: the prometheus metric set; the manager's and the store's
        #: counters land in it
        self.metrics = NodeMetrics()
        self.txm.metrics = self.metrics
        self.store.metrics = self.metrics
        # the package's ERROR-level log records bump antidote_error_count
        self._error_handler = install_error_monitor(
            self.metrics, logging.getLogger("antidote_tpu_torch"))
        self._metrics_server: Optional[MetricsServer] = None

    def serve_metrics(self, port: Optional[int] = None) -> MetricsServer:
        """Serve ``/metrics`` over HTTP on ``port`` (default 3001; 0 picks
        a free port).  A second call returns the running server."""
        if port is None:
            port = DEFAULT_METRICS_PORT
        if self._metrics_server is not None:
            if port not in (0, self._metrics_server.port):
                raise RuntimeError(
                    f"metrics already served on port "
                    f"{self._metrics_server.port}, not {port}")
            return self._metrics_server
        self._metrics_server = MetricsServer(self.metrics.registry, port=port)
        return self._metrics_server

    def receive_handoff(self, pkg, shard: Optional[int] = None) -> None:
        raise NotImplementedError("handoff is not ported yet")

    # --- transactions ---------------------------------------------------
    def start_transaction(self, clock=None, props=None) -> Transaction:
        return self.txm.start_transaction(clock, props)

    def read_objects(self, objects: Sequence,
                     txn: Optional[Transaction] = None, clock=None):
        if txn is not None:
            return self.txm.read_objects(objects, txn)
        return self.txm.read_objects_static(objects, clock)

    def update_objects(self, updates: Sequence[Update],
                       txn: Optional[Transaction] = None, clock=None):
        if txn is not None:
            self.txm.update_objects(updates, txn)
            return None
        return self.txm.update_objects_static(updates, clock)

    def commit_transaction(self, txn: Transaction) -> np.ndarray:
        return self.txm.commit_transaction(txn)

    def abort_transaction(self, txn: Transaction) -> None:
        self.txm.abort_transaction(txn)

    # --- hooks ------------------------------------------------------------
    def register_pre_hook(self, bucket: str, fn) -> None:
        self.txm.hooks.register_pre_hook(bucket, fn)

    def register_post_hook(self, bucket: str, fn) -> None:
        self.txm.hooks.register_post_hook(bucket, fn)

    def unregister_hook(self, kind: str, bucket: str) -> None:
        self.txm.hooks.unregister_hook(kind, bucket)

    # --- introspection ----------------------------------------------------
    @staticmethod
    def is_type(type_name: str) -> bool:
        return is_type(type_name)

    def stable_vc(self) -> np.ndarray:
        return self.store.stable_vc()


__all__ = ["AntidoteNode", "AbortError"]
