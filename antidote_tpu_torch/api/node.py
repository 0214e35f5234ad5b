"""AntidoteNode — the public API facade: static and interactive
transactions over typed bound objects, hook registration and the metrics
registry, over one replica's TransactionManager + KVStore.

With ``log_dir`` the node is durable: every commit is logged before the
tables observe it (and, under ``sync_log``, fsynced before it is
acknowledged), ``recover=True`` rebuilds the node from the newest
checkpoint image, its delta chain and the WAL tail (or from the whole log),
``checkpoint_now`` / ``start_checkpointer`` write images, and a refused
WAL append puts the node in degraded read-only mode.  The metadata store
(``meta=``), shard handoff and the cold tier are later slices.
"""

from __future__ import annotations

import glob
import logging
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np

from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt import is_type
from antidote_tpu_torch.obs import (MetricsServer, NodeMetrics,
                                    install_error_monitor)
from antidote_tpu_torch.obs.server import DEFAULT_METRICS_PORT
from antidote_tpu_torch.store.kv import (KVStore, effect_from_rec,
                                         freeze_key, key_to_shard)
from antidote_tpu_torch.txn.manager import (
    AbortError,
    Transaction,
    TransactionManager,
    Update,
)


class AntidoteNode:
    """One replica ("DC") of the store; ``dc_id`` is its clock lane.  Its
    tables live on ``device`` ("cuda" by default; "cpu" only when asked).

    ``log_dir`` makes the node durable; a directory that already holds
    data (WAL records or a published checkpoint) must be opened with
    ``recover=True``, never booted fresh over."""

    def __init__(self, cfg: Optional[AntidoteConfig] = None, dc_id: int = 0,
                 cert: bool = True, log_dir: Optional[str] = None,
                 recover: bool = False, meta=None, store=None,
                 resident_rows: int = 0, device="cuda"):
        if meta is not None:
            raise NotImplementedError("meta: the metadata store is not "
                                      "ported yet")
        if store is not None:
            raise NotImplementedError("store=: adopting a store (a reshard "
                                      "output) comes with shard handoff")
        if resident_rows:
            raise NotImplementedError("resident_rows: the cold tier is not "
                                      "ported yet")
        self.cfg = cfg or AntidoteConfig()
        self.dc_id = dc_id
        log = None
        if log_dir is not None and self.cfg.enable_logging:
            from antidote_tpu_torch.log import LogManager
            from antidote_tpu_torch.log.checkpoint import has_checkpoints

            # a published checkpoint carries committed data even when
            # every WAL file below its floor was reclaimed
            has_data = any(
                os.path.getsize(p) > 0
                for p in glob.glob(os.path.join(log_dir, "shard_*.wal"))
            ) or has_checkpoints(log_dir)
            if has_data and not recover:
                # appending to an existing log with fresh counters would
                # mint duplicate (commit counter, origin) dots
                raise RuntimeError(
                    f"log_dir {log_dir!r} contains existing WAL data; pass "
                    "recover=True (or point at an empty directory)")
            log = LogManager(self.cfg, log_dir)
        elif recover:
            raise RuntimeError(
                "recover=True requires log_dir and cfg.enable_logging")
        self.store = KVStore(self.cfg, device=device, log=log)
        self.txm = TransactionManager(self.store, my_dc=dc_id, cert=cert)
        #: the prometheus metric set; the manager's and the store's
        #: counters land in it
        self.metrics = NodeMetrics()
        self.txm.metrics = self.metrics
        self.store.metrics = self.metrics
        if log is not None:
            # group-fsync coordinator -> antidote_wal_fsync_batch
            log.on_fsync_batch = self.metrics.wal_fsync_batch.observe
        # the package's ERROR-level log records bump antidote_error_count
        self._error_handler = install_error_monitor(
            self.metrics, logging.getLogger("antidote_tpu_torch"))
        self._metrics_server: Optional[MetricsServer] = None
        #: background checkpoint writer; started by start_checkpointer or
        #: lazily by checkpoint_now
        self.checkpointer = None
        self._ckpt_init_lock = threading.Lock()
        #: extras restored from the checkpoint chain, for embedders
        self.checkpoint_extras: dict = {}
        #: name -> provider of extra state embedded in checkpoint images
        #: (shared with the Checkpointer, so late registrations are seen)
        self.checkpoint_extras_providers: dict = {}
        if recover and log is not None:
            self._recover(log_dir)

    def _recover(self, log_dir: str) -> None:
        """Node restart: compose the newest verifiable full image with its
        delta chain, then replay only the WAL tail above the last link's
        floor; without a checkpoint, replay the whole log.  Both rebuild
        the certification table and the commit counter."""
        from antidote_tpu_torch.log import checkpoint as ckpt

        rlog = logging.getLogger("antidote_tpu_torch.recovery")
        t0 = time.monotonic()
        loaded = ckpt.load_chain(log_dir)
        if loaded is not None:
            image, _manifest, deltas = loaded
            summary = ckpt.install_image(self.store, self.txm, image)
            self.checkpoint_extras = image.get("extras", {}) or {}
            for delta, _dman in deltas:
                ds = ckpt.install_delta(self.store, self.txm, delta)
                self.checkpoint_extras.update(delta.get("extras", {}) or {})
                rlog.info("recovery chain link %d: %d rows, %d keys",
                          ds["id"], ds["rows"], ds["keys"])
            ckpt_s = time.monotonic() - t0
            self.metrics.recovery_seconds.set(ckpt_s, phase="checkpoint")
            rlog.info("recovery phase checkpoint: image %d + %d chain "
                      "link(s) (%d keys, %d rows, %d tables) installed in "
                      "%.2f s", summary["id"], len(deltas), summary["keys"],
                      summary["rows"], summary["tables"], ckpt_s)
        t1 = time.monotonic()
        last = self.store.recover(track_origin=self.dc_id)
        self.txm.committed_keys.update(last)
        self.txm.commit_counter = int(self.store.dc_max_vc()[self.dc_id])
        tail_s = time.monotonic() - t1
        n_tail = self.store.last_recovery_records
        self.metrics.recovery_seconds.set(tail_s, phase="tail")
        self.metrics.recovery_records.inc(n_tail)
        rlog.info("recovery phase tail: %d record(s) replayed in %.2f s "
                  "(total %.2f s, %s)", n_tail, tail_s,
                  time.monotonic() - t0,
                  "checkpoint + tail" if loaded is not None
                  else "full replay, no checkpoint found")

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
        raise NotImplementedError("shard handoff is not ported yet")

    # --- checkpointing ----------------------------------------------------
    def start_checkpointer(self, interval_s: float = 300.0, retain: int = 2,
                           rebase_every: int = 8,
                           scrub_every_s: float = 0.0):
        """Attach (and, for ``interval_s`` > 0, start) the background
        checkpoint writer.  Requires a durable log.  Idempotent."""
        if self.store.log is None:
            raise RuntimeError("checkpointing requires log_dir (a durable "
                               "WAL to stamp floors into)")
        with self._ckpt_init_lock:
            if self.checkpointer is None:
                from antidote_tpu_torch.log.checkpoint import Checkpointer

                cp = Checkpointer(self.store, self.txm, metrics=self.metrics,
                                  interval_s=interval_s, retain=retain,
                                  rebase_every=rebase_every,
                                  scrub_every_s=scrub_every_s)
                cp.extras_providers = self.checkpoint_extras_providers
                cp.start()
                self.checkpointer = cp
        return self.checkpointer

    def checkpoint_now(self, full: Optional[bool] = None) -> dict:
        """Run one synchronous checkpoint cycle (stamp, stream, publish,
        reclaim); returns the published manifest with ``barrier_ms`` (the
        stamp's time from asking for the commit lock to releasing it),
        ``held_ms`` (the part holding it) and ``total_s``.  ``full``
        forces a rebase (True) or a delta link (False); None lets the
        chain cadence decide."""
        if self.checkpointer is None:
            self.start_checkpointer(interval_s=0.0)
        return self.checkpointer.checkpoint_now(full=full)

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

    def get_log_operations(self, object_clock_pairs: Sequence) -> list:
        """Logged update operations newer than a snapshot time, per object
        (``antidote:get_log_operations``).  ``object_clock_pairs`` is
        ``[((key, type, bucket), clock), ...]``; ``clock`` is a dense VC
        (``None`` = all ops).  Returns one list per object of ``(opid,
        op)`` with ``op`` the origin lane, commit VC and decoded effect;
        an op is included iff its commit VC is NOT dominated by the clock.
        """
        log = self.store.log
        if log is None:
            raise RuntimeError("get_log_operations requires a durable log "
                               "(node started with log_dir)")
        d = self.cfg.max_dcs
        wanted: dict = {}  # shard -> [(out idx, key, type, bucket, vc)]
        for i, ((key, type_name, bucket), clock) in enumerate(
                object_clock_pairs):
            key = freeze_key(key)
            shard = key_to_shard(key, bucket, self.cfg.n_shards)
            vc = None
            if clock is not None:
                vc = np.zeros(d, np.int64)
                clock = np.asarray(clock, np.int64)
                vc[: len(clock)] = clock[:d]
            wanted.setdefault(shard, []).append(
                (i, key, type_name, bucket, vc))
        out: list = [[] for _ in object_clock_pairs]
        for shard, items in wanted.items():
            by_obj: dict = {}  # an object may be asked at several clocks
            for i, k, t, b, vc in items:
                by_obj.setdefault((k, t, b), []).append((i, vc))
            for rec in log.replay_shard(shard):  # one scan per shard
                hits = by_obj.get((freeze_key(rec["k"]), rec["t"], rec["b"]))
                if hits is None:
                    continue
                rec_vc = np.zeros(d, np.int64)
                rv = np.asarray(rec["vc"], np.int64)
                rec_vc[: len(rv)] = rv[:d]
                for i, vc in hits:
                    if vc is not None and (rec_vc <= vc).all():
                        continue  # already in the given snapshot
                    out[i].append((int(rec["id"]), {
                        "origin": int(rec["o"]),
                        "commit_vc": rec_vc,
                        "effect": effect_from_rec(rec),
                    }))
        return out

    def set_sync_log(self, sync: bool) -> None:
        """Flip fsync-on-commit on the running log (the reference's
        ``logging_vnode:set_sync_log``).  The JAX node routes the flag
        through its replicated metadata store so that every node of the DC
        applies it; the port has no metadata store yet, so this applies it
        to this node's log directly."""
        if self.store.log is not None:
            self.store.log.set_sync(bool(sync))

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

    def close(self) -> None:
        """Stop the checkpointer and close the log (fsync thread, files)."""
        if self.checkpointer is not None:
            self.checkpointer.stop()
        if self.store.log is not None:
            self.store.log.close()


__all__ = ["AntidoteNode", "AbortError"]
