"""AntidoteNode — the public API facade: static and interactive
transactions over typed bound objects, hook registration and the metrics
registry, over one replica's TransactionManager + KVStore.

With ``log_dir`` the node is durable: every commit is logged before the
tables observe it (and, under ``sync_log``, fsynced before it is
acknowledged), ``recover=True`` rebuilds the node from the newest
checkpoint image, its delta chain and the WAL tail (or from the whole log),
``checkpoint_now`` / ``start_checkpointer`` write images, and a refused
WAL append puts the node in degraded read-only mode.  ``resident_rows``
bounds the rows on the device: the cold tier evicts image-covered rows to
the checkpoint sidecar and faults them back in on demand.  ``store=``
adopts a populated store (a reshard's output) and ``receive_handoff``
installs an exported shard.  The metadata store (``meta=``, a fresh
in-memory one by default) carries the DC-replicated runtime flags
(``sync_log``, ``txn_cert``).  ``check_ready`` runs a transaction on the
node's device and ``status`` is the operator's one-call view.
"""

from __future__ import annotations

import glob
import logging
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt import is_type
from antidote_tpu_torch.meta import MetaDataStore
from antidote_tpu_torch.obs import (MetricsServer, NodeMetrics,
                                    install_error_monitor)
from antidote_tpu_torch.obs.metrics import net_metrics
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
    ``recover=True``, never booted fresh over.  ``store`` adopts an
    existing KVStore (a reshard's output) with its own log and device;
    ``log_dir`` must be None then.  ``sharding``
    (``parallel.shard_axis_sharding``, or a ``MeshServingPlane``'s) places
    every table over a device mesh from its creation, recovery's included;
    attach the plane afterwards for its stable time.  ``resident_rows`` > 0
    attaches the cold tier with that resident budget (it needs
    ``log_dir``), and ``cold_fault_rate_cap`` caps its fault-ins a
    second."""

    def __init__(self, cfg: Optional[AntidoteConfig] = None, dc_id: int = 0,
                 cert: bool = True, log_dir: Optional[str] = None,
                 recover: bool = False, meta=None,
                 store: Optional[KVStore] = None, resident_rows: int = 0,
                 cold_fault_rate_cap: float = 0.0, device="cuda",
                 sharding=None):
        if store is not None and cfg is None:
            cfg = store.cfg
        self.cfg = cfg or AntidoteConfig()
        self.dc_id = dc_id
        #: durable, DC-replicated metadata/flag store
        self.meta = meta if meta is not None else MetaDataStore()
        log = None
        if store is not None:
            assert log_dir is None, "store= and log_dir= are exclusive"
            if recover:
                raise RuntimeError(
                    "store= adopts already-populated tables; recover=True "
                    "would replay its log on top of them (double-apply)")
            log = store.log
        elif log_dir is not None and self.cfg.enable_logging:
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
            log = LogManager(self.cfg, log_dir,
                             sync_on_commit=self.meta.get_env(
                                 "sync_log", self.cfg.sync_log))
        elif recover:
            raise RuntimeError(
                "recover=True requires log_dir and cfg.enable_logging")
        self.store = store if store is not None else KVStore(
            self.cfg, device=device, log=log, sharding=sharding)
        self.txm = TransactionManager(
            self.store, my_dc=dc_id,
            cert=self.meta.get_env("txn_cert", cert),
            protocol=self.meta.get_env("txn_prot", "clocksi"))
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
        if store is not None:
            # an adopted store: continue the commit counter above every
            # applied clock, so new commits never mint duplicate dots
            self.txm.commit_counter = int(self.store.dc_max_vc()[dc_id])
        #: background checkpoint writer; started by start_checkpointer or
        #: lazily by checkpoint_now
        self.checkpointer = None
        self._ckpt_init_lock = threading.Lock()
        #: extras restored from the checkpoint chain, for embedders
        self.checkpoint_extras: dict = {}
        #: name -> provider of extra state embedded in checkpoint images
        #: (shared with the Checkpointer, so late registrations are seen)
        self.checkpoint_extras_providers: dict = {}
        # the cold tier attaches BEFORE recovery, so that a chain image's
        # cold_directory registers fault-in refs and the tail replay stays
        # under the resident budget
        if resident_rows > 0 and self.store.cold is None:
            # enable_cold_tier raises without a durable log: an explicitly
            # asked residency bound must never be a silent no-op
            self.enable_cold_tier(resident_rows, cold_fault_rate_cap)
        if recover and log is not None:
            self._recover(log_dir, cold_fault_rate_cap)
        # react to replicated flag flips from ANY node in the DC
        # (registered last: construction-time get_env seeds fire watchers)
        self.meta.watch(self._on_meta_change)

    def _recover(self, log_dir: str, cold_fault_rate_cap: float) -> None:
        """Node restart: compose the newest verifiable full image with its
        delta chain, then replay only the WAL tail above the last link's
        floor; without a checkpoint, replay the whole log.  Both rebuild
        the certification table and the commit counter.  An image's cold
        keys get no device row: they register with the cold tier (attached
        here if the node has none) and fault in on demand; with a resident
        budget, the rows past it go back cold before the node serves."""
        from antidote_tpu_torch.log import checkpoint as ckpt

        rlog = logging.getLogger("antidote_tpu_torch.recovery")
        t0 = time.monotonic()
        loaded = ckpt.load_chain(log_dir)
        if loaded is not None:
            image, manifest, deltas = loaded
            summary = ckpt.install_image(self.store, self.txm, image)
            self.checkpoint_extras = image.get("extras", {}) or {}
            if summary["cold_directory"]:
                if self.store.cold is None:
                    self.enable_cold_tier(0, cold_fault_rate_cap)
                self.store.cold.seed(summary["cold_directory"],
                                     int(manifest["id"]))
            if (self.store.cold is not None
                    and manifest.get("cold") is not None):
                # the resident keys' image coordinates double as evict
                # hints (their rows ARE the sidecar rows)
                self.store.cold.seed_hints(int(manifest["id"]))
            for delta, _dman in deltas:
                ds = ckpt.install_delta(self.store, self.txm, delta)
                self.checkpoint_extras.update(delta.get("extras", {}) or {})
                rlog.info("recovery chain link %d: %d rows, %d keys, %d "
                          "evicted", ds["id"], ds["rows"], ds["keys"],
                          ds["evicted"])
            ckpt_s = time.monotonic() - t0
            self.metrics.recovery_seconds.set(ckpt_s, phase="checkpoint")
            rlog.info("recovery phase checkpoint: image %d + %d chain "
                      "link(s) (%d keys, %d rows, %d tables, %d cold) "
                      "installed in %.2f s", summary["id"], len(deltas),
                      summary["keys"], summary["rows"], summary["tables"],
                      len(summary["cold_directory"]), ckpt_s)
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
        cold = self.store.cold
        if cold is not None and cold.budget > 0:
            # a restart larger than the card enforces the resident budget
            # BEFORE serving: rows the image covers (and the tail left
            # untouched) go straight back cold
            n_ev = cold.enforce_budget()
            if n_ev:
                rlog.info("recovery cold tier: %d row(s) evicted to the "
                          "resident budget (%d)", n_ev, cold.budget)

    # --- cold tier --------------------------------------------------------
    def enable_cold_tier(self, resident_rows: int = 0,
                         fault_rate_cap: float = 0.0):
        """Attach the cold tier: device residency bounded by
        ``resident_rows`` (0 = unbounded; fault-in only), fault-ins past
        ``fault_rate_cap`` a second refused with a typed ColdMiss.  Needs a
        durable log (cold state lives in checkpoint sidecars).  On an
        attached tier it resets the budget and the cap."""
        if self.store.log is None:
            raise RuntimeError("the cold tier requires log_dir (cold rows "
                               "live in checkpoint sidecars)")
        if self.store.cold is None:
            from antidote_tpu_torch.store.coldtier import ColdTier

            self.store.cold = ColdTier(
                self.store, budget=resident_rows,
                fault_rate_cap=fault_rate_cap, lock=self.txm.commit_lock)
            cp = self.checkpointer
            if cp is not None:
                self.store.cold.on_pressure = cp.request
                self.store.cold.on_corrupt = cp._on_cold_corrupt
        else:
            self.store.cold.budget = int(resident_rows)
            self.store.cold.fault_rate_cap = float(fault_rate_cap)
        return self.store.cold

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
        """Install an exported shard package (:meth:`install_handoff`).  A
        package from a checkpoint-compacted source carries only its log's
        tail, so a durable node seals the import (:meth:`seal_import`)
        before returning: the import is not done until an image covers
        the moved rows."""
        self.install_handoff(pkg, shard)
        if pkg.get("compacted"):
            if self.store.log is not None:
                summary = self.seal_import()
                logging.getLogger("antidote_tpu_torch").info(
                    "compacted-source shard import sealed by local "
                    "checkpoint %s", summary.get("id"))
            else:
                logging.getLogger("antidote_tpu_torch").warning(
                    "imported a shard from a checkpoint-compacted source "
                    "into a node without a log: the moved rows have no "
                    "durable history at all")

    def install_handoff(self, pkg, shard: Optional[int] = None) -> None:
        """The package's rows, clocks and log records in the store
        (``store/handoff.py``), the commit counter raised above every
        imported clock, so this node's own-lane snapshots cover the moved
        commits, and the moved keys' certification stamps.  A package
        from a compacted source still waits for :meth:`seal_import`."""
        from antidote_tpu_torch.store import handoff

        handoff.import_shard(self.store, pkg, shard)
        self.txm.commit_counter = max(
            self.txm.commit_counter,
            int(self.store.dc_max_vc()[self.dc_id]))
        # the certification table for the moved keys: their last own-lane
        # commit is the head clock's own lane, or a transaction whose
        # snapshot predates the import could overwrite a moved commit
        # unchecked (noted in the checkpoint window the seal reads)
        own = {tname: np.asarray(tb["head_vc"])[:, self.dc_id]
               for tname, tb in pkg["tables"].items()}
        ckd = self.txm.ckpt_dirty_committed
        for key, bucket, tname, row in pkg["directory"]:
            lane = int(own[tname][row])
            if lane:
                dk = (freeze_key(key), bucket)
                self.txm.committed_keys[dk] = max(
                    self.txm.committed_keys.get(dk, 0), lane)
                if ckd is not None:
                    ckd.add(dk)

    def seal_import(self) -> dict:
        """The local checkpoint a compacted shard import waits for, at the
        least cost (:meth:`Checkpointer.seal`: a delta link of the imported
        keys without a WAL rotation, or a full image when no published
        image can parent one).  A node without a log has nothing to
        seal."""
        if self.store.log is None:
            return {}
        if self.checkpointer is None:
            self.start_checkpointer(interval_s=0.0)
        return self.checkpointer.seal()

    # --- readiness (the reference's wait_init) ----------------------------
    def check_ready(self) -> dict:
        """Probe every subsystem; returns {probe: bool}.  All-true means
        the node can serve traffic.  The ``txn`` probe runs a transaction
        (an update and a read, then an abort) and, on a card, a launch of
        the kernel library on the node's device: the first probe builds
        the kernels, so a node that answers ready has them built."""
        probes = {}
        probes["types"] = bool(is_type("counter_pn"))
        try:
            probes["meta"] = self.meta.get_env("txn_prot", "clocksi") in (
                "clocksi", "gr")
        except Exception:
            probes["meta"] = False
        try:
            self.store.stable_vc()
            probes["clocks"] = True
        except Exception:
            probes["clocks"] = False
        if self.store.log is not None:
            try:
                self.store.log.commit_barrier([0])
                probes["log"] = True
            except Exception:
                probes["log"] = False
        else:
            probes["log"] = True  # ephemeral mode: nothing to probe
        metrics, self.txm.metrics = self.txm.metrics, None
        try:
            # full txn machinery, then rolled back.  Metrics are detached
            # so health polling never skews op/abort dashboards; the
            # aborted probe binds no rows
            txn = self.start_transaction()
            self.update_objects(
                [("__ready__", "counter_pn", "__ready__", ("increment", 1))],
                txn)
            self.read_objects([("__ready__", "counter_pn", "__ready__")], txn)
            self.abort_transaction(txn)
            dev = self.store.device
            if dev.type == "cuda":
                # the device round trip: the probe's reads of unwritten
                # keys launch nothing, so launch the kernel library's
                # empty kernel on the node's card (building the library on
                # the first call) and wait for it
                from antidote_tpu_torch.materializer import cuda_kernels

                cuda_kernels.launch_floor(dev)
                torch.cuda.synchronize(dev)
            probes["txn"] = True
        except Exception:
            logging.getLogger("antidote_tpu_torch").exception(
                "readiness probe")
            probes["txn"] = False
        finally:
            self.txm.metrics = metrics
        return probes

    def is_ready(self) -> bool:
        return all(self.check_ready().values())

    def status(self, include_ready: bool = False) -> dict:
        """Operator-facing snapshot (the console's ``status`` command).

        Passive by default — ``include_ready=True`` additionally runs the
        full readiness probe (a device round trip + WAL barrier), which is
        too heavy for high-frequency monitoring polls."""
        stable = self.store.stable_vc()
        out = {
            "dc_id": self.dc_id,
            "n_shards": self.cfg.n_shards,
            "max_dcs": self.cfg.max_dcs,
            "protocol": self.txm.protocol,
            "certification": self.txm.cert,
            "stable_vc": [int(x) for x in stable],
            "commit_counter": int(self.txm.commit_counter),
            "keys": len(self.store.directory),
            "tables": {
                t: {"rows_used": int(tab.used_rows.sum()),
                    "n_rows": tab.n_rows}
                for t, tab in self.store.tables.items()
            },
            "durable": self.store.log is not None,
        }
        if self.store.mesh is not None:
            # the mesh serving plane: devices, per-shard publish rows,
            # stable-time latency
            out["mesh"] = self.store.mesh.status()
        # fabric/RPC resilience counters (process-wide)
        out["net"] = {k: v for k, v in net_metrics().snapshot().items()
                      if v}
        # overload/degradation view: every bound and shed is visible here
        # and on /metrics
        shed = {
            plane[0]: v
            for plane, v in sorted(self.metrics.shed.snapshot().items())
            if v
        }
        out["overload"] = {
            "read_only": self.txm.read_only_reason,
            "commit_backlog": self.txm._commit_backlog,
            "max_commit_backlog": self.txm.max_commit_backlog,
            "shed": shed,
        }
        # escrow economy: typed bounded-counter refusals, queued shortfall
        # and rights-transfer traffic
        out["escrow"] = dict(
            self.txm.bcounters.status(),
            grants={
                role[0]: int(v) for role, v in sorted(
                    self.metrics.escrow_grants.snapshot().items()) if v
            },
        )

        # write plane: merge width, group-fsync batching, per-segment
        # durability debt, bypass counts
        def _hist(h):
            s = h.summary()
            return {"count": s["count"], "mean": round(s["mean"], 2),
                    "p50": s["p50"], "p99": s["p99"]}

        wlog = self.store.log
        out["write_plane"] = {
            "merge_width": _hist(self.metrics.commit_merge_width),
            "fsync_batch": _hist(self.metrics.wal_fsync_batch),
            "cert_bypass_total": int(self.metrics.cert_bypass.value()),
            "sync_log": (bool(wlog.wals[0].sync_on_commit)
                         if wlog is not None else None),
            "wal_segments": wlog.n_segments if wlog is not None else 0,
            "segment_depth_bytes": (wlog.segment_depths()
                                    if wlog is not None else []),
        }
        # checkpoint view: last published image stamp, size, age, and the
        # tail a crash-now restart would replay; read from disk when no
        # checkpointer is attached
        if wlog is not None:
            if self.checkpointer is not None:
                out["checkpoint"] = self.checkpointer.status()
            else:
                from antidote_tpu_torch.log import checkpoint as _ckpt

                cks = _ckpt.list_checkpoints(
                    _ckpt.checkpoint_root(wlog.dir))
                blk = {
                    "interval_s": 0,
                    "tail_records": int(
                        (wlog.seqs - wlog.floor_seqs).sum()),
                }
                if cks:
                    m = _ckpt.load_manifest(cks[-1][1]) or {}
                    blk.update({
                        "last_id": m.get("id"),
                        "stamp_vc_max": m.get("stamp_vc_max"),
                        "image_bytes": m.get("image_bytes"),
                        "age_s": round(
                            time.time() - m.get("created_at", 0), 1),
                    })
                out["checkpoint"] = blk
        if self.store.cold is not None:
            # residency vs budget, fault/evict counters, anchor image
            out["cold_tier"] = self.store.cold.status()
        if include_ready:
            out["ready"] = self.check_ready()
        return out

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
        from antidote_tpu_torch.log import segment_index

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
        segments = segment_index(log.dir)  # one listing for every shard
        for shard, items in wanted.items():
            by_obj: dict = {}  # an object may be asked at several clocks
            for i, k, t, b, vc in items:
                by_obj.setdefault((k, t, b), []).append((i, vc))
            for rec in log.replay_shard(shard, index=segments):
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
        """Flip fsync-on-commit DC-wide (the reference's replicated
        ``logging_vnode:set_sync_log``): the flag goes through the metadata
        store, whose broadcast reaches every member node's watcher, which
        applies it to its running log."""
        self.meta.set_env("sync_log", sync)

    def _on_meta_change(self, key: str, value) -> None:
        if key == "env:sync_log" and self.store.log is not None:
            self.store.log.set_sync(bool(value))
        elif key == "env:txn_cert":
            self.txm.cert = bool(value)

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
