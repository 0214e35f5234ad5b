"""Mesh serving plane — one store's tables placed over a list of devices.

The JAX package's plane lays every table array over a ``jax.sharding.Mesh``
and computes the DC's stable snapshot as a ``lax.pmin`` collective.  The
port runs the same plane in one process over a list of ``torch.device``s
(``parallel.make_mesh``):

  * every table is PLACED (``TypedTable(..., sharding=)``): contiguous
    shard blocks, block ``b`` owning shards ``[b*spd, (b+1)*spd)`` on the
    mesh's ``b``-th device, ``spd = n_shards // n_devices``, permanently;
    every table operation runs on the device of its rows' block;
  * epoch-eligible reads launch as ROUTED per-block gathers
    (``epoch_gather``): each block gathers and resolves its own rows from
    its own slice of the frozen serving slot, and the host copy of the
    writeback stage merges them back into input order;
  * the stable VC is the ``stable_min`` kernel on each block's ``[spd,
    D]`` applied-clock rows on that block's device, then the min over the
    ``n`` ``[D]`` results on the host (``stable_vc``), cached per
    applied-clock snapshot;
  * epoch publication is PER-SHARD INCREMENTAL: a freeze scatters only into
    the blocks that own dirty rows (``TypedTable.freeze_serving``), which
    ``antidote_mesh_publish_total{shard}`` counts;
  * one key's over-ring log folds with its op axis split over the devices
    (``fold_giant_key``, ``longlog.sharded_assoc_fold_fn``).

Nothing uses ``torch.distributed``: a block's results cross to another
device only as ``[D]``-sized clocks and deltas, by ``Tensor.to``.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from antidote_tpu_torch.materializer import cuda_kernels, longlog
from antidote_tpu_torch.parallel.spmd import (SHARD_AXIS, make_mesh,
                                              shard_axis_sharding,
                                              visible_devices)


class MeshServingPlane:
    """Placement and stable time for one store's serving plane.

    Build with the deployment config, then :meth:`attach` a
    :class:`~antidote_tpu_torch.store.kv.KVStore` (or pass ``sharding`` into
    ``AntidoteNode`` so that recovery-built tables are placed at creation,
    then attach).  ``devices`` defaults to the visible CUDA devices; a
    list may repeat a device (several blocks on one card, or on the CPU).
    More devices than the list holds, and an ``n_shards`` not divisible by
    the device count, are refused."""

    def __init__(self, cfg, n_devices: int | None = None, metrics=None,
                 devices=None):
        devices = visible_devices() if devices is None else list(devices)
        n = int(n_devices) if n_devices else len(devices)
        if cfg.n_shards % max(n, 1):
            raise ValueError(
                f"n_shards={cfg.n_shards} is not divisible by "
                f"{n} mesh devices: every device must own a whole "
                "number of shards")
        if not 1 <= n <= len(devices):
            raise ValueError(
                f"mesh wants {n} devices; {len(devices)} are visible")
        self.cfg = cfg
        self.n_devices = n
        self.mesh = make_mesh(n, devices)
        self.sharding = shard_axis_sharding(self.mesh)
        #: NodeMetrics (attached with the store; may arrive later)
        self.metrics = metrics
        self.store = None
        #: the last stable VC keyed by the applied-clock snapshot it was
        #: computed from: transaction starts ask per request, and the
        #: kernels run again only when a commit advanced a clock
        self._stable_cache: "tuple | None" = None
        self._stable_lock = threading.Lock()
        #: stable-time computations actually launched (cache misses)
        self.stable_collectives = 0
        #: giant-key folds dispatched through the mesh
        self.giant_folds = 0
        #: routed epoch gathers launched
        self.epoch_gathers = 0
        self._giant_fold_fns: dict = {}

    # ------------------------------------------------------------------
    # placement
    # ------------------------------------------------------------------
    def attach(self, store) -> "MeshServingPlane":
        """Adopt ``store``: place every existing table over the mesh, point
        new-table creation at the mesh placement, and route the store's
        stable time through the plane."""
        if self.metrics is None:
            self.metrics = store.metrics
        store.sharding = self.sharding
        for t in store.tables.values():
            self.place_table(t)
        store.mesh = self
        self.store = store
        if self.metrics is not None:
            self.metrics.mesh_devices.set(self.n_devices)
        return self

    def place_table(self, t) -> None:
        """Move one table's tensors into the mesh's blocks (idempotent).
        Frozen copies cut from the old placement die with it: readers fall
        back to the locked path until the next publish."""
        if t.sharding is self.sharding:
            return
        t.place(self.sharding)

    # ------------------------------------------------------------------
    # routed epoch gathers (the launch stage of the epoch read)
    # ------------------------------------------------------------------
    def epoch_gather(self, t, head, head_vc, shards, rows):
        """One routed gather of a frozen serving slot: each block gathers
        and resolves its own rows on its own device, with no host sync.
        Returns the resolved fields as ``BlockParts`` in input order (the
        writeback stage owns the host copy)."""
        self.epoch_gathers += 1
        return t.routed_gather(head, head_vc, shards, rows)

    # ------------------------------------------------------------------
    # giant-key sequence sharding
    # ------------------------------------------------------------------
    def fold_giant_key(self, ty, cfg, state0, ops_a, ops_b, ops_vc,
                       ops_origin, n_ops, base_vc, read_vc):
        """Fold ONE key's over-ring op log with the op axis split over the
        mesh's devices (``longlog.sharded_assoc_fold_fn``).  Host operands
        on the leading op axis L (a replay's log); ``n_ops`` the true op
        count ≤ L.  Requires ``ty.supports_assoc``.  L is padded to a
        power-of-two multiple of the device count (pad slots sit at global
        index ≥ n_ops, so the inclusion mask drops them), as in the JAX
        package.  Returns (state, applied) as tensors on the first device
        (no host sync here)."""
        key = (ty.name, cfg)
        fn = self._giant_fold_fns.get(key)
        if fn is None:
            fn = longlog.sharded_assoc_fold_fn(ty, cfg, self.mesh)
            self._giant_fold_fns[key] = fn
        length = int(ops_vc.shape[0])
        padded = self.n_devices
        while padded < length:
            padded *= 2
        pad = padded - length

        def padl(x, dtype):
            x = np.asarray(x, dtype)
            if pad:
                x = np.concatenate(
                    [x, np.zeros((pad,) + x.shape[1:], dtype)])
            return x

        self.giant_folds += 1
        return fn(state0, padl(ops_a, np.int64), padl(ops_b, np.int32),
                  padl(ops_vc, np.int32), padl(ops_origin, np.int32),
                  int(n_ops), np.asarray(base_vc, np.int32),
                  np.asarray(read_vc, np.int32))

    # ------------------------------------------------------------------
    # stable time: stable_min per block, then the min over the blocks
    # ------------------------------------------------------------------
    def stable_vc(self, applied: np.ndarray | None = None) -> np.ndarray:
        """The DC-wide stable snapshot: ``stable_min`` on each block's
        ``[spd, D]`` rows of the applied clocks, on the block's device (the
        kernel on a card, its plain version on the CPU), then the min over
        the blocks' ``[D]`` results on the host.  Cached per applied-clock
        snapshot, so only clock advances launch; it launches whatever the
        row count (the single-device ``stable_min_of`` keeps its host min
        below ``_KERNEL_MIN_ROWS`` rows).

        ``applied`` is the caller's clock matrix: ``KVStore.stable_vc``
        passes its OWN ``applied_vc``, so across a follower reinstall (the
        plane re-attaches to the fresh store before the manager swaps
        over) a lock-free start on the old store still computes from the
        old store's clocks."""
        if applied is None:
            applied = self.store.applied_vc
        with self._stable_lock:
            c = self._stable_cache
            if c is not None and np.array_equal(c[0], applied):
                return c[1].copy()
            snap = applied.copy()
        t0 = time.monotonic()
        spd = snap.shape[0] // self.n_devices
        parts = []
        for b, dev in enumerate(self.mesh.devices):
            rows = torch.from_numpy(np.ascontiguousarray(
                snap[b * spd:(b + 1) * spd], np.int32))
            with cuda_kernels.on_block(b):
                parts.append(cuda_kernels.stable_min(rows.to(dev)))
        out = parts[0].cpu().numpy()
        for p in parts[1:]:
            out = np.minimum(out, p.cpu().numpy())
        if self.metrics is not None:
            self.metrics.mesh_stable_seconds.observe(time.monotonic() - t0)
        with self._stable_lock:
            self.stable_collectives += 1
            self._stable_cache = (snap, out)
        return out.copy()

    # ------------------------------------------------------------------
    def status(self) -> dict:
        """The node-status ``mesh`` block."""
        out = {
            "devices": self.n_devices,
            "axis": SHARD_AXIS,
            "shards_per_device": self.cfg.n_shards // self.n_devices,
            "stable_collectives": self.stable_collectives,
            "giant_folds": self.giant_folds,
        }
        m = self.metrics
        if m is not None:
            # int keys, numeric order (labels are strings internally)
            out["publish_by_shard"] = dict(sorted(
                (int(k[0]), int(v))
                for k, v in m.mesh_publish.snapshot().items()
            ))
            s = m.mesh_stable_seconds.summary()
            out["stable_pmin_us"] = {
                "count": s["count"],
                "mean_us": round(s["mean"] * 1e6, 1),
                "p99_us": round(s["p99"] * 1e6, 1),
            }
        return out
