"""Shard placement over a list of devices, and the replica step over it.

The JAX package lays every table array's leading shard axis over a
one-axis ``jax.sharding.Mesh`` (``"shard"``) and runs the replica step as
one ``shard_map`` program whose stable snapshot is a ``lax.pmin``.  Here
the mesh is an ordered list of ``torch.device``s (the visible CUDA devices
by default; a list may repeat a device, as the CPU tests' ``[cpu] * 8``
does for the JAX tests' 8 virtual devices): block ``b`` of ``n`` owns
shards ``[b*spd, (b+1)*spd)``, ``spd = n_shards // n``, permanently, and a
placed table (``TypedTable(..., sharding=shard_axis_sharding(mesh))``)
holds each block's tensors on its device.  One process drives every
block; nothing crosses between devices but ``[D]``-sized clocks and
deltas.

``sharded_step_fn`` is the JAX package's replica step, block by block:
  1. scatter a routed commit batch into the op rings (per shard)
  2. advance per-shard applied clocks; the stable VC is ``stable_min`` on
     each block's ``[spd, D]`` clock rows on its device, then the min of
     the blocks' ``[D]`` results
  3. materialize a routed read batch (per shard): base select, then the
     ring fold — ``counter_fold`` / ``set_aw_fold`` on a card for their
     types, their plain versions on the CPU
"""

from __future__ import annotations

import types
from typing import List, Sequence

import numpy as np
import torch

from antidote_tpu_torch.materializer import cuda_kernels

SHARD_AXIS = "shard"


class Mesh:
    """An ordered list of devices along the one ``SHARD_AXIS`` axis."""

    def __init__(self, devices: Sequence, axis: str = SHARD_AXIS):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (axis,)
        self.shape = {axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


class ShardSharding:
    """Leading-axis placement of table tensors over a mesh: ``[P, ...]``
    split into ``mesh.size`` contiguous shard blocks, block ``b`` on
    ``mesh.devices[b]``."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    @property
    def devices(self):
        return self.mesh.devices

    def shards_per_block(self, n_shards: int) -> int:
        n = self.mesh.size
        if n_shards % n:
            raise ValueError(
                f"n_shards={n_shards} is not divisible by {n} mesh "
                "devices: every device must own a whole number of shards")
        return n_shards // n


def visible_devices() -> List[torch.device]:
    """The CUDA devices this process sees."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: the
    visible CUDA devices; all of them when ``n_devices`` is None)."""
    devices = visible_devices() if devices is None else list(devices)
    n = int(n_devices) if n_devices else len(devices)
    if not 1 <= n <= len(devices):
        raise ValueError(f"mesh wants {n} devices; {len(devices)} "
                         "are available")
    return Mesh(devices[:n])


def shard_axis_sharding(mesh: Mesh) -> ShardSharding:
    """Leading-axis placement for table tensors: [P, ...] over the mesh."""
    return ShardSharding(mesh)


def _blocks_of(x, n: int, spd: int, devices, dtype=None):
    """An operand as per-block tensors: a placed table's per-block list as
    it is, a [P, ...] array split into blocks, each on its device."""
    if isinstance(x, (list, tuple)):
        return list(x)
    if isinstance(x, dict):
        parts = {f: _blocks_of(v, n, spd, devices, dtype)
                 for f, v in x.items()}
        return [{f: parts[f][b] for f in parts} for b in range(n)]
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    if dtype is not None:
        x = x.to(dtype)
    return [x[b * spd:(b + 1) * spd].to(devices[b]) for b in range(n)]


def sharded_step_fn(ty, cfg, mesh: Mesh):
    """One replica step over the mesh (see the module docstring).

    Every operand is per shard, routed and padded, as a [P, ...] array or
    as a placed table's per-block list (``[blk.ops_a for blk in
    table.blocks]``; ``snap`` as per-block field dicts):
      snap{f}[P, N, V, ...], snap_vc i32[P, N, V, D], snap_seq i64[P, N, V],
      ops_a i64[P, N, K, A], ops_b i32[P, N, K, B], ops_vc i32[P, N, K, D],
      ops_origin i32[P, N, K];
      app_rows/app_slots i64[P, Ma], app_a i64[P, Ma, A], app_b i32[P, Ma,
      B], app_vc i32[P, Ma, D], app_origin i32[P, Ma] (rows at or past N
      are padding, dropped);
      read_rows i64[P, Mr], read_n_ops i32[P, Mr], read_vcs i32[P, Mr, D];
      applied_vc i32[P, D].
    Returns, each as a list of per-block results on the block's device:
    (new ops_a, ops_b, ops_vc, ops_origin — the inputs are not written —,
    read state {f: [spd, Mr, ...]}, applied i32[spd, Mr], complete
    bool[spd, Mr], new applied_vc i32[spd, D], stable_vc i32[spd, D], the
    min over every shard, equal on every row)."""
    from antidote_tpu_torch.store.typed_table import fold_strategy, read_block

    devices = mesh.devices
    n = mesh.size
    spd = ShardSharding(mesh).shards_per_block(cfg.n_shards)
    strategy = fold_strategy(ty)

    def step(snap, snap_vc, snap_seq, ops_a, ops_b, ops_vc, ops_origin,
             app_rows, app_slots, app_a, app_b, app_vc, app_origin,
             read_rows, read_n_ops, read_vcs, applied_vc):
        def blocks(x, dtype=None):
            return _blocks_of(x, n, spd, devices, dtype)

        snap, snap_vc, snap_seq = blocks(snap), blocks(snap_vc), blocks(
            snap_seq)
        ops = [blocks(x) for x in (ops_a, ops_b, ops_vc, ops_origin)]
        app = [blocks(app_rows, torch.int64), blocks(app_slots, torch.int64),
               blocks(app_a, torch.int64), blocks(app_b, torch.int32),
               blocks(app_vc, torch.int32), blocks(app_origin, torch.int32)]
        rrows = np.asarray(read_rows, np.int64)
        rn_ops = np.asarray(read_n_ops, np.int32)
        rvcs = blocks(read_vcs, torch.int32)
        applied = blocks(applied_vc, torch.int32)
        new_ops, new_applied = [], []
        for b in range(n):
            # 1. commit scatter (padding rows and slots out of range drop)
            a_rows, a_slots, a_a, a_b, a_vc, a_o = (x[b] for x in app)
            oa, ob, ov, oo = (x[b].clone() for x in ops)
            n_rows, k = oa.shape[1], oa.shape[2]
            keep = (a_rows >= 0) & (a_rows < n_rows) & (a_slots >= 0) & (
                a_slots < k)
            sidx = torch.arange(spd, device=devices[b])[:, None].expand_as(
                a_rows)
            at = (sidx[keep], a_rows[keep], a_slots[keep])
            oa[at] = a_a[keep]
            ob[at] = a_b[keep]
            ov[at] = a_vc[keep]
            oo[at] = a_o[keep]
            new_ops.append((oa, ob, ov, oo))
            # 2. advance this block's shards' applied clocks
            valid = (a_rows < n_rows)[..., None]
            new_applied.append(torch.maximum(
                applied[b],
                torch.where(valid, a_vc, 0).amax(1)
                if a_vc.shape[1] else applied[b]))
        # the stable snapshot: the kernel on each block's clock rows on its
        # device, then the min over the blocks' [D] results
        with_block = []
        for b in range(n):
            with cuda_kernels.on_block(b):
                with_block.append(cuda_kernels.stable_min(new_applied[b]))
        stable = with_block[0].cpu()
        for part in with_block[1:]:
            stable = torch.minimum(stable, part.cpu())
        # 3. the routed read, every shard of a block in one batch
        states, applieds, completes = [], [], []
        for b in range(n):
            oa, ob, ov, oo = new_ops[b]
            src = types.SimpleNamespace(
                snap=snap[b], snap_vc=snap_vc[b], snap_seq=snap_seq[b],
                ops_a=oa, ops_b=ob, ops_vc=ov, ops_origin=oo)
            n_rows = oa.shape[1]
            rows_b = np.minimum(rrows[b * spd:(b + 1) * spd], n_rows - 1)
            mr = rows_b.shape[1]
            ss = torch.arange(spd, device=devices[b]).repeat_interleave(mr)
            rr = torch.as_tensor(rows_b.reshape(-1), device=devices[b])
            nops = rn_ops[b * spd:(b + 1) * spd].reshape(-1)
            with cuda_kernels.on_block(b):
                state, app_n, comp = read_block(
                    ty, cfg, src, ss, rr, nops,
                    rvcs[b].reshape(-1, rvcs[b].shape[-1]), strategy)
            states.append({f: x.reshape((spd, mr) + tuple(x.shape[1:]))
                           for f, x in state.items()})
            applieds.append(app_n.reshape(spd, mr))
            completes.append(comp.reshape(spd, mr))
        stables = [stable.to(devices[b]).expand(spd, -1).clone()
                   for b in range(n)]
        return ([o[0] for o in new_ops], [o[1] for o in new_ops],
                [o[2] for o in new_ops], [o[3] for o in new_ops],
                states, applieds, completes, new_applied, stables)

    return step
