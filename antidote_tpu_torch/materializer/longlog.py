"""Long op-log materialization, batched over keys.

The JAX package folds one key's log under ``vmap``; here every function
takes B keys' logs as ``[B, L]`` op tensors.  Two strategies:

  * ``assoc_fold`` — for monoid CRDTs (``supports_assoc``: counter_pn,
    flag_ew, flag_dw; and, from a bottom base, set_go and set_aw's add
    lane) the masked fold is one reduction over the op axis instead of a
    length-L serial scan.  The table's ``assoc`` strategy runs it on the
    ring of the flag types.
  * ``fold_long`` — for every type, a serial fold of an arbitrarily long
    log in chunks of ``chunk`` ops, each chunk one ``fold_batch`` (a
    batched ``apply`` per op slot) with ``n_ops`` masking.

Inclusion semantics are those of ``fold.fold_batch``.  The mesh form,
``sharded_assoc_fold_fn``, comes with the multi-card slice.
"""

from __future__ import annotations

import torch

from antidote_tpu_torch.clock import vector as vc
from antidote_tpu_torch.materializer import fold as fold_mod


def include_mask(ops_vc, n_ops, base_vc, read_vc):
    """Per-op inclusion ``¬(op ≤ base) ∧ op ≤ read ∧ slot < n_ops``:
    ops_vc int32[B, L, D], n_ops int[B], base_vc/read_vc int32[B, D] →
    bool[B, L]."""
    slots = torch.arange(ops_vc.shape[1], device=ops_vc.device)
    in_base = vc.le(ops_vc, base_vc[:, None])
    visible = vc.le(ops_vc, read_vc[:, None])
    return ~in_base & visible & (slots < n_ops[:, None])


def assoc_fold(ty, cfg, state0, ops_a, ops_b, ops_vc, ops_origin, n_ops,
               base_vc, read_vc):
    """Monoid reduction fold of B keys' op windows (requires
    ``ty.supports_assoc``; exact from any base unless
    ``ty.assoc_bottom_only``).  Shapes as in ``fold.fold_batch``, with the
    op axis of any length L ≥ 1.  Returns (state, applied int32[B])."""
    assert ty.supports_assoc, ty.name
    mask = include_mask(ops_vc, n_ops, base_vc, read_vc)
    delta = ty.delta_of_ops(cfg, ops_a, ops_b, ops_vc, ops_origin, mask)
    return ty.delta_apply(state0, delta), mask.sum(-1, dtype=torch.int32)


def fold_long(ty, cfg, state0, ops_a, ops_b, ops_vc, ops_origin, n_ops,
              base_vc, read_vc, chunk: int = 1024):
    """Serial fold of B keys' arbitrarily long op logs, ``chunk`` ops at a
    time: each chunk is one ``fold_batch`` over views of the log, with
    ``n_ops`` shifted to the chunk.  The caller pads L to a multiple of
    ``chunk`` and masks the padding through ``n_ops``.  Works for every
    CRDT type.  Returns (state, applied int32[B])."""
    length = ops_vc.shape[1]
    assert length % chunk == 0, (length, chunk)
    state = dict(state0)
    applied = torch.zeros(n_ops.shape, dtype=torch.int32,
                          device=n_ops.device)
    for lo in range(0, length, chunk):
        hi = lo + chunk
        state, got = fold_mod.fold_batch(
            ty, cfg, state, ops_a[:, lo:hi], ops_b[:, lo:hi],
            ops_vc[:, lo:hi], ops_origin[:, lo:hi], n_ops - lo, base_vc,
            read_vc)
        applied += got
    return state, applied
