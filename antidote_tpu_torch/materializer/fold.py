"""The generic materializer fold: the ``serial`` strategy and the oracle
the kernels are held to.

For a batch of keys, each key's op ring is folded into its base state in
slot order.  An op is folded iff

    ¬(op_vc ≤ base_vc)        -- not already in the base snapshot
  ∧   op_vc ≤ read_vc         -- visible at the read snapshot
  ∧   slot < n_ops            -- a real (written) ring slot

The JAX package runs a ``lax.scan`` over the K slots, vmapped over keys;
here the loop over slots is Python and each step is one batched ``apply``
over all B keys.
"""

from __future__ import annotations

import torch

from antidote_tpu_torch.clock import vector as vc


def where_rows(include, new, old):
    """Per-key ``where`` over a state dict (include is bool[B])."""
    return {
        f: torch.where(include.view((-1,) + (1,) * (x.dim() - 1)), new[f], x)
        for f, x in old.items()
    }


def fold_key(ty, cfg, state0, ops_a, ops_b, ops_vc, ops_origin, n_ops,
             base_vc, read_vc):
    """Fold ONE key's ring (the shapes of :func:`fold_batch` without the
    leading batch axis; ``n_ops`` a 0-d tensor).  Returns (state, applied)."""
    state, applied = fold_batch(
        ty, cfg, {f: x.unsqueeze(0) for f, x in state0.items()},
        ops_a.unsqueeze(0), ops_b.unsqueeze(0), ops_vc.unsqueeze(0),
        ops_origin.unsqueeze(0), n_ops.reshape(1), base_vc.unsqueeze(0),
        read_vc.unsqueeze(0))
    return {f: x[0] for f, x in state.items()}, applied[0]


def fold_batch(ty, cfg, state0, ops_a, ops_b, ops_vc, ops_origin, n_ops,
               base_vc, read_vc):
    """Fold B keys' rings into their base states.

    Shapes: state0 fields ``[B, ...]``, ops_a int64[B, K, A], ops_b
    int32[B, K, Bw], ops_vc int32[B, K, D], ops_origin int32[B, K], n_ops
    int32[B], base_vc/read_vc int32[B, D].  Returns (state, applied
    int32[B])."""
    state = dict(state0)
    applied = torch.zeros(n_ops.shape, dtype=torch.int32, device=n_ops.device)
    for k in range(ops_vc.shape[1]):
        op_vc = ops_vc[:, k]
        include = (~vc.le(op_vc, base_vc) & vc.le(op_vc, read_vc)
                   & (k < n_ops))
        new = ty.apply(cfg, state, ops_a[:, k], ops_b[:, k], op_vc,
                       ops_origin[:, k])
        state = where_rows(include, new, state)
        applied += include.to(torch.int32)
    return state, applied


def eager_fold_batch(ty, cfg, state0, ops_a, ops_b, ops_vc, ops_origin,
                     n_ops):
    """Apply every real ring op unconditionally (no snapshot filtering) —
    used to overlay a transaction's own writes on its reads."""
    state = dict(state0)
    for k in range(ops_vc.shape[1]):
        new = ty.apply(cfg, state, ops_a[:, k], ops_b[:, k], ops_vc[:, k],
                       ops_origin[:, k])
        state = where_rows(k < n_ops, new, state)
    return state
