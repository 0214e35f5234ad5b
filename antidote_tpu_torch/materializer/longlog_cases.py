"""Seeded long op logs for the assoc-capable types, numpy only: B keys'
logs of L ops each, inside the exactness preconditions of
``longlog.assoc_fold`` (sets from a bottom base, set_aw adds only, own
commit dots ≥ 1), so the assoc fold, ``fold_long`` and ``fold_batch``
must agree on them.  The CPU tests hold the port to the JAX package on
them (``tests/test_torch_longlog.py``); ``chip_smoke.py`` holds the card's
folds to each other at L = 4096."""

from __future__ import annotations

import numpy as np

#: the types whose fold is a monoid (``CRDTType.supports_assoc``)
ASSOC_TYPES = ("counter_pn", "flag_ew", "flag_dw", "set_go", "set_aw")


def long_log(name: str, rng, b: int, length: int, cfg):
    """One batch: (state0 dict of numpy [b, ...], [ops_a, ops_b, ops_vc,
    ops_origin, n_ops, base_vc, read_vc]) in ``fold_batch``'s order.
    Clock lanes: ops in [1, 9), base VCs in [0, 3) (zero for the sets:
    their base is bottom), read VCs in [4, 9), so each log mixes ops
    inside the base, visible ops and ops past the read VC; n_ops spans
    0 to L, with a quarter of the rows full."""
    d, w = cfg.max_dcs, cfg.set_slots
    ops_vc = rng.integers(1, 9, (b, length, d)).astype(np.int32)
    origin = rng.integers(0, d, (b, length)).astype(np.int32)
    n_ops = rng.integers(0, length + 1, b).astype(np.int32)
    n_ops[::4] = length
    base_vc = rng.integers(0, 3, (b, d)).astype(np.int32)
    read_vc = rng.integers(4, 9, (b, d)).astype(np.int32)
    ops_b = np.zeros((b, length, 1 + d), np.int32)
    ops_a = np.zeros((b, length, 1), np.int64)
    if name == "counter_pn":
        ops_b = np.zeros((b, length, 1), np.int32)
        ops_a[..., 0] = rng.integers(-2**40, 2**40, (b, length))
        state = {"cnt": rng.integers(-2**40, 2**40, b).astype(np.int64)}
    elif name in ("flag_ew", "flag_dw"):
        ops_b[..., 0] = rng.random((b, length)) < 0.5
        ops_b[..., 1:] = rng.integers(0, 9, (b, length, d))
        state = {"envc": rng.integers(0, 9, (b, d)).astype(np.int32),
                 "disvc": rng.integers(0, 9, (b, d)).astype(np.int32)}
    else:
        base_vc[:] = 0
        # a pool of handles per key, one row in eight wider than the
        # slots (the overflow tail), with the edge values of the handle
        # planes
        pool = rng.integers(1, 2**62, (b, w + 4))
        pool[:, :3] = [1 << 32, -(1 << 32), -1]
        width = np.where(np.arange(b) % 8 == 0, w + 4, w - 2)
        pick = (rng.random((b, length)) * width[:, None]).astype(np.int64)
        ops_a[..., 0] = np.take_along_axis(pool, pick, 1)
        if name == "set_go":
            ops_b = np.zeros((b, length, 1), np.int32)
            state = {"elems": np.zeros((b, w), np.int64),
                     "ovf": np.zeros(b, np.int32)}
        else:
            state = {"elems": np.zeros((b, w), np.int64),
                     "addvc": np.zeros((b, w, d), np.int32),
                     "rmvc": np.zeros((b, w, d), np.int32),
                     "ovf": np.zeros(b, np.int32)}
    return state, [ops_a, ops_b, ops_vc, origin, n_ops, base_vc, read_vc]
