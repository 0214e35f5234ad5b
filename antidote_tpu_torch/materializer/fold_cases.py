"""Inputs that hold every edge of the ``set_aw_fold``, ``orset_presence``
/ ``orset_resolve`` and ``counter_fold`` wrappers, for holding their
kernels to their plain versions on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``) and the plain versions to the JAX package
(``tests/test_torch_kernels.py``).  numpy only."""

from __future__ import annotations

import numpy as np


def set_aw_edge_batch(rng, b, k, e, d):
    """A set_aw fold batch (numpy) holding every edge of the fold, by row %
    6: 0 adds and removes over a small handle pool; 1 n_ops = 0; 2 every
    op excluded (inside the base, or past the read VC); 3 a full key of
    present slots that adds of new handles overflow; 4 one handle added
    again and again among removes of absent handles; 5 negative handles.
    Handles are int64 of either sign.  Returns (state, ring list in the
    wrapper's order)."""
    grp = np.arange(b) % 6
    pool = rng.integers(1, 2**62, size=(b, 12), dtype=np.int64)
    pool[rng.random((b, 12)) < 0.5] *= -1
    pool[grp == 5] = -np.abs(pool[grp == 5])
    elems = np.take_along_axis(pool, rng.integers(0, 12, (b, e)), 1)
    elems[rng.random((b, e)) < 0.4] = 0
    addvc = rng.integers(0, 6, (b, e, d)).astype(np.int32)
    rmvc = rng.integers(0, 6, (b, e, d)).astype(np.int32)
    handles = np.take_along_axis(pool, rng.integers(0, 12, (b, k)), 1)
    kind = (rng.random((b, k)) < 0.3).astype(np.int32)
    obs = rng.integers(0, 8, (b, k, d)).astype(np.int32)
    ops_vc = rng.integers(0, 9, (b, k, d)).astype(np.int32)
    origin = rng.integers(0, d, (b, k)).astype(np.int32)
    n_ops = rng.integers(0, k + 1, b).astype(np.int32)
    base_vc = rng.integers(0, 3, (b, d)).astype(np.int32)
    read_vc = rng.integers(4, 9, (b, d)).astype(np.int32)
    n_ops[np.isin(grp, (2, 3, 4))] = k
    n_ops[grp == 1] = 0
    g2 = np.nonzero(grp == 2)[0]
    ops_vc[g2[::2]] = base_vc[g2[::2], None]
    ops_vc[g2[1::2]] = read_vc[g2[1::2], None] + 1
    g34 = np.isin(grp, (3, 4))
    ops_vc[g34] = rng.integers(3, 5, (int(g34.sum()), k, d))  # all included
    g3 = np.nonzero(grp == 3)[0]
    elems[g3] = rng.integers(1, 2**62, size=(len(g3), e), dtype=np.int64)
    addvc[g3, :, 0] = rmvc[g3, :, 0] + 1
    handles[g3] = rng.integers(1, 2**62, size=(len(g3), k), dtype=np.int64)
    kind[g3] = 0
    g4 = np.nonzero(grp == 4)[0]
    handles[g4] = pool[g4, :1]
    kind[g4] = 0
    handles[g4, 1::2] = -rng.integers(1, 2**62, size=(len(g4), k // 2),
                                      dtype=np.int64)
    kind[g4, 1::2] = 1
    state = {"elems": elems, "addvc": addvc, "rmvc": rmvc,
             "ovf": rng.integers(0, 2, b).astype(np.int32)}
    ring = [handles[..., None], np.concatenate([kind[..., None], obs], -1),
            ops_vc, origin, n_ops, base_vc, read_vc]
    return state, ring


#: special handles: both 32-bit halves in play, a zero low word, negatives
EDGE_HANDLES = np.array([1 << 32, -(1 << 32), -1, 1, 2**63 - 1, -2**63,
                         (7 << 40) | 5], dtype=np.int64)


def orset_edge_batch(rng, b, e, d, top=4):
    """An OR-set state (numpy: elems int64[b, e], addvc / rmvc int32[b, e,
    d]) holding every edge of presence and compaction, by row % 6: 0
    random slots; 1 nothing present (count 0); 2 exactly ``top`` present;
    3 every slot present (count = e > top); 4 present clock rows on empty
    slots and the special handles (``EDGE_HANDLES``) in the rest; 5 one
    present slot, the last.  Handles are int64 of either sign."""
    grp = np.arange(b) % 6
    elems = rng.integers(-2**63, 2**63 - 1, size=(b, e), dtype=np.int64)
    elems[rng.random((b, e)) < 0.3] = 0
    addvc = rng.integers(0, 6, (b, e, d)).astype(np.int32)
    rmvc = rng.integers(0, 6, (b, e, d)).astype(np.int32)
    lo = np.minimum(addvc, rmvc)
    for r in np.nonzero(grp == 1)[0]:  # every row dominated by its remove
        addvc[r] = lo[r]
    for r in np.nonzero(grp == 2)[0]:  # exactly `top` present
        addvc[r] = lo[r]
        elems[r][elems[r] == 0] = 3
        on = rng.choice(e, size=min(top, e), replace=False)
        addvc[r, on, rng.integers(0, d, len(on))] = rmvc[r, on].max(-1) + 1
    for r in np.nonzero(grp == 3)[0]:  # every slot present
        elems[r][elems[r] == 0] = -5
        addvc[r, :, d - 1] = rmvc[r, :, d - 1] + 1
    for r in np.nonzero(grp == 4)[0]:
        elems[r] = EDGE_HANDLES[rng.integers(0, len(EDGE_HANDLES), e)]
        elems[r, ::3] = 0
        addvc[r, :, 0] = rmvc[r, :, 0] + 1
    for r in np.nonzero(grp == 5)[0]:
        addvc[r] = lo[r]
        elems[r, -1] = 1 << 32
        addvc[r, -1, 0] = rmvc[r, -1, 0] + 1
    return elems, addvc, rmvc


def counter_edge_batch(rng, b, k, d):
    """A counter_pn fold batch (numpy, the ``counter_fold`` wrapper's order:
    base_cnt, deltas, ops_vc, n_ops, base_vc, read_vc) by row % 5: 0 a
    random ring; 1 n_ops = 0; 2 n_ops past K; 3 every slot included, deltas
    past the int32 range; 4 every op excluded (inside the base, or past the
    read VC)."""
    grp = np.arange(b) % 5
    base = rng.integers(-2**40, 2**40, b)
    deltas = rng.integers(-1000, 1000, (b, k))
    ops_vc = rng.integers(0, 9, (b, k, d)).astype(np.int32)
    n_ops = rng.integers(0, k + 1, b).astype(np.int32)
    base_vc = rng.integers(0, 3, (b, d)).astype(np.int32)
    read_vc = rng.integers(4, 9, (b, d)).astype(np.int32)
    n_ops[grp == 1] = 0
    n_ops[grp == 2] = k + 7
    g3 = grp == 3
    n_ops[g3] = k
    ops_vc[g3] = 3
    deltas[g3] = rng.integers(-2**50, 2**50, (int(g3.sum()), k))
    g4 = np.nonzero(grp == 4)[0]
    n_ops[g4] = k
    ops_vc[g4[::2]] = base_vc[g4[::2], None]
    ops_vc[g4[1::2]] = read_vc[g4[1::2], None] + 1
    return base, deltas, ops_vc, n_ops, base_vc, read_vc
