"""Typed-table parity: one JAX ``TypedTable`` is populated past its ring size
(GC folds, two snapshot versions) for ``set_aw`` and ``counter_pn``.  A port
table is populated with the same ``append`` batches, and a second one is
carried across from the JAX table's arrays (``carry.table_from_numpy``).
Both must hold the JAX table's exact arrays and answer ``read_resolved_flat``
/ ``read_resolved`` / ``read`` / ``read_latest`` identically at fresh and at
historical VCs.  The JAX side serves on its XLA strategies."""

import numpy as np
import pytest

from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu.crdt import get_type as jax_type
from antidote_tpu.store import TypedTable as JaxTable
from antidote_tpu_torch.carry import table_arrays, table_from_numpy
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.store import TypedTable

D, P, ROWS = 3, 2, 6
KW = dict(n_shards=P, max_dcs=D, ops_per_key=4, snap_versions=2, set_slots=8,
          keys_per_table=8)


def _batches(name, seed, n_batches=30):
    """Commit-ordered append batches over P*ROWS keys; each op carries its
    own commit VC (a per-origin counter, causally ordered).  Returns the
    batches and the clock after each batch."""
    rng = np.random.default_rng(seed)
    clock = np.zeros(D, np.int32)
    handles = (rng.integers(1, 2**40, size=10) | (1 << 33)).astype(np.int64)
    out, clocks = [], []
    for _ in range(n_batches):
        m = int(rng.integers(2, 9))
        shards = rng.integers(0, P, size=m)
        rows = rng.integers(0, ROWS, size=m)
        origins = rng.integers(0, D, size=m).astype(np.int32)
        vcs = np.zeros((m, D), np.int32)
        for i, o in enumerate(origins):
            clock[o] += 1
            vcs[i] = clock
        if name == "set_aw":
            eff_a = rng.choice(handles, size=(m, 1))
            eff_b = np.zeros((m, 1 + D), np.int32)
            eff_b[:, 0] = rng.random(m) < 0.3
            eff_b[:, 1:] = rng.integers(0, clock.max() + 1, size=(m, D))
        else:
            eff_a = rng.integers(-2**40, 2**40, size=(m, 1))
            eff_b = np.zeros((m, 1), np.int32)
        out.append((shards, rows, eff_a.astype(np.int64), eff_b, vcs,
                    origins))
        clocks.append(clock.copy())
    return out, clocks


def _assert_tree(want, got, msg):
    if isinstance(want, dict):
        assert set(want) == set(got), msg
        for f in want:
            _assert_tree(want[f], got[f], f"{msg}.{f}")
    elif isinstance(want, tuple):
        assert len(want) == len(got), msg
        for i, (w, g) in enumerate(zip(want, got)):
            _assert_tree(w, g, f"{msg}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(want), np.asarray(got),
                                      err_msg=msg)


@pytest.fixture(scope="module", params=["set_aw", "counter_pn"])
def tables(request):
    name = request.param
    jt = JaxTable(jax_type(name), JaxConfig(**KW, batch_buckets=(16, 64)),
                  n_rows=8, n_shards=P)
    tcfg = AntidoteConfig(**KW)
    tt = TypedTable(get_type(name), tcfg, n_rows=8, n_shards=P, device="cpu")
    for t in (jt, tt):
        t.used_rows[:] = ROWS
    batches, clocks = _batches(name, seed=len(name))
    for b in batches:
        jt.append(*b)
        tt.append(*b)
    carried = table_from_numpy(name, tcfg, table_arrays(jt), device="cpu")
    return name, jt, {"appended": tt, "carried": carried}, clocks


def test_tables_hold_the_jax_arrays(tables):
    name, jt, ports, _ = tables
    want = table_arrays(jt)
    # GC'd past the ring: keys hold two snapshot versions
    assert (np.count_nonzero(want["snap_seq"], axis=-1) == 2).sum() >= 4
    for label, t in ports.items():
        _assert_tree(want, table_arrays(t), f"{name}/{label}")


def _read_cases(clocks):
    rng = np.random.default_rng(9)
    shards = np.repeat(np.arange(P), ROWS)
    rows = np.tile(np.arange(ROWS), P)
    m = len(rows)
    yield "fresh", shards, rows, np.broadcast_to(clocks[-1], (m, D))
    for i in (4, 11, 19, 26):
        yield f"at{i}", shards, rows, np.broadcast_to(clocks[i], (m, D))
    # per-key historical VCs, keys repeated in one batch
    pick = rng.integers(0, len(clocks), size=2 * m)
    yield ("mixed", np.concatenate([shards, shards]),
           np.concatenate([rows, rows]), np.stack([clocks[i] for i in pick]))


def test_reads_match_jax_at_fresh_and_historical_vcs(tables):
    name, jt, ports, clocks = tables
    folded = 0
    for label, shards, rows, vcs in _read_cases(clocks):
        w_res, w_fresh, w_comp = jt.read_resolved_flat(shards, rows, vcs)
        w_state, w_applied, w_full = jt.read(shards, rows, vcs)
        w_latest, w_lfresh = jt.read_latest(shards, rows, vcs)
        folded += int((~np.asarray(w_fresh)).sum())
        for port, t in ports.items():
            msg = f"{name}/{port}/{label}"
            g_res, g_fresh, g_comp = t.read_resolved_flat(shards, rows, vcs)
            _assert_tree({f: np.asarray(x) for f, x in w_res.items()},
                         {f: x.numpy() for f, x in g_res.items()}, msg)
            np.testing.assert_array_equal(np.asarray(w_fresh), g_fresh)
            np.testing.assert_array_equal(np.asarray(w_comp), g_comp)
            _assert_tree(jt.read_resolved(shards, rows, vcs),
                         t.read_resolved(shards, rows, vcs), msg + "/flat")
            g_state, g_applied, g_full = t.read(shards, rows, vcs)
            _assert_tree(w_state, g_state, msg + "/read")
            np.testing.assert_array_equal(w_applied, g_applied)
            np.testing.assert_array_equal(w_full, g_full)
            g_latest, g_lfresh = t.read_latest(shards, rows, vcs)
            _assert_tree(w_latest, g_latest, msg + "/latest")
            np.testing.assert_array_equal(w_lfresh, g_lfresh)
    assert folded > 0  # historical reads went through the ring fold
    kernel = "kernel_set_aw" if name == "set_aw" else "kernel_counter"
    for t in ports.values():
        assert t._fold_strategy() == kernel
        assert t.fold_dispatches.get(kernel, 0) >= 1
