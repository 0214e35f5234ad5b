"""Parity of the port's materializer kernels (plain versions, CPU) with the
JAX package: the same seeded numpy inputs go through both.

Oracles are the JAX entries that run on the CPU: ``fold.fold_batch``, the
Pallas kernels in interpret mode through their trace-safe entries
(``_presence_call``, ``counter_fold_local``, ``set_aw_fold``),
``crdt.base.compact_top`` and ``SetAW.resolve``'s plain-XLA branch.  Every
comparison is exact equality — all of this is integer work."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu.crdt import get_type as jax_type
from antidote_tpu.crdt.base import compact_top as jax_compact_top
from antidote_tpu.materializer import fold as jax_fold
from antidote_tpu.materializer import pallas_kernels as pk
from antidote_tpu_torch.materializer import cuda_kernels as ck
from antidote_tpu_torch.materializer.fold_cases import (counter_edge_batch,
                                                        orset_edge_batch)

D = 3


def _t(x):
    return torch.as_tensor(np.array(x))


def _assert_state(want, got, msg=""):
    for f, x in want.items():
        np.testing.assert_array_equal(np.asarray(x), got[f].numpy(),
                                      err_msg=f"{msg}{f}")


def _handles(ids, neg=False):
    """Handle ids -> int64 handles with both 32-bit halves set; with
    ``neg`` the odd ids are negative."""
    h = ids.astype(np.int64) * 0x1_0000_0003
    return np.where(ids % 2 == 1, -h, h) if neg else h


def _set_state(rng, b, e, n_handles, fill=0.6, d=D, neg=False):
    elems = _handles(rng.integers(1, n_handles + 1, size=(b, e)), neg)
    elems[rng.random((b, e)) > fill] = 0
    elems[:, 0] = np.where(rng.random(b) < 0.2, 1 << 32, elems[:, 0])
    return {
        "elems": elems,
        "addvc": rng.integers(0, 6, size=(b, e, d)).astype(np.int32),
        "rmvc": rng.integers(0, 6, size=(b, e, d)).astype(np.int32),
        "ovf": rng.integers(0, 3, size=(b,)).astype(np.int32),
    }


def _set_ring(rng, b, k, n_handles, p_rm=0.4, d=D, neg=False):
    handles = _handles(rng.integers(1, n_handles + 1, size=(b, k)), neg)
    is_rm = (rng.random((b, k)) < p_rm).astype(np.int32)
    obs = rng.integers(0, 7, size=(b, k, d)).astype(np.int32)
    ops_vc = rng.integers(0, 8, size=(b, k, d)).astype(np.int32)
    origin = rng.integers(0, d, size=(b, k)).astype(np.int32)
    ops_vc[np.arange(b)[:, None], np.arange(k)[None, :], origin] = (
        rng.integers(1, 9, size=(b, k)))
    return {
        "ops_a": handles[..., None],
        "ops_b": np.concatenate([is_rm[..., None], obs], -1).astype(np.int32),
        "ops_vc": ops_vc,
        "ops_origin": origin,
        "n_ops": rng.integers(0, k + 1, size=(b,)).astype(np.int32),
        "base_vc": rng.integers(0, 3, size=(b, d)).astype(np.int32),
        "read_vc": rng.integers(3, 9, size=(b, d)).astype(np.int32),
    }


RING_ORDER = ("ops_a", "ops_b", "ops_vc", "ops_origin", "n_ops", "base_vc",
              "read_vc")


# ---------------------------------------------------------------------------
# orset_presence
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,e", [(64, 8), (40, 32)])
def test_presence_plain_matches_pallas(b, e):
    rng = np.random.default_rng(11 + e)
    st = _set_state(rng, b, e, n_handles=6)
    occ = (st["elems"] | (st["elems"] >> 32)).astype(np.int32)
    want = pk._presence_call(jnp.asarray(st["addvc"]), jnp.asarray(st["rmvc"]),
                             jnp.asarray(occ), 8, True)
    got = ck.orset_presence(_t(st["addvc"]), _t(st["rmvc"]), _t(st["elems"]))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(np.asarray(want) > 0, got.numpy())


def _jax_presence(el, av, rv):
    occ = (el | (el >> 32)).astype(np.int32)
    return np.asarray(pk._presence_call(jnp.asarray(av), jnp.asarray(rv),
                                        jnp.asarray(occ), 8, True)) > 0


# orset_edge_batch rows: counts 0, the resolve's top and past it, empty
# slots with present clocks, handles 1 << 32 / -(1 << 32) and negatives;
# widths that fill no whole group of the kernel's lanes, 1 to 8 clock lanes
@pytest.mark.parametrize("e,d", [(8, 4), (16, 4), (17, 3), (40, 1), (64, 8),
                                 (16, 1), (64, 4), (40, 8)])
def test_orset_resolve_plain_matches_pallas_and_compact_top(e, d):
    rng = np.random.default_rng(40 + e + d)
    el, av, rv = orset_edge_batch(rng, 60, e, d)
    present = _jax_presence(el, av, rv)
    np.testing.assert_array_equal(
        present, ck.orset_presence(_t(av), _t(rv), _t(el)).numpy())
    want_top, want_count = jax_compact_top(jnp.asarray(el),
                                           jnp.asarray(present), 4)
    top, count = ck.orset_resolve(_t(el), _t(av), _t(rv), 4)
    assert top.dtype == torch.int64 and count.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want_top), top.numpy())
    np.testing.assert_array_equal(np.asarray(want_count), count.numpy())
    c = count.numpy()
    assert {0, 4} <= set(c.tolist()) and (c > 4).any()
    assert (top.numpy() < 0).any() and (top.numpy() == 1 << 32).any()


@pytest.mark.parametrize("e,d", [(16, 4), (40, 3)])
def test_set_aw_resolve_matches_jax_plain_branch(e, d):
    """The port's SetAW.resolve on a CPU state (presence, then
    compact_top) against the JAX SetAW.resolve without Pallas."""
    from antidote_tpu_torch.crdt import get_type

    rng = np.random.default_rng(50 + e)
    el, av, rv = orset_edge_batch(rng, 48, e, d)
    ovf = rng.integers(0, 3, 48).astype(np.int32)
    cfg = JaxConfig(n_shards=1, max_dcs=d, set_slots=e)
    assert not cfg.use_pallas
    state = {"elems": el, "addvc": av, "rmvc": rv, "ovf": ovf}
    want = jax_type("set_aw").resolve(
        cfg, {f: jnp.asarray(x) for f, x in state.items()})
    got = get_type("set_aw").resolve(None, {f: _t(x)
                                           for f, x in state.items()})
    assert set(got) == set(want) == {"top", "count", "ovf"}
    _assert_state(want, got, "resolve:")


# ---------------------------------------------------------------------------
# counter_fold
# ---------------------------------------------------------------------------
def _counter_case(seed, b, k, big=False):
    rng = np.random.default_rng(seed)
    ring = _set_ring(rng, b, k, n_handles=4)
    hi = (2**31 - 1) if big else 1000
    deltas = rng.integers(-hi, hi, size=(b, k)).astype(np.int64)
    base = rng.integers(-5000, 5000, size=(b,)).astype(np.int64)
    return base, deltas, ring


def _jax_counter_fold(base, deltas, ring):
    cfg = JaxConfig(n_shards=1, max_dcs=D, ops_per_key=deltas.shape[1])
    ty = jax_type("counter_pn")
    b, k = deltas.shape
    state, applied = jax_fold.fold_batch(
        ty, cfg, {"cnt": jnp.asarray(base)}, jnp.asarray(deltas[..., None]),
        jnp.zeros((b, k, 1), jnp.int32), jnp.asarray(ring["ops_vc"]),
        jnp.asarray(ring["ops_origin"]), jnp.asarray(ring["n_ops"]),
        jnp.asarray(ring["base_vc"]), jnp.asarray(ring["read_vc"]))
    return np.asarray(state["cnt"]), np.asarray(applied)


@pytest.mark.parametrize("seed,b,k", [(1, 64, 8), (2, 24, 5)])
def test_counter_fold_plain_matches_fold_and_pallas(seed, b, k):
    base, deltas, ring = _counter_case(seed, b, k)
    cnt, applied = ck.counter_fold(
        _t(base), _t(deltas), _t(ring["ops_vc"]), _t(ring["n_ops"]),
        _t(ring["base_vc"]), _t(ring["read_vc"]))
    want_cnt, want_applied = _jax_counter_fold(base, deltas, ring)
    np.testing.assert_array_equal(want_cnt, cnt.numpy())
    np.testing.assert_array_equal(want_applied, applied.numpy())
    dsum, p_applied = pk.counter_fold_local(
        deltas.astype(np.int32), ring["ops_vc"], ring["n_ops"],
        ring["base_vc"], ring["read_vc"], block=b, interpret=True)
    np.testing.assert_array_equal(base + np.asarray(dsum, np.int64),
                                  cnt.numpy())
    np.testing.assert_array_equal(np.asarray(p_applied), applied.numpy())


def test_counter_fold_plain_exact_past_the_int32_bound():
    """|delta| > INT32_MAX // K: the TPU kernel refuses these; the int64 sum
    must still equal fold_batch (the Pallas entry is no oracle here)."""
    base, deltas, ring = _counter_case(3, 48, 8, big=True)
    ring["n_ops"][:] = 8
    ring["base_vc"][:] = 0
    ring["read_vc"][:] = 9
    assert np.abs(deltas).max() > (2**31 - 1) // 8
    cnt, applied = ck.counter_fold(
        _t(base), _t(deltas), _t(ring["ops_vc"]), _t(ring["n_ops"]),
        _t(ring["base_vc"]), _t(ring["read_vc"]))
    want_cnt, want_applied = _jax_counter_fold(base, deltas, ring)
    np.testing.assert_array_equal(want_cnt, cnt.numpy())
    np.testing.assert_array_equal(want_applied, applied.numpy())
    assert (applied.numpy() == 8).all()


# counter_edge_batch rows: n_ops 0 and past K, every slot included with
# deltas past the int32 range, every op excluded; rings of one op, the
# path's and one past a warp of lanes
@pytest.mark.parametrize("k,d", [(1, 4), (16, 4), (33, 3)])
def test_counter_fold_plain_strided_view_matches_contiguous_and_fold(k, d):
    rng = np.random.default_rng(60 + k)
    base, deltas, ops_vc, n_ops, base_vc, read_vc = counter_edge_batch(
        rng, 40, k, d)
    assert np.abs(deltas).max() > 2**31 and (n_ops == 0).any()
    assert (n_ops > k).any()
    wide = np.zeros((40, k, 3), np.int64)
    wide[..., 0] = deltas
    strided = _t(wide)[..., 0]
    assert not strided.is_contiguous()
    rest = [_t(x) for x in (ops_vc, n_ops, base_vc, read_vc)]
    got = ck.counter_fold(_t(base), strided, *rest)
    contiguous = ck.counter_fold(_t(base), _t(deltas), *rest)
    cfg = JaxConfig(n_shards=1, max_dcs=d, ops_per_key=max(k, 2))
    want, want_applied = jax_fold.fold_batch(
        jax_type("counter_pn"), cfg, {"cnt": jnp.asarray(base)},
        jnp.asarray(deltas[..., None]), jnp.zeros((40, k, 1), jnp.int32),
        jnp.asarray(ops_vc), jnp.zeros((40, k), jnp.int32),
        jnp.asarray(n_ops), jnp.asarray(base_vc), jnp.asarray(read_vc))
    for g in (got, contiguous):
        np.testing.assert_array_equal(np.asarray(want["cnt"]), g[0].numpy())
        np.testing.assert_array_equal(np.asarray(want_applied),
                                      g[1].numpy())


def test_orset_resolve_and_counter_fold_refuse_unsupported_devices():
    m = dict(device="meta")
    clocks = torch.zeros((1, 2, D), dtype=torch.int32, **m)
    elems = torch.zeros((1, 2), dtype=torch.int64, **m)
    with pytest.raises(ValueError, match="no kernel"):
        ck.orset_resolve(elems, clocks, clocks, 4)
    with pytest.raises(ValueError, match="operands on"):
        ck.orset_resolve(torch.zeros((1, 2), dtype=torch.int64), clocks,
                         clocks, 4)
    ring = torch.zeros((1, 2, D), dtype=torch.int32, **m)
    row = torch.zeros((1, D), dtype=torch.int32, **m)
    with pytest.raises(ValueError, match="no kernel"):
        ck.counter_fold(torch.zeros(1, dtype=torch.int64, **m),
                        torch.zeros((1, 2), dtype=torch.int64, **m), ring,
                        torch.zeros(1, dtype=torch.int32, **m), row, row)


# ---------------------------------------------------------------------------
# set_aw_fold
# ---------------------------------------------------------------------------
def _set_case(seed, b, k, e, n_handles, p_rm, fill, d=D, neg=False):
    rng = np.random.default_rng(seed)
    return (_set_state(rng, b, e, n_handles, fill, d, neg),
            _set_ring(rng, b, k, n_handles, p_rm, d, neg))


# the clock lanes and handle signs of the cases that are not D = 3 with
# positive handles
_SET_CASE_OPTS = {"d8": {"d": 8}, "d1-k33-e17-neg": {"d": 1, "neg": True},
                  "e40-neg": {"neg": True}}


@pytest.mark.parametrize("name,seed,b,k,e,n_handles,p_rm,fill", [
    # removes and re-adds over a warm base: matches, steals of absent slots
    ("steal", 5, 64, 8, 8, 10, 0.4, 0.6),
    # more distinct adds than free slots: the ovf counter
    ("ovf", 6, 32, 8, 8, 40, 0.05, 1.0),
    # a tier-1 width (E = 32 spans a whole warp chunk in the kernel)
    ("tier", 7, 24, 8, 32, 48, 0.3, 0.5),
    # eight clock lanes (the kernel's wider register variant)
    ("d8", 11, 9, 4, 16, 10, 0.4, 0.6),
    # one clock lane, a ring past one warp of ops, a width that fills no
    # segment of lanes, negative handles
    ("d1-k33-e17-neg", 12, 9, 33, 17, 12, 0.4, 0.6),
    # two slots a lane in the kernel, negative handles
    ("e40-neg", 13, 9, 16, 40, 30, 0.3, 0.5),
])
def test_set_aw_fold_plain_matches_fold_and_pallas(name, seed, b, k, e,
                                                   n_handles, p_rm, fill):
    opts = _SET_CASE_OPTS.get(name, {})
    st, ring = _set_case(seed, b, k, e, n_handles, p_rm, fill, **opts)
    got, applied = ck.set_aw_fold({f: _t(x) for f, x in st.items()},
                                  *(_t(ring[n]) for n in RING_ORDER))
    cfg = JaxConfig(n_shards=1, max_dcs=opts.get("d", D), ops_per_key=k,
                    set_slots=e)
    want, want_applied = jax_fold.fold_batch(
        jax_type("set_aw"), cfg, {f: jnp.asarray(x) for f, x in st.items()},
        *(jnp.asarray(ring[n]) for n in RING_ORDER))
    _assert_state(want, got, f"{name}:fold_batch:")
    np.testing.assert_array_equal(np.asarray(want_applied), applied.numpy())
    p_state, p_applied = pk.set_aw_fold(
        st, *(ring[n] for n in RING_ORDER), block=b, interpret=True)
    _assert_state(p_state, got, f"{name}:pallas:")
    np.testing.assert_array_equal(np.asarray(p_applied), applied.numpy())
    if name == "ovf":
        assert (got["ovf"].numpy() > st["ovf"]).any()
    if name == "steal":
        changed = got["elems"].numpy() != st["elems"]
        assert (changed & (st["elems"] != 0)).any()  # an occupied slot taken
    if opts.get("neg"):
        assert (got["elems"].numpy() < 0).any()


def test_wrappers_refuse_unsupported_devices():
    x = torch.zeros((1, 1, D), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ck.orset_presence(x, x, torch.zeros((1, 1), dtype=torch.int64,
                                            device="meta"))
    with pytest.raises(ValueError, match="operands on"):
        ck.orset_presence(x, torch.zeros((1, 1, D), dtype=torch.int32),
                          torch.zeros((1, 1), dtype=torch.int64))


def test_fold_key_and_eager_fold_match_jax():
    """The generic fold's single-key entry and the unconditional (overlay)
    fold, against the JAX package's."""
    from antidote_tpu_torch.crdt import get_type
    from antidote_tpu_torch.materializer import fold

    st, ring = _set_case(9, 16, 6, 8, 10, 0.4, 0.6)
    cfg = JaxConfig(n_shards=1, max_dcs=D, ops_per_key=6, set_slots=8)
    jty, tty = jax_type("set_aw"), get_type("set_aw")
    one = {f: x[3] for f, x in st.items()}
    r1 = [ring[n][3] for n in RING_ORDER]
    want, w_applied = jax_fold.fold_key(
        jty, cfg, {f: jnp.asarray(x) for f, x in one.items()},
        *(jnp.asarray(x) for x in r1))
    got, g_applied = fold.fold_key(tty, None, {f: _t(x) for f, x in
                                               one.items()},
                                   *(_t(x) for x in r1))
    _assert_state(want, got, "fold_key:")
    assert int(w_applied) == int(g_applied)
    eager_in = [ring[n] for n in RING_ORDER[:5]]
    want = jax_fold.eager_fold_batch(
        jty, cfg, {f: jnp.asarray(x) for f, x in st.items()},
        *(jnp.asarray(x) for x in eager_in))
    got = fold.eager_fold_batch(tty, None, {f: _t(x) for f, x in st.items()},
                                *(_t(x) for x in eager_in))
    _assert_state(want, got, "eager:")


# ---------------------------------------------------------------------------
# stable_min
# ---------------------------------------------------------------------------
I32_MAX = 2**31 - 1


def _clock_matrix(seed, n, d, all_max_rows=0.0, negative=False):
    rng = np.random.default_rng(seed)
    lo = -2**31 if negative else 0
    x = rng.integers(lo, 2**31 - 1, size=(n, d),
                     dtype=np.int64).astype(np.int32)
    x[rng.random(n) < all_max_rows] = I32_MAX  # identity rows
    return x


@pytest.mark.parametrize("name,n,d,block,max_rows,neg", [
    ("path", 2048, 4, 512, 0.1, False),       # the cluster path's shape
    ("below-threshold", 2047, 4, 512, 0.0, False),
    ("stress", 1 << 16, 4, 4096, 0.3, True),
    ("d1", 1000, 1, 128, 0.0, True),
    ("d3", 777, 3, 128, 0.2, False),          # N not a block multiple
    ("d8", 3001, 8, 512, 0.5, True),
    ("one-row", 1, 4, 8, 0.0, True),
    ("all-max", 600, 4, 256, 1.0, False),
])
def test_stable_min_plain_matches_pallas(name, n, d, block, max_rows, neg):
    x = _clock_matrix(n + d, n, d, max_rows, neg)
    got = ck.stable_min(_t(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), x.min(axis=0), name)
    want = pk._stable_min_call(jnp.asarray(x, jnp.int32), block, True)
    np.testing.assert_array_equal(np.asarray(want), got.numpy(), name)
    if name == "all-max":
        assert (got.numpy() == I32_MAX).all()


@pytest.mark.parametrize("d", [1, 4])
def test_stable_min_plain_empty_is_identity(d):
    """N = 0 gives all INT32_MAX, the rule of the JAX entry
    (``pallas_kernels.stable_min``), whose kernel call never sees N = 0."""
    got = ck.stable_min(torch.zeros((0, d), dtype=torch.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.full(d, I32_MAX, np.int32))


def test_stable_min_refuses_unsupported_devices():
    with pytest.raises(ValueError, match="no kernel"):
        ck.stable_min(torch.zeros((4, 4), dtype=torch.int32, device="meta"))
