"""Parity of the port's long-log materializer with the JAX package: the
batched ``include_mask``, ``assoc_fold``, ``fold_long`` and the types'
``delta_merge`` against ``jax.vmap`` of ``antidote_tpu.materializer
.longlog`` per key, on seeded logs of the five assoc-capable types
(``longlog_cases.long_log``: sets from a bottom base, set_aw adds only);
the port's assoc fold and ``fold_long`` against its own ``fold_batch`` on
the same logs; and the typed table's ``assoc`` strategy: the flag tables
dispatch it and read equal to JAX tables fed the same ops, fresh and
historical, while the other types keep their strategies.  Exact equality
throughout."""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antidote_tpu import crdt as jax_crdt
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu.materializer import longlog as jax_longlog
from antidote_tpu.store import TypedTable as JaxTable
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt import TYPE_NAMES, get_type
from antidote_tpu_torch.crdt.type_cases import populate_stream
from antidote_tpu_torch.materializer import fold, longlog
from antidote_tpu_torch.materializer.longlog_cases import (ASSOC_TYPES,
                                                           long_log)
from antidote_tpu_torch.store import TypedTable

D, E = 3, 8
KW = dict(n_shards=2, max_dcs=D, ops_per_key=8, set_slots=E,
          keys_per_table=16)
JCFG, TCFG = JaxConfig(**KW, batch_buckets=(16, 64)), AntidoteConfig(**KW)
B, L, CHUNK = 24, 32, 8


def _case(name, length=L):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    return long_log(name, rng, B, length, TCFG)


def _t(tree):
    return {f: torch.as_tensor(x) for f, x in tree.items()}


def _np(tree):
    return {f: np.asarray(x) for f, x in tree.items()}


def _jax_per_key(fn, name, state, ops):
    ty = jax_crdt.get_type(name)
    out = jax.vmap(functools.partial(fn, ty, JCFG))(
        {f: jnp.asarray(x) for f, x in state.items()},
        *[jnp.asarray(x) for x in ops])
    return _np(out[0]), np.asarray(out[1])


def _assert_states(want, got, msg):
    assert set(want) == set(got), msg
    for f in want:
        assert got[f].dtype == want[f].dtype, f"{msg}:{f}"
        np.testing.assert_array_equal(want[f], got[f], err_msg=f"{msg}:{f}")


@pytest.mark.parametrize("name", ASSOC_TYPES)
def test_include_mask_matches_jax(name):
    _, ops = _case(name)
    ops_vc, n_ops, base_vc, read_vc = ops[2], ops[4], ops[5], ops[6]
    want = np.asarray(jax.vmap(jax_longlog.include_mask)(
        jnp.asarray(ops_vc), jnp.asarray(n_ops), jnp.asarray(base_vc),
        jnp.asarray(read_vc)))
    got = longlog.include_mask(*map(torch.as_tensor,
                                    (ops_vc, n_ops, base_vc, read_vc)))
    np.testing.assert_array_equal(want, got.numpy())
    assert 0 < want.sum() < want.size  # the logs mix included and not


@pytest.mark.parametrize("name", ASSOC_TYPES)
def test_assoc_fold_matches_jax_and_the_serial_fold(name):
    state, ops = _case(name)
    want, w_applied = _jax_per_key(jax_longlog.assoc_fold, name, state, ops)
    ty = get_type(name)
    targs = [torch.as_tensor(x) for x in ops]
    got, applied = longlog.assoc_fold(ty, TCFG, _t(state), *targs)
    _assert_states(want, _np(got), f"{name} assoc")
    np.testing.assert_array_equal(w_applied, applied.numpy())
    serial, s_applied = fold.fold_batch(ty, TCFG, _t(state), *targs)
    _assert_states(_np(serial), _np(got), f"{name} assoc vs serial")
    np.testing.assert_array_equal(s_applied.numpy(), applied.numpy())


@pytest.mark.parametrize("name", ASSOC_TYPES)
def test_fold_long_matches_jax_and_the_serial_fold(name):
    state, ops = _case(name)
    want, w_applied = _jax_per_key(
        functools.partial(jax_longlog.fold_long, chunk=CHUNK), name, state,
        ops)
    ty = get_type(name)
    targs = [torch.as_tensor(x) for x in ops]
    got, applied = longlog.fold_long(ty, TCFG, _t(state), *targs,
                                     chunk=CHUNK)
    _assert_states(want, _np(got), f"{name} fold_long")
    np.testing.assert_array_equal(w_applied, applied.numpy())
    serial, s_applied = fold.fold_batch(ty, TCFG, _t(state), *targs)
    _assert_states(_np(serial), _np(got), f"{name} fold_long vs serial")
    np.testing.assert_array_equal(s_applied.numpy(), applied.numpy())


@pytest.mark.parametrize("name", ASSOC_TYPES)
def test_delta_merge_matches_jax(name):
    """Deltas of the two halves of each window, merged: equal to the JAX
    merge of the same halves, and applied equal to the whole window's
    assoc fold."""
    state, ops = _case(name)
    ops_a, ops_b, ops_vc, origin, n_ops, base_vc, read_vc = ops
    mask = np.array(jax.vmap(jax_longlog.include_mask)(
        jnp.asarray(ops_vc), jnp.asarray(n_ops), jnp.asarray(base_vc),
        jnp.asarray(read_vc)))
    jty, ty = jax_crdt.get_type(name), get_type(name)
    h = L // 2
    halves = [[x[:, sl] for x in (ops_a, ops_b, ops_vc, origin, mask)]
              for sl in (slice(0, h), slice(h, L))]

    def jax_delta(a, b, v, o, m):
        return jax.vmap(functools.partial(jty.delta_of_ops, JCFG))(
            *map(jnp.asarray, (a, b, v, o, m)))

    want = _np(jax.vmap(jty.delta_merge)(*[jax_delta(*x) for x in halves]))
    parts = [ty.delta_of_ops(TCFG, *map(torch.as_tensor, x))
             for x in halves]
    merged = ty.delta_merge(*parts)
    _assert_states(want, _np(merged), f"{name} merge")
    whole, _ = longlog.assoc_fold(ty, TCFG, _t(state),
                                  *map(torch.as_tensor, ops))
    _assert_states(_np(whole), _np(ty.delta_apply(_t(state), merged)),
                   f"{name} merged apply")


# ---------------------------------------------------------------------------
# the table's assoc strategy
# ---------------------------------------------------------------------------
N_KEYS, ROUNDS = 24, 20


@pytest.fixture(scope="module", params=["flag_ew", "flag_dw"])
def flag_tables(request):
    name = request.param
    rng = np.random.default_rng(zlib.crc32(name.encode()) + 1)
    st = populate_stream(name, rng, N_KEYS, ROUNDS, TCFG)
    jt = JaxTable(jax_crdt.get_type(name), JCFG)
    tt = TypedTable(get_type(name), TCFG, device="cpu")
    shards = st["keys"] % KW["n_shards"]
    rows = st["keys"] // KW["n_shards"]
    for t in (jt, tt):
        t.used_rows[:] = N_KEYS // KW["n_shards"]
    for lo in range(0, len(shards), 16):
        sl = slice(lo, lo + 16)
        batch = (shards[sl], rows[sl], st["eff_a"][sl], st["eff_b"][sl],
                 st["vcs"][sl], st["origins"][sl])
        jt.append(*batch)
        tt.append(*batch)
    return name, jt, tt, st["cum"], shards, rows


def test_flag_tables_dispatch_assoc_and_match_jax(flag_tables):
    name, jt, tt, cum, shards, rows = flag_tables
    assert tt._fold_strategy() == jt._fold_strategy() == "assoc"
    ks = np.arange(N_KEYS)
    ss, rr = ks % KW["n_shards"], ks // KW["n_shards"]
    stale_rows = 0
    for t_read in (len(cum) - 1, int(len(cum) * 0.9), int(len(cum) * 0.7),
                   int(len(cum) * 0.45)):
        vcs = np.broadcast_to(cum[t_read], (N_KEYS, D))
        w_res, w_fresh, w_comp = jt.read_resolved_flat(ss, rr, vcs)
        g_res, g_fresh, g_comp = tt.read_resolved_flat(ss, rr, vcs)
        np.testing.assert_array_equal(np.asarray(w_res["value"]),
                                      g_res["value"].numpy())
        np.testing.assert_array_equal(np.asarray(w_fresh), g_fresh)
        np.testing.assert_array_equal(np.asarray(w_comp), g_comp)
        w_state, w_applied, w_full = jt.read(ss, rr, vcs)
        g_state, g_applied, g_full = tt.read(ss, rr, vcs)
        _assert_states(w_state, g_state, f"{name} read at {t_read}")
        np.testing.assert_array_equal(w_applied, g_applied)
        np.testing.assert_array_equal(w_full, g_full)
        stale_rows += int((~g_fresh).sum())
    assert stale_rows > 0  # historical reads reached the fold
    assert tt.fold_dispatches.get("assoc", 0) >= 1
    assert set(tt.fold_dispatches) == {"assoc"}
    assert jt.fold_dispatches == tt.fold_dispatches


@pytest.mark.parametrize("name", [n for n in TYPE_NAMES
                                  if not n.startswith("map_")])
def test_other_types_keep_their_strategies(name):
    t = TypedTable(get_type(name), TCFG, n_rows=4, device="cpu")
    want = {"set_aw": "kernel_set_aw", "counter_pn": "kernel_counter",
            "flag_ew": "assoc", "flag_dw": "assoc"}.get(name, "serial")
    assert t._fold_strategy() == want
