"""Parity of the port's CRDT boundary (``set_aw``, ``counter_pn``) with the
JAX package on seeded random states: per-op ``apply``, ``resolve`` against
the plain branch of the JAX resolve, ``downstream`` and ``value`` through a
``BlobStore``, and the type registry.  Exact equality throughout."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antidote_tpu import crdt as jax_crdt
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu.crdt import base as jax_base
from antidote_tpu.crdt.blob import BlobStore as JaxBlobStore
from antidote_tpu_torch import crdt
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt import base
from antidote_tpu_torch.crdt.blob import BlobStore

D, E = 3, 8
KW = dict(n_shards=2, max_dcs=D, ops_per_key=8, set_slots=E)
JCFG, TCFG = JaxConfig(**KW), AntidoteConfig(**KW)


def _rand_set_states(rng, b, handles):
    elems = rng.choice(np.append(handles, [0, 0]), size=(b, E))
    return {
        "elems": elems.astype(np.int64),
        "addvc": rng.integers(0, 5, size=(b, E, D)).astype(np.int32),
        "rmvc": rng.integers(0, 5, size=(b, E, D)).astype(np.int32),
        "ovf": rng.integers(0, 2, size=(b,)).astype(np.int32),
    }


def _jax_apply(name, state, a, b, v, o):
    ty = jax_crdt.get_type(name)
    fn = jax.vmap(functools.partial(ty.apply, JCFG))
    out = fn({f: jnp.asarray(x) for f, x in state.items()}, jnp.asarray(a),
             jnp.asarray(b), jnp.asarray(v), jnp.asarray(o))
    return {f: np.asarray(x) for f, x in out.items()}


def _torch_apply(name, state, a, b, v, o):
    ty = crdt.get_type(name)
    t = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    out = ty.apply(TCFG, {f: t(x) for f, x in state.items()}, t(a), t(b),
                   t(v), t(o))
    return {f: x.numpy() for f, x in out.items()}


def _assert_states(want, got, msg):
    for f in want:
        np.testing.assert_array_equal(want[f], got[f], err_msg=f"{msg}:{f}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_set_aw_apply_matches_jax_per_op(seed):
    rng = np.random.default_rng(seed)
    b = 48
    handles = (rng.integers(1, 2**40, size=12) | (1 << 32)).astype(np.int64)
    state = _rand_set_states(rng, b, handles)
    for step in range(6):
        a = rng.choice(handles, size=(b, 1)).astype(np.int64)
        eff_b = np.zeros((b, 1 + D), np.int32)
        eff_b[:, 0] = rng.random(b) < 0.35
        eff_b[:, 1:] = rng.integers(0, 6, size=(b, D))
        v = rng.integers(0, 7, size=(b, D)).astype(np.int32)
        o = rng.integers(0, D, size=(b,)).astype(np.int32)
        want = _jax_apply("set_aw", state, a, eff_b, v, o)
        got = _torch_apply("set_aw", state, a, eff_b, v, o)
        _assert_states(want, got, f"step {step}")
        state = want


def test_counter_pn_apply_matches_jax_per_op():
    rng = np.random.default_rng(4)
    b = 32
    state = {"cnt": rng.integers(-2**40, 2**40, size=(b,)).astype(np.int64)}
    for _ in range(4):
        a = rng.integers(-2**35, 2**35, size=(b, 1)).astype(np.int64)
        eff_b = np.zeros((b, 1), np.int32)
        v = rng.integers(0, 5, size=(b, D)).astype(np.int32)
        o = np.zeros((b,), np.int32)
        want = _jax_apply("counter_pn", state, a, eff_b, v, o)
        _assert_states(want, _torch_apply("counter_pn", state, a, eff_b, v, o),
                       "counter")
        state = want


@pytest.mark.parametrize("name", ["set_aw", "counter_pn"])
def test_resolve_matches_jax_plain_branch(name):
    rng = np.random.default_rng(5)
    m = 64
    if name == "set_aw":
        handles = (rng.integers(1, 2**40, size=20)).astype(np.int64)
        handles[:3] = [1 << 32, 2 << 32, 7]  # zero low halves stay occupied
        state = _rand_set_states(rng, m, handles)
    else:
        state = {"cnt": rng.integers(-99, 99, size=(m,)).astype(np.int64)}
    want = jax_crdt.get_type(name).resolve(
        JCFG, {f: jnp.asarray(x) for f, x in state.items()})
    got = crdt.get_type(name).resolve(
        TCFG, {f: torch.as_tensor(x) for f, x in state.items()})
    _assert_states({f: np.asarray(x) for f, x in want.items()},
                   {f: x.numpy() for f, x in got.items()}, name)


def test_compact_top_keeps_the_stable_slot_order():
    rng = np.random.default_rng(6)
    elems = rng.integers(1, 1000, size=(40, 16)).astype(np.int64)
    present = rng.random((40, 16)) < 0.3
    want = jax_base.compact_top(jnp.asarray(elems), jnp.asarray(present), 4)
    got = base.compact_top(torch.as_tensor(elems), torch.as_tensor(present), 4)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_downstream_and_value_match_jax_through_blobs():
    """Effects of the same client ops (observed-remove downstream reading a
    state) and the values decoded from the same states, in both packages,
    each through its own BlobStore."""
    jb, tb = JaxBlobStore(), BlobStore()
    values = ["a", "b", 7, ["n", 1], {"k": 2}, b"raw"]
    rng = np.random.default_rng(8)
    hs = np.asarray([jb.intern(v) for v in values], np.int64)
    assert [tb.intern(v) for v in values] == hs.tolist()
    states = _rand_set_states(rng, 6, hs)
    ops = [("add", "a"), ("add_all", ["b", 7, ["n", 1]]),
           ("remove", "a"), ("remove_all", ["b", "zz"]), ("add", b"raw")]
    for name, ops_, st in (("set_aw", ops, states),
                           ("counter_pn", [("increment", 5),
                                           ("decrement", 2**40)], None)):
        jt, tt = jax_crdt.get_type(name), crdt.get_type(name)
        for i, op in enumerate(ops_):
            assert jt.is_operation(op) == tt.is_operation(op)
            assert (jt.require_state_downstream(op)
                    == tt.require_state_downstream(op))
            s = None if st is None else {f: x[i] for f, x in st.items()}
            want = jt.downstream(op, s, jb, JCFG)
            got = tt.downstream(op, s, tb, TCFG)
            assert len(want) == len(got)
            for (wa, wb, wr), (ga, gb, gr) in zip(want, got):
                np.testing.assert_array_equal(wa, ga)
                np.testing.assert_array_equal(wb, gb)
                assert wr == gr
                assert jt.slot_demand(wa, wb) == tt.slot_demand(ga, gb)
    ja, ta = jax_crdt.get_type("set_aw"), crdt.get_type("set_aw")
    for i in range(6):
        s = {f: x[i] for f, x in states.items()}
        s["ovf"] = np.int32(0)
        assert ja.value(s, jb, JCFG) == ta.value(s, tb, TCFG)
        assert ja.used_slots(s) == ta.used_slots(s)
        rv = ta.resolve(TCFG, {f: torch.as_tensor(x)[None]
                               for f, x in s.items()})
        rv = {f: x[0].numpy() for f, x in rv.items()}
        v = ta.value_from_resolved(rv, tb, TCFG)
        if v is base.RESOLVE_OVERFLOW:
            assert int(rv["count"]) > ta.resolve_top
        else:
            assert v == ja.value(s, jb, JCFG)
    eff_b = np.asarray([1, 4, 9, 2], np.int32)
    for tent in (9, 3):
        want = ja.restamp_own_dots(JCFG, None, eff_b, 1, tent, 11)[1]
        got = ta.restamp_own_dots(TCFG, None, eff_b, 1, tent, 11)[1]
        np.testing.assert_array_equal(want, got)


def test_registry_answers_for_every_jax_type():
    """Every one of the store's 13 types resolves in the port, under the
    JAX package's ``type_id``, with the same lane widths, commutativity
    and composite flag."""
    assert set(crdt.TYPE_NAMES) == set(jax_crdt.TYPES)
    assert len(crdt.TYPES) == 13
    for name, jt in jax_crdt.TYPES.items():
        assert crdt.is_type(name)
        t = crdt.get_type(name)
        assert (t.name, t.type_id) == (name, jt.type_id)
        assert t.commutative_blind == jt.commutative_blind
        composite = getattr(jt, "composite", False)
        assert getattr(t, "composite", False) == composite
        assert (name in crdt.COMPOSITE_NAMES) == composite
        if not composite:
            assert t.eff_a_width(TCFG) == jt.eff_a_width(JCFG)
            assert t.eff_b_width(TCFG) == jt.eff_b_width(JCFG)
    assert not crdt.is_type("no_such_type")
    with pytest.raises(KeyError):
        crdt.get_type("no_such_type")
