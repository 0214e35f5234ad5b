"""Parity of the port's other eleven CRDT types with the JAX package:
the batched ``apply`` against ``jax.vmap(ty.apply)`` on seeded states and
effects (edge rows included), ``resolve`` against the JAX resolve,
``downstream`` / ``value`` / slot accounting / restamping through a
``BlobStore``, rga's host twin ``apply_host`` against its batched
``apply`` on random op tapes, and the map composites' ``expand_update``
and key placement against the JAX router.  Exact equality throughout."""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antidote_tpu import crdt as jax_crdt
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu.crdt import maps as jax_maps
from antidote_tpu.crdt import registers as jax_registers
from antidote_tpu.crdt.blob import BlobStore as JaxBlobStore
from antidote_tpu.store import router as jax_router
from antidote_tpu_torch import crdt
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt import base, maps, registers
from antidote_tpu_torch.crdt.blob import BlobStore
from antidote_tpu_torch.crdt.type_cases import (DEVICE_TYPES, clock_batch,
                                                edge_states, effect_batch,
                                                state_batch)
from antidote_tpu_torch.store import router

D, E, MV, S = 3, 8, 4, 16
KW = dict(n_shards=4, max_dcs=D, ops_per_key=8, set_slots=E, mv_slots=MV,
          rga_slots=S)
JCFG, TCFG = JaxConfig(**KW), AntidoteConfig(**KW)
B = 96


def _jax_apply(name, state, a, b, v, o):
    fn = jax.vmap(functools.partial(jax_crdt.get_type(name).apply, JCFG))
    out = fn({f: jnp.asarray(x) for f, x in state.items()}, jnp.asarray(a),
             jnp.asarray(b), jnp.asarray(v), jnp.asarray(o))
    return {f: np.array(x) for f, x in out.items()}


def _torch_apply(name, state, a, b, v, o):
    t = lambda x: torch.as_tensor(np.array(x))  # noqa: E731
    out = crdt.get_type(name).apply(TCFG, {f: t(x) for f, x in state.items()},
                                    t(a), t(b), t(v), t(o))
    return {f: x.numpy() for f, x in out.items()}


def _assert_states(want, got, msg):
    assert set(want) == set(got), msg
    for f in want:
        assert got[f].dtype == want[f].dtype, f"{msg}:{f}"
        np.testing.assert_array_equal(want[f], got[f], err_msg=f"{msg}:{f}")


@pytest.mark.parametrize("name", DEVICE_TYPES)
def test_batched_apply_matches_jax_vmap(name):
    """Several steps of one effect per row, each held to the JAX type's
    vmapped ``apply``; rga from the empty state, so later steps insert
    among earlier uids (concurrent siblings, full keys past 16 inserts)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    state = state_batch(name, rng, B, TCFG)
    steps = 24 if name == "rga" else 6
    for step in range(steps):
        a, b = effect_batch(name, rng, state, TCFG)
        v, o = clock_batch(rng, B, TCFG, hi=2**20 if name != "rga" else 300)
        if name == "rga":
            v[:, 0] += 200 + step  # stamps past 128: the int64 shift
            o[::3] = 0  # same origin and stamp: uid order by op seq
            v[::3] = v[0]
        want = _jax_apply(name, state, a, b, v, o)
        got = _torch_apply(name, state, a, b, v, o)
        _assert_states(want, got, f"{name} step {step}")
        state = want
    if name == "rga":
        assert (state["ovf"] > 0).any() and (state["tomb"] == 1).any()
        assert (state["uid"][:, S - 1] != 0).any()


@pytest.mark.parametrize("name", ["set_rw", "set_go", "register_mv", "rga",
                                  "counter_b"])
def test_apply_on_full_and_empty_rows(name):
    """The ``argmax`` sites on their edges: every row full (the ovf
    path, and argmax of an all-false row), every row empty (ties: the
    first slot)."""
    rng = np.random.default_rng(3)
    edges = edge_states(name, rng, state_batch(name, rng, B, TCFG), TCFG)
    for tag, st in edges.items():
        a, b = effect_batch(name, rng, st, TCFG)
        if name == "register_mv":
            a[:, 1:] = 0  # observes nothing: a full row cannot insert
        v, o = clock_batch(rng, B, TCFG, hi=300)
        want = _jax_apply(name, st, a, b, v, o)
        _assert_states(want, _torch_apply(name, st, a, b, v, o),
                       f"{name} {tag}")
        if tag == "full" and name != "counter_b":
            assert (want["ovf"] > st["ovf"]).any()


def _resolve_states(rng, name):
    st = state_batch(name, rng, B, TCFG)
    for f in ("elems", "ids"):
        if f in st:
            st[f][3::7] = 0  # nothing present
    if name == "set_rw":
        st["addvc"][::4] = 0  # no add: absent whatever the clocks
        st["rmvc"][1::4] = 0
    return st


@pytest.mark.parametrize("name", [n for n in DEVICE_TYPES
                                  if crdt.get_type(n).resolve_spec(TCFG)])
def test_resolve_matches_jax(name):
    """The compact resolved view against the JAX resolve (plain XLA for
    these types), with present counts 0, at ``resolve_top`` and past it."""
    rng = np.random.default_rng(7)
    st = _resolve_states(rng, name)
    jt, tt = jax_crdt.get_type(name), crdt.get_type(name)
    assert tt.resolve_spec(TCFG).keys() == jt.resolve_spec(JCFG).keys()
    want = jt.resolve(JCFG, {f: jnp.asarray(x) for f, x in st.items()})
    got = tt.resolve(TCFG, {f: torch.as_tensor(x) for f, x in st.items()})
    _assert_states({f: np.asarray(x) for f, x in want.items()},
                   {f: x.numpy() for f, x in got.items()}, name)
    if "count" in want:
        counts = set(np.asarray(want["count"]).tolist())
        assert 0 in counts and tt.resolve_top in counts
        assert max(counts) > tt.resolve_top or name == "register_mv"


def test_types_without_resolution_match_jax():
    for name in ("counter_b", "rga"):
        assert crdt.get_type(name).resolve_spec(TCFG) is None
        assert jax_crdt.get_type(name).resolve_spec(JCFG) is None


# ---------------------------------------------------------------------------
# downstream, value, slot accounting and restamping through blob stores
# ---------------------------------------------------------------------------
VALUES = ["a", "b", 7, ["n", 1], {"k": 2}, b"raw", "zz"]


def _op_cases(st_of):
    """(type, op, state for the downstream) cases; ``st_of(name, i)`` is a
    seeded host state of the type."""
    return [
        ("counter_fat", ("increment", 5), None),
        ("counter_fat", ("decrement", 2**40), None),
        ("counter_fat", ("reset", None), st_of("counter_fat", 0)),
        ("counter_b", ("increment", (5, 1)), None),
        ("counter_b", ("decrement", (3, 0)), None),
        ("counter_b", ("transfer", (4, 2, 0)), None),
        ("register_lww", ("assign", "a"), None),
        ("register_lww", ("assign", ["n", 1]), None),
        ("register_mv", ("assign", "b"), st_of("register_mv", 1)),
        ("register_mv", ("assign", 7), st_of("register_mv", 2)),
        ("set_rw", ("add", "a"), st_of("set_rw", 0)),
        ("set_rw", ("add_all", ["b", 7, "zz"]), st_of("set_rw", 1)),
        ("set_rw", ("remove", "a"), None),
        ("set_rw", ("remove_all", ["b", "q"]), None),
        ("set_go", ("add", {"k": 2}), None),
        ("set_go", ("add_all", ["a", b"raw"]), None),
        ("flag_ew", ("enable", None), None),
        ("flag_ew", ("disable", None), st_of("flag_ew", 0)),
        ("flag_ew", ("reset", None), st_of("flag_ew", 1)),
        ("flag_dw", ("enable", None), st_of("flag_dw", 0)),
        ("flag_dw", ("disable", None), None),
        ("flag_dw", ("reset", None), None),
        ("rga", ("insert", (0, "a")), st_of("rga", 0)),
        ("rga", ("insert", (2, "b")), st_of("rga", 0)),
        ("rga", ("delete", 1), st_of("rga", 0)),
        ("rga", ("add_right", (77, "x")), None),
    ]


def _host_states(jb):
    """Seeded host states with handles of VALUES interned, and an rga
    document built by the JAX apply."""
    rng = np.random.default_rng(11)
    hs = np.asarray([jb.intern(v) for v in VALUES], np.int64)
    out = {}
    for name in DEVICE_TYPES:
        st = state_batch(name, rng, B, TCFG)
        if name in ("set_rw", "set_go"):
            st["elems"] = rng.choice(np.append(hs, [0, 0]), (B, E))
        if name == "register_mv":
            st["vals"] = np.where(st["ids"] != 0,
                                  rng.choice(hs, (B, MV)), 0)
        if name == "register_lww":
            st["val"] = rng.choice(np.append(hs, 0), B)
        out[name] = st
    doc = {f: x[:1] for f, x in out["rga"].items()}
    for i, h in enumerate(hs[:5]):
        a = np.asarray([[h, 0 if i == 0 else doc["uid"][0, 0]]])
        v = np.asarray([[300 + i, 0, 0]], np.int32)
        doc = _jax_apply("rga", doc, a, np.zeros((1, 2), np.int32), v,
                         np.zeros(1, np.int32))
    doc["tomb"][0, 2] = 1
    out["rga"] = {f: np.repeat(x, B, 0) for f, x in doc.items()}
    return out


def test_downstream_value_and_slots_match_jax(monkeypatch):
    """Effects of the same client ops in both packages (the LWW wall clock
    patched to one value in both), each through its own BlobStore, and
    the values, slot counts and resolved decodes of the same states."""
    monkeypatch.setattr(jax_registers, "_now_micros", lambda: 1234567)
    monkeypatch.setattr(registers, "_now_micros", lambda: 1234567)
    jb, tb = JaxBlobStore(), BlobStore()
    assert [tb.intern(v) for v in VALUES] == [jb.intern(v) for v in VALUES]
    states = _host_states(jb)

    def st_of(name, i):
        return {f: x[i] for f, x in states[name].items()}

    for name, op, st in _op_cases(st_of):
        jt, tt = jax_crdt.get_type(name), crdt.get_type(name)
        assert jt.is_operation(op) == tt.is_operation(op), (name, op)
        assert (jt.require_state_downstream(op)
                == tt.require_state_downstream(op)), (name, op)
        want = jt.downstream(op, st, jb, JCFG)
        got = tt.downstream(op, st, tb, TCFG)
        assert len(want) == len(got), (name, op)
        for (wa, wb, wr), (ga, gb, gr) in zip(want, got):
            np.testing.assert_array_equal(wa, ga, err_msg=f"{name} {op}")
            np.testing.assert_array_equal(wb, gb, err_msg=f"{name} {op}")
            assert wa.dtype == ga.dtype and wb.dtype == gb.dtype
            assert wr == gr
            assert jt.slot_demand(wa, wb) == tt.slot_demand(ga, gb)
            for seq in (0, 5, 65535):
                ja, jbb = jt.stamp_op_seq(wa, wb, seq)
                ta, tbb = tt.stamp_op_seq(ga, gb, seq)
                np.testing.assert_array_equal(ja, ta)
                np.testing.assert_array_equal(jbb, tbb)
            for tent in (int(wb[1]) if wb.shape[0] > 1 else 3, 300, 302):
                for lanes in ((wa, wb),
                              (np.full_like(wa, (tent << 24) | 1), wb),
                              (np.full_like(wa, (tent << 8) | 1), wb),
                              (wa, np.full_like(wb, tent))):
                    jr = jt.restamp_own_dots(JCFG, *lanes, 1, tent, 900)
                    tr = tt.restamp_own_dots(TCFG, *lanes, 1, tent, 900)
                    for x, y in zip(jr, tr):
                        np.testing.assert_array_equal(x, y)
    with pytest.raises(OverflowError, match="65535"):
        crdt.get_type("rga").stamp_op_seq(np.zeros(2, np.int64),
                                          np.zeros(2, np.int32), 65536)
    for bad in (("delete", 9), ("insert", (9, "x"))):
        for t, blobs, cfg in ((jax_crdt, jb, JCFG), (crdt, tb, TCFG)):
            with pytest.raises(IndexError):
                t.get_type("rga").downstream(bad, st_of("rga", 0), blobs, cfg)
    for name in DEVICE_TYPES:
        jt, tt = jax_crdt.get_type(name), crdt.get_type(name)
        assert tt.slot_capacity(TCFG) == jt.slot_capacity(JCFG)
        for i in range(12):
            s = st_of(name, i)
            if "ovf" in s:
                s["ovf"] = np.int32(0)
            assert tt.value(s, tb, TCFG) == jt.value(s, jb, JCFG), (name, i)
            assert tt.used_slots(s) == jt.used_slots(s)
            if tt.resolve_spec(TCFG) is None:
                continue
            rv = tt.resolve(TCFG, {f: torch.as_tensor(np.asarray(x))[None]
                                   for f, x in s.items()})
            rv = {f: x[0].numpy() for f, x in rv.items()}
            v = tt.value_from_resolved(rv, tb, TCFG)
            if v is base.RESOLVE_OVERFLOW:
                assert int(rv["count"]) > tt.resolve_top
            else:
                assert v == jt.value(s, jb, JCFG), (name, i)
    cb_j, cb_t = jax_crdt.get_type("counter_b"), crdt.get_type("counter_b")
    for i in range(6):
        for dc in range(D):
            assert (cb_t.local_rights(st_of("counter_b", i), dc)
                    == cb_j.local_rights(st_of("counter_b", i), dc))


# ---------------------------------------------------------------------------
# rga: the host twin against the batched apply
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rga_apply_host_matches_batched_apply(seed):
    """Random op tapes on one key (inserts anywhere, head inserts,
    deletes, missing origins, several DCs at one stamp, past the slot
    count): the port's ``apply_host``, its batched ``apply`` and the JAX
    package's ``apply_host`` agree after every op."""
    rng = np.random.default_rng(seed)
    ty, jt = crdt.get_type("rga"), jax_crdt.get_type("rga")
    one = state_batch("rga", rng, 1, TCFG)
    host = {f: x[0] for f, x in one.items()}
    for step in range(40):
        a, b = effect_batch("rga", rng, {"uid": host["uid"][None]}, TCFG)
        v, o = clock_batch(rng, 1, TCFG, hi=300)
        v[0, 0] += 128
        host = ty.apply_host(TCFG, host, a[0], b[0], v[0], int(o[0]))
        jhost = jt.apply_host(JCFG, {f: x[0] for f, x in one.items()},
                              a[0], b[0], v[0], int(o[0]))
        one = _torch_apply("rga", one, a, b, v, o)
        for f in one:
            np.testing.assert_array_equal(host[f], one[f][0],
                                          err_msg=f"step {step} {f}")
            np.testing.assert_array_equal(jhost[f], one[f][0])
    assert int(host["ovf"]) > 0


# ---------------------------------------------------------------------------
# maps
# ---------------------------------------------------------------------------
MAP_OPS = [
    ("map_rr", ("update", {("clicks", "counter_pn"): ("increment", 3),
                           ("name", "register_lww"): ("assign", "u"),
                           ("tags", "set_aw"): ("add", "t1")})),
    ("map_go", ("update", [(("f", "set_go"), ("add_all", [1, 2]))])),
    ("map_rr", ("update", {("sub", "map_rr"):
                           ("update", {("x", "flag_ew"): ("enable", None)})})),
    ("map_rr", ("remove", ("tags", "set_aw"))),
    ("map_rr", ("remove_all", [("tags", "set_rw"), ("c", "counter_fat"),
                               ("f", "flag_dw"), ("r", "rga"),
                               ("n", "counter_pn")])),
]


def test_map_types_and_expand_update_match_jax():
    current = {"set_aw": ["t1", "t2"], "set_rw": [], "counter_fat": 9,
               "flag_dw": True, "rga": ["a"], "counter_pn": 4}

    def read_field_value(fk, ft):
        return current[ft]

    for map_type, op in MAP_OPS:
        jt, tt = jax_crdt.get_type(map_type), crdt.get_type(map_type)
        assert tt.is_operation(op) == jt.is_operation(op)
        for key in ("m", ("nested", 3), 17):
            want = jax_maps.expand_update(key, map_type, "b", op,
                                          read_field_value)
            got = maps.expand_update(key, map_type, "b", op,
                                     read_field_value)
            assert got == want
    for map_type in ("map_rr", "map_go"):
        jt, tt = jax_crdt.get_type(map_type), crdt.get_type(map_type)
        for op in [("update", "oops"), ("update", {("f", "nope"): ("x", 1)}),
                   ("update", {("f", "counter_pn"): ("assign", 1)}),
                   ("remove", ("f", "set_aw")), ("bogus", None)]:
            assert tt.is_operation(op) == jt.is_operation(op), (map_type, op)
        with pytest.raises(TypeError, match="composite"):
            tt.state_spec(TCFG)
    with pytest.raises(AssertionError):
        maps.expand_update("m", "map_go", "b", ("remove", ("f", "set_go")),
                           read_field_value)
    assert maps.MAP_MEMBERSHIP == jax_maps.MAP_MEMBERSHIP


def test_map_keys_land_on_the_jax_shard():
    """A map's membership and field keys (nested tuples) hash to the same
    shard in both routers, for string, integer and tuple parents."""
    for n_shards in (1, 4, 7, 2048):
        for parent in ("m", 17, ("nested", 3), "doc9"):
            keys = [jax_maps.member_key(parent),
                    jax_maps.field_key(parent, "clicks", "counter_pn"),
                    jax_maps.field_key(jax_maps.field_key(parent, "s",
                                                          "map_rr"),
                                       "x", "flag_ew")]
            assert [maps.member_key(parent),
                    maps.field_key(parent, "clicks", "counter_pn"),
                    maps.field_key(maps.field_key(parent, "s", "map_rr"),
                                   "x", "flag_ew")] == keys
            for k in keys:
                for bucket in ("b", "other"):
                    assert router.key_bytes(k, bucket) == \
                        jax_router.key_bytes(k, bucket)
                    assert router.shard_of(k, bucket, n_shards) == \
                        jax_router.shard_of(k, bucket, n_shards)
