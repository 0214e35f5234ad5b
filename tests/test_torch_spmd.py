"""The port's shard placement and replica step against the JAX package's.

The port's mesh is ``[cpu] * 8`` (blocks of a placed table on the CPU);
the JAX package's is the 8 virtual CPU devices of ``tests/conftest.py``.
Exact equality throughout (integer state, decoded values):

  * ``sharded_step_fn``'s nine outputs on the JAX tests' counter and
    ``set_aw`` batches;
  * node workloads on placed tables (``set_aw`` and ``map_rr``, reads at a
    snapshot while commits interleave), against the JAX mesh node;
  * ``reshard`` 8 -> 16 keeping the placement, 8 -> 4 falling back with
    the JAX package's warning, handoff between two placed nodes;
  * the giant-key fold: ``longlog.sharded_assoc_fold_fn`` and
    ``MeshServingPlane.fold_giant_key`` against the JAX ones, and the
    replay ladder's ``mesh_assoc`` rung.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from antidote_tpu.api import AntidoteNode as JaxNode
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu.crdt import get_type as jax_type
from antidote_tpu.materializer import longlog as jax_longlog
from antidote_tpu.parallel import MeshServingPlane as JaxPlane
from antidote_tpu.parallel import make_mesh as jax_make_mesh
from antidote_tpu.parallel import shard_axis_sharding as jax_sharding
from antidote_tpu.parallel import sharded_step_fn as jax_step_fn
from antidote_tpu.store import TypedTable as JaxTable
from antidote_tpu.store import handoff as jax_handoff
from antidote_tpu_torch.api import AntidoteNode
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.parallel import (MeshServingPlane, SHARD_AXIS,
                                         make_mesh, shard_axis_sharding,
                                         sharded_step_fn)
from antidote_tpu_torch.store import TypedTable, handoff

CPU = torch.device("cpu")


def _mesh(n=8):
    return make_mesh(n, devices=[CPU] * n)


def _cat(parts):
    """Per-block step outputs as one [P, ...] host array (or field dict)."""
    if isinstance(parts[0], dict):
        return {f: _cat([p[f] for p in parts]) for f in parts[0]}
    return torch.cat([p.cpu() for p in parts]).numpy()


def _np(x):
    if isinstance(x, dict):
        return {f: np.asarray(v) for f, v in x.items()}
    return np.asarray(x)


def _assert_equal(want, got, msg):
    if isinstance(want, dict):
        assert set(want) == set(got), msg
        for f in want:
            _assert_equal(want[f], got[f], f"{msg}:{f}")
        return
    assert want.dtype == got.dtype, (msg, want.dtype, got.dtype)
    np.testing.assert_array_equal(want, got, err_msg=msg)


def test_make_mesh_and_placement():
    mesh = _mesh(4)
    assert mesh.shape == {SHARD_AXIS: 4} and mesh.devices == (CPU,) * 4
    sh = shard_axis_sharding(mesh)
    assert sh.shards_per_block(8) == 2
    with pytest.raises(ValueError):
        sh.shards_per_block(6)
    with pytest.raises(ValueError):
        make_mesh(5, devices=[CPU] * 4)
    t = TypedTable(get_type("counter_pn"),
                   AntidoteConfig(n_shards=8, keys_per_table=16),
                   device="cpu", sharding=sh)
    assert [(b.off, b.n) for b in t.blocks] == [(0, 2), (2, 2), (4, 2),
                                                (6, 2)]
    with pytest.raises(TypeError):
        t.ops_a  # noqa: B018 — a placed table has no flat tensors


# ---------------------------------------------------------------------------
# sharded_step_fn
# ---------------------------------------------------------------------------
def _step_case(name, ty, c, n_rows):
    p, ma, mr, d = c.n_shards, 8, 8, c.max_dcs
    aw, bw = ty.eff_a_width(c), ty.eff_b_width(c)
    app_rows = np.zeros((p, ma), np.int64)
    app_slots = np.zeros((p, ma), np.int64)
    app_a = np.zeros((p, ma, aw), np.int64)
    app_b = np.zeros((p, ma, bw), np.int32)
    app_vc = np.zeros((p, ma, d), np.int32)
    app_origin = np.zeros((p, ma), np.int32)
    read_rows = np.zeros((p, mr), np.int64)
    read_vcs = np.ones((p, mr, d), np.int32)
    applied_vc = np.zeros((p, d), np.int32)
    if name == "counter":
        # test_spmd: one increment of +shard on row 0 of every shard
        app_rows[:, 1:] = n_rows  # padding
        app_a[:, 0, 0] = np.arange(p) + 1
        app_vc[:, 0, 0] = 1
        read_n_ops = np.ones((p, mr), np.int32)
    elif name == "counter_filtered":
        # test_mesh: two ops, the read VC sees the first only
        app_rows[:, 2:] = n_rows
        app_slots[:, 1] = 1
        app_a[:, 0, 0] = np.arange(p) + 1
        app_a[:, 1, 0] = 10
        app_vc[:, 0, 0] = 1
        app_vc[:, 1, 0] = 2
        read_n_ops = np.full((p, mr), 2, np.int32)
    else:
        # test_spmd_wide: one add of handle (shard+1)*100 on row 0
        app_rows[:, 1:] = n_rows
        app_a[:, 0, 0] = (np.arange(p) + 1) * 100
        app_vc[:, 0, 0] = 1
        read_n_ops = np.zeros((p, mr), np.int32)
        read_n_ops[:, 0] = 1
        read_vcs = np.zeros((p, mr, d), np.int32)
        read_vcs[..., 0] = 1
    return (app_rows, app_slots, app_a, app_b, app_vc, app_origin,
            read_rows, read_n_ops, read_vcs, applied_vc)


@pytest.mark.parametrize("case,type_name,n_blocks", [
    ("counter", "counter_pn", 8), ("counter_filtered", "counter_pn", 4),
    ("set_aw", "set_aw", 8), ("set_aw", "set_aw", 2)])
def test_sharded_step_matches_jax(case, type_name, n_blocks):
    assert len(jax.devices()) == 8, "conftest must force 8 devices"
    kw = dict(n_shards=8, max_dcs=2, ops_per_key=8 if case == "set_aw"
              else 4, snap_versions=2, keys_per_table=16)
    if case == "set_aw":
        kw["set_slots"] = 8
    jc = JaxConfig(**kw, batch_buckets=(16,), use_pallas=False)
    tc = AntidoteConfig(**kw)
    jmesh = jax_make_mesh(8)
    jt = JaxTable(jax_type(type_name), jc, sharding=jax_sharding(jmesh))
    batch = _step_case(case, get_type(type_name), tc, jt.n_rows)
    want = jax_step_fn(jax_type(type_name), jc, jmesh)(
        jt.snap, jt.snap_vc, jt.snap_seq, jt.ops_a, jt.ops_b, jt.ops_vc,
        jt.ops_origin, *batch)
    mesh = _mesh(n_blocks)
    t = TypedTable(get_type(type_name), tc, device="cpu",
                   sharding=shard_axis_sharding(mesh))
    bl = t.blocks
    got = sharded_step_fn(get_type(type_name), tc, mesh)(
        [b.snap for b in bl], [b.snap_vc for b in bl],
        [b.snap_seq for b in bl], [b.ops_a for b in bl],
        [b.ops_b for b in bl], [b.ops_vc for b in bl],
        [b.ops_origin for b in bl], *batch)
    assert len(got) == len(want) == 9
    for i, (w, g) in enumerate(zip(want, got)):
        assert len(g) == n_blocks
        _assert_equal(_np(w), _cat(g), f"output {i}")
    # the step writes new op tensors; the table's own stay untouched
    assert not bl[0].ops_a.any()
    # the stable VC is the min over every shard, on every row
    st = _cat(got[8])
    assert (st == _cat(got[7]).min(0)).all()


# ---------------------------------------------------------------------------
# node workloads on placed tables
# ---------------------------------------------------------------------------
KW = dict(n_shards=8, max_dcs=2, ops_per_key=8, snap_versions=2,
          set_slots=8, keys_per_table=16)


def _cfgs(n_shards=8):
    kw = dict(KW, n_shards=n_shards)
    return AntidoteConfig(**kw), JaxConfig(**kw, batch_buckets=(16,))


def _nodes(n_blocks=8):
    tc, jc = _cfgs()
    port = AntidoteNode(tc, device="cpu",
                        sharding=shard_axis_sharding(_mesh(n_blocks)))
    jax_node = JaxNode(jc, sharding=jax_sharding(jax_make_mesh(8)))
    return port, jax_node


def _assert_placed(table, n_blocks):
    assert table.placed and len(table.blocks) == n_blocks
    assert all(b.ops_a.shape[0] == table.n_shards // n_blocks
               for b in table.blocks)


def test_mesh_node_set_aw_and_map_rr():
    port, jax_node = _nodes()
    script = [
        [("s", "set_aw", "bk", ("add_all", ["a", "b", "c"])),
         ("m", "map_rr", "bk", ("update", [
             (("cnt", "counter_pn"), ("increment", 7)),
             (("tags", "set_aw"), ("add", "x"))]))],
        [("s", "set_aw", "bk", ("remove", "b")),
         ("m", "map_rr", "bk", ("update", [
             (("tags", "set_aw"), ("add", "y"))]))],
    ]
    objs = [("s", "set_aw", "bk"), ("m", "map_rr", "bk")]
    for node in (port, jax_node):
        for ups in script:
            node.update_objects(ups)
    got, _ = port.read_objects(objs)
    want, _ = jax_node.read_objects(objs)
    assert got == want
    assert got[0] == ["a", "c"]
    assert got[1] == {("cnt", "counter_pn"): 7,
                      ("tags", "set_aw"): ["x", "y"]}
    _assert_placed(port.store.tables["set_aw"], 8)


def test_mesh_read_while_commit_interleaving():
    port, jax_node = _nodes(4)
    seen = {}
    for name, node in (("port", port), ("jax", jax_node)):
        node.update_objects([("k", "set_aw", "bk", ("add", "v1")),
                             ("c", "counter_pn", "bk", ("increment", 2))])
        txn = node.start_transaction()
        out = []
        for i in range(3):
            node.update_objects([("k", "set_aw", "bk", ("add", f"w{i}")),
                                 ("c", "counter_pn", "bk",
                                  ("increment", 1))])
            out.append(node.read_objects([("k", "set_aw", "bk"),
                                          ("c", "counter_pn", "bk")], txn))
        node.commit_transaction(txn)
        out.append(node.read_objects([("k", "set_aw", "bk"),
                                      ("c", "counter_pn", "bk")])[0])
        seen[name] = out
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == [["v1"], 2]
    assert seen["port"][-1] == [["v1", "w0", "w1", "w2"], 5]


def _reshard_workload(node, n):
    expect = {}
    for i in range(n):
        node.update_objects([
            (f"c{i}", "counter_pn", "bk", ("increment", i + 1)),
            (f"s{i}", "set_aw", "bk", ("add", f"e{i}"))])
        expect[(f"c{i}", "counter_pn", "bk")] = i + 1
        expect[(f"s{i}", "set_aw", "bk")] = [f"e{i}"]
    return expect


def test_reshard_keeps_mesh_layout():
    port, jax_node = _nodes()
    expect = _reshard_workload(port, 24)
    _reshard_workload(jax_node, 24)
    tc16, jc16 = _cfgs(16)
    new = handoff.reshard(port.store, tc16, my_dc=0)
    jnew = jax_handoff.reshard(jax_node.store, jc16, my_dc=0)
    _assert_placed(new.tables["counter_pn"], 8)
    assert new.directory == dict(jnew.directory)
    objs = list(expect)
    got, _ = AntidoteNode(store=new).read_objects(objs)
    want, _ = JaxNode(store=jnew).read_objects(objs)
    assert got == want == list(expect.values())


def test_reshard_shrink_incompatible_mesh_falls_back(caplog):
    port, _ = _nodes()
    expect = {}
    for i in range(12):
        port.update_objects([(f"c{i}", "counter_pn", "bk",
                              ("increment", i + 1))])
        expect[(f"c{i}", "counter_pn", "bk")] = i + 1
    tc4, _ = _cfgs(4)
    with caplog.at_level(logging.WARNING):
        new = handoff.reshard(port.store, tc4, my_dc=0)
    assert "falls back to default device placement" in caplog.text
    assert new.cfg.n_shards == 4 and new.sharding is None
    t = new.tables["counter_pn"]
    assert not t.placed and t.device == CPU
    got, _ = AntidoteNode(store=new).read_objects(list(expect))
    assert got == list(expect.values())


def test_handoff_between_mesh_nodes():
    tc, _ = _cfgs()
    a = AntidoteNode(tc, device="cpu",
                     sharding=shard_axis_sharding(_mesh(8)))
    expect = {}
    for i in range(16):
        a.update_objects([(f"s{i}", "set_aw", "bk",
                           ("add_all", [f"p{i}", f"q{i}"]))])
        expect[(f"s{i}", "set_aw", "bk")] = sorted([f"p{i}", f"q{i}"])
    for i in range(0, 16, 4):
        a.update_objects([(f"s{i}", "set_aw", "bk", ("remove", f"p{i}"))])
        expect[(f"s{i}", "set_aw", "bk")] = [f"q{i}"]
    b = AntidoteNode(tc, device="cpu",
                     sharding=shard_axis_sharding(_mesh(2)))
    for shard in range(tc.n_shards):
        pkg = handoff.unpack(handoff.pack(handoff.export_shard(a.store,
                                                               shard)))
        b.receive_handoff(pkg)
    got, _ = b.read_objects(list(expect))
    assert got == list(expect.values())
    _assert_placed(b.store.tables["set_aw"], 2)


# ---------------------------------------------------------------------------
# the giant-key fold
# ---------------------------------------------------------------------------
FCFG = dict(n_shards=8, max_dcs=3, ops_per_key=8, snap_versions=2,
            set_slots=8, keys_per_table=16)


def _counter_ops(rng, length, d):
    a = rng.integers(-5, 6, size=(length, 1)).astype(np.int64)
    b = np.zeros((length, 1), np.int32)
    v = rng.integers(0, 10, size=(length, d)).astype(np.int32)
    o = rng.integers(0, d, size=(length,)).astype(np.int32)
    return a, b, v, o


def _set_ops(rng, length, d, n_handles, cfg):
    """An add-only set_aw log: distinct own commit dots, ≤ n_handles
    handles (the assoc fold's precondition)."""
    ty = get_type("set_aw")
    a = np.zeros((length, ty.eff_a_width(cfg)), np.int64)
    a[:, 0] = rng.integers(1, n_handles + 1, size=length)
    b = np.zeros((length, ty.eff_b_width(cfg)), np.int32)
    o = rng.integers(0, d, size=length).astype(np.int32)
    v = rng.integers(0, 4, size=(length, d)).astype(np.int32)
    v[np.arange(length), o] = np.arange(1, length + 1)
    return a, b, v, o


def _jax_bottom(name, jc):
    return {f: jnp.zeros(sh, dt)
            for f, (sh, dt) in jax_type(name).state_spec(jc).items()}


@pytest.mark.parametrize("type_name,length,n_ops", [
    ("counter_pn", 64, 61), ("set_aw", 64, 57)])
def test_sharded_assoc_fold_matches_jax(type_name, length, n_ops):
    from antidote_tpu_torch.materializer import longlog

    tc, jc = AntidoteConfig(**FCFG), JaxConfig(**FCFG)
    d = tc.max_dcs
    rng = np.random.default_rng(3)
    ops = (_counter_ops(rng, length, d) if type_name == "counter_pn"
           else _set_ops(rng, length, d, 6, tc))
    base_vc = np.asarray([1, 1, 0], np.int32)
    read_vc = np.asarray([8, 8, 8], np.int32) if type_name == "counter_pn" \
        else np.asarray([length, length, length], np.int32)
    jfn = jax_longlog.sharded_assoc_fold_fn(jax_type(type_name), jc,
                                            jax_make_mesh(8))
    want_s, want_n = jfn(_jax_bottom(type_name, jc), *ops, n_ops,
                         jnp.asarray(base_vc), jnp.asarray(read_vc))
    fn = longlog.sharded_assoc_fold_fn(get_type(type_name), tc, _mesh(8))
    got_s, got_n = fn(get_type(type_name).bottom(tc), *ops, n_ops,
                      base_vc, read_vc)
    assert int(got_n) == int(want_n)
    _assert_equal(_np(want_s), {f: x.numpy() for f, x in got_s.items()},
                  type_name)


def test_mesh_fold_giant_key_pads_and_matches_jax():
    tc, jc = AntidoteConfig(**FCFG), JaxConfig(**FCFG)
    d = tc.max_dcs
    plane = MeshServingPlane(tc, 8, devices=[CPU] * 8)
    jplane = JaxPlane(jc, 8)
    rng = np.random.default_rng(9)
    cases = [("set_aw", _set_ops(rng, 37, d, 6, tc), 33,
              np.asarray([0, 0, 0], np.int32),
              np.asarray([37, 37, 37], np.int32)),
             ("counter_pn", _counter_ops(rng, 50, d), 47,
              np.asarray([1, 0, 1], np.int32),
              np.asarray([9, 9, 9], np.int32))]
    for name, ops, n_ops, bvc, rvc in cases:
        want_s, want_n = jplane.fold_giant_key(
            jax_type(name), jc, _jax_bottom(name, jc), *ops,
            np.int32(n_ops), bvc, rvc)
        got_s, got_n = plane.fold_giant_key(
            get_type(name), tc, get_type(name).bottom(tc), *ops,
            np.int32(n_ops), bvc, rvc)
        assert int(got_n) == int(want_n)
        _assert_equal(_np(want_s), {f: x.numpy() for f, x in got_s.items()},
                      name)
    assert plane.giant_folds == jplane.giant_folds == len(cases)


def test_replay_mesh_assoc_over_ring(tmp_path):
    """With a plane attached and an over-chunk assoc-safe log, the replay
    ladder dispatches the giant-key fold, equal to the JAX node's."""
    kw = dict(FCFG, fold_chunk=8)
    tc, jc = AntidoteConfig(**kw), JaxConfig(**kw)
    vals = {}
    for name in ("port", "jax"):
        if name == "port":
            node = AntidoteNode(tc, device="cpu",
                                log_dir=str(tmp_path / name))
            MeshServingPlane(tc, 8, devices=[CPU] * 8).attach(node.store)
        else:
            node = JaxNode(jc, log_dir=str(tmp_path / name))
            JaxPlane(jc, 8).attach(node.store)
        vcs = [node.update_objects([("c", "counter_pn", "b",
                                     ("increment", 1))])
               for _ in range(25)]
        txn = node.start_transaction()
        txn.snapshot_vc = np.asarray(vcs[12], np.int32)
        vals[name] = node.read_objects([("c", "counter_pn", "b")], txn)
        assert node.store.replay_fold_dispatches.get("mesh_assoc", 0) >= 1
        assert node.store.mesh.giant_folds >= 1
        assert node.store.materializer_status()["giant_folds"] >= 1
        node.store.log.close()
    assert vals["port"] == vals["jax"] == [13]
