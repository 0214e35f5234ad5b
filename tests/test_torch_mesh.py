"""The mesh serving plane on the port against the JAX package's.

The port's plane runs with ``[cpu] * n`` blocks; the JAX plane on the 8
virtual CPU devices that ``tests/conftest.py`` forces (``use_pallas`` off:
its Pallas path does not run under this JAX).  Both nodes apply one
deterministic workload, so their clocks, layouts and epoch ids line up,
and everything compared is integer state or encoded reply bytes, held
exactly equal:

  * epoch reads byte-identical to a single-device port node and to the
    JAX mesh node at 8, 4, 2 and 1 blocks; a plane of 3 refused;
  * the per-shard publish counters after a hot shard's burst equal the
    JAX plane's (``{("3",): 4.0}``), and the other blocks' frozen slots
    are left untouched;
  * ``stable_vc`` equal to the host min and to the JAX plane's, cached;
  * the pin and graveyard protocol under a commit storm;
  * shard digests equal across the three nodes;
  * a placed node's full image and delta link byte-equal to a
    single-device node's, recovered onto a plane;
  * a follower reinstall keeps its plane; ``serve --mesh-devices 3``
    exits 2 on 8 shards.
"""

from __future__ import annotations

import itertools
import threading
import time

import jax
import msgpack
import numpy as np
import pytest
import torch

from antidote_tpu.api.node import AntidoteNode as JaxNode
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu.crdt import registers as jax_registers
from antidote_tpu.obs import NodeMetrics as JaxMetrics
from antidote_tpu.parallel import MeshServingPlane as JaxPlane
from antidote_tpu.proto.codec import encode_value as jax_encode
from antidote_tpu.store.kv import Effect as JaxEffect
from antidote_tpu.store.kv import KVStore as JaxStore
from antidote_tpu.store.kv import shard_digest as jax_shard_digest
from antidote_tpu_torch import console
from antidote_tpu_torch.api.node import AntidoteNode
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.crdt import registers
from antidote_tpu_torch.obs import NodeMetrics
from antidote_tpu_torch.parallel import MeshServingPlane
from antidote_tpu_torch.proto.codec import encode_value
from antidote_tpu_torch.store.kv import Effect, KVStore, shard_digest

CPU = torch.device("cpu")
KW = dict(n_shards=8, max_dcs=2, keys_per_table=64)
CFG = AntidoteConfig(**KW)
JCFG = JaxConfig(**KW, batch_buckets=(16, 64), use_pallas=False)


def _blocks(n):
    return [CPU] * n


def _port_node(n_blocks=None, **kw):
    plane = None
    if n_blocks:
        plane = MeshServingPlane(CFG, n_blocks, devices=_blocks(8))
    node = AntidoteNode(CFG, device="cpu",
                        sharding=plane.sharding if plane else None, **kw)
    if plane is not None:
        plane.metrics = node.metrics
        plane.attach(node.store)
    return node, plane


def _jax_node(n_dev=None):
    plane = None
    if n_dev:
        plane = JaxPlane(JCFG, n_dev)
    node = JaxNode(JCFG, sharding=plane.sharding if plane else None)
    if plane is not None:
        plane.metrics = node.metrics
        plane.attach(node.store)
    return node, plane


@pytest.fixture
def fixed_clock(monkeypatch):
    """``register_lww`` stamps from the wall clock: a tick stream instead,
    restarted by the returned function, so every node stamps alike."""
    ticks = {}

    def restart():
        for mod in (registers, jax_registers):
            ticks[mod] = itertools.count(1_000_000)

    restart()
    for mod in (registers, jax_registers):
        monkeypatch.setattr(mod, "_now_micros",
                            lambda m=mod: next(ticks[m]))
    return restart


def _apply_workload(node):
    for i in range(24):
        node.update_objects([
            (i, "counter_pn", "b", ("increment", i + 1)),
            (f"s{i % 5}", "set_aw", "b", ("add", f"e{i}")),
            (f"r{i % 3}", "register_lww", "b", ("assign", f"v{i}")),
        ])


OBJS = ([(i, "counter_pn", "b") for i in range(24)]
        + [(f"s{j}", "set_aw", "b") for j in range(5)]
        + [(f"r{j}", "register_lww", "b") for j in range(3)])


def _epoch_read(store, objs):
    ep = store.pin_serving_epoch()
    assert ep is not None
    try:
        pending, fallback = store.epoch_read_launch(objs, ep)
        assert not fallback, fallback
        vals = store.epoch_read_finish(pending)
    finally:
        store.unpin_serving_epoch(ep)
    return ep.id, [int(x) for x in ep.vc], vals


def _wire(vals, vc, enc):
    return msgpack.packb(
        {"values": [enc(v) for v in vals], "commit_clock": vc},
        use_bin_type=True, default=repr)


# ---------------------------------------------------------------------------
# epoch reads: byte-identical to a single-device node and to the JAX plane
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_blocks", [8, 4, 2, 1])
def test_mesh_reads_byte_identical(n_blocks, fixed_clock):
    assert len(jax.devices()) == 8, "conftest must force 8 devices"
    chip, _ = _port_node()
    mesh, plane = _port_node(n_blocks)
    jmesh, _ = _jax_node(n_blocks)
    t = mesh.store.table("counter_pn")
    assert [b.device for b in t.blocks] == _blocks(n_blocks)
    assert all(b.ops_a.shape[0] == 8 // n_blocks for b in t.blocks)
    for _round in range(2):  # the second round publishes incrementally
        for node in (chip, mesh, jmesh):
            _apply_workload(node)
            node.txm.publish_serving_epoch()
        cid, cvc, cvals = _epoch_read(chip.store, OBJS)
        mid, mvc, mvals = _epoch_read(mesh.store, OBJS)
        jid, jvc, jvals = _epoch_read(jmesh.store, OBJS)
        assert cid == mid == jid, "epoch ids must line up"
        assert _wire(mvals, mvc, encode_value) == _wire(cvals, cvc,
                                                        encode_value)
        assert _wire(mvals, mvc, encode_value) == _wire(jvals, jvc,
                                                        jax_encode)
    direct, _ = mesh.read_objects(OBJS)
    assert direct == mvals
    assert plane.status()["shards_per_device"] == 8 // n_blocks
    assert (mesh.store.stable_vc() == mesh.store.applied_vc.min(0)).all()


def test_mesh_refuses_indivisible_and_too_many_devices():
    with pytest.raises(ValueError, match="not divisible"):
        MeshServingPlane(CFG, 3, devices=_blocks(8))  # 8 % 3 != 0
    with pytest.raises(ValueError, match="visible"):
        MeshServingPlane(CFG, 16, devices=_blocks(8))
    with pytest.raises(ValueError):
        JaxPlane(JCFG, 3)


def test_attach_places_existing_tables_and_promotions_stay_placed(
        fixed_clock):
    """A plane attached to a node that already holds data moves its tables
    into blocks (``place_table``), and a key promoted to a wider slot tier
    afterwards moves within its shard's block: both nodes read alike."""
    cfg = AntidoteConfig(**dict(KW, set_slots=4))
    chip = AntidoteNode(cfg, device="cpu")
    mesh = AntidoteNode(cfg, device="cpu")
    for node in (chip, mesh):
        fixed_clock()
        _apply_workload(node)
    plane = MeshServingPlane(cfg, 4, devices=_blocks(4))
    plane.attach(mesh.store)
    assert all(t.placed and len(t.blocks) == 4
               for t in mesh.store.tables.values())
    assert mesh.read_objects(OBJS)[0] == chip.read_objects(OBJS)[0]
    for node in (chip, mesh):
        for j in range(12):  # past set_slots: the key promotes
            node.update_objects([("big", "set_aw", "b", ("add", f"x{j}"))])
    assert mesh.store.promotions == chip.store.promotions > 0
    tier = mesh.store.directory[("big", "b")][0]
    assert tier != "set_aw" and mesh.store.tables[tier].placed
    objs = OBJS + [("big", "set_aw", "b")]
    assert mesh.read_objects(objs)[0] == chip.read_objects(objs)[0]
    mesh.txm.publish_serving_epoch()
    chip.txm.publish_serving_epoch()
    assert _epoch_read(mesh.store, objs)[2] == _epoch_read(chip.store,
                                                           objs)[2]


# ---------------------------------------------------------------------------
# per-shard incremental publish
# ---------------------------------------------------------------------------
def _publish_script(store, effect_cls, before_probe=None):
    ty = get_type("counter_pn")
    aw, bw = ty.eff_a_width(CFG), ty.eff_b_width(CFG)
    counter = [0]

    def write(keys):
        effs = [effect_cls(k, "counter_pn", "b", np.full(aw, 1, np.int64),
                           np.zeros(bw, np.int32)) for k in keys]
        vcs = []
        for _ in keys:
            counter[0] += 1
            vcs.append(np.asarray([counter[0], 0], np.int32))
        store.apply_effects(effs, vcs, [0] * len(keys))

    write(range(32))
    store.publish_serving_epoch(store.dc_max_vc())
    write(range(32))
    store.publish_serving_epoch(store.dc_max_vc())
    write([3, 11, 19])
    store.publish_serving_epoch(store.dc_max_vc())
    write([3, 11, 27])  # shard 3 only (integer keys map key % n_shards)
    if before_probe is not None:
        before_probe()
    before = dict(store.metrics.mesh_publish.snapshot())
    assert store.publish_serving_epoch(store.dc_max_vc()) == "published"
    delta = {k: v - before.get(k, 0)
             for k, v in store.metrics.mesh_publish.snapshot().items()}
    return {k: v for k, v in delta.items() if v}


def test_per_shard_publish_counts_equal_the_jax_plane():
    plane = MeshServingPlane(CFG, 8, devices=_blocks(8))
    store = KVStore(CFG, device="cpu", sharding=plane.sharding)
    store.metrics = NodeMetrics()
    plane.attach(store)
    jplane = JaxPlane(JCFG, 8)
    jstore = JaxStore(JCFG, sharding=jplane.sharding)
    jstore.metrics = JaxMetrics()
    jplane.attach(jstore)
    want = _publish_script(jstore, JaxEffect)
    assert want == {("3",): 4.0}
    # the probed publish re-freezes shard 3's block only: every other
    # block's spare slot must come out of it untouched
    checked = []

    def probe():
        t = store.table("counter_pn")
        orig = t.freeze_serving

        def freeze(*a, **kw):
            spare = t.serving_spare()
            before = [(x.clone(), {f: y.clone() for f, y in h.items()})
                      for x, h in zip(spare["head_vc"], spare["head"])]
            res = orig(*a, **kw)
            assert res[1] == "scatter" and res[4] == {3: 4}, res[1:]
            for b, (hvc, head) in enumerate(before):
                if b == 3:
                    assert not torch.equal(hvc, res[0]["head_vc"][b])
                    continue
                assert torch.equal(hvc, res[0]["head_vc"][b])
                for f, y in head.items():
                    assert torch.equal(y, res[0]["head"][b][f])
            checked.append(b)
            return res

        t.freeze_serving = freeze

    got = _publish_script(store, Effect, before_probe=probe)
    assert checked and got == want
    objs = [(i, "counter_pn", "b") for i in range(32)]
    _, _, vals = _epoch_read(store, objs)
    assert vals == store.read_values(objs, store.dc_max_vc())


# ---------------------------------------------------------------------------
# stable time: stable_min per block, then the min over the blocks
# ---------------------------------------------------------------------------
def test_stable_vc_equals_host_min_and_jax_plane():
    plane = MeshServingPlane(CFG, 4, devices=_blocks(4))
    store = KVStore(CFG, device="cpu", sharding=plane.sharding)
    plane.attach(store)
    jplane = JaxPlane(JCFG, 8)
    jstore = JaxStore(JCFG, sharding=jplane.sharding)
    jplane.attach(jstore)
    rng = np.random.default_rng(7)
    for _ in range(5):
        clocks = rng.integers(0, 1000, size=store.applied_vc.shape)
        store.applied_vc[:] = clocks.astype(np.int32)
        jstore.applied_vc[:] = clocks.astype(np.int32)
        got = store.stable_vc()
        assert (got == store.applied_vc.min(axis=0)).all()
        assert (got == np.asarray(jstore.stable_vc())).all()
    n0 = plane.stable_collectives
    for _ in range(10):  # unchanged clocks hit the cache
        store.stable_vc()
    assert plane.stable_collectives == n0 == 5


# ---------------------------------------------------------------------------
# pin and graveyard under concurrent commits
# ---------------------------------------------------------------------------
def test_pin_graveyard_holds_for_placed_slots_under_commits():
    """Commit + publish storms rewrite placed spare slots in place while
    lock-free gathers hold pins: served counter values stay monotone per
    key, and no gather reads a slot being rewritten."""
    node, _plane = _port_node(8)
    store = node.store
    node.update_objects([(k, "counter_pn", "b", ("increment", 1))
                         for k in range(16)])
    node.txm.publish_serving_epoch()
    stop = time.monotonic() + 2.0
    errors: list = []

    def writer():
        try:
            while time.monotonic() < stop:
                node.update_objects(
                    [(k, "counter_pn", "b", ("increment", 1))
                     for k in range(16)])
                node.txm.publish_serving_epoch()
        except BaseException as e:  # surfaced by the main thread
            errors.append(e)

    t = threading.Thread(target=writer)
    t.start()
    objs = [(k, "counter_pn", "b") for k in range(16)]
    last = [0] * 16
    reads = 0
    try:
        while time.monotonic() < stop:
            ep = store.pin_serving_epoch()
            if ep is None:
                continue
            try:
                pending, fallback = store.epoch_read_launch(objs, ep)
                vals = store.epoch_read_finish(pending)
            finally:
                store.unpin_serving_epoch(ep)
            fb = set(fallback)
            # one epoch = one commit boundary: every key read the same
            # number of increments
            got = [v for i, v in enumerate(vals) if i not in fb]
            assert len(set(got)) <= 1, got
            for i, v in enumerate(vals):
                if i in fb:
                    continue
                assert v >= last[i], (i, v, last[i])
                last[i] = v
            reads += 1
    finally:
        t.join()
    assert not errors, errors
    assert reads > 5, "the reader never overlapped the write storm"


# ---------------------------------------------------------------------------
# shard digests
# ---------------------------------------------------------------------------
def test_shard_digests_equal_across_placements(fixed_clock):
    chip, _ = _port_node()
    mesh, _ = _port_node(4)
    jmesh, _ = _jax_node(8)
    for node in (chip, mesh, jmesh):
        _apply_workload(node)
    for s in range(CFG.n_shards):
        with mesh.txm.commit_lock:
            got = shard_digest(mesh.store, s)
        assert got == shard_digest(chip.store, s)
        with jmesh.txm.commit_lock:
            assert got == jax_shard_digest(jmesh.store, s)


# ---------------------------------------------------------------------------
# checkpoint images and recovery onto a plane
# ---------------------------------------------------------------------------
def test_placed_images_byte_equal_and_recover_onto_a_plane(tmp_path,
                                                           fixed_clock):
    from antidote_tpu_torch.log import checkpoint as ckpt

    dirs, nodes, ids = {}, {}, {}
    for name, n in (("chip", None), ("mesh", 4)):
        dirs[name] = str(tmp_path / name)
        nodes[name], _ = _port_node(n, log_dir=dirs[name])
    for name, node in nodes.items():
        fixed_clock()
        _apply_workload(node)
        node.checkpoint_now()
        node.update_objects([(3, "counter_pn", "b", ("increment", 9)),
                             ("s1", "set_aw", "b", ("add", "late"))])
        node.checkpoint_now(full=False)
        ids[name] = [i for i, _p in ckpt.list_checkpoints(
            ckpt.checkpoint_root(dirs[name]))]
    assert ids["chip"] == ids["mesh"] and len(ids["chip"]) == 2
    kinds = []
    for cid in ids["chip"]:
        images = []
        for name in ("chip", "mesh"):
            with open(ckpt.image_path(dirs[name], cid), "rb") as f:
                images.append(f.read())
        assert images[0] == images[1], cid
        kinds.append(ckpt.manifest_kind(ckpt.load_manifest(
            ckpt.checkpoint_root(dirs["chip"]) + f"/ckpt_{cid}")))
    assert kinds == ["full", "delta"]
    want, _ = nodes["chip"].read_objects(OBJS)
    for node in nodes.values():
        node.close()
    plane = MeshServingPlane(CFG, 2, devices=_blocks(2))
    rec = AntidoteNode(CFG, device="cpu", log_dir=dirs["mesh"],
                       recover=True, sharding=plane.sharding)
    plane.attach(rec.store)
    assert all(t.placed and len(t.blocks) == 2
               for t in rec.store.tables.values())
    got, _ = rec.read_objects(OBJS)
    assert got == want
    rec.update_objects([(0, "counter_pn", "b", ("increment", 1))])
    assert rec.read_objects([(0, "counter_pn", "b")])[0] == [want[0] + 1]
    rec.close()


# ---------------------------------------------------------------------------
# a follower's reinstall keeps its plane
# ---------------------------------------------------------------------------
def test_follower_reinstall_keeps_the_plane(tmp_path):
    from antidote_tpu_torch.interdc import (DCReplica, FollowerReplica,
                                            LoopbackHub)

    hub = LoopbackHub()
    owner = AntidoteNode(CFG, dc_id=0, log_dir=str(tmp_path / "o"),
                         device="cpu")
    orep = DCReplica(owner, hub, "dc0")
    objs = []
    for i in range(16):
        owner.update_objects([(i, "counter_pn", "b", ("increment", i + 1)),
                              (f"s{i}", "set_aw", "b", ("add", f"e{i}"))])
        objs += [(i, "counter_pn", "b"), (f"s{i}", "set_aw", "b")]
    owner.checkpoint_now()
    fnode, plane = _port_node(4, log_dir=str(tmp_path / "f"))
    old_store = fnode.store
    fol = FollowerReplica(fnode, hub, "f1",
                          owner_client_addr=("owner-host", 1234),
                          fabric_id=77)
    assert fol.attach(orep.descriptor()) == "image"
    # the image bootstrap installed into a fresh store: the plane came
    # along, and every table of it is placed over the plane's blocks
    assert fnode.store is not old_store
    assert fnode.store.mesh is plane and plane.store is fnode.store
    assert fnode.store.sharding is plane.sharding
    assert all(t.placed and len(t.blocks) == 4
               for t in fnode.store.tables.values())
    for _ in range(40):
        orep.heartbeat()
        hub.pump()
        if (fnode.store.stable_vc() >= owner.store.dc_max_vc()).all():
            break
    target = owner.store.dc_max_vc()
    want, _ = owner.read_objects(objs, clock=target)
    got, _ = fnode.read_objects(objs, clock=target)
    assert got == want
    n0 = plane.stable_collectives
    assert (fnode.store.stable_vc()
            == fnode.store.applied_vc.min(0)).all()
    assert plane.stable_collectives >= n0
    owner.store.log.close()
    fnode.store.log.close()


# ---------------------------------------------------------------------------
# the console
# ---------------------------------------------------------------------------
def test_serve_refuses_an_indivisible_mesh(capsys):
    assert console.main(["serve", "--device", "cpu", "--shards", "8",
                         "--port", "0", "--mesh-devices", "3"]) == 2
    assert "not divisible" in capsys.readouterr().err
