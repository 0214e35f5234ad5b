"""Shard handoff and resharding on the port (``device="cpu"``), held to the
JAX package.

  * the cases of ``tests/test_handoff.py`` on the port's node: export /
    import round trips, certification across a move, collisions rejected
    before any mutation, the source cleared by ``drop_shard`` with its WAL
    truncated (no resurrection at restart), a moved shard recovering from
    the receiver's log, and reshards to 2 and 8 shards keeping every value
    and routing every key where the router puts it;
  * packages cross packages: a JAX export, ``pack``ed, imports into the
    port and the reverse, with equal values (and equal after the
    receiver's restart);
  * a reshard and an export of a store with cold keys fault them in first
    (the JAX package's reshard walks resident keys only and leaves the
    cold ones behind)."""

import numpy as np
import pytest

from antidote_tpu.api import AntidoteNode as JaxNode
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu.store import handoff as jhandoff
from antidote_tpu_torch.api import AntidoteNode
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.log import LogManager
from antidote_tpu_torch.store import handoff
from antidote_tpu_torch.store.kv import key_to_shard
from antidote_tpu_torch.txn.manager import AbortError

KW = dict(max_dcs=2, ops_per_key=8, snap_versions=2, set_slots=8,
          keys_per_table=16)


def mk_cfg(n_shards=4):
    return AntidoteConfig(n_shards=n_shards, **KW)


def mk_node(cfg, log_dir=None, **kw):
    return AntidoteNode(cfg, log_dir=None if log_dir is None
                        else str(log_dir), device="cpu", **kw)


def populate(node, n=24):
    """Mixed-type workload; returns the bound objects and expected values."""
    expect = {}
    for i in range(n):
        node.update_objects([
            (f"c{i}", "counter_pn", "bk", ("increment", i + 1)),
            (f"s{i}", "set_aw", "bk", ("add", f"e{i}")),
        ])
        expect[(f"c{i}", "counter_pn", "bk")] = i + 1
        expect[(f"s{i}", "set_aw", "bk")] = [f"e{i}"]
    # removes exercise non-trivial folds
    for i in range(0, n, 3):
        node.update_objects([(f"s{i}", "set_aw", "bk", ("remove", f"e{i}"))])
        expect[(f"s{i}", "set_aw", "bk")] = []
    return expect


def check(node, expect):
    objs = list(expect)
    vals, _ = node.read_objects(objs)
    for (obj, want), got in zip(expect.items(), vals):
        assert got == want, (obj, got, want)


def test_export_import_roundtrip():
    cfg = mk_cfg()
    a = mk_node(cfg)
    expect = populate(a)
    b = mk_node(cfg)
    moved = 0
    for shard in range(cfg.n_shards):
        pkg = handoff.unpack(handoff.pack(handoff.export_shard(a.store,
                                                               shard)))
        b.receive_handoff(pkg)
        moved += len(pkg["directory"])
    assert moved == len(a.store.directory)
    check(b, expect)


def test_certification_sees_moved_commits():
    """A txn whose snapshot predates a handoff must not silently overwrite
    a moved commit (first-committer-wins carries across the move)."""
    cfg = mk_cfg()
    a = mk_node(cfg)
    a.update_objects([("k", "counter_pn", "bk", ("increment", 1))])
    b = mk_node(cfg)
    txn = b.start_transaction()  # snapshot taken BEFORE the import
    b.read_objects([("k", "counter_pn", "bk")], txn)  # read-bearing
    for shard in range(cfg.n_shards):
        b.receive_handoff(handoff.export_shard(a.store, shard))
    b.update_objects([("k", "counter_pn", "bk", ("increment", 10))], txn)
    with pytest.raises(AbortError):
        b.commit_transaction(txn)


def test_import_rejects_collision():
    cfg = mk_cfg()
    a = mk_node(cfg)
    a.update_objects([("k", "counter_pn", "bk", ("increment", 1))])
    shard = a.store.locate("k", "counter_pn", "bk")[1]
    pkg = handoff.export_shard(a.store, shard)
    with pytest.raises(ValueError, match="already bound"):
        handoff.import_shard(a.store, pkg)  # same replica: keys collide


def test_drop_shard_clears_source():
    cfg = mk_cfg()
    a = mk_node(cfg)
    populate(a, n=8)
    victim = a.store.locate("c0", "counter_pn", "bk")[1]
    before = len(a.store.directory)
    dropped = [dk for dk, ent in a.store.directory.items()
               if ent[1] == victim]
    handoff.drop_shard(a.store, victim)
    assert len(a.store.directory) == before - len(dropped)
    assert a.store.locate("c0", "counter_pn", "bk", create=False) is None
    for t in a.store.tables.values():
        assert t.used_rows[victim] == 0
        assert (t.n_ops[victim] == 0).all()
        assert int(t.head_vc[victim].abs().sum()) == 0


def test_drop_shard_truncates_wal_no_resurrection(tmp_path):
    """After handoff + drop, a recover on the SOURCE does not resurrect the
    moved keys (their WAL records moved with them)."""
    cfg = mk_cfg()
    a = mk_node(cfg, tmp_path / "a")
    a.update_objects([("k", "counter_pn", "bk", ("increment", 9))])
    victim = a.store.locate("k", "counter_pn", "bk")[1]
    b = mk_node(cfg, tmp_path / "b")
    b.receive_handoff(handoff.export_shard(a.store, victim))
    handoff.drop_shard(a.store, victim)
    a.close()
    a2 = mk_node(cfg, tmp_path / "a", recover=True)
    assert a2.store.locate("k", "counter_pn", "bk", create=False) is None
    vals, _ = b.read_objects([("k", "counter_pn", "bk")])
    assert vals == [9]


def test_import_failure_leaves_destination_untouched():
    """A colliding import rejects BEFORE mutating anything; so does an
    import into a shard that holds rows, and a log-less package into a
    durable node."""
    cfg = mk_cfg()
    a = mk_node(cfg)
    a.update_objects([("k", "counter_pn", "bk", ("increment", 1)),
                      ("other", "counter_pn", "bk", ("increment", 2))])
    shard = a.store.locate("k", "counter_pn", "bk")[1]
    pkg = handoff.export_shard(a.store, shard)
    used_before = {t: a.store.tables[t].used_rows.copy()
                   for t in a.store.tables}
    dir_before = dict(a.store.directory)
    with pytest.raises(ValueError, match="already bound"):
        handoff.import_shard(a.store, pkg)
    c = mk_node(cfg)
    c.update_objects([("mine", "counter_pn", "bk", ("increment", 1))])
    occupied = c.store.locate("mine", "counter_pn", "bk")[1]
    with pytest.raises(ValueError, match="already holds"):
        handoff.import_shard(c.store, pkg, shard=occupied)
    assert dict(a.store.directory) == dir_before
    for t, used in used_before.items():
        np.testing.assert_array_equal(a.store.tables[t].used_rows, used)


def test_logless_package_refused_by_a_durable_node(tmp_path):
    cfg = mk_cfg()
    a = mk_node(cfg)
    a.update_objects([("k", "counter_pn", "bk", ("increment", 1))])
    shard = a.store.locate("k", "counter_pn", "bk")[1]
    pkg = handoff.export_shard(a.store, shard)
    b = mk_node(cfg, tmp_path / "b")
    with pytest.raises(ValueError, match="no log records"):
        b.receive_handoff(pkg)
    assert not b.store.directory
    b.close()


def test_handoff_with_log_recovers(tmp_path):
    cfg = mk_cfg()
    a = mk_node(cfg, tmp_path / "a")
    expect = populate(a, n=10)
    b = mk_node(cfg, tmp_path / "b")
    for shard in range(cfg.n_shards):
        b.receive_handoff(handoff.export_shard(a.store, shard))
    check(b, expect)
    b.close()
    # B's WAL re-chains the moved records: a replica recovered from B's log
    # alone serves the same values
    c = mk_node(cfg, tmp_path / "b", recover=True)
    check(c, expect)


@pytest.mark.parametrize("new_n", [2, 8])
def test_reshard_preserves_values_and_routing(new_n, tmp_path):
    cfg = mk_cfg(4)
    a = mk_node(cfg, tmp_path / "a")
    expect = populate(a, n=20)
    new_cfg = mk_cfg(new_n)
    log_new = LogManager(new_cfg, str(tmp_path / "n"))
    new_store = handoff.reshard(a.store, new_cfg, log=log_new, my_dc=0)
    b = AntidoteNode(new_cfg, store=new_store)
    check(b, expect)
    for (key, bucket), (_, s, _) in new_store.directory.items():
        assert s == key_to_shard(key, bucket, new_n)
    b.close()
    # the re-chained log alone rebuilds the resharded replica
    c = mk_node(new_cfg, tmp_path / "n", recover=True)
    check(c, expect)


def test_reshard_refuses_replication_in_flight():
    cfg = mk_cfg()
    a = mk_node(cfg)
    populate(a, n=4)
    a.store.applied_vc[1, 1] = 5  # a remote commit on one shard only
    with pytest.raises(RuntimeError, match="in flight"):
        handoff.reshard(a.store, mk_cfg(8), my_dc=0)


def test_store_adoption_and_its_guards(tmp_path):
    cfg = mk_cfg()
    a = mk_node(cfg)
    populate(a, n=6)
    b = AntidoteNode(store=a.store)
    assert b.cfg is cfg and b.txm.commit_counter == a.txm.commit_counter
    vc = b.update_objects([("c0", "counter_pn", "bk", ("increment", 1))])
    assert vc[0] == a.txm.commit_counter + 1
    with pytest.raises(RuntimeError, match="double-apply"):
        AntidoteNode(cfg, store=a.store, recover=True)


# ---------------------------------------------------------------------------
# packages across packages
# ---------------------------------------------------------------------------
def _jax_cfg(n_shards=4):
    return JaxConfig(n_shards=n_shards, batch_buckets=(16,), **KW)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_packed_package_crosses_packages(tmp_path, direction):
    """A shard exported and ``pack``ed by one package imports into the
    other's durable node; every value equals the source's, and again after
    the receiver restarts from its own log."""
    src_pkg, dst_pkg = direction.split("_to_")

    def make(pkg, d, **kw):
        if pkg == "jax":
            return JaxNode(_jax_cfg(), log_dir=str(d), **kw)
        return mk_node(mk_cfg(), d, **kw)

    src = make(src_pkg, tmp_path / "src")
    expect = populate(src, n=12)
    dst = make(dst_pkg, tmp_path / "dst")
    exporter = jhandoff if src_pkg == "jax" else handoff
    importer = jhandoff if dst_pkg == "jax" else handoff
    for shard in range(4):
        data = exporter.pack(exporter.export_shard(src.store, shard))
        dst.receive_handoff(importer.unpack(data))
    check(dst, expect)
    dst.store.log.close()
    again = make(dst_pkg, tmp_path / "dst", recover=True)
    check(again, expect)
    again.store.log.close()
    src.store.log.close()


def _cold_store(tmp_path, n=20):
    cfg = mk_cfg()
    a = mk_node(cfg, tmp_path / "a", resident_rows=1 << 30)
    expect = populate(a, n=n)
    a.checkpoint_now()
    a.store.cold.budget = 4
    a.store.cold.evict_now(max_rows=1024)
    assert len(a.store.cold.cold_set) > n
    return cfg, a, expect


def test_export_faults_in_the_shards_cold_keys(tmp_path):
    cfg, a, expect = _cold_store(tmp_path)
    b = mk_node(cfg, tmp_path / "b")
    for shard in range(cfg.n_shards):
        b.receive_handoff(handoff.export_shard(a.store, shard))
        handoff.drop_shard(a.store, shard)
        assert not a.store.cold.shard_cold_keys(shard)
    assert not a.store.cold.refs and not a.store.directory
    check(b, expect)


def test_reshard_faults_cold_keys_in_first(tmp_path):
    cfg, a, expect = _cold_store(tmp_path)
    new_cfg = mk_cfg(8)
    new_store = handoff.reshard(a.store, new_cfg,
                                log=LogManager(new_cfg, str(tmp_path / "n")))
    assert not a.store.cold.cold_set
    check(AntidoteNode(new_cfg, store=new_store), expect)
