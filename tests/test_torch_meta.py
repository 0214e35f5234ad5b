"""The port's stable metadata store and the node's operator surface, on
the CPU.

Counterparts of ``tests/test_meta.py`` (durable KV, DC broadcast,
merge-broadcast, env mirroring, replicated runtime flags — the reference's
stable_meta_data_server + dc_meta_data_utilities), ``set_sync_log``
through the metadata store, and the node's ``status()`` and
``check_ready()`` held to the JAX node's after one script.
"""

import os

import pytest

from antidote_tpu.api.node import AntidoteNode as JNode
from antidote_tpu.config import AntidoteConfig as JConfig
from antidote_tpu.meta import MetaDataStore as JMetaDataStore
from antidote_tpu_torch.api import AntidoteNode as _Node
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.meta import MetaCluster, MetaDataStore

pytestmark = pytest.mark.smoke


def AntidoteNode(*a, **kw):
    """The port's node on the CPU."""
    kw.setdefault("device", "cpu")
    return _Node(*a, **kw)


def test_local_put_get_and_persistence(tmp_path):
    p = str(tmp_path / "meta.bin")
    s = MetaDataStore(path=p)
    s.put("dc_id", 3)
    s.put("descriptors", [[0, "dc0", 8], [1, "dc1", 8]])
    # restart: reload from disk (recover_meta_data_on_start)
    s2 = MetaDataStore(path=p)
    assert s2.get("dc_id") == 3
    assert s2.get("descriptors") == [[0, "dc0", 8], [1, "dc1", 8]]


def test_atomic_persist_no_torn_file(tmp_path):
    p = str(tmp_path / "meta.bin")
    s = MetaDataStore(path=p)
    for i in range(50):
        s.put(f"k{i}", "x" * 100)
    assert MetaDataStore(path=p).get("k49") == "x" * 100
    assert not os.path.exists(p + ".tmp")


def test_cluster_broadcast_reaches_all_nodes(tmp_path):
    cluster = MetaCluster()
    stores = [MetaDataStore(path=str(tmp_path / f"n{i}.bin"), node_id=i)
              for i in range(3)]
    for s in stores:
        cluster.join(s)
    stores[0].put("flag", True)
    assert all(s.get("flag") is True for s in stores)
    # survives each node's restart independently
    assert MetaDataStore(path=str(tmp_path / "n2.bin")).get("flag") is True


def test_merge_broadcast():
    cluster = MetaCluster()
    stores = [MetaDataStore(node_id=i) for i in range(2)]
    for s in stores:
        cluster.join(s)
    merge = lambda new, cur: sorted(set(cur) | {new})
    out = stores[0].put_merge("members", 5, merge, default=[])
    assert out == [5]
    out = stores[1].put_merge("members", 2, merge, default=[])
    assert out == [2, 5]
    assert stores[0].get("members") == [2, 5]


def test_late_joiner_catches_up():
    cluster = MetaCluster()
    a = MetaDataStore(node_id=0)
    cluster.join(a)
    a.put("seed", 42)
    b = MetaDataStore(node_id=1)
    cluster.join(b)
    assert b.get("seed") == 42


def test_env_mirroring(monkeypatch):
    monkeypatch.setenv("ANTIDOTE_TXN_CERT", "false")
    s = MetaDataStore()
    assert s.get_env("txn_cert", True) is False
    # first lookup seeds the replicated table: later env changes don't flip it
    monkeypatch.setenv("ANTIDOTE_TXN_CERT", "true")
    assert s.get_env("txn_cert", True) is False


def test_env_default_and_parse(monkeypatch):
    monkeypatch.delenv("ANTIDOTE_MISSING", raising=False)
    s = MetaDataStore()
    assert s.get_env("missing", 7) == 7
    monkeypatch.setenv("ANTIDOTE_NUM", "123")
    assert s.get_env("num") == 123


def test_sync_log_flip_reaches_other_live_nodes(tmp_path):
    """Flipping the flag on one node must apply to every member node's
    RUNNING log via the meta watcher, not only at restart."""
    cfg = AntidoteConfig(
        n_shards=2, max_dcs=2, ops_per_key=4, snap_versions=2,
        set_slots=4, keys_per_table=16,
    )
    cluster = MetaCluster()
    metas = [MetaDataStore(node_id=i) for i in range(2)]
    nodes = [
        AntidoteNode(cfg, log_dir=str(tmp_path / f"wal{i}"), meta=metas[i])
        for i in range(2)
    ]
    for m in metas:
        cluster.join(m)
    nodes[0].set_sync_log(True)
    assert all(w.sync_on_commit for w in nodes[1].store.log.wals)
    nodes[1].set_sync_log(False)
    assert not any(w.sync_on_commit for w in nodes[0].store.log.wals)


def test_sync_log_replicated_flag(tmp_path):
    cfg = AntidoteConfig(
        n_shards=2, max_dcs=2, ops_per_key=4, snap_versions=2,
        set_slots=4, keys_per_table=16,
    )
    node = AntidoteNode(cfg, log_dir=str(tmp_path / "wal"))
    assert node.store.log.wals[0].sync_on_commit is False
    node.set_sync_log(True)
    assert node.meta.get_env("sync_log") is True
    assert all(w.sync_on_commit for w in node.store.log.wals)
    # committing with sync on still works end-to-end
    node.update_objects([("k", "counter_pn", "b", ("increment", 1))])
    vals, _ = node.read_objects([("k", "counter_pn", "b")])
    assert vals[0] == 1


# ---------------------------------------------------------------------------
# the node against the JAX node
# ---------------------------------------------------------------------------
def _script(node):
    node.update_objects([("k", "counter_pn", "b", ("increment", 2)),
                         ("s", "set_aw", "b", ("add", 3))])
    t = node.start_transaction()
    node.update_objects([("k", "counter_pn", "b", ("increment", 1))], t)
    node.commit_transaction(t)
    t = node.start_transaction()
    node.update_objects([("s", "set_aw", "b", ("add", 4))], t)
    node.abort_transaction(t)
    node.checkpoint_now()
    node.update_objects([("k2", "counter_pn", "b", ("increment", 2))])


def _untimed(d):
    """``d`` without the entries that read a clock (ages, durations)."""
    if isinstance(d, dict):
        return {k: _untimed(v) for k, v in d.items()
                if not (str(k).endswith(("_s", "_ms")) or k == "age_s")}
    return d


@pytest.mark.parametrize("durable", [False, True], ids=["ephemeral",
                                                        "durable"])
def test_status_equals_the_jax_node_after_one_script(tmp_path, durable):
    kw = dict(n_shards=2, max_dcs=2, keys_per_table=64)
    got = {}
    for name, mk in (("jax", lambda d: JNode(JConfig(**kw), log_dir=d)),
                     ("torch", lambda d: AntidoteNode(AntidoteConfig(**kw),
                                                      log_dir=d))):
        d = str(tmp_path / name) if durable else None
        node = mk(d)
        if durable:
            _script(node)
        else:
            node.update_objects([("k", "counter_pn", "b",
                                  ("increment", 2))])
        got[name] = node.status(include_ready=True)
        if name == "torch":
            node.close()
        elif node.store.log is not None:
            node.store.log.close()
    assert set(got["torch"]) == set(got["jax"])
    # ``net`` reads process-wide counters that other tests of this
    # process move (each package has its own registry): a dict in both
    for st in got.values():
        assert isinstance(st.pop("net"), dict)
    assert _untimed(got["torch"]) == _untimed(got["jax"])
    assert got["torch"]["ready"] == {"types": True, "meta": True,
                                     "clocks": True, "log": True,
                                     "txn": True}
    assert ("checkpoint" in got["torch"]) == durable


def test_meta_given_to_the_node_carries_its_flags(tmp_path):
    """``meta=`` is the node's store: flags set before boot seed the
    log and the certification switch, flips after boot reach both."""
    meta = MetaDataStore()
    meta.set_env("txn_cert", False)
    meta.set_env("sync_log", True)
    node = AntidoteNode(AntidoteConfig(n_shards=2, max_dcs=2,
                                       keys_per_table=16),
                        log_dir=str(tmp_path / "wal"), meta=meta)
    try:
        assert node.meta is meta
        assert node.txm.cert is False
        assert all(w.sync_on_commit for w in node.store.log.wals)
        meta.set_env("txn_cert", True)
        assert node.txm.cert is True
        node.set_sync_log(False)
        assert meta.get_env("sync_log") is False
        assert not any(w.sync_on_commit for w in node.store.log.wals)
        assert node.is_ready()
    finally:
        node.close()
    # the JAX node seeds its certification switch the same way
    jmeta = JMetaDataStore()
    jmeta.set_env("txn_cert", False)
    jn = JNode(JConfig(n_shards=2, max_dcs=2, keys_per_table=16), meta=jmeta)
    assert jn.txm.cert is False
    jmeta.set_env("txn_cert", True)
    assert jn.txm.cert is True
