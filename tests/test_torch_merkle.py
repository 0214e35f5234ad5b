"""Shard digests and the Merkle divergence tree of the port against the JAX
package's.

One seeded stream (counters, add-wins sets with removes, multi-value
registers, enable-wins flags) goes into a JAX node and a port node
(``device="cpu"``); then, for every shard, the flat ``shard_digest``
strings, the Merkle roots, every tree node's children and every leaf's key
set are equal across the packages — with keys evicted to the cold tier on
both sides included (a cold key digests as its value, faulted in chunk by
chunk with the resident budget enforced after each chunk).  An incremental
``mark`` after more writes equals a rebuild from scratch, and a digest
reads a chunk of ``set_aw`` keys with one resolve.  Tolerance: exact
equality of every hash string.
"""

from __future__ import annotations

import numpy as np
import pytest

from antidote_tpu.api import AntidoteNode as JNode
from antidote_tpu.config import AntidoteConfig as JConfig
from antidote_tpu.store.kv import shard_digest as jdigest
from antidote_tpu.store.merkle import MerkleIndex as JMerkle
from antidote_tpu_torch.api import AntidoteNode
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.store import merkle
from antidote_tpu_torch.store.kv import shard_digest
from antidote_tpu_torch.store.merkle import MerkleIndex

KW = dict(n_shards=4, max_dcs=3, ops_per_key=8, snap_versions=2,
          set_slots=8, keys_per_table=64)


def _stream(node, seed, n, start=0):
    rng = np.random.default_rng(seed)
    for i in range(start, start + n):
        k = int(rng.integers(40))
        ups = [(f"c{k}", "counter_pn", "b",
                ("increment", int(rng.integers(-9, 20)))),
               (k, "set_aw", "s",
                ("add" if rng.random() < 0.75 else "remove",
                 int(rng.integers(5))))]
        if i % 3 == 0:
            ups.append((("r", k % 7), "register_mv", "b",
                        ("assign", f"v{i}")))
        if i % 5 == 0:
            ups.append((f"f{k % 4}", "flag_ew", "b",
                        ("enable" if rng.random() < 0.6 else "disable",
                         ())))
        node.update_objects(ups)


@pytest.fixture
def pair(tmp_path):
    """A JAX node and a port node after one seeded stream, each with a
    WAL and a cold tier (resident budget 24 rows)."""
    j = JNode(JConfig(**KW, batch_buckets=(8,)), dc_id=0,
              log_dir=str(tmp_path / "j"), resident_rows=24)
    p = AntidoteNode(AntidoteConfig(**KW), dc_id=0,
                     log_dir=str(tmp_path / "p"), resident_rows=24,
                     device="cpu")
    for node in (j, p):
        _stream(node, 7, 90)
    yield j, p
    j.store.log.close()
    p.close()


def _evict(node, n):
    node.checkpoint_now(full=True)
    return node.store.cold.evict_now(max_rows=n)


def test_shard_digests_equal_across_packages(pair):
    j, p = pair
    assert np.array_equal(np.asarray(j.store.applied_vc), p.store.applied_vc)
    for s in range(KW["n_shards"]):
        assert shard_digest(p.store, s) == jdigest(j.store, s), s


def test_cold_keys_digest_as_their_values_in_both_packages(pair):
    j, p = pair
    before = [shard_digest(p.store, s) for s in range(KW["n_shards"])]
    assert _evict(j, 60) > 0 and _evict(p, 60) > 0
    assert p.store.cold.cold_set and j.store.cold.cold_set
    for s in range(KW["n_shards"]):
        mine = shard_digest(p.store, s)
        assert mine == jdigest(j.store, s) == before[s], s
        # the chunked fault-in kept the resident budget after the read
        assert p.store.cold.resident_rows() <= max(
            24, p.store.cold.budget)


def test_merkle_trees_equal_across_packages(pair):
    j, p = pair
    assert _evict(j, 40) > 0 and _evict(p, 40) > 0
    jm, pm = JMerkle(j.store), MerkleIndex(p.store)
    assert pm.depth() == jm.depth() == 2
    for s in range(KW["n_shards"]):
        assert pm.root(s) == jm.root(s), s
        frontier = [0]
        for level in range(pm.depth()):
            nxt = []
            for idx in frontier:
                assert pm.children(s, level, idx) == jm.children(
                    s, level, idx), (s, level, idx)
                nxt.extend(idx * pm.fanout + c for c in range(pm.fanout))
            frontier = nxt
        for leaf in range(pm.n_leaves):
            assert pm.leaf_keys(s, leaf) == jm.leaf_keys(s, leaf)
        # every key is in exactly its leaf
        keys = set(p.store.directory.shard_keys(s)) | set(
            p.store.cold.shard_cold_keys(s))
        assert sum(len(pm.leaf_keys(s, lf))
                   for lf in range(pm.n_leaves)) == len(keys)


def test_incremental_marks_equal_a_rebuild(pair):
    j, p = pair
    mk = merkle.get_merkle(p.store)
    roots = [mk.root(s) for s in range(KW["n_shards"])]
    _stream(p, 8, 25, start=90)
    _stream(j, 8, 25, start=90)
    fresh = MerkleIndex(p.store)
    jfresh = JMerkle(j.store)
    for s in range(KW["n_shards"]):
        assert mk.root(s) == fresh.root(s) == jfresh.root(s), s
        for leaf in range(0, mk.n_leaves, 17):
            assert mk.leaf_keys(s, leaf) == fresh.leaf_keys(s, leaf)
    assert any(mk.root(s) != r for s, r in enumerate(roots))


def test_mark_all_and_rescan_rebuild_from_the_data(pair):
    _j, p = pair
    mk = merkle.get_merkle(p.store)
    root = mk.root(0)
    tname, s, row = next(ent for dk, ent in p.store.directory.items()
                         if ent[1] == 0 and ent[0] == "counter_pn")
    t = p.store.tables[tname]
    f = next(iter(t.head))
    old = t.head[f][s, row].clone()
    t.head[f][s, row] = old + 1  # silent damage: no mark
    assert mk.root(0) == root  # the incremental tree trusts its marks
    mk.rescan(0)
    assert mk.root(0) != root  # detection re-reads the data
    t.head[f][s, row] = old
    mk.mark_all(0)
    assert mk.root(0) == root
    with pytest.raises(ValueError):
        MerkleIndex(p.store, n_leaves=100, fanout=16)


def test_a_digest_chunk_of_sets_is_one_resolve(pair, monkeypatch):
    _j, p = pair
    from antidote_tpu_torch.crdt.sets import SetAW

    calls = []
    orig = SetAW.resolve

    def counted(self, cfg, state):
        calls.append(len(next(iter(state.values()))))
        return orig(self, cfg, state)

    monkeypatch.setattr(SetAW, "resolve", counted)
    n_sets = sum(1 for dk, ent in p.store.directory.items()
                 if ent[1] == 1 and ent[0].startswith("set_aw"))
    assert n_sets > 1
    shard_digest(p.store, 1)
    # one resolve per set table of the shard's one chunk, never per key
    tables = {ent[0] for ent in p.store.directory.values()
              if ent[1] == 1 and ent[0].startswith("set_aw")}
    assert len(calls) == len(tables)
    assert sum(calls) == n_sets
