"""Checkpointed fast restart on the port (``device="cpu"``): the cases of
``tests/test_checkpoint.py`` that need no cold tier, inter-DC replica or
wire server, run on the port's node.

The invariant: recovery from (image + delta chain + WAL tail) is
observably identical to a full-log replay — the same values at every
readable clock, op-id chains, append sequences and stable snapshot — and
a failed checkpoint changes nothing (no floor movement, no truncation, no
read-only flip).  All state is integer, so every comparison is exact."""

import os
import shutil

import numpy as np
import pytest

from antidote_tpu_torch import faults
from antidote_tpu_torch.api import AntidoteNode
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.log import checkpoint as ckpt
from antidote_tpu_torch.overload import ReadOnlyError


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faults.uninstall()


@pytest.fixture
def dcfg():
    # small tables + several WAL segments: checkpoints exercise the
    # generation rotation and tier promotion cheaply
    return AntidoteConfig(
        n_shards=4, max_dcs=3, ops_per_key=8, snap_versions=2, set_slots=8,
        mv_slots=4, rga_slots=16, keys_per_table=64, wal_segments=3)


def node_at(cfg, log_dir, recover=False):
    return AntidoteNode(cfg, log_dir=log_dir, recover=recover, device="cpu")


def wal_bytes(log_dir) -> int:
    return sum(os.path.getsize(os.path.join(log_dir, f))
               for f in os.listdir(log_dir) if f.endswith(".wal"))


def digest(node) -> dict:
    """The recovery digest (``tests/test_checkpoint.py``'s shape)."""
    return {
        "op_ids": node.store.log.op_ids.tolist(),
        "seqs": node.store.log.seqs.tolist(),
        "stable": [int(x) for x in node.stable_vc()],
        "commit_counter": int(node.txm.commit_counter),
        "keys": len(node.store.directory),
    }


def populate(node, rounds=3):
    for i in range(rounds):
        node.update_objects([
            ("c", "counter_pn", "b", ("increment", 7 + i)),
            (f"c{i}", "counter_pn", "b", ("increment", i + 1)),
            ("s", "set_aw", "b", ("add_all", [f"x{i}", f"y{i}"])),
            ("r", "register_lww", "b", ("assign", f"val{i}")),
        ])
    node.update_objects([("s", "set_aw", "b", ("remove", "x0"))])


def test_checkpoint_then_tail_recovery_byte_identical(dcfg, tmp_path):
    log_dir = str(tmp_path / "wal")
    node = node_at(dcfg, log_dir)
    populate(node)
    summary = node.checkpoint_now()
    assert summary["n_keys"] == len(node.store.directory)
    assert summary["reclaimed_bytes"] > 0, "no WAL file fell below the floor"
    vc = node.update_objects([
        ("c", "counter_pn", "b", ("increment", 100)),
        ("s", "set_aw", "b", ("add", "z")),
        ("m", "map_rr", "b", ("update", {
            ("f", "counter_pn"): ("increment", 3)})),
    ])
    objs = [("c", "counter_pn", "b"), ("s", "set_aw", "b"),
            ("r", "register_lww", "b"), ("m", "map_rr", "b")]
    want_vals, _ = node.read_objects(objs, clock=vc)
    want = digest(node)
    node.close()
    for _ in range(2):  # two independent recoveries agree
        n2 = node_at(dcfg, log_dir, recover=True)
        assert n2.read_objects(objs, clock=vc)[0] == want_vals
        assert digest(n2) == want
        assert (n2.store.log.floor_seqs > 0).any(), "fast path not engaged"
        n2.close()
    n3 = node_at(dcfg, log_dir, recover=True)
    vc2 = n3.update_objects([("c", "counter_pn", "b", ("increment", 1))])
    assert vc2[n3.dc_id] > vc[n3.dc_id]
    n3.close()
    n4 = node_at(dcfg, log_dir, recover=True)
    assert n4.read_objects([("c", "counter_pn", "b")], clock=vc2)[0] == [
        want_vals[0] + 1]
    n4.close()


def test_fast_path_replays_only_the_tail(dcfg, tmp_path):
    log_dir = str(tmp_path / "wal")
    node = node_at(dcfg, log_dir)
    populate(node, rounds=5)
    node.checkpoint_now()
    node.update_objects([("c", "counter_pn", "b", ("increment", 1)),
                         ("s", "set_aw", "b", ("add", "tail"))])
    node.close()
    n2 = node_at(dcfg, log_dir, recover=True)
    assert n2.store.last_recovery_records == 2
    assert n2.metrics.recovery_records.value() == 2
    assert n2.metrics.recovery_seconds.value(phase="tail") > 0
    assert n2.metrics.recovery_seconds.value(phase="checkpoint") > 0
    blk = n2.start_checkpointer(interval_s=0.0).status()
    assert blk["last_id"] == 1 and blk["image_bytes"] > 0
    assert blk["tail_records"] == 2
    n2.close()


def test_wal_bounded_under_sustained_writes(dcfg, tmp_path):
    log_dir = str(tmp_path / "wal")
    node = node_at(dcfg, log_dir)
    node.start_checkpointer(interval_s=0.0, rebase_every=2)
    sizes = []
    for _round in range(6):
        for i in range(40):
            node.update_objects([(i % 8, "counter_pn", "b",
                                  ("increment", 1))])
        node.checkpoint_now()
        sizes.append(wal_bytes(log_dir))
    assert sizes[-1] <= sizes[1] * 3.5, sizes
    assert node.metrics.wal_reclaimed.value() > 0
    assert node.checkpointer.reclaimed_total > 0
    published = [ckpt.load_manifest(p) for _i, p in
                 ckpt.list_checkpoints(ckpt.checkpoint_root(log_dir))]
    fulls = [m for m in published if ckpt.manifest_kind(m) == "full"]
    assert len(fulls) == 2
    newest_full = max(m["id"] for m in fulls)
    assert all(m["id"] > newest_full for m in published
               if ckpt.manifest_kind(m) == "delta")
    objs = [(i, "counter_pn", "b") for i in range(8)]
    assert node.read_objects(objs)[0] == [30] * 8
    node.close()
    n2 = node_at(dcfg, log_dir, recover=True)
    assert n2.read_objects(objs)[0] == [30] * 8
    n2.close()


def test_checkpoint_enospc_never_flips_read_only_or_truncates(dcfg,
                                                              tmp_path):
    log_dir = str(tmp_path / "wal")
    node = node_at(dcfg, log_dir)
    populate(node)
    before = {f: os.path.getsize(os.path.join(log_dir, f))
              for f in os.listdir(log_dir) if f.endswith(".wal")}
    faults.install(faults.FaultPlan(seed=1).enospc("ckpt.write"))
    with pytest.raises(ckpt.CheckpointError):
        node.checkpoint_now()
    assert node.txm.read_only_reason is None
    assert node.metrics.degraded_read_only.value() == 0
    assert (node.store.log.floor_seqs == 0).all()
    after = {f: os.path.getsize(os.path.join(log_dir, f))
             for f in os.listdir(log_dir)
             if f.endswith(".wal") and f in before}
    assert after == before, "a failed checkpoint touched the WAL"
    assert ckpt.list_checkpoints(ckpt.checkpoint_root(log_dir)) == []
    assert node.metrics.checkpoint_total.value(status="error") == 1
    node.update_objects([("c", "counter_pn", "b", ("increment", 1))])
    faults.uninstall()
    assert node.checkpoint_now()["id"] == 2
    node.close()


def test_checkpoint_fsync_and_rename_faults_abort_cleanly(dcfg, tmp_path):
    log_dir = str(tmp_path / "wal")
    node = node_at(dcfg, log_dir)
    populate(node, rounds=1)
    for site in ("ckpt.fsync", "ckpt.rename"):
        faults.install(faults.FaultPlan(seed=2).io_error(site, times=1))
        with pytest.raises(ckpt.CheckpointError):
            node.checkpoint_now()
        faults.uninstall()
        assert ckpt.list_checkpoints(ckpt.checkpoint_root(log_dir)) == []
        assert node.txm.read_only_reason is None
    summary = node.checkpoint_now()
    assert [f for f in os.listdir(ckpt.checkpoint_root(log_dir))
            if f.startswith("tmp.")] == []
    assert summary["id"] >= 3
    node.close()


def test_corrupt_newest_image_falls_back_to_older(dcfg, tmp_path):
    log_dir = str(tmp_path / "wal")
    node = node_at(dcfg, log_dir)
    node.update_objects([("c", "counter_pn", "b", ("increment", 1))])
    node.checkpoint_now(full=True)
    node.update_objects([("c", "counter_pn", "b", ("increment", 2))])
    node.checkpoint_now(full=True)
    vc = node.update_objects([("c", "counter_pn", "b", ("increment", 4))])
    node.close()
    cks = ckpt.list_checkpoints(ckpt.checkpoint_root(log_dir))
    assert len(cks) == 2
    with open(os.path.join(cks[-1][1], "image.bin"), "r+b") as f:
        f.seek(10)
        f.write(b"\xff\xff\xff\xff")
    n2 = node_at(dcfg, log_dir, recover=True)
    assert n2.read_objects([("c", "counter_pn", "b")], clock=vc)[0] == [7]
    n2.close()


def test_read_only_store_serves_reads_after_checkpoint_restart(dcfg,
                                                               tmp_path):
    log_dir = str(tmp_path / "wal")
    node = node_at(dcfg, log_dir)
    populate(node)
    node.checkpoint_now()
    node.close()
    n2 = node_at(dcfg, log_dir, recover=True)
    faults.install(faults.FaultPlan(seed=3).enospc("wal.append"))
    with pytest.raises(ReadOnlyError):
        n2.update_objects([("c", "counter_pn", "b", ("increment", 1))])
    assert n2.txm.read_only_reason is not None
    vals, _ = n2.read_objects([("c", "counter_pn", "b"),
                               ("r", "register_lww", "b")])
    assert vals == [24, "val2"]
    faults.uninstall()
    n2.txm._ro_probe_at = 0.0
    n2.update_objects([("c", "counter_pn", "b", ("increment", 1))])
    assert n2.txm.read_only_reason is None
    assert n2.read_objects([("c", "counter_pn", "b")])[0] == [25]
    n2.close()


def test_read_below_compaction_horizon_raises_typed(dcfg, tmp_path):
    log_dir = str(tmp_path / "wal")
    node = node_at(dcfg, log_dir)
    vcs = [node.update_objects([("k", "counter_pn", "b", ("increment", 1))])
           for _ in range(25)]
    node.checkpoint_now()
    node.close()
    n2 = node_at(dcfg, log_dir, recover=True)
    assert n2.read_objects([("k", "counter_pn", "b")])[0] == [25]
    txn = n2.start_transaction()
    txn.snapshot_vc = np.asarray(vcs[2], np.int32)
    with pytest.raises(RuntimeError, match="compaction horizon"):
        n2.read_objects([("k", "counter_pn", "b")], txn)
    n2.abort_transaction(txn)
    n2.close()


def test_promoted_keys_roundtrip_through_checkpoint(dcfg, tmp_path):
    log_dir = str(tmp_path / "wal")
    node = node_at(dcfg, log_dir)
    node.update_objects([("big", "set_aw", "b",
                          ("add_all", [f"e{i}" for i in range(20)]))])
    assert node.store.promotions > 0
    node.checkpoint_now()
    node.update_objects([("big", "set_aw", "b",
                          ("add_all", [f"t{i}" for i in range(40)]))])
    want, _ = node.read_objects([("big", "set_aw", "b")])
    node.close()
    n2 = node_at(dcfg, log_dir, recover=True)
    assert n2.read_objects([("big", "set_aw", "b")])[0] == want
    assert len(want[0]) == 60
    n2.close()


def test_relinquished_shard_does_not_resurrect_from_image(dcfg, tmp_path):
    """A shard whose log was truncated after the stamp (the relinquish leg
    of a shard move bumps its durable reset epoch) is dropped from the
    restore."""
    log_dir = str(tmp_path / "wal")
    node = node_at(dcfg, log_dir)
    keys = list(range(16))
    node.update_objects([(k, "counter_pn", "b", ("increment", k + 1))
                         for k in keys])
    node.checkpoint_now()
    victim = node.store.directory[(0, "b")][1]
    moved = {k for k in keys if node.store.directory[(k, "b")][1] == victim}
    node.store.log.truncate_shard(victim)
    node.close()
    n2 = node_at(dcfg, log_dir, recover=True)
    for k in keys:
        if k in moved:
            assert (k, "b") not in n2.store.directory
        else:
            assert n2.read_objects([(k, "counter_pn", "b")])[0] == [k + 1]
    assert int(n2.store.applied_vc[victim].max()) == 0
    n2.close()


# ---------------------------------------------------------------------------
# delta chains: compose / rebase / corrupt-link matrix
# ---------------------------------------------------------------------------
def _chain_store(dcfg, tmp_path, links=3, writes_per_link=6):
    """full image + ``links`` delta links + a WAL tail; returns (log_dir,
    oracle values)."""
    log_dir = str(tmp_path / "wal")
    node = node_at(dcfg, log_dir)
    node.start_checkpointer(interval_s=0.0, rebase_every=64)
    vals = {}
    for i in range(12):
        node.update_objects([(i, "counter_pn", "b", ("increment", i + 1))])
        vals[i] = i + 1
    node.checkpoint_now(full=True)
    for link in range(links):
        for j in range(writes_per_link):
            k = (link * writes_per_link + j) % 12
            node.update_objects([(k, "counter_pn", "b", ("increment", 10))])
            vals[k] += 10
        assert node.checkpoint_now()["kind"] == "delta"
    node.update_objects([(1, "counter_pn", "b", ("increment", 7))])
    vals[1] += 7
    node.close()
    return log_dir, vals


def _assert_recovers(dcfg, log_dir, vals, rounds=2):
    for _ in range(rounds):
        n = node_at(dcfg, log_dir, recover=True)
        got, _ = n.read_objects([(i, "counter_pn", "b")
                                 for i in sorted(vals)])
        assert got == [vals[i] for i in sorted(vals)], got
        dig = digest(n)
        n.close()
    return dig


def _deltas(log_dir):
    return [(i, p) for i, p in
            ckpt.list_checkpoints(ckpt.checkpoint_root(log_dir))
            if ckpt.manifest_kind(ckpt.load_manifest(p)) == "delta"]


def test_chain_composes_byte_identical(dcfg, tmp_path):
    log_dir, vals = _chain_store(dcfg, tmp_path)
    chain = ckpt.load_chain(log_dir)
    assert chain is not None and len(chain[2]) == 3
    assert _assert_recovers(dcfg, log_dir, vals) == \
        _assert_recovers(dcfg, log_dir, vals)


@pytest.mark.parametrize("damage", ["corrupt", "missing"])
def test_broken_mid_chain_link_falls_back_to_prefix(dcfg, tmp_path, damage):
    """A bit-rotted or deleted mid-chain link: recovery composes the prefix
    before it and replays a longer WAL tail, to the same state."""
    log_dir, vals = _chain_store(dcfg, tmp_path)
    mid = _deltas(log_dir)[1][1]
    if damage == "corrupt":
        with open(os.path.join(mid, "image.bin"), "r+b") as f:
            f.seek(8)
            f.write(b"\xff\xff\xff\xff")
    else:
        shutil.rmtree(mid)
    assert len(ckpt.load_chain(log_dir)[2]) == 1
    _assert_recovers(dcfg, log_dir, vals)


def test_delta_stamp_cost_tracks_dirty_rows(dcfg, tmp_path):
    log_dir = str(tmp_path / "wal")
    node = node_at(dcfg, log_dir)
    node.start_checkpointer(interval_s=0.0, rebase_every=64)
    for i in range(200):
        node.update_objects([(i, "counter_pn", "b", ("increment", 1))])
    full = node.checkpoint_now(full=True)
    node.update_objects([(3, "counter_pn", "b", ("increment", 1))])
    small = node.checkpoint_now()
    assert small["kind"] == "delta" and small["n_rows"] == 1
    assert small["image_bytes"] < full["image_bytes"] / 5
    for i in range(50):
        node.update_objects([(i, "counter_pn", "b", ("increment", 1))])
    bigger = node.checkpoint_now()
    assert bigger["kind"] == "delta" and bigger["n_rows"] == 50
    assert small["image_bytes"] < bigger["image_bytes"] \
        < full["image_bytes"]
    node.close()
    n2 = node_at(dcfg, log_dir, recover=True)
    got, _ = n2.read_objects([(i, "counter_pn", "b") for i in range(200)])
    assert got == [1 + (i < 50) + (i == 3) for i in range(200)]
    n2.close()


def test_failed_delta_stamp_forces_rebase(dcfg, tmp_path):
    log_dir = str(tmp_path / "wal")
    node = node_at(dcfg, log_dir)
    node.start_checkpointer(interval_s=0.0, rebase_every=64)
    populate(node)
    node.checkpoint_now(full=True)
    node.update_objects([("c", "counter_pn", "b", ("increment", 5))])
    faults.install(faults.FaultPlan(seed=9).enospc("ckpt.write", times=1))
    with pytest.raises(ckpt.CheckpointError):
        node.checkpoint_now()
    faults.uninstall()
    assert node.checkpointer.force_rebase is True
    assert node.checkpoint_now()["kind"] == "full"
    node.update_objects([("c", "counter_pn", "b", ("increment", 1))])
    want, _ = node.read_objects([("c", "counter_pn", "b")])
    node.close()
    n2 = node_at(dcfg, log_dir, recover=True)
    assert n2.read_objects([("c", "counter_pn", "b")])[0] == want
    n2.close()


def test_scrubber_retires_corrupt_link_and_forces_rebase(dcfg, tmp_path):
    log_dir, vals = _chain_store(dcfg, tmp_path)
    n = node_at(dcfg, log_dir, recover=True)
    n.start_checkpointer(interval_s=0.0, rebase_every=64)
    mid = _deltas(log_dir)[1][1]
    with open(os.path.join(mid, "image.bin"), "r+b") as f:
        f.seek(8)
        f.write(b"\xff\xff\xff\xff")
    out = n.checkpointer.scrub()
    assert out["corrupt"] == 1 and out["ok"] >= 2
    assert n.metrics.checkpoint_scrub.value(result="corrupt") == 1
    assert not os.path.isdir(mid)
    assert n.checkpointer.force_rebase is True
    assert n.checkpoint_now()["kind"] == "full"
    assert n.checkpointer.scrub()["corrupt"] == 0
    n.close()
    _assert_recovers(dcfg, log_dir, vals)


def test_delta_after_recovery_carries_the_tail_blobs(dcfg, tmp_path):
    """A delta link stamped right after a checkpointed recovery covers the
    replayed tail with its floor, so it must carry the tail's blob
    payloads.  (The JAX package's recovery does not record them, and its
    next restart fails to decode the set element.)"""
    log_dir = str(tmp_path / "wal")
    node = node_at(dcfg, log_dir)
    node.update_objects([("s", "set_aw", "b", ("add_all", ["x", "y"]))])
    node.checkpoint_now()
    node.update_objects([("s", "set_aw", "b", ("add", "z"))])
    node.close()
    n2 = node_at(dcfg, log_dir, recover=True)
    assert n2.checkpoint_now()["kind"] == "delta"
    n2.close()
    n3 = node_at(dcfg, log_dir, recover=True)
    assert n3.read_objects([("s", "set_aw", "b")])[0] == [["x", "y", "z"]]
    n3.close()


# ---------------------------------------------------------------------------
# import seals: the chain bound, and recovery through a long chain
# ---------------------------------------------------------------------------
_IMPORT_SHARDS = 12
_IMPORT_KW = dict(n_shards=_IMPORT_SHARDS, max_dcs=2, ops_per_key=8,
                  snap_versions=2, set_slots=8, keys_per_table=32)


def _compacted_packages(tmp_path):
    """A durable port node with counters and sets on every shard,
    checkpointed (so every export is compacted: its log is the tail
    above the floor) and written to after the image.  Returns the packed
    package of every shard and the objects with their values."""
    from antidote_tpu_torch.store import handoff

    src = node_at(AntidoteConfig(**_IMPORT_KW), str(tmp_path / "src"))
    expect = {}
    for i in range(4 * _IMPORT_SHARDS):
        src.update_objects([(f"c{i}", "counter_pn", "b", ("increment", i + 1)),
                            (f"s{i}", "set_aw", "b", ("add", f"e{i}"))])
        expect[(f"c{i}", "counter_pn", "b")] = i + 1
        expect[(f"s{i}", "set_aw", "b")] = [f"e{i}"]
    src.checkpoint_now()
    for i in range(0, 4 * _IMPORT_SHARDS, 5):
        src.update_objects([(f"c{i}", "counter_pn", "b", ("increment", 3)),
                            (f"s{i}", "set_aw", "b", ("add", f"t{i}"))])
        expect[(f"c{i}", "counter_pn", "b")] += 3
        expect[(f"s{i}", "set_aw", "b")] = sorted([f"e{i}", f"t{i}"])
    datas = []
    for shard in range(_IMPORT_SHARDS):
        pkg = handoff.export_shard(src.store, shard)
        assert pkg["compacted"]
        datas.append(handoff.pack(pkg))
    src.close()
    return datas, expect


def _values(node, expect):
    vals, _ = node.read_objects(list(expect))
    return [sorted(v) if isinstance(v, list) else v for v in vals]


def _jax_import_node(tmp_path, datas):
    """A JAX node that took the same imports through its own
    ``receive_handoff`` checkpoint cycles."""
    from antidote_tpu.api import AntidoteNode as JaxNode
    from antidote_tpu.config import AntidoteConfig as JaxConfig
    from antidote_tpu.store import handoff as jhandoff

    jcfg = JaxConfig(batch_buckets=(16,), **_IMPORT_KW)
    j = JaxNode(jcfg, log_dir=str(tmp_path / "jax"))
    kinds = []
    for data in datas:
        j.receive_handoff(jhandoff.unpack(data))
        kinds.append(j.checkpointer.last["kind"])
    return j, kinds


def test_import_seals_keep_the_chain_below_rebase_every(tmp_path):
    """More than ``rebase_every`` compacted imports into a durable node:
    each import's seal is a delta link until the chain reaches the bound,
    then a full image that resets it, and no seal rotates the WAL.  The
    values equal the JAX node's after the same imports."""
    from antidote_tpu_torch.store import handoff

    datas, expect = _compacted_packages(tmp_path)
    dst = node_at(AntidoteConfig(**_IMPORT_KW), str(tmp_path / "dst"))
    gen = dst.store.log.gen
    kinds, chains = [], []
    for data in datas:
        dst.receive_handoff(handoff.unpack(data))
        kinds.append(dst.checkpointer.last["kind"])
        chains.append(dst.checkpointer.chain_len)
    rebase = dst.checkpointer.rebase_every
    assert rebase == 8 and len(datas) > rebase
    assert kinds == ["full"] + ["delta"] * 7 + ["full"] + ["delta"] * 3
    assert max(chains) < rebase and chains[-1] == 3
    assert dst.store.log.gen == gen
    assert _values(dst, expect) == [
        sorted(v) if isinstance(v, list) else v for v in expect.values()]
    j, jkinds = _jax_import_node(tmp_path, datas)
    try:
        # the JAX import keeps no dirty window for the imported rows, so
        # each of its checkpoints is a full image
        assert jkinds == ["full"] * len(datas)
        assert _values(j, expect) == _values(dst, expect)
    finally:
        j.store.log.close()
    dst.close()


def test_recovery_through_a_chain_past_rebase_every_equals_jax(tmp_path):
    """A node whose import seals ran under a larger bound (``rebase_every``
    64) holds a chain of 11 links, past the default 8.  Recovered, its
    values equal the JAX node's after the same imports (and the JAX
    node's own recovery); the first stamp after the recovery — a seal,
    or a periodic checkpointer's next stamp — is a full image that
    re-bounds the chain."""
    from antidote_tpu_torch.store import handoff

    datas, expect = _compacted_packages(tmp_path)
    cfg = AntidoteConfig(**_IMPORT_KW)
    log_dir = str(tmp_path / "dst")
    dst = node_at(cfg, log_dir)
    dst.start_checkpointer(interval_s=0.0, rebase_every=64)
    for data in datas:
        dst.receive_handoff(handoff.unpack(data))
    assert dst.checkpointer.chain_len == len(datas) - 1 == 11
    want = _values(dst, expect)
    dst.close()
    copy_dir = str(tmp_path / "dst_copy")
    shutil.copytree(log_dir, copy_dir)
    chain = ckpt.load_chain(log_dir)
    assert chain is not None and len(chain[2]) == 11
    rec = node_at(cfg, log_dir, recover=True)
    assert _values(rec, expect) == want
    j, _ = _jax_import_node(tmp_path, datas)
    try:
        assert _values(j, expect) == want
    finally:
        j.store.log.close()
    from antidote_tpu.api import AntidoteNode as JaxNode
    from antidote_tpu.config import AntidoteConfig as JaxConfig

    jrec = JaxNode(JaxConfig(batch_buckets=(16,), **_IMPORT_KW),
                   log_dir=str(tmp_path / "jax"), recover=True)
    try:
        assert _values(jrec, expect) == want
    finally:
        jrec.store.log.close()
    # the default bound on the recovered chain: the next seal rebases
    cp = rec.start_checkpointer(interval_s=0.0)
    assert cp.rebase_every == 8 and cp.chain_len == 11
    assert rec.seal_import()["kind"] == "full" and cp.chain_len == 0
    rec.close()
    # a periodic checkpointer's next stamp, on a copy of the long chain
    again = node_at(cfg, copy_dir, recover=True)
    cp = again.start_checkpointer(interval_s=0.0)
    assert cp.chain_len == 11
    assert again.checkpoint_now()["kind"] == "full" and cp.chain_len == 0
    assert _values(again, expect) == want
    again.close()
