"""The port's durable log against the JAX package's: the WAL writers and
their frames, directory metadata, segments, op-id chains, whole-log
recovery and ``get_log_operations``.  All state is integer or bytes, so
every comparison is exact equality."""

import dataclasses
import os

import msgpack
import numpy as np
import pytest

from antidote_tpu.api import AntidoteNode as JaxNode
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu.log import LogManager as JaxLogManager
from antidote_tpu.log import wal as jwal
from antidote_tpu_torch.api import AbortError, AntidoteNode
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.log import LogDirMismatch, LogManager
from antidote_tpu_torch.log import wal
from antidote_tpu_torch.txn.manager import Transaction

KW = dict(n_shards=4, max_dcs=3, ops_per_key=8, snap_versions=2, set_slots=8,
          mv_slots=4, rga_slots=16, keys_per_table=64)


def _cfgs(**over):
    kw = dict(KW, **over)
    return AntidoteConfig(**kw), JaxConfig(batch_buckets=(16, 64), **kw)


@pytest.fixture(params=[True, False], ids=["native", "python"])
def native(request, monkeypatch):
    """Each WAL test runs with the native writer and with the pure-Python
    one (what a host without a compiler gets)."""
    if not request.param:
        monkeypatch.setattr(wal, "_load_lib", lambda: None)
    return request.param


def _records(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"i": i, "blob": bytes(rng.integers(0, 256, int(rng.integers(
        0, 64)), dtype=np.uint8)), "vc": [int(x) for x in rng.integers(
            0, 9, 3)]} for i in range(n)]


def test_wal_roundtrip(tmp_path, native):
    p = str(tmp_path / "a.wal")
    w = wal.ShardWAL(p)
    assert w.native == native
    recs = _records(100)
    for r in recs:
        w.append(r)
    w.commit()
    w.close()
    assert list(wal.replay(p)) == recs


def test_wal_torn_tail_heals(tmp_path, native):
    """A crash mid-append leaves a torn frame: replay stops before it, and
    a failed append's torn bytes are rolled back so later appends replay."""
    p = str(tmp_path / "b.wal")
    w = wal.ShardWAL(p)
    for i in range(10):
        w.append({"i": i})
    w.commit()
    w.close()
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 3)
    assert [r["i"] for r in wal.replay(p)] == list(range(9))
    # reopen: the rollback point includes the torn bytes; roll them away
    w = wal.ShardWAL(p)
    torn_end = w.tell()
    good = sum(len(wal.pack_frames([msgpack.packb({"i": i},
                                                  use_bin_type=True)]))
               for i in range(9))
    assert torn_end > good
    w.rollback_to(good)
    w.append({"i": 99})
    w.commit()
    w.close()
    assert [r["i"] for r in wal.replay(p)] == list(range(9)) + [99]


def test_frames_byte_identical(tmp_path, monkeypatch):
    """The native and the Python writer write the same bytes, and both
    equal the JAX package's writer; ``pack_frames`` equals the JAX one."""
    recs = _records(50, seed=1)
    payloads = [msgpack.packb(r, use_bin_type=True) for r in recs]
    assert wal.pack_frames(payloads) == jwal.pack_frames(payloads)
    writers = [("n", wal.ShardWAL(str(tmp_path / "n.wal"))),
               ("j", jwal.ShardWAL(str(tmp_path / "j.wal")))]
    monkeypatch.setattr(wal, "_load_lib", lambda: None)
    writers.insert(1, ("p", wal.ShardWAL(str(tmp_path / "p.wal"))))
    assert [w.native for _n, w in writers] == [True, False, True]
    blobs = []
    for name, w in writers:
        w.append_packed(wal.pack_frames(payloads[:20]))
        for r in recs[20:]:
            w.append(r)
        w.commit()
        w.close()
        blobs.append((tmp_path / f"{name}.wal").read_bytes())
    assert blobs[0] == blobs[1] == blobs[2]


def _entries(base, n, shards=(0, 1)):
    return [(s, f"k{base + i}", "counter_pn", "b",
             np.asarray([base + i], np.int64), np.asarray([], np.int32),
             np.asarray([base + i + 1, 0, 0], np.int32), 0, ())
            for i in range(n) for s in shards]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_segments_replay_across_packages(tmp_path, writer):
    """A segmented log written by either package replays, in exact append
    order and with equal records, through both packages' readers, under
    fewer and more segments than it was written with."""
    cfg, jcfg = _cfgs(wal_segments=3)
    d = str(tmp_path / "wal")
    lm = (JaxLogManager(jcfg, d) if writer == "jax" else LogManager(cfg, d))
    for i in range(8):
        lm.log_effects(_entries(i * 10, 2))
        lm.commit_barrier([0, 1])
    lm.close()
    for n_seg in (1, 3, 6):
        a = LogManager(dataclasses.replace(cfg, wal_segments=n_seg), d)
        b = JaxLogManager(dataclasses.replace(jcfg, wal_segments=n_seg), d)
        for shard in (0, 1):
            ra, rb = list(a.replay_shard(shard)), list(b.replay_shard(shard))
            assert ra == rb and len(ra) == 16
            assert [r["q"] for r in ra] == list(range(1, 17))
        assert (a.seqs == b.seqs).all()
        a.close()
        b.close()
    # the files themselves replay alike through both segment mergers
    paths = sorted(str(p) for p in (tmp_path / "wal").glob("shard_0*.wal"))
    assert (list(wal.replay_segments(paths))
            == list(jwal.replay_segments(paths)))


def test_validate_dir_mismatch(tmp_path):
    """A directory stamped with one shape refuses another, in both
    packages; a legacy directory (no metadata) is adopted or refused by
    its shard files and clock widths."""
    from antidote_tpu.log import LogDirMismatch as JaxMismatch

    cfg, jcfg = _cfgs()
    d = str(tmp_path / "wal")
    LogManager(cfg, d).close()
    for bad in (dict(n_shards=8), dict(max_dcs=2)):
        with pytest.raises(LogDirMismatch, match="was created with"):
            LogManager(dataclasses.replace(cfg, **bad), d)
        with pytest.raises(JaxMismatch, match="was created with"):
            JaxLogManager(dataclasses.replace(jcfg, **bad), d)
    JaxLogManager(jcfg, d).close()  # the port's stamp is the JAX stamp
    # legacy dir: shard files only, written with 2 shards of 3-lane clocks
    leg = tmp_path / "legacy"
    leg.mkdir()
    for s in range(2):
        w = wal.ShardWAL(str(leg / f"shard_{s}.wal"))
        w.append({"k": "x", "vc": [1, 0, 0]})
        w.close()
    with pytest.raises(LogDirMismatch, match="holds shard files"):
        LogManager(cfg, str(leg))
    with pytest.raises(LogDirMismatch, match="3-lane clocks"):
        LogManager(dataclasses.replace(cfg, n_shards=2, max_dcs=4), str(leg))
    LogManager(dataclasses.replace(cfg, n_shards=2), str(leg)).close()
    # a retired dir refuses to boot
    from antidote_tpu_torch.log import mark_dir_retired

    mark_dir_retired(d, 3)
    with pytest.raises(LogDirMismatch, match="retired"):
        LogManager(cfg, d)


def _script(node):
    """One write script over both packages' nodes; returns the clocks."""
    vcs = [node.update_objects([(i, "counter_pn", "b", ("increment", 1))
                                for i in range(12)])]
    vcs.append(node.update_objects([
        ("c", "counter_pn", "b", ("increment", 3)),
        ("s", "set_aw", "b", ("add_all", ["x", "y"])),
        ("r", "register_lww", "b", ("assign", "v")),
    ]))
    vcs.append(node.update_objects([("c", "counter_pn", "b",
                                     ("increment", 4))]))
    vcs.append(node.update_objects([("s", "set_aw", "b", ("remove", "x")),
                                    (("t", 1), "set_aw", "b", ("add", 5))]))
    return vcs


def test_opid_chains_and_log_operations_match_jax(tmp_path):
    """Op-id chains, append sequences and ``get_log_operations`` on one
    script equal the JAX node's."""
    cfg, jcfg = _cfgs()
    port = AntidoteNode(cfg, log_dir=str(tmp_path / "p"), device="cpu")
    jax_ = JaxNode(jcfg, log_dir=str(tmp_path / "j"))
    pv, jv = _script(port), _script(jax_)
    assert [v.tolist() for v in pv] == [v.tolist() for v in jv]
    assert (port.store.log.op_ids == jax_.store.log.op_ids).all()
    assert port.store.log.op_ids[:, 0].sum() == 19
    assert (port.store.log.op_ids[:, 1:] == 0).all()
    assert (port.store.log.seqs == jax_.store.log.seqs).all()
    asks = [(("c", "counter_pn", "b"), None), (("c", "counter_pn", "b"),
                                              pv[1]),
            (("s", "set_aw", "b"), None), ((("t", 1), "set_aw", "b"), None),
            ((["t", 1], "set_aw", "b"), pv[2]),
            (("nope", "counter_pn", "b"), None)]

    def plain(res):
        return [[(opid, op["origin"], op["commit_vc"].tolist(),
                  op["effect"].key, op["effect"].type_name,
                  op["effect"].eff_a.tolist(), op["effect"].eff_b.tolist(),
                  op["effect"].blob_refs) for opid, op in ops]
                for ops in res]

    got, want = (plain(port.get_log_operations(asks)),
                 plain(jax_.get_log_operations(asks)))
    assert got == want
    assert [len(x) for x in got] == [2, 1, 3, 1, 1, 0]
    port.close()
    jax_.store.log.close()


@pytest.mark.parametrize("segments", [1, 3])
def test_whole_log_recovery(tmp_path, segments):
    """No checkpoint: the port replays the whole log to the live state,
    the commit counter continues the chain, and certification survives."""
    cfg, _ = _cfgs(wal_segments=segments)
    d = str(tmp_path / "logs")
    node = AntidoteNode(cfg, log_dir=d, device="cpu")
    vcs = _script(node)
    objs = [("c", "counter_pn", "b"), ("s", "set_aw", "b"),
            ("r", "register_lww", "b"), (("t", 1), "set_aw", "b")]
    want = [node.read_objects(objs, clock=vc)[0] for vc in vcs]
    node.close()
    n2 = AntidoteNode(cfg, log_dir=d, recover=True, device="cpu")
    assert [n2.read_objects(objs, clock=vc)[0] for vc in vcs] == want
    assert want[-1] == [7, ["y"], "v", [5]]
    assert n2.store.last_recovery_records == 19
    vc2 = n2.update_objects([("c", "counter_pn", "b", ("increment", 1))])
    assert vc2[0] > vcs[-1][0]
    stale = Transaction(np.zeros(cfg.max_dcs, np.int32))
    n2.txm.read_objects([("c", "counter_pn", "b")], stale)
    n2.txm.update_objects([("c", "counter_pn", "b", ("increment", 1))],
                          stale)
    with pytest.raises(AbortError):
        n2.txm.commit_transaction(stale)
    n2.close()
    # booting fresh over existing data is refused
    with pytest.raises(RuntimeError, match="recover=True"):
        AntidoteNode(cfg, log_dir=d, device="cpu")


def test_replay_read_below_coverage(tmp_path):
    """Rows read below the device's retained coverage replay the log —
    counters and sets in one batch, mapped back to the right objects."""
    cfg, _ = _cfgs()
    node = AntidoteNode(cfg, log_dir=str(tmp_path / "logs"), device="cpu")
    early = None
    for i in range(25):  # beyond ring + versions (8 ops, 2 versions)
        vc = node.update_objects([
            ("c", "counter_pn", "b", ("increment", 1)),
            ("s", "set_aw", "b", ("add", f"e{i % 3}"))])
        if i == 2:
            early = vc
    txn = node.start_transaction()
    txn.snapshot_vc = np.asarray(early, np.int32)
    assert node.read_objects([("c", "counter_pn", "b"),
                              ("s", "set_aw", "b")], txn) == [
        3, ["e0", "e1", "e2"]]
    assert node.store.materializer_status()["replay_folds"] == {"assoc": 2}
    assert node.metrics.fold_dispatch.value(strategy="assoc") == 2
    node.close()
