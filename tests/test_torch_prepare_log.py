"""The members' durable prepare log against the JAX package.

One seeded script drives a 2-member DC of each package (the port's on
``device="cpu"``) with log directories: committed transactions, an aborted
prepare, a transaction wedged after sequencing (prepared, undecided), a
commit logged but never applied (the torn window between the durable
record and the store apply), and one compaction of the sequencer's log.
Both packages' ``prepare.wal`` files are byte-equal.  Then each package's
directories are recovered by BOTH packages' members: the staged
write-sets, prepared locks, outcome tables, the sequencer's ledger
(``issued``, ``chain``, ``txid_index``), the chain frontiers and the
values are equal (exact: the tolerance is equality)."""

import itertools
import os
import shutil

import pytest

from antidote_tpu.cluster import ClusterMember as JaxMember
from antidote_tpu.cluster import ClusterNode as JaxNode
from antidote_tpu.cluster import coordinator as jax_coord
from antidote_tpu.cluster.rpc import eff_to_wire as jax_eff_to_wire
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu_torch.cluster import ClusterMember, ClusterNode
from antidote_tpu_torch.cluster import coordinator as port_coord
from antidote_tpu_torch.cluster.rpc import eff_to_wire
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.store.kv import key_to_shard

KW = dict(n_shards=4, max_dcs=3, ops_per_key=8, keys_per_table=64)
C, S, B = "counter_pn", "set_aw", "b"
#: the keys the script writes (int key k lives on shard k % 4: member 0
#: owns shards 0 and 2, member 1 shards 1 and 3)
OBJS = [(k, t, B) for k in range(8) for t in (C,)] + [(10, S, B),
                                                      (11, S, B)]


class _Jax:
    Node = JaxNode
    wire = staticmethod(jax_eff_to_wire)
    coord = jax_coord

    @staticmethod
    def member(i, log_dir, recover=False):
        cfg = JaxConfig(**KW, batch_buckets=(16, 64))
        return JaxMember(cfg, dc_id=0, member_id=i, n_members=2,
                         log_dir=log_dir, recover=recover)


class _Port:
    Node = ClusterNode
    wire = staticmethod(eff_to_wire)
    coord = port_coord

    @staticmethod
    def member(i, log_dir, recover=False):
        return ClusterMember(AntidoteConfig(**KW), dc_id=0, member_id=i,
                             n_members=2, log_dir=log_dir, recover=recover,
                             device="cpu")


def _duo(pkg, dirs, recover=False):
    ms = [pkg.member(i, d, recover) for i, d in enumerate(dirs)]
    ms[0].connect(1, *ms[1].address)
    ms[1].connect(0, *ms[0].address)
    return ms


def _crash(m):
    m.rpc.close()
    m.node.store.log.close()
    m._prep_wal.close()


def _prepare_and_seq(pkg, coord, updates, seq=True):
    """Prepare a txn at every owner and (``seq``) take its ts, then stop:
    the coordinator dies there."""
    coord.member.invalidate_seq_cache()
    txn = coord.start_transaction()
    coord._update(updates, txn)
    by_owner, shards = {}, set()
    for eff in txn.writeset:
        shard = key_to_shard(eff.key, eff.bucket, KW["n_shards"])
        shards.add(shard)
        by_owner.setdefault(coord._owner_of_shard(shard), []).append(eff)
    snap = int(txn.snapshot_vc[0])
    for owner, effs in by_owner.items():
        wires = [pkg.wire(e) for e in effs]
        if owner is None:
            coord.member.m_prepare(txn.txid, wires, snap)
        else:
            coord.member.peers[owner].call("m_prepare", txn.txid, wires,
                                           snap)
    if not seq:
        return txn, None, None
    ts, prev = coord._seq(sorted(shards), txn.txid)
    return txn, ts, {int(k): int(v) for k, v in prev.items()}


def _script(pkg, root):
    """Write the directories; returns them (member 0's, member 1's)."""
    dirs = [str(root / f"m{i}") for i in range(2)]
    m0, m1 = _duo(pkg, dirs)
    try:
        c0, c1 = pkg.Node(m0), pkg.Node(m1)
        for k in range(8):
            (c0 if k % 2 else c1).update_objects(
                [(k, C, B, ("increment", k + 1)),
                 ((k + 1) % 8, C, B, ("increment", 10))])
        c1.update_objects([(10, S, B, ("add_all", ["x", "y"])),
                           (11, S, B, ("add", "z"))])
        c0.update_objects([(10, S, B, ("remove", "x"))])
        # an aborted prepare: both owners prepared, the coordinator
        # releases them (the failed-commit path)
        txn, _, _ = _prepare_and_seq(pkg, c1, [(2, C, B, ("increment", 50)),
                                               (3, C, B, ("increment", 50))],
                                     seq=False)
        m0.m_abort(txn.txid)
        m1.m_abort(txn.txid)
        # the sequencer's log compacts with that history behind it
        m0._compact_prepare_log()
        # wedged after sequencing: prepared at both owners, undecided
        _prepare_and_seq(pkg, c1, [(4, C, B, ("increment", 100)),
                                   (5, C, B, ("increment", 100))])
        # a commit logged at member 1 but never applied there
        txn, ts, prev = _prepare_and_seq(pkg, c0,
                                         [(7, C, B, ("increment", 21))])
        vc = [0] * KW["max_dcs"]
        vc[0] = ts
        m1._prep_append({"ev": "commit", "txid": int(txn.txid), "vc": vc,
                         "prev": prev})
        # more sequenced history on member 0 after the compaction
        c0.update_objects([(6, C, B, ("increment", 3))])
    finally:
        _crash(m0)
        _crash(m1)
    return dirs


def _state(m) -> dict:
    """What a recovered member knows, in plain comparable form."""
    seq = None
    if m.seq is not None:
        seq = {"counter": m.seq.counter,
               "issued": {int(ts): [int(e[0]), [int(s) for s in e[1]],
                                    {int(k): int(v) for k, v in e[2].items()}]
                          for ts, e in m.seq.issued.items()},
               "chain": {int(s): [[int(a), int(b)] for a, b in c]
                         for s, c in m.seq.chain.items()},
               "txid_index": {int(k): int(v)
                              for k, v in m.seq.txid_index.items()},
               "last_ts": {int(k): int(v) for k, v in m.seq.last_ts.items()}}
    store = m.node.store
    return {
        "staged": {int(t): [[(k, b) for k, b in st[1]], st[2]]
                   for t, st in m.staged.items()},
        "prepared": {f"{k!r}/{b}": int(t) for (k, b), t in
                     m.prepared.items()},
        "committed": {int(t): [[int(x) for x in vc],
                               {int(k): int(v) for k, v in prev.items()}]
                      for t, (vc, prev) in m.committed_txns.items()},
        "aborted": sorted(int(t) for t in m.aborted_txns),
        "seq": seq,
        "applied_ts": {int(s): int(v) for s, v in m.applied_ts.items()},
        "shards": sorted(m.shards),
        "values": [v if not isinstance(v, list) else sorted(v)
                   for v in store.read_values(
                       [o for o in OBJS
                        if key_to_shard(o[0], B, KW["n_shards"])
                        in m.shards],
                       store.dc_max_vc())],
    }


def _recover(pkg, dirs, into):
    """Recover copies of ``dirs`` with ``pkg``'s members."""
    copies = []
    for i, d in enumerate(dirs):
        c = str(into / f"m{i}")
        shutil.copytree(d, c)
        copies.append(c)
    ms = _duo(pkg, copies, recover=True)
    try:
        return [_state(m) for m in ms]
    finally:
        for m in ms:
            m.close()


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    out = {}
    for pkg in (_Jax, _Port):
        with pytest.MonkeyPatch.context() as mp:
            # one txid tape for both packages: the records carry txids
            mp.setattr(pkg.coord.ClusterTxn, "_ids", itertools.count(1000))
            out[pkg.__name__] = _script(
                pkg, tmp_path_factory.mktemp(pkg.__name__))
    return out


@pytest.mark.parametrize("member", [0, 1])
def test_prepare_wal_bytes_equal(written, member):
    got = open(os.path.join(written["_Port"][member], "prepare.wal"),
               "rb").read()
    want = open(os.path.join(written["_Jax"][member], "prepare.wal"),
                "rb").read()
    assert got == want
    assert len(got) > 0


@pytest.mark.parametrize("src", ["_Jax", "_Port"])
def test_directory_recovers_equal_in_both_packages(written, src, tmp_path):
    dirs = written[src]
    by_jax = _recover(_Jax, dirs, tmp_path / "jax")
    by_port = _recover(_Port, dirs, tmp_path / "port")
    assert by_port == by_jax
    m0, m1 = by_port
    # what the directory holds: the wedged txn staged at both owners and
    # its locks held, the aborted one gone, the torn commit re-applied
    # (member 1's frontier on shard 3 reached its ts), and a ledger that
    # names the wedged txn behind the hole
    assert len(m0["staged"]) == 1 and len(m1["staged"]) == 1
    assert list(m0["staged"]) == list(m1["staged"])
    wedged = next(iter(m0["staged"]))
    assert set(m0["prepared"].values()) == {wedged}
    # member 1's log holds the abort record; member 0's compaction kept
    # only takeover outcomes (a coordinator's abort leaves none behind)
    assert len(m1["aborted"]) == 1 and m0["aborted"] == []
    assert wedged in m0["seq"]["txid_index"]
    torn_ts = max(v for t, v in m0["seq"]["txid_index"].items()
                  if t != wedged and v < m0["seq"]["counter"])
    assert m1["applied_ts"][3] >= torn_ts
    # member 1 reads keys 1, 3, 5, 7 and set 11: key 7 holds its two
    # committed increments and the re-applied torn one; the wedged +100 on
    # key 5 is not in the store
    assert m1["values"][3] == 8 + 10 + 21
    assert m1["values"][2] == 6 + 10


def test_both_packages_directories_recover_alike(written, tmp_path):
    """The JAX directory recovered by the port equals the port's own
    directory recovered by the port (one script, two writers)."""
    a = _recover(_Port, written["_Jax"], tmp_path / "a")
    b = _recover(_Port, written["_Port"], tmp_path / "b")
    assert a == b
