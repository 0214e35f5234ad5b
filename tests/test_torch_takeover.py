"""Coordinator-crash takeover and member rejoin against the JAX package.

The nine cases of ``tests/test_takeover.py`` run as one script on each
package: a 2-member DC (the port's on ``device="cpu"``) over localhost RPC,
a coordinator that "dies" after sequencing (prepare everywhere + take a
ts), before or during the commit fan-out, the takeover's decisions, members
rejoining from their log directories, the stale-prepare sweep, the
prepare-log compaction and the type-binding abort.  Every decision,
chain frontier (``applied_ts``), value and refusal the script logs must be
equal across the packages (exact: the tolerance is equality).
"""

import numpy as np
import pytest

from antidote_tpu.cluster import ClusterMember as JaxMember
from antidote_tpu.cluster import ClusterNode as JaxNode
from antidote_tpu.cluster.rpc import eff_to_wire as jax_eff_to_wire
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu.txn.manager import AbortError as JaxAbort
from antidote_tpu_torch.cluster import ClusterMember, ClusterNode
from antidote_tpu_torch.cluster.rpc import eff_to_wire
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.store.kv import key_to_shard
from antidote_tpu_torch.txn.manager import AbortError

KW = dict(n_shards=4, max_dcs=3, ops_per_key=8, keys_per_table=64)
C, B = "counter_pn", "b"


class _Jax:
    Abort = JaxAbort
    wire = staticmethod(jax_eff_to_wire)
    Node = JaxNode

    @staticmethod
    def member(i, log_dir=None, recover=False):
        cfg = JaxConfig(**KW, batch_buckets=(16, 64))
        return JaxMember(cfg, dc_id=0, member_id=i, n_members=2,
                         log_dir=log_dir, recover=recover)


class _Port:
    Abort = AbortError
    wire = staticmethod(eff_to_wire)
    Node = ClusterNode

    @staticmethod
    def member(i, log_dir=None, recover=False):
        return ClusterMember(AntidoteConfig(**KW), dc_id=0, member_id=i,
                             n_members=2, log_dir=log_dir, recover=recover,
                             device="cpu")


def _duo(pkg, log0=None, log1=None):
    m0, m1 = pkg.member(0, log0), pkg.member(1, log1)
    m0.connect(1, *m1.address)
    m1.connect(0, *m0.address)
    return m0, m1


def _rejoin(pkg, m0, log1):
    m1b = pkg.member(1, log1, recover=True)
    m0.connect(1, *m1b.address)
    m1b.connect(0, *m0.address)
    return m1b


def _crash(m):
    """Kill a member the way a process death does: its RPC and its logs
    stop, nothing is closed cleanly."""
    m.rpc.close()
    if m.node.store.log is not None:
        m.node.store.log.close()
    if m._prep_wal is not None:
        m._prep_wal.close()


def _key(member, tag):
    for i in range(10_000):
        k = f"{tag}{i}"
        if key_to_shard(k, B, KW["n_shards"]) in member.shards:
            return k
    raise AssertionError("no key found")


def _shard(k):
    return key_to_shard(k, B, KW["n_shards"])


def _wedge(pkg, coord, updates):
    """A coordinator crash after sequencing, before ANY commit fan-out:
    prepare everywhere + take a ts, then stop."""
    coord.member.invalidate_seq_cache()
    txn = coord.start_transaction()
    coord._update(updates, txn)
    by_owner, shards = {}, set()
    for eff in txn.writeset:
        shard = _shard(eff.key)
        shards.add(shard)
        by_owner.setdefault(coord._owner_of_shard(shard), []).append(eff)
    snap_own = int(txn.snapshot_vc[coord.dc_id])
    for owner, effs in by_owner.items():
        wires = [pkg.wire(e) for e in effs]
        if owner is None:
            coord.member.m_prepare(txn.txid, wires, snap_own)
        else:
            coord.member.peers[owner].call("m_prepare", txn.txid, wires,
                                           snap_own)
    ts, prev = coord._seq(sorted(shards), txn.txid)
    return txn, ts, {int(s): int(p) for s, p in prev.items()}


def _dec(dec):
    """A decision without its txid (txids are per-process)."""
    return None if dec is None else [dec[0]] + [
        x for x in dec[2:] if not isinstance(x, dict)]


def _try(pkg, fn):
    try:
        return ["ok", fn()]
    except pkg.Abort:
        return ["abort"]
    except Exception as e:  # noqa: BLE001 — the refusal is the result
        return ["refused", type(e).__name__]


def _plain(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


# ---------------------------------------------------------------------------
# the nine cases, each a script logging what both packages must agree on
# ---------------------------------------------------------------------------
def case_aborts_wedged(pkg, tmp, log):
    m0, m1 = _duo(pkg)
    try:
        c1 = pkg.Node(m1)
        k0, k1 = _key(m0, "a"), _key(m1, "b")
        txn, ts, prev = _wedge(pkg, c1, [(k0, C, B, ("increment", 100)),
                                         (k1, C, B, ("increment", 100))])
        c0 = pkg.Node(m0)
        log("conflict", _try(pkg, lambda: c0.update_objects(
            [(k0, C, B, ("increment", 1))]) is not None))
        log("resolve0", m0.resolve_wedged())
        log("resolve1", m1.resolve_wedged())
        log("frontiers", [m0.applied_ts[_shard(k0)] >= ts,
                          m1.applied_ts[_shard(k1)] >= ts])
        c0.update_objects([(k0, C, B, ("increment", 1))])
        log("values", c0.read_objects([(k0, C, B), (k1, C, B)])[0])
        log("zombie", _try(pkg, lambda: m0.m_commit(txn.txid, [ts, 0, 0],
                                                    prev)))
        log("applied", [dict(m0.applied_ts), dict(m1.applied_ts)])
    finally:
        m0.close(), m1.close()


def case_completes_partial(pkg, tmp, log):
    m0, m1 = _duo(pkg)
    try:
        c1 = pkg.Node(m1)
        k0, k1 = _key(m0, "a"), _key(m1, "b")
        txn, ts, prev = _wedge(pkg, c1, [(k0, C, B, ("increment", 7)),
                                         (k1, C, B, ("increment", 7))])
        m0.m_commit(txn.txid, [ts, 0, 0], prev)
        log("status", [m0.m_txn_status(txn.txid)[0],
                       m1.m_txn_status(txn.txid)[0]])
        log("resolve1", m1.resolve_wedged())
        log("values", pkg.Node(m0).read_objects([(k0, C, B),
                                                 (k1, C, B)])[0])
        log("applied", [dict(m0.applied_ts), dict(m1.applied_ts)])
    finally:
        m0.close(), m1.close()


def case_blocks_unreachable(pkg, tmp, log):
    m0, m1 = _duo(pkg)
    try:
        c1 = pkg.Node(m1)
        k0, k1 = _key(m0, "a"), _key(m1, "b")
        _wedge(pkg, c1, [(k0, C, B, ("increment", 9)),
                         (k1, C, B, ("increment", 9))])
        m1.rpc.close()
        s0 = _shard(k0)
        log("decision", _dec(m0.m_resolve_chain(s0, m0.applied_ts[s0])))
        log("resolve0", m0.resolve_wedged())
    finally:
        m0.close(), m1.close()


def case_rejoin_restores(pkg, tmp, log):
    log1 = str(tmp / "m1")
    m0, m1 = _duo(pkg, str(tmp / "m0"), log1)
    m1b = None
    try:
        c1 = pkg.Node(m1)
        k0, k1 = _key(m0, "a"), _key(m1, "b")
        c1.update_objects([(k1, C, B, ("increment", 5))])
        txn, ts, prev = _wedge(pkg, c1, [(k0, C, B, ("increment", 7)),
                                         (k1, C, B, ("increment", 7))])
        m0.m_commit(txn.txid, [ts, 0, 0], prev)
        _crash(m1)
        m1b = _rejoin(pkg, m0, log1)
        log("staged", txn.txid in m1b.staged)
        log("recovered", int(m1b.node.store.applied_vc[_shard(k1), 0]))
        log("resolve1", m1b.resolve_wedged())
        log("values", pkg.Node(m0).read_objects([(k0, C, B),
                                                 (k1, C, B)])[0])
        log("applied", [dict(m0.applied_ts), dict(m1b.applied_ts)])
    finally:
        m0.close()
        if m1b is not None:
            m1b.close()


def case_rejoin_learns_abort(pkg, tmp, log):
    log1 = str(tmp / "m1")
    m0, m1 = _duo(pkg, None, log1)
    m1b = None
    try:
        c1 = pkg.Node(m1)
        k0, k1 = _key(m0, "a"), _key(m1, "b")
        txn, ts, prev = _wedge(pkg, c1, [(k0, C, B, ("increment", 3)),
                                         (k1, C, B, ("increment", 3))])
        log("resolve1", m1.resolve_wedged())
        _crash(m1)
        m1b = _rejoin(pkg, m0, log1)
        log("learned", [txn.txid in m1b.staged,
                        txn.txid in m1b.aborted_txns])
        log("values", pkg.Node(m0).read_objects([(k0, C, B),
                                                 (k1, C, B)])[0])
    finally:
        m0.close()
        if m1b is not None:
            m1b.close()


def case_stale_swept(pkg, tmp, log):
    m0, m1 = _duo(pkg)
    try:
        c1 = pkg.Node(m1)
        k0 = _key(m0, "a")
        txn = c1.start_transaction()
        c1._update([(k0, C, B, ("increment", 50))], txn)
        m1.peers[0].call("m_prepare", txn.txid,
                         [pkg.wire(e) for e in txn.writeset],
                         int(txn.snapshot_vc[0]))
        c0 = pkg.Node(m0)
        inc = [(k0, C, B, ("increment", 1))]
        log("conflict", _try(pkg, lambda: c0.update_objects(inc) is None))
        log("sequenced", m0.m_txn_sequenced(txn.txid))
        log("swept", m0.sweep_stale_prepared(grace_s=0.0))
        log("late_seq", _try(pkg, lambda: c1._seq([_shard(k0)],
                                                  txn.txid) is None))
        c0.update_objects(inc)
        log("values", c0.read_objects([(k0, C, B)])[0])
        _wedge(pkg, c1, [(k0, C, B, ("increment", 9))])
        log("conflict2", _try(pkg, lambda: c0.update_objects(inc) is None))
        log("swept2", m0.sweep_stale_prepared(grace_s=0.0))
        log("resolve0", m0.resolve_wedged())
        c0.update_objects(inc)
        log("values2", c0.read_objects([(k0, C, B)])[0])
    finally:
        m0.close(), m1.close()


def case_commit_logged_not_applied(pkg, tmp, log):
    log1 = str(tmp / "m1")
    m0, m1 = _duo(pkg, None, log1)
    m1b = None
    try:
        c1 = pkg.Node(m1)
        k1 = _key(m1, "b")
        txn, ts, prev = _wedge(pkg, c1, [(k1, C, B, ("increment", 21))])
        # the torn window: the commit record is durable, the store apply
        # never happened
        m1._prep_append({"ev": "commit", "txid": int(txn.txid),
                         "vc": [ts, 0, 0], "prev": prev})
        _crash(m1)
        m1b = _rejoin(pkg, m0, log1)
        log("reapplied", [m1b.applied_ts[_shard(k1)] >= ts,
                          txn.txid in m1b.staged])
        log("values", pkg.Node(m0).read_objects([(k1, C, B)])[0])
        log("applied", dict(m1b.applied_ts))
    finally:
        m0.close()
        if m1b is not None:
            m1b.close()


def case_compaction(pkg, tmp, log):
    import os

    log1 = str(tmp / "m1")
    m0, m1 = _duo(pkg, None, log1)
    m1b = None
    try:
        c1 = pkg.Node(m1)
        k1 = _key(m1, "b")
        for _ in range(5):
            c1.update_objects([(k1, C, B, ("increment", 1))])
        txn, ts, prev = _wedge(pkg, c1, [(k1, C, B, ("increment", 100))])
        before = os.path.getsize(f"{log1}/prepare.wal")
        m1._compact_prepare_log()
        after = os.path.getsize(f"{log1}/prepare.wal")
        log("shrunk", after <= before)
        _crash(m1)
        m1b = _rejoin(pkg, m0, log1)
        log("staged", txn.txid in m1b.staged)
        log("recovered", int(m1b.node.store.applied_vc[_shard(k1), 0]))
        log("resolve1", m1b.resolve_wedged())
        log("values", pkg.Node(m0).read_objects([(k1, C, B)])[0])
    finally:
        m0.close()
        if m1b is not None:
            m1b.close()


def case_type_conflict(pkg, tmp, log):
    m0, m1 = _duo(pkg)
    try:
        c1 = pkg.Node(m1)
        k0 = _key(m0, "a")
        c1.update_objects([(k0, "set_aw", B, ("add", "x"))])
        log("conflict", _try(pkg, lambda: c1.update_objects(
            [(k0, C, B, ("increment", 1))]) is None))
        log("values", c1.read_objects([(k0, "set_aw", B)])[0])
        c1.update_objects([(k0, "set_aw", B, ("add", "y"))])
        log("values2", c1.read_objects([(k0, "set_aw", B)])[0])
    finally:
        m0.close(), m1.close()


CASES = [case_aborts_wedged, case_completes_partial, case_blocks_unreachable,
         case_rejoin_restores, case_rejoin_learns_abort, case_stale_swept,
         case_commit_logged_not_applied, case_compaction, case_type_conflict]


def _run(case, pkg, tmp):
    out = []
    tmp.mkdir()
    case(pkg, tmp, lambda tag, x: out.append((tag, _plain(x))))
    return out


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_takeover_case_matches_jax(case, tmp_path):
    want = _run(case, _Jax, tmp_path / "jax")
    got = _run(case, _Port, tmp_path / "port")
    assert [t for t, _ in got] == [t for t, _ in want]
    for (tag, w), (_, g) in zip(want, got):
        assert g == w, (case.__name__, tag, g, w)
    log = dict(want)
    # what the JAX suite asserts holds for both
    expect = {
        "aborts_wedged": {"conflict": ["abort"], "values": [1, 0],
                          "frontiers": [True, True],
                          "zombie": ["refused", "RuntimeError"]},
        "completes_partial": {"values": [7, 7],
                              "status": ["committed", "staged"]},
        "blocks_unreachable": {"decision": ["wait"], "resolve0": 0},
        "rejoin_restores": {"staged": True, "values": [7, 12]},
        "rejoin_learns_abort": {"learned": [False, True], "values": [0, 0]},
        "stale_swept": {"conflict": ["abort"], "swept": 1, "values": [1],
                        "sequenced": False, "swept2": 0,
                        "late_seq": ["refused", "RpcError"]},
        "commit_logged_not_applied": {"reapplied": [True, False],
                                      "values": [21]},
        "compaction": {"shrunk": True, "staged": True},
        "type_conflict": {"conflict": ["abort"], "values": [["x"]],
                          "values2": [["x", "y"]]},
    }[case.__name__[5:]]
    for tag, v in expect.items():
        assert log[tag] == v, (tag, log[tag])
