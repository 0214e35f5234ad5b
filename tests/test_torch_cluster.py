"""The cluster slice against the JAX package: a 2-member DC of each package
(the port's on ``device="cpu"``), joined over real localhost RPC, runs the
same script.  Values, commit VCs and ``stable_vc`` after gossip must be
identical, for cross-member transactions, observed-remove generated at the
owner, a cross-member certification abort, out-of-order chained commits
and the idle-shard stable advance.  A DC of 2048 shards routes its clock
matrix through the ``stable_min`` wrapper and aggregates the same stable
VC as the JAX member."""

import itertools
import threading

import numpy as np
import pytest

from antidote_tpu.cluster import ClusterMember as JaxMember
from antidote_tpu.cluster import ClusterNode as JaxNode
from antidote_tpu.cluster.rpc import eff_to_wire as jax_eff_to_wire
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu.crdt import registers as jax_registers
from antidote_tpu.txn.manager import AbortError as JaxAbort
from antidote_tpu_torch.cluster import ClusterMember, ClusterNode
from antidote_tpu_torch.cluster.rpc import eff_to_wire
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt import registers
from antidote_tpu_torch.materializer import cuda_kernels as ck
from antidote_tpu_torch.store import kv as port_kv
from antidote_tpu_torch.txn.manager import AbortError

KW = dict(n_shards=4, max_dcs=3, ops_per_key=8, keys_per_table=64)
C, S, B = "counter_pn", "set_aw", "b"


class _Jax:
    """The JAX package's cluster, as the script drives it."""
    Abort = JaxAbort
    wire = staticmethod(jax_eff_to_wire)
    registers = jax_registers

    @staticmethod
    def members(**kw):
        cfg = JaxConfig(**{**KW, **kw}, batch_buckets=(16, 64))
        return [JaxMember(cfg, dc_id=0, member_id=i, n_members=2)
                for i in range(2)]

    @staticmethod
    def node(m):
        return JaxNode(m)

    @staticmethod
    def seq(m0, shards, txid):
        return m0.seq_ts(shards, txid)


class _Port:
    """The port's cluster on the CPU."""
    Abort = AbortError
    wire = staticmethod(eff_to_wire)
    registers = registers

    @staticmethod
    def members(**kw):
        cfg = AntidoteConfig(**{**KW, **kw})
        return [ClusterMember(cfg, dc_id=0, member_id=i, n_members=2,
                              device="cpu") for i in range(2)]

    @staticmethod
    def node(m):
        return m.coordinator()

    @staticmethod
    def seq(m0, shards, txid):
        return m0.seq_ts(shards)


def _plain(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _wire(pkg, **kw):
    m0, m1 = pkg.members(**kw)
    m0.connect(1, *m1.address)
    m1.connect(0, *m0.address)
    return m0, m1


def _gossip(*ms):
    """Exchange clock rows and force a fresh sequencer frontier, so the
    stable VC does not depend on how old a member's cached frontier is."""
    for m in ms:
        m.invalidate_seq_cache()
        m.refresh_peer_clocks()


def _script(pkg):
    out = []

    def log(tag, x):
        out.append((tag, _plain(x)))

    m0, m1 = _wire(pkg)
    try:
        n0, n1 = pkg.node(m0), pkg.node(m1)
        log("owned", [sorted(m0.shards), sorted(m1.shards)])
        # --- cross-member txns: shard of int key k is k % 4 -------------
        vc = n0.update_objects([(0, C, B, ("increment", 5)),
                                (1, C, B, ("increment", 7)),
                                (3, S, B, ("add_all", ["x", "y"]))])
        log("cross", vc)
        for n in (n0, n1):
            n.member.refresh_peer_clocks()
            log("cross-read", n.read_objects(
                [(0, C, B), (1, C, B), (3, S, B)], clock=vc))
        # --- observed-remove generated at the owner ---------------------
        vc = n0.update_objects([(5, S, B, ("add_all", ["a", "b"]))])
        _gossip(m0)
        vc = n0.update_objects([(5, S, B, ("remove", "a"))], clock=vc)
        log("or-remove", vc)
        _gossip(m0)
        log("or-read", n0.read_objects([(5, S, B)], clock=vc))
        # interactive, both owners: read-your-writes through the owners'
        # overlays, then a same-txn add-then-remove at the remote owner
        t = n1.start_transaction(clock=vc)
        n1.update_objects([(5, S, B, ("add", "z")), (2, S, B, ("add", "w")),
                           (6, C, B, ("increment", 4))], txn=t)
        log("ryw", n1.read_objects([(5, S, B), (2, S, B), (6, C, B)], txn=t))
        n1.update_objects([(2, S, B, ("remove", "w")),
                           (6, C, B, ("decrement", 1))], txn=t)
        log("ryw2", n1.read_objects([(2, S, B), (6, C, B)], txn=t))
        vc = n1.commit_transaction(t)
        log("ryw-commit", vc)
        # --- cross-member certification: two coordinators, one key -------
        t0, t1 = n0.start_transaction(), n1.start_transaction()
        n0.update_objects([(9, C, B, ("increment", 1))], t0)
        n1.update_objects([(9, C, B, ("increment", 1))], t1)
        log("cert-first", n0.commit_transaction(t0))
        try:
            n1.commit_transaction(t1)
            log("cert-second", "committed")
        except pkg.Abort:
            log("cert-second", "aborted")
        _gossip(m0, m1)
        log("cert-read", n1.read_objects([(9, C, B)])[0])
        # --- out-of-order chained commits on member 1's shard 1 ----------
        ta, tb = n0.start_transaction(), n0.start_transaction()
        n0.update_objects([(13, C, B, ("increment", 2))], ta)
        n0.update_objects([(17, C, B, ("increment", 3)),
                           (21, C, B, ("increment", 10))], tb)
        for t in (ta, tb):
            m1.m_prepare(t.txid, [pkg.wire(e) for e in t.writeset],
                         int(t.snapshot_vc[0]))
        commits = []
        for t in (ta, tb):
            ts, prev = pkg.seq(m0, [1], t.txid)
            cvc = t.snapshot_vc.copy()
            cvc[0] = ts
            commits.append((t.txid, [int(x) for x in cvc], prev))
        m1.m_commit(*commits[1])  # tb first: its chain link waits
        log("chain-buffered", [len(m1.chain_wait[1]), m1.applied_ts[1]])
        m1.m_commit(*commits[0])
        log("chain-drained", [len(m1.chain_wait[1]), m1.applied_ts[1]])
        for t in (ta, tb):
            n0.abort_transaction(t)  # driven by hand: unregister only
        _gossip(m0, m1)
        log("chain-read", n0.read_objects(
            [(13, C, B), (17, C, B), (21, C, B)], clock=commits[1][1]))
        # --- idle-shard stable advance ------------------------------------
        vc = n0.update_objects([(1, C, B, ("increment", 1))])
        log("idle-commit", vc)
        _gossip(m0, m1)
        log("stable", [m0.stable_vc(), m1.stable_vc()])
        log("status", [n.status()["stable_vc"] for n in (n0, n1)])
        log("seq", [m0.seq.counter, dict(m0.seq.last_ts)])
    finally:
        m0.close(), m1.close()
    return out


@pytest.fixture(scope="module")
def scripts():
    return _script(_Jax), _script(_Port)


def test_cluster_script_matches_jax(scripts):
    want, got = scripts
    assert [t for t, _ in got] == [t for t, _ in want]
    for (tag, w), (_, g) in zip(want, got):
        assert g == w, tag
    log = dict(want)
    assert log["cert-second"] == "aborted"
    assert log["chain-buffered"] == [1, log["chain-buffered"][1]]
    assert log["chain-drained"][0] == 0
    assert log["chain-read"][0] == [2, 3, 10]
    # every shard idle: the aggregated own lane reaches the frontier, and
    # no remote lane is ever claimed
    frontier = log["seq"][0]
    for st in log["stable"]:
        assert st == [frontier, 0, 0]


def _types_script(pkg):
    """Maps, rga and counter_b across the members: map fields and their
    membership on different owners, nested maps, a field remove and
    re-add, rga inserts and deletes in one transaction with read-your-
    writes through the owner's overlay, and counter_b spends checked at
    the key's owner (a spend past the lane's rights and one on another
    lane abort)."""
    out = []

    def log(tag, x):
        out.append((tag, _plain(x)))

    def attempt(tag, fn):
        try:
            log(tag, fn())
        except pkg.Abort as e:
            log(tag, ["aborted", "insufficient rights" in str(e),
                      "lane" in str(e)])

    m0, m1 = _wire(pkg)
    try:
        n0, n1 = pkg.node(m0), pkg.node(m1)
        M, G, R, CB = "map_rr", "map_go", "rga", "counter_b"
        maps = [("m1", M, B), ("g1", G, B), (5, M, B)]
        vc = n0.update_objects([
            ("m1", M, B, ("update", {
                ("clicks", C): ("increment", 3),
                ("name", "register_lww"): ("assign", "u"),
                ("tags", S): ("add_all", ["t1", "t2"]),
                ("sub", M): ("update", {("on", "flag_ew"): ("enable", None),
                                        ("n", "counter_fat"):
                                        ("increment", 2)})})),
            ("g1", G, B, ("update", [(("f", "set_go"), ("add", 1)),
                                     (("v", "register_mv"),
                                      ("assign", "x"))])),
            (5, M, B, ("update", {("c", C): ("increment", 1)})),
            ("cb", CB, B, ("increment", (10, 0))),
            ("doc", R, B, ("insert", (0, "h")))])
        log("populate", vc)
        _gossip(m0, m1)
        log("read-1", n1.read_objects(maps + [("doc", R, B), ("cb", CB, B)],
                                      clock=vc))
        # rga and maps in one interactive txn on the other coordinator
        t = n1.start_transaction(clock=vc)
        n1.update_objects([("doc", R, B, ("insert", (1, "a"))),
                           ("doc", R, B, ("insert", (1, "b"))),
                           ("doc", R, B, ("delete", 0)),
                           ("m1", M, B, ("remove", ("name", "register_lww"))),
                           ("g1", G, B, ("update", [(("f", "set_go"),
                                                     ("add", 2))]))], txn=t)
        log("ryw", n1.read_objects([("doc", R, B), ("m1", M, B),
                                    ("g1", G, B)], txn=t))
        n1.update_objects([("doc", R, B, ("insert", (0, "c")))], txn=t)
        log("ryw2", n1.read_objects([("doc", R, B)], txn=t))
        vc = n1.commit_transaction(t)
        log("commit", vc)
        # a field remove, then its re-add
        vc = n0.update_objects([("m1", M, B, ("remove", ("tags", S)))],
                               clock=vc)
        _gossip(m0, m1)
        log("removed", n1.read_objects([("m1", M, B)], clock=vc))
        vc = n1.update_objects([("m1", M, B, ("update", {
            ("tags", S): ("add", "t9")}))], clock=vc)
        # counter_b: spends at the owner, net of the lane's rights
        vc = n0.update_objects([("cb", CB, B, ("decrement", (4, 0)))],
                               clock=vc)
        log("spend", vc)
        attempt("overspend", lambda: n1.update_objects(
            [("cb", CB, B, ("decrement", (7, 0)))], clock=vc))
        attempt("other-lane", lambda: n1.update_objects(
            [("cb", CB, B, ("decrement", (1, 1)))], clock=vc))
        vc = n1.update_objects([("cb", CB, B, ("transfer", (2, 1, 0)))],
                               clock=vc)
        _gossip(m0, m1)
        log("final", n0.read_objects(maps + [("doc", R, B), ("cb", CB, B)],
                                     clock=vc))
        log("stable", [m0.stable_vc(), m1.stable_vc()])
    finally:
        m0.close(), m1.close()
    return out


def test_cluster_types_script_matches_jax():
    got = {}
    for pkg in (_Jax, _Port):
        ticks = itertools.count(5_000, 3)
        with pytest.MonkeyPatch.context() as mp:
            # the LWW downstream reads the wall clock: one tape for both
            mp.setattr(pkg.registers, "_now_micros", lambda: next(ticks))
            got[pkg.__name__] = _types_script(pkg)
    want = got["_Jax"]
    assert [t for t, _ in got["_Port"]] == [t for t, _ in want]
    for (tag, w), (_, g) in zip(want, got["_Port"]):
        assert g == w, tag
    log = dict(want)
    assert log["overspend"] == ["aborted", True, False]
    assert log["other-lane"] == ["aborted", False, True]
    assert log["final"][0][4] == 6  # 10 minted, 4 spent (a transfer moves)


@pytest.mark.parametrize("pkg", [_Jax, _Port], ids=["jax", "port"])
def test_concurrent_coordinators_chain_in_ts_order(pkg):
    """Two coordinators commit concurrently on the same two shards (one per
    member): interleaved commit fan-outs still apply in ts order, the
    chains drain, and both packages end at the same values."""
    m0, m1 = _wire(pkg)
    try:
        nodes = (pkg.node(m0), pkg.node(m1))
        errs, final = [], [None, None]

        def worker(lo):
            try:
                for _ in range(10):
                    final[lo] = nodes[lo].update_objects([
                        (1 + 4 * (lo + 1), C, B, ("increment", 1)),
                        (2 + 4 * (lo + 1), C, B, ("increment", 1))])
            except Exception as e:  # noqa: BLE001 — reported below
                errs.append(repr(e))

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        assert not errs, errs
        _gossip(m0, m1)
        vals, _ = nodes[0].read_objects(
            [(5, C, B), (9, C, B), (6, C, B), (10, C, B)],
            clock=np.maximum(final[0], final[1]))
        assert vals == [10, 10, 10, 10]
        assert m0.seq.counter == 20
        for m in (m0, m1):
            for s in m.shards:
                assert not m.chain_wait[s], (s, m.chain_wait[s])
                assert m.applied_ts[s] == m0.seq.last_ts.get(s, 0)
    finally:
        m0.close(), m1.close()


def test_stable_min_of_routes_by_rows(monkeypatch):
    """Below 2048 rows the host numpy min; from 2048 rows on the matrix
    goes to the ``stable_min`` wrapper on the given device."""
    calls = []
    wrapped = ck.stable_min

    def counting(x):
        calls.append(tuple(x.shape))
        return wrapped(x)

    monkeypatch.setattr(ck, "stable_min", counting)
    rng = np.random.default_rng(3)
    for n in (1, 2047, 2048, 5000):
        x = rng.integers(-2**31, 2**31 - 1, size=(n, 4),
                         dtype=np.int64).astype(np.int32)
        got = port_kv.stable_min_of(x, "cpu")
        np.testing.assert_array_equal(got, x.min(axis=0))
        assert got.dtype == np.int32
    assert calls == [(2048, 4), (5000, 4)]


def test_wide_cluster_stable_vc_through_the_wrapper(monkeypatch):
    """At 2048 shards every member's stable VC runs through the wrapper
    (its plain version here) and equals the JAX member's."""
    calls = []
    wrapped = ck.stable_min
    monkeypatch.setattr(ck, "stable_min",
                        lambda x: calls.append(x.shape) or wrapped(x))
    kw = dict(n_shards=2048, keys_per_table=16)
    got = {}
    for pkg in (_Jax, _Port):
        m0, m1 = _wire(pkg, **kw)
        try:
            n0, n1 = pkg.node(m0), pkg.node(m1)
            vcs = [n0.update_objects([(k, C, B, ("increment", k))])
                   for k in (1, 2, 2049)]
            vcs.append(n1.update_objects([(7, S, B, ("add", "q")),
                                          (8, C, B, ("increment", 1))]))
            _gossip(m0, m1)
            vals, _ = n1.read_objects([(1, C, B), (2049, C, B), (7, S, B)],
                                      clock=vcs[-1])
            got[pkg.__name__] = _plain([vcs, vals, m0.stable_vc(),
                                        m1.stable_vc()])
        finally:
            m0.close(), m1.close()
    assert got["_Port"] == got["_Jax"]
    assert got["_Port"][2] == [4, 0, 0]
    assert calls and all(tuple(s) == (2048, 3) for s in calls)


def test_unported_cluster_options_raise():
    cfg = AntidoteConfig(**KW)
    with pytest.raises(NotImplementedError, match="prepare log"):
        ClusterMember(cfg, 0, 0, 1, log_dir="x", device="cpu")
    m = ClusterMember(cfg, 0, 0, 1, device="cpu")
    try:
        n = ClusterNode(m)
        with pytest.raises(NotImplementedError):
            n.checkpoint_now()
        assert n.check_ready() == {"local": True}
        assert set(m.rpc.handlers) == {
            "m_read_values", "m_downstream", "m_prepare", "m_commit",
            "m_abort", "m_clocks", "m_seq", "m_seq_counter", "m_ready",
            "m_shard_map", "m_membership"}
        assert m.m_membership() == {"n_members": 1, "members": [0]}
        # granting escrow rights to another DC rides the inter-DC channel
        with pytest.raises(NotImplementedError, match="inter-DC"):
            m.node.txm.bcounters.process_transfer(m.node.txm, 1, B, 1, 1)
    finally:
        m.close()
