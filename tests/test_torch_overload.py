"""The port's overload protection on the CPU: typed shed errors on every
plane, deadline discipline, and the WAL-failure read-only degraded mode.
Counterparts of ``tests/test_overload.py`` against a port server over a
``device="cpu"`` node, with the port's own fault injector.

The invariants under test mirror riak_core's vnode overload protection:
a saturated plane answers a TYPED busy/deadline/read-only error (with a
retry hint where that helps the client), in-flight work still completes,
and degraded modes exit automatically once the underlying fault clears —
no silent queue growth, no wedged node, no operator restart.
"""

import threading
import time

import pytest

from antidote_tpu_torch import faults
from antidote_tpu_torch.api.node import AntidoteNode as _Node
from antidote_tpu_torch.txn.manager import AbortError
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.overload import (
    AdmissionGate,
    BusyError,
    DeadlineExceeded,
    check_deadline,
    deadline_from_ms,
)
from antidote_tpu_torch.proto.client import (
    AntidoteClient,
    RemoteBusy,
    RemoteDeadline,
    RemoteReadOnly,
)
from antidote_tpu_torch.proto.server import ProtocolServer


def AntidoteNode(*a, **kw):
    """The port's node on the CPU."""
    kw.setdefault("device", "cpu")
    return _Node(*a, **kw)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.uninstall()


def mk_cfg():
    return AntidoteConfig(
        n_shards=2, max_dcs=2, ops_per_key=8, snap_versions=2,
        set_slots=8, rga_slots=16, keys_per_table=64,
    )


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
@pytest.mark.smoke
def test_admission_gate_caps_and_hints():
    g = AdmissionGate(max_in_flight=2, max_per_client=1)
    g.enter(1)
    # per-client cap fires before the global one
    with pytest.raises(BusyError) as e1:
        g.enter(1)
    assert e1.value.retry_after_ms >= 25
    g.enter(2)
    with pytest.raises(BusyError) as e2:
        g.enter(3)  # global cap
    assert "max_in_flight=2" in str(e2.value)
    g.exit(1)
    g.enter(3)  # freed slot readmits
    g.exit(2)
    g.exit(3)
    assert g.in_flight() == 0


@pytest.mark.smoke
def test_deadline_helpers():
    assert deadline_from_ms(None, None) is None
    # client budget wins over the configured default
    d = deadline_from_ms(10_000, 1.0)
    assert d is not None and d > time.monotonic() + 5
    check_deadline(None, "anywhere")  # no deadline = never expires
    check_deadline(time.monotonic() + 5, "dispatch")
    with pytest.raises(DeadlineExceeded, match="dequeue"):
        check_deadline(time.monotonic() - 0.01, "dequeue")


# ---------------------------------------------------------------------------
# WAL failure -> read-only degraded mode -> auto-recovery
# ---------------------------------------------------------------------------
@pytest.fixture(params=["native", "python"])
def wal_plane(request, monkeypatch):
    """Run the degraded-mode path over both WAL implementations."""
    from antidote_tpu_torch.log import wal as walmod

    if request.param == "python":
        monkeypatch.setattr(walmod, "_load_lib", lambda: None)
    elif walmod._load_lib() is None:
        pytest.skip("native WAL unavailable in this image")
    return request.param


def test_wal_probe_consults_fault_site(tmp_path, wal_plane):
    from antidote_tpu_torch.log.wal import ShardWAL

    wal = ShardWAL(str(tmp_path / "shard_0.wal"))
    assert wal.native == (wal_plane == "native")
    wal.probe()  # healthy volume: no-op
    faults.install(faults.FaultPlan(seed=1).enospc("wal.append", times=2))
    import errno

    with pytest.raises(OSError) as e:
        wal.probe()
    assert e.value.errno == errno.ENOSPC
    with pytest.raises(OSError):
        wal.probe()
    wal.probe()  # rule exhausted: the volume is "writable" again
    wal.close()
    # the probe's sidecar never pollutes the log directory
    assert list(tmp_path.iterdir()) == [tmp_path / "shard_0.wal"]


@pytest.mark.parametrize("action", ["enospc", "io_error"])
def test_node_wal_failure_enters_and_exits_read_only(tmp_path, wal_plane,
                                                     action):
    node = AntidoteNode(mk_cfg(), log_dir=str(tmp_path))
    node.update_objects([("k", "counter_pn", "b", ("increment", 1))])
    plan = faults.FaultPlan(seed=7)
    getattr(plan, action)("wal.append", times=3)
    faults.install(plan)
    from antidote_tpu_torch.overload import ReadOnlyError

    # the failing append aborts the commit and flips the node read-only
    with pytest.raises(ReadOnlyError):
        node.update_objects([("k", "counter_pn", "b", ("increment", 2))])
    assert node.txm.read_only_reason is not None
    assert node.metrics.degraded_read_only.value() == 1
    # reads keep serving (and see only the pre-fault commit)
    vals, _ = node.read_objects([("k", "counter_pn", "b")])
    assert vals == [1]
    # while the volume still fails, writes stay rejected (each attempt
    # probes; the probe consumes the remaining injected failures)
    for _ in range(2):
        node.txm._ro_probe_at = 0.0
        with pytest.raises(ReadOnlyError):
            node.update_objects([("k", "counter_pn", "b", ("increment", 9))])
    # fault clears -> the next write attempt's probe succeeds and the
    # mode exits automatically; the write goes through
    node.txm._ro_probe_at = 0.0
    node.update_objects([("k", "counter_pn", "b", ("increment", 5))])
    assert node.txm.read_only_reason is None
    assert node.metrics.degraded_read_only.value() == 0
    vals, _ = node.read_objects([("k", "counter_pn", "b")])
    assert vals == [6]  # the rejected increments never half-applied
    assert node.status()["overload"]["read_only"] is None


def test_read_only_survives_recovery_replay(tmp_path, wal_plane):
    """Nothing a failed append half-wrote may resurrect at restart."""
    cfg = mk_cfg()
    node = AntidoteNode(cfg, log_dir=str(tmp_path))
    node.update_objects([("k", "counter_pn", "b", ("increment", 1))])
    faults.install(faults.FaultPlan(seed=9).enospc("wal.append", times=1))
    from antidote_tpu_torch.overload import ReadOnlyError

    with pytest.raises(ReadOnlyError):
        node.update_objects([("k", "counter_pn", "b", ("increment", 7))])
    faults.uninstall()
    node.store.log.close()
    re = AntidoteNode(cfg, log_dir=str(tmp_path), recover=True)
    vals, _ = re.read_objects([("k", "counter_pn", "b")])
    assert vals == [1]


# ---------------------------------------------------------------------------
# wire server: admission caps, bounded gate, deadlines, typed replies
# ---------------------------------------------------------------------------
def _mk_server(tmp_path=None, **kw):
    node = AntidoteNode(mk_cfg(),
                        log_dir=None if tmp_path is None else str(tmp_path))
    return node, ProtocolServer(node, port=0, **kw)


def test_saturated_server_sheds_busy_and_inflight_completes():
    node, srv = _mk_server(max_in_flight=1, max_in_flight_per_client=1)
    a, b = AntidoteClient(port=srv.port), AntidoteClient(port=srv.port)
    try:
        res = {}
        with node.txm.commit_lock:  # wedge the commit plane
            ta = threading.Thread(target=lambda: res.update(
                ok=a.update_objects(
                    [("k", "counter_pn", "b", ("increment", 3))])))
            ta.start()
            deadline = time.monotonic() + 10
            while srv.admission.in_flight() < 1:  # a is admitted + parked
                assert time.monotonic() < deadline
                time.sleep(0.005)
            # the server is at max_in_flight: b gets a TYPED busy reply
            # with a retry hint, not a parked-forever connection
            with pytest.raises(RemoteBusy) as e:
                b.read_objects([("k", "counter_pn", "b")])
            assert e.value.retry_after_ms >= 25
        ta.join(timeout=30)
        assert res["ok"] is not None  # the in-flight request completed
        # pressure gone: the same connection serves again
        vals, _ = b.read_objects([("k", "counter_pn", "b")])
        assert vals == [3]
        assert node.metrics.shed.value(plane="server") >= 1
    finally:
        a.close()
        b.close()
        srv.close()


def test_full_batch_gate_answers_busy():
    node, srv = _mk_server(queue_max=1)
    cs = [AntidoteClient(port=srv.port) for _ in range(3)]
    try:
        with node.txm.commit_lock:
            done = []
            ts = []
            for c in cs[:2]:
                t = threading.Thread(target=lambda c=c: done.append(
                    c.update_objects(
                        [("g", "counter_pn", "b", ("increment", 1))])))
                t.start()
                ts.append(t)
                time.sleep(0.2)  # 1st grabbed by the batcher, 2nd parked
            with pytest.raises(RemoteBusy, match="batch gate full"):
                cs[2].update_objects(
                    [("g", "counter_pn", "b", ("increment", 1))])
        for t in ts:
            t.join(timeout=30)
        assert len(done) == 2
        assert node.metrics.shed.value(plane="server_queue") >= 1
    finally:
        for c in cs:
            c.close()
        srv.close()


def test_deadline_aborts_parked_work_at_dequeue():
    node, srv = _mk_server()
    a, b = AntidoteClient(port=srv.port), AntidoteClient(port=srv.port)
    try:
        with node.txm.commit_lock:
            res = {}
            ta = threading.Thread(target=lambda: res.update(
                ok=a.update_objects(
                    [("d", "counter_pn", "b", ("increment", 1))])))
            ta.start()
            time.sleep(0.3)  # the batcher holds a's work at the lock
            tb_err = []

            def send_b():
                try:
                    b.update_objects(
                        [("d", "counter_pn", "b", ("increment", 1))],
                        deadline_ms=200)
                except Exception as e:
                    tb_err.append(e)

            tb = threading.Thread(target=send_b)
            tb.start()
            time.sleep(0.6)  # b's deadline passes while parked
        ta.join(timeout=30)
        tb.join(timeout=30)
        assert res["ok"] is not None
        assert len(tb_err) == 1 and isinstance(tb_err[0], RemoteDeadline)
        # the expired update was aborted at dequeue, NOT executed
        vals, _ = a.read_objects([("d", "counter_pn", "b")])
        assert vals == [1]
        assert node.metrics.shed.value(plane="deadline") >= 1
    finally:
        a.close()
        b.close()
        srv.close()


def test_commit_backlog_cap_sheds_typed_busy():
    node, srv = _mk_server()
    c = AntidoteClient(port=srv.port)
    try:
        node.txm.max_commit_backlog = 0
        with pytest.raises(RemoteBusy, match="commit backlog"):
            c.update_objects([("cb", "counter_pn", "b", ("increment", 1))])
        assert node.metrics.shed.value(plane="txn") >= 1
        node.txm.max_commit_backlog = 64
        c.update_objects([("cb", "counter_pn", "b", ("increment", 1))])
        # shed commits never leak open transactions (they would pin the
        # certification-GC floor forever)
        assert not node.txm._open_snaps
    finally:
        c.close()
        srv.close()


def test_interactive_commit_busy_is_retryable():
    """A commit-backlog shed must leave the interactive txn OPEN: the
    busy reply invites a retry, so retrying the SAME commit (same txid)
    has to work — the shed happens before the group touches the txn."""
    node, srv = _mk_server()
    c = AntidoteClient(port=srv.port)
    try:
        txn = c.start_transaction()
        txn.update_objects([("ic", "counter_pn", "b", ("increment", 4))])
        node.txm.max_commit_backlog = 0
        with pytest.raises(RemoteBusy):
            txn.commit()
        node.txm.max_commit_backlog = 64
        txn.commit()  # the honest retry: same txid, now admitted
        vals, _ = c.read_objects([("ic", "counter_pn", "b")])
        assert vals == [4]
        assert not node.txm._open_snaps
    finally:
        c.close()
        srv.close()


def test_read_only_over_the_wire(tmp_path):
    node, srv = _mk_server(tmp_path=tmp_path)
    c = AntidoteClient(port=srv.port)
    try:
        c.update_objects([("w", "counter_pn", "b", ("increment", 2))])
        faults.install(
            faults.FaultPlan(seed=3).enospc("wal.append", times=1))
        with pytest.raises(RemoteReadOnly):
            c.update_objects([("w", "counter_pn", "b", ("increment", 5))])
        # reads keep serving over the wire while the node is degraded
        vals, _ = c.read_objects([("w", "counter_pn", "b")])
        assert vals == [2]
        st = c.node_status()["overload"]
        assert st["read_only"] is not None
        assert st["max_in_flight"] == srv.admission.max_in_flight
        # volume heals (rule exhausted): auto-recovery on the next write
        node.txm._ro_probe_at = 0.0
        clock = c.update_objects([("w", "counter_pn", "b", ("increment", 5))])
        vals, _ = c.read_objects([("w", "counter_pn", "b")], clock=clock)
        assert vals == [7]
        assert c.node_status()["overload"]["read_only"] is None
    finally:
        c.close()
        srv.close()


def test_default_deadline_config_applies_to_plain_requests():
    node, srv = _mk_server(default_deadline_ms=250.0)
    a, b = AntidoteClient(port=srv.port), AntidoteClient(port=srv.port)
    try:
        with node.txm.commit_lock:
            res, errs = {}, []
            ta = threading.Thread(target=lambda: res.update(
                ok=a.update_objects(
                    [("x", "counter_pn", "b", ("increment", 1))])))
            ta.start()
            time.sleep(0.3)  # the batcher holds a's work at the lock

            def send_b():  # carries NO deadline_ms: the default applies
                try:
                    b.update_objects(
                        [("x", "counter_pn", "b", ("increment", 1))])
                except Exception as e:
                    errs.append(e)

            tb = threading.Thread(target=send_b)
            tb.start()
            time.sleep(0.6)  # past the configured default while parked
        ta.join(timeout=30)
        tb.join(timeout=30)
        assert res["ok"] is not None  # no deadline default for round 1
        assert len(errs) == 1 and isinstance(errs[0], RemoteDeadline)
    finally:
        a.close()
        b.close()
        srv.close()


# ---------------------------------------------------------------------------
# mid-group ENOSPC: the failed group must leave NO durable trace
# ---------------------------------------------------------------------------
def test_log_effects_mid_group_rolls_back_prefix(tmp_path, wal_plane):
    """A group whose LATER record hits ENOSPC must roll back the records,
    op-id chains and blob-dedup memory it already appended — a durable
    prefix of a NACKed group would resurrect on recovery replay, and an
    advanced op-id chain would publish a permanent gap to subscribers."""
    import numpy as np

    from antidote_tpu_torch.log import LogManager, replay

    lm = LogManager(mk_cfg(), str(tmp_path / "wal"))
    vc = np.zeros(2, np.int64)

    def ent(shard, key):
        return (shard, key, "counter_pn", "b",
                np.array([1], np.int64), np.array([], np.int32), vc, 0, ())

    lm.log_effect(*ent(0, "seed"))
    lm.commit_barrier([0])
    before_ids = lm.op_ids.copy()
    before_off = lm.wals[0].tell()
    faults.install(
        faults.FaultPlan(seed=2).enospc("wal.append", key="shard_1.wal",
                                        times=1))
    with pytest.raises(OSError):
        lm.log_effects([ent(0, "x"), ent(1, "y")])
    faults.uninstall()
    assert np.array_equal(lm.op_ids, before_ids)
    assert lm.wals[0].tell() == before_off  # shard 0's record rolled back
    lm.commit_barrier([0, 1])
    p0 = str(tmp_path / "wal" / "shard_0.wal")
    p1 = str(tmp_path / "wal" / "shard_1.wal")
    assert [r["k"] for r in replay(p0)] == ["seed"]
    assert [r["k"] for r in replay(p1)] == []
    # the log still works after a rollback: the same group re-logs clean
    lm.log_effects([ent(0, "x"), ent(1, "y")])
    lm.commit_barrier([0, 1])
    assert [r["k"] for r in replay(p0)] == ["seed", "x"]
    assert [(r["k"], r["id"]) for r in replay(p1)] == [("y", 1)]
    lm.close()


def test_enospc_mid_group_nacks_only_its_subgroup(tmp_path):
    """Node-level mid-merged-batch ENOSPC (sub-group atomicity):
    the sub-group whose shard file refuses the append fails TYPED and
    rolls back alone — op-id chain, certification stamps, recovery
    replay — while its sibling sub-group commits and stays durable.  A
    pre-group transaction must not first-committer-abort against the
    NACKed member's phantom stamps, but must still abort against the
    committed sibling's real ones."""
    import numpy as np

    from antidote_tpu_torch.overload import ReadOnlyError

    cfg = mk_cfg()
    node = AntidoteNode(cfg, log_dir=str(tmp_path))
    # seed a pool and find two keys on DIFFERENT shards, so a fault
    # scoped to the second key's shard file fails exactly one sub-group
    pool = [f"k{i}" for i in range(8)]
    node.update_objects(
        [(k, "counter_pn", "b", ("increment", 1)) for k in pool])
    by_shard = {}
    for k in pool:
        by_shard.setdefault(
            int(node.store.locate(k, "counter_pn", "b")[1]), k)
    assert len(by_shard) == 2, "pool never spanned both shards"
    k_first, k_second = by_shard[0], by_shard[1]

    def rmw(key, amount):
        # read-bearing: keeps certification (and its stamps) in play —
        # blind increments would take the commutativity bypass
        t = node.start_transaction()
        node.read_objects([(key, "counter_pn", "b")], t)
        node.update_objects([(key, "counter_pn", "b",
                              ("increment", amount))], t)
        return t

    # transactions whose snapshots predate the doomed merged batch
    pre_second = rmw(k_second, 10)
    pre_first = rmw(k_first, 10)
    ids_before = node.store.log.op_ids.copy()
    counter_before = node.txm.commit_counter
    t1 = rmw(k_first, 100)
    t2 = rmw(k_second, 100)
    shard_first = int(node.store.locate(k_first, "counter_pn", "b")[1])
    shard_second = int(node.store.locate(k_second, "counter_pn", "b")[1])
    faults.install(faults.FaultPlan(seed=5).enospc(
        "wal.append", key=f"shard_{shard_second}.wal", times=1))
    outs = node.txm.commit_transactions_group([t1, t2])
    faults.uninstall()
    # sibling committed, refused sub-group NACKed typed
    assert isinstance(outs[0], np.ndarray)
    assert isinstance(outs[1], ReadOnlyError)
    assert node.txm.read_only_reason is not None
    # t1's chain advanced; t2's rolled back
    ids_after = ids_before.copy()
    ids_after[shard_first, 0] += 1
    assert np.array_equal(node.store.log.op_ids, ids_after)
    # t2's counter stays a HOLE (holes are safe; nothing reuses them)
    assert node.txm.commit_counter == counter_before + 2
    # recovery probe exits read-only; the NACKed member's stamps are
    # gone (pre_second commits — a phantom stamp would abort it) while
    # the committed sibling's stamps stand (pre_first aborts)
    node.txm._ro_probe_at = 0.0
    node.commit_transaction(pre_second)
    with pytest.raises(AbortError):
        node.commit_transaction(pre_first)
    vals, _ = node.read_objects([(k_first, "counter_pn", "b"),
                                 (k_second, "counter_pn", "b")])
    assert vals == [101, 11]  # t1 + seeds + pre_second; t2 never landed
    node.store.log.close()
    # replay must agree: the committed sibling survives restart, the
    # NACKed sub-group does not resurrect
    re = AntidoteNode(cfg, log_dir=str(tmp_path), recover=True)
    vals, _ = re.read_objects([(k_first, "counter_pn", "b"),
                               (k_second, "counter_pn", "b")])
    assert vals == [101, 11]


def test_typed_errors_match_the_jax_package():
    """Every typed refusal of the port carries the JAX package's message
    and fields (the wire mapping reads them), and keeps its base class."""
    from antidote_tpu import overload as j
    from antidote_tpu_torch import overload as t

    cases = [
        ("BusyError", ("at cap",), {"retry_after_ms": 75}),
        ("TenantBusyError", ("lane full",), {"tenant": "gold",
                                              "retry_after_ms": 30}),
        ("DeadlineExceeded", ("late",), {}),
        ("ReadOnlyError", ("ENOSPC",), {}),
        ("NotOwnerError", (["10.0.0.1", 8087],), {}),
        ("NotOwnerError", (None,), {}),
        ("ReplicaLagging", ("behind",), {"retry_after_ms": 40,
                                         "redirect": ("h", 1)}),
        ("ColdMiss", ("capped",), {"retry_after_ms": 60,
                                   "permanent": True}),
        ("ReplicaDown", ("every endpoint refused",), {}),
        ("InsufficientRightsError", ("needs 5",), {"key": "k",
                                                    "needed": 5,
                                                    "held": 2}),
        ("ForwardFailed", ("lost",), {}),
    ]
    fields = ("retry_after_ms", "tenant", "reason", "redirect",
              "permanent", "key", "needed", "held", "maybe_executed")
    for name, args, kw in cases:
        a, b = getattr(t, name)(*args, **kw), getattr(j, name)(*args, **kw)
        assert str(a) == str(b)
        assert [getattr(a, f, None) for f in fields] == \
            [getattr(b, f, None) for f in fields]
        assert [c.__name__ for c in type(a).__mro__] == \
            [c.__name__ for c in type(b).__mro__]
    for streak in range(0, 100, 3):
        assert t.retry_hint_ms(streak) == j.retry_hint_ms(streak)
