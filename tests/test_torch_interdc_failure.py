"""Node failure and restart of the port's replicated DCs.

The six cases of ``tests/test_failure.py`` on port nodes
(``device="cpu"``): a restarted DC resumes replication from its WAL, a
restarted origin serves catch-up, a restart never re-applies a chain, a
node killed mid-stream converges, a TCP endpoint restart reconnects, and
a healed partition converges.  "Kill" discards every in-memory object;
only the WAL directory survives.  Tolerance: exact values.
"""

import numpy as np
import pytest

from antidote_tpu_torch.api import AntidoteNode
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.interdc import DCReplica
from antidote_tpu_torch.interdc.transport import LoopbackHub


@pytest.fixture
def cfg():
    return AntidoteConfig(
        n_shards=2, max_dcs=3, ops_per_key=8, snap_versions=2,
        set_slots=4, keys_per_table=16
    )


def mk_dc(cfg, hub, dc_id, log_dir, recover=False):
    node = AntidoteNode(cfg, dc_id=dc_id, log_dir=str(log_dir),
                        recover=recover, device="cpu")
    rep = DCReplica(node, hub, f"dc{dc_id}")
    if recover:
        rep.restore_from_log()
    return node, rep


def kill(hub, dc_id):
    """Simulate kill -9: the hub forgets the dead DC's callbacks."""
    hub.unregister(dc_id)


def test_restart_preserves_and_resumes_replication(cfg, tmp_path):
    hub = LoopbackHub()
    n0, r0 = mk_dc(cfg, hub, 0, tmp_path / "dc0")
    n1, r1 = mk_dc(cfg, hub, 1, tmp_path / "dc1")
    r0.observe_dc(r1), r1.observe_dc(r0)
    n0.update_objects([("k", "counter_pn", "b", ("increment", 5)),
                       ("s", "set_aw", "b", ("add", "x"))])
    hub.pump()
    # kill DC1, restart from its WAL alone
    kill(hub, 1)
    del n1, r1
    n1, r1 = mk_dc(cfg, hub, 1, tmp_path / "dc1", recover=True)
    r1.observe_dc(r0), r0.observe_dc(r1)
    # the reference's 1 s heartbeat timers re-advance idle shard clocks
    # after a restart; fire them explicitly (the loopback has no timers)
    r0.heartbeat(), r1.heartbeat()
    hub.pump()
    vals, _ = n1.read_objects([("k", "counter_pn", "b"), ("s", "set_aw", "b")],
                              clock=n1.store.dc_max_vc())
    assert vals == [5, ["x"]]
    # replication resumes in BOTH directions after the restart
    n0.update_objects([("k", "counter_pn", "b", ("increment", 1))])
    n1.update_objects([("k2", "counter_pn", "b", ("increment", 7))])
    hub.pump()
    tgt = np.maximum(n0.store.dc_max_vc(), n1.store.dc_max_vc())
    for n in (n0, n1):
        vals, _ = n.read_objects(
            [("k", "counter_pn", "b"), ("k2", "counter_pn", "b")], clock=tgt)
        assert vals == [6, 7]


def test_restarted_origin_serves_catch_up(cfg, tmp_path):
    """DC0 commits, is killed, restarts — then a late subscriber's catch-up
    query must still replay the pre-crash txns (rebuilt egress chains)."""
    hub = LoopbackHub()
    n0, r0 = mk_dc(cfg, hub, 0, tmp_path / "dc0")
    n0.update_objects([("k", "counter_pn", "b", ("increment", 3))])
    n0.update_objects([("k", "counter_pn", "b", ("increment", 4))])
    kill(hub, 0)
    del n0, r0
    n0, r0 = mk_dc(cfg, hub, 0, tmp_path / "dc0", recover=True)
    # DC1 arrives only now
    n1, r1 = mk_dc(cfg, hub, 1, tmp_path / "dc1")
    r1.observe_dc(r0)
    r0.heartbeat()  # chain head reveals the gap → catch-up query
    hub.pump()
    vals, _ = n1.read_objects([("k", "counter_pn", "b")],
                              clock=n1.store.dc_max_vc())
    assert vals == [7]


def test_restart_does_not_reapply_duplicates(cfg, tmp_path):
    """After restart, a conservative catch-up may re-deliver already-applied
    txns; the dependency gate must drop them (idempotent re-delivery)."""
    hub = LoopbackHub()
    n0, r0 = mk_dc(cfg, hub, 0, tmp_path / "dc0")
    n1, r1 = mk_dc(cfg, hub, 1, tmp_path / "dc1")
    r1.observe_dc(r0)
    n0.update_objects([("k", "counter_pn", "b", ("increment", 5))])
    hub.pump()
    # restart DC1; force its ingress chains back to zero so the next ping
    # triggers a full-history catch-up (worst-case re-delivery)
    kill(hub, 1)
    del n1, r1
    n1, r1 = mk_dc(cfg, hub, 1, tmp_path / "dc1", recover=True)
    r1.last_seen.clear()
    r1.observe_dc(r0)
    r0.heartbeat()
    hub.pump()
    vals, _ = n1.read_objects([("k", "counter_pn", "b")],
                              clock=n1.store.dc_max_vc())
    assert vals == [5]  # not 10


def test_kill_mid_stream_then_converge(cfg, tmp_path):
    """The node-failure suite's core scenario: DC1 dies while DC0 keeps
    committing; after restart the missed txns flow via catch-up and both
    DCs converge (no lost or duplicated updates)."""
    hub = LoopbackHub()
    n0, r0 = mk_dc(cfg, hub, 0, tmp_path / "dc0")
    n1, r1 = mk_dc(cfg, hub, 1, tmp_path / "dc1")
    r0.observe_dc(r1), r1.observe_dc(r0)
    for i in range(3):
        n0.update_objects([("c", "counter_pn", "b", ("increment", 1))])
    hub.pump()
    kill(hub, 1)
    survivors_only = [
        n0.update_objects([("c", "counter_pn", "b", ("increment", 1))])
        for _ in range(4)
    ]
    del n1, r1, survivors_only
    n1, r1 = mk_dc(cfg, hub, 1, tmp_path / "dc1", recover=True)
    r1.observe_dc(r0), r0.observe_dc(r1)
    r0.heartbeat()
    hub.pump()
    vals, _ = n1.read_objects([("c", "counter_pn", "b")],
                              clock=n1.store.dc_max_vc())
    assert vals == [7]
    # and the restarted DC can still write; DC0 sees it
    n1.update_objects([("c", "counter_pn", "b", ("increment", 10))])
    hub.pump()
    vals, _ = n0.read_objects([("c", "counter_pn", "b")],
                              clock=np.maximum(n0.store.dc_max_vc(),
                                               n1.store.dc_max_vc()))
    assert vals == [17]


def test_tcp_restart_and_reconnect(cfg, tmp_path):
    """Same kill/restart flow over real sockets: the reborn DC binds a new
    endpoint, the survivor learns the new address (descriptor
    re-exchange) and both converge."""
    from antidote_tpu_torch.interdc.tcp import TcpFabric

    fab0, fab1 = TcpFabric(), TcpFabric()
    n0 = AntidoteNode(cfg, dc_id=0, log_dir=str(tmp_path / "dc0"), device="cpu")
    n1 = AntidoteNode(cfg, dc_id=1, log_dir=str(tmp_path / "dc1"), device="cpu")
    r0, r1 = DCReplica(n0, fab0, "dc0"), DCReplica(n1, fab1, "dc1")
    TcpFabric.interconnect([fab0, fab1])
    r0.observe_dc(r1), r1.observe_dc(r0)
    try:
        n0.update_objects([("k", "counter_pn", "b", ("increment", 2))])
        fab0.pump(timeout=0.2), fab1.pump(timeout=0.2)
        # kill DC1's process: sockets die, memory gone; WAL survives
        fab1.close()
        del n1, r1
        n0.update_objects([("k", "counter_pn", "b", ("increment", 3))])
        fab1 = TcpFabric()
        n1 = AntidoteNode(cfg, dc_id=1, log_dir=str(tmp_path / "dc1"),
                          recover=True, device="cpu")
        r1 = DCReplica(n1, fab1, "dc1")
        r1.restore_from_log()
        # descriptor re-exchange: both sides learn current addresses
        TcpFabric.interconnect([fab0, fab1])
        fab0.connect_remote(1, *fab1.address_of(1))
        r1.observe_dc(r0), r0.observe_dc(r1)
        r0.heartbeat()
        for _ in range(4):
            fab1.pump(timeout=0.3), fab0.pump(timeout=0.3)
        vals, _ = n1.read_objects([("k", "counter_pn", "b")],
                                  clock=n1.store.dc_max_vc())
        assert vals == [5]
    finally:
        fab0.close(), fab1.close()


def test_partition_heal_converges(cfg, tmp_path):
    """Network partition (all links drop) then heal: commits made on both
    sides during the partition converge afterwards."""
    hub = LoopbackHub()
    n0, r0 = mk_dc(cfg, hub, 0, tmp_path / "dc0")
    n1, r1 = mk_dc(cfg, hub, 1, tmp_path / "dc1")
    r0.observe_dc(r1), r1.observe_dc(r0)
    n0.update_objects([("s", "set_aw", "b", ("add", "pre"))])
    hub.pump()
    # partition: drop everything published while split (both directions)
    hub.drop_next(0, 1, 10_000)
    hub.drop_next(1, 0, 10_000)
    n0.update_objects([("s", "set_aw", "b", ("add", "left"))])
    n1.update_objects([("s", "set_aw", "b", ("add", "right"))])
    hub.pump()
    # heal + heartbeats reveal the opid gaps → catch-up both ways
    hub.drop.clear()
    r0.heartbeat(), r1.heartbeat()
    hub.pump()
    tgt = np.maximum(n0.store.dc_max_vc(), n1.store.dc_max_vc())
    for n in (n0, n1):
        vals, _ = n.read_objects([("s", "set_aw", "b")], clock=tgt)
        assert sorted(vals[0]) == ["left", "pre", "right"]
