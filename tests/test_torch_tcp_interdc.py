"""Inter-DC replication of the port over real sockets.

The six cases of ``tests/test_tcp_interdc.py`` on port nodes
(``device="cpu"``), each DC with its own ``TcpFabric`` and the native
receive pump: the stream path, a causal chain, catch-up over the query
channel after a late subscription, a bounded-counter transfer over the
query channel, ``public_host`` kept out of local dialing, and parallel
writes from every DC.  Tolerance: exact values.
"""

import numpy as np
import pytest

from antidote_tpu_torch.api import AntidoteNode
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.interdc import DCReplica
from antidote_tpu_torch.interdc.tcp import TcpFabric
from antidote_tpu_torch.overload import InsufficientRightsError


@pytest.fixture
def cfg():
    return AntidoteConfig(
        n_shards=2, max_dcs=3, ops_per_key=8, snap_versions=2,
        set_slots=4, keys_per_table=16
    )


@pytest.fixture
def dcs(cfg):
    fabrics = [TcpFabric() for _ in range(3)]
    nodes = [AntidoteNode(cfg, dc_id=i, device="cpu") for i in range(3)]
    reps = [DCReplica(n, f, f"dc{i}")
            for i, (n, f) in enumerate(zip(nodes, fabrics))]
    TcpFabric.interconnect(fabrics)
    for a in reps:
        for b in reps:
            if a is not b:
                a.observe_dc(b)
    yield fabrics, nodes, reps
    for f in fabrics:
        f.close()


def pump_all(fabrics, rounds=6, timeout=0.3):
    """Until quiescent across every DC."""
    for _ in range(rounds):
        moved = sum(f.pump(timeout=timeout) for f in fabrics)
        if moved == 0:
            return


def test_replication_over_sockets(dcs):
    fabrics, nodes, reps = dcs
    vc = nodes[0].update_objects([("k", "counter_pn", "b", ("increment", 5))])
    pump_all(fabrics)
    for n in nodes[1:]:
        vals, _ = n.read_objects([("k", "counter_pn", "b")], clock=vc)
        assert vals == [5]


def test_multi_txn_causal_chain(dcs):
    fabrics, nodes, reps = dcs
    vc0 = nodes[0].update_objects([("s", "set_aw", "b", ("add", "a"))])
    pump_all(fabrics)
    vals, vc1 = nodes[1].read_objects([("s", "set_aw", "b")], clock=vc0)
    assert vals == [["a"]]
    vc2 = nodes[1].update_objects([("s", "set_aw", "b", ("remove", "a"))],
                                  clock=vc1)
    pump_all(fabrics)
    vals, _ = nodes[2].read_objects([("s", "set_aw", "b")], clock=vc2)
    assert vals == [[]]


def test_late_subscriber_catches_up_via_log_query(cfg):
    """DC1 subscribes only AFTER DC0 already committed: the first ping
    reveals the opid gap and the catch-up RPC replays the missed txns over
    the query connection."""
    fabrics = [TcpFabric() for _ in range(2)]
    nodes = [AntidoteNode(cfg, dc_id=i, device="cpu") for i in range(2)]
    reps = [DCReplica(n, f, f"dc{i}")
            for i, (n, f) in enumerate(zip(nodes, fabrics))]
    TcpFabric.interconnect(fabrics)
    try:
        # commit before anyone subscribes: the stream push goes nowhere
        nodes[0].update_objects([("k", "counter_pn", "b", ("increment", 3))])
        reps[1].observe_dc(reps[0])
        # a later heartbeat (its chain opid exposes the gap) triggers
        # catch-up through the socket query channel
        reps[0].heartbeat()
        pump_all(fabrics)
        vals, _ = nodes[1].read_objects(
            [("k", "counter_pn", "b")], clock=nodes[1].store.dc_max_vc()
        )
        assert vals == [3]
    finally:
        for f in fabrics:
            f.close()


def test_bcounter_transfer_over_socket_query_channel(dcs):
    fabrics, nodes, reps = dcs
    nodes[0].update_objects([("c", "counter_b", "b", ("increment", (10, 0)))])
    pump_all(fabrics)
    with pytest.raises(InsufficientRightsError):
        nodes[1].update_objects([("c", "counter_b", "b", ("decrement", (4, 1)))])
    assert reps[1].bcounter_tick() == 1   # RPC to DC0 over the socket
    pump_all(fabrics)
    nodes[1].update_objects([("c", "counter_b", "b", ("decrement", (4, 1)))])
    pump_all(fabrics)
    vals, _ = nodes[0].read_objects([("c", "counter_b", "b")],
                                    clock=nodes[0].store.dc_max_vc())
    assert vals[0] == 6


def test_public_host_keeps_local_dialing_on_bind_address(cfg):
    """--public-host with an external DNS/LB name must not break
    in-process observe_dc/_rpc: local dialing uses the BIND address;
    the public name appears only in exported descriptors."""
    fabrics = [TcpFabric(public_host="lb.invalid") for _ in range(2)]
    nodes = [AntidoteNode(cfg, dc_id=i, device="cpu") for i in range(2)]
    reps = [DCReplica(n, f, f"dc{i}")
            for i, (n, f) in enumerate(zip(nodes, fabrics))]
    TcpFabric.interconnect(fabrics)
    try:
        # in-process subscribe + catch-up RPC dial 127.0.0.1, not the
        # unresolvable advertised name
        reps[1].observe_dc(reps[0])
        nodes[0].update_objects([("k", "counter_pn", "b", ("increment", 2))])
        pump_all(fabrics)
        vals, _ = nodes[1].read_objects(
            [("k", "counter_pn", "b")], clock=nodes[1].store.dc_max_vc())
        assert vals == [2]
        # the wire descriptor carries the public name for REMOTE DCs
        assert reps[0].descriptor().address[0] == "lb.invalid"
        assert fabrics[0].address_of(0)[0] == "127.0.0.1"
    finally:
        for f in fabrics:
            f.close()


def test_parallel_writes_from_all_dcs(dcs):
    fabrics, nodes, reps = dcs
    for i, n in enumerate(nodes):
        n.update_objects([("shared", "counter_pn", "b", ("increment", i + 1))])
    pump_all(fabrics)
    target = np.maximum.reduce([n.store.dc_max_vc() for n in nodes])
    for n in nodes:
        vals, _ = n.read_objects([("shared", "counter_pn", "b")], clock=target)
        assert vals[0] == 6


def test_a_burst_of_frames_leaves_in_a_few_sends_in_order():
    """A subscriber's writer sends what its outbox holds in batches of up
    to ``SEND_BATCH`` frames, one ``sendall`` a batch: a heartbeat's burst
    of pings (one a shard) costs a few system calls, and the frames
    arrive whole and in order."""
    import socket

    from antidote_tpu_torch.interdc import tcp

    a, b = socket.socketpair()

    class Counting:
        def __init__(self, sock):
            self.sock, self.sends = sock, 0

        def sendall(self, data):
            self.sends += 1
            self.sock.sendall(data)

        def fileno(self):
            return self.sock.fileno()

    out = Counting(a)
    sub = tcp._Subscriber(out)
    frames = [f"frame {i}".encode() * (1 + i % 5) for i in range(1000)]
    for f in frames:
        assert sub.offer(f)
    sub.stop()
    dead = []
    sub.start(dead.append)
    b.settimeout(10)
    got = [tcp._recv(b) for _ in frames]
    sub._thread.join(10)
    assert got == [(tcp.K_PUSH, f) for f in frames]
    assert out.sends == -(-len(frames) // tcp._Subscriber.SEND_BATCH)
    assert not dead and not sub._thread.is_alive()
    a.close()
    b.close()
