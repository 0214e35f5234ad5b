"""Inter-DC replication from a multi-member DC (``attach_interdc``) against
the JAX package.

The JAX suite's clustered cases on each package (the port's members and
nodes on ``device="cpu"``, a loopback hub each): a 2-member DC0 and a
single-node DC1 replicating both ways with per-member chains, a lost
message healed by catch-up routed to the owning member; and a counter_b
rights request from DC1 routed to the owning member of DC0, whose
coordinator commits the grant through the sequencer.  Both packages log
the same values.  Then a port 2-member DC replicates over ``TcpFabric`` to
a JAX single-node DC and back, with equal values.  Exact: the tolerance
is equality."""

import threading

import pytest

from antidote_tpu.api.node import AntidoteNode as JaxAntidoteNode
from antidote_tpu.cluster import ClusterMember as JaxMember
from antidote_tpu.cluster import ClusterNode as JaxNode
from antidote_tpu.cluster import attach_interdc as jax_attach
from antidote_tpu.cluster import cluster_query_router as jax_router
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu.interdc import DCReplica as JaxReplica
from antidote_tpu.interdc import LoopbackHub as JaxHub
from antidote_tpu.overload import InsufficientRightsError as JaxRights
from antidote_tpu_torch.api import AntidoteNode
from antidote_tpu_torch.cluster import (ClusterMember, ClusterNode,
                                        attach_interdc, cluster_query_router,
                                        fabric_id_of)
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.interdc import DCReplica, LoopbackHub
from antidote_tpu_torch.interdc.tcp import TcpFabric
from antidote_tpu_torch.overload import InsufficientRightsError
from antidote_tpu_torch.store.kv import key_to_shard

KW = dict(n_shards=4, max_dcs=3, ops_per_key=8, keys_per_table=64)
C, S, CB, B = "counter_pn", "set_aw", "counter_b", "b"


class _Jax:
    Hub = JaxHub
    Node = JaxNode
    Replica = JaxReplica
    attach = staticmethod(jax_attach)
    router = staticmethod(jax_router)
    Rights = JaxRights

    @staticmethod
    def members():
        cfg = JaxConfig(**KW, batch_buckets=(16, 64))
        return [JaxMember(cfg, dc_id=0, member_id=i, n_members=2)
                for i in range(2)]

    @staticmethod
    def single(dc):
        return JaxAntidoteNode(JaxConfig(**KW, batch_buckets=(16, 64)),
                               dc_id=dc)


class _Port:
    Hub = LoopbackHub
    Node = ClusterNode
    Replica = DCReplica
    attach = staticmethod(attach_interdc)
    router = staticmethod(cluster_query_router)
    Rights = InsufficientRightsError

    @staticmethod
    def members():
        return [ClusterMember(AntidoteConfig(**KW), dc_id=0, member_id=i,
                              n_members=2, device="cpu") for i in range(2)]

    @staticmethod
    def single(dc):
        return AntidoteNode(AntidoteConfig(**KW), dc_id=dc, device="cpu")


def _cluster_plus_dc1(pkg):
    """DC0 = 2 members, DC1 = a single node, a full mesh on one hub."""
    hub = pkg.Hub()
    m0, m1 = pkg.members()
    m0.connect(1, *m1.address)
    m1.connect(0, *m0.address)
    r0a, r0b = pkg.attach(m0, hub), pkg.attach(m1, hub)
    node1 = pkg.single(1)
    r1 = pkg.Replica(node1, hub)
    r1.route_query = pkg.router({0: 2}, KW["n_shards"])
    for sub in (r0a, r0b):
        sub.observe_dc(r1)
    r1.observe_dc(r0a)
    r1.observe_dc(r0b)
    return hub, m0, m1, r0a, r0b, node1, r1


def _key_on(member, tag):
    for i in range(10_000):
        k = f"{tag}{i}"
        if key_to_shard(k, B, KW["n_shards"]) in member.shards:
            return k
    raise AssertionError


def _interdc_script(pkg):
    out = []
    hub, m0, m1, r0a, r0b, node1, r1 = _cluster_plus_dc1(pkg)
    try:
        n0 = pkg.Node(m0)
        vc = n0.update_objects([(0, C, B, ("increment", 3)),
                                (1, S, B, ("add", "cross"))])
        hub.pump()
        out.append(node1.read_objects([(0, C, B), (1, S, B)], clock=vc)[0])
        # the reverse direction: DC1 writes, the clustered DC0 reads
        vc1 = node1.update_objects([(2, C, B, ("increment", 9))])
        hub.pump()
        m0.refresh_peer_clocks()
        m1.refresh_peer_clocks()
        out.append(n0.read_objects([(2, C, B)], clock=vc1)[0])
        # catch-up through the router: drop a DC0 -> DC1 message of member
        # 1's chain, heal it from the owning member's log window
        hub.drop_next(fabric_id_of(0, 1), 1, n=1)
        vc2 = n0.update_objects([(1, S, B, ("add", "lost"))])
        hub.pump()
        r0b.heartbeat()
        hub.pump()
        vals = node1.read_objects([(1, S, B)], clock=vc2)[0]
        out.append(sorted(vals[0]))
        # the owner stamps taught DC1 which member serves each chain
        out.append(sorted((o, s, list(r))
                          for (o, s), r in r1.shard_route.items()))
    finally:
        m0.close(), m1.close()
    return out


def _transfer_script(pkg):
    out = []
    hub, m0, m1, r0a, r0b, node1, r1 = _cluster_plus_dc1(pkg)
    try:
        c0 = pkg.Node(m0)
        k = _key_on(m1, "xf")  # owner: member 1 (not the bare-dc endpoint)
        vc = c0.update_objects([(k, CB, B, ("increment", (10, 0)))])
        hub.pump()
        out.append(node1.read_objects([(k, CB, B)], clock=vc)[0])
        with pytest.raises(pkg.Rights):
            node1.update_objects([(k, CB, B, ("decrement", (3, 1)))])
        out.append(r1.bcounter_tick())
        for _ in range(100):
            hub.pump()
            try:
                node1.update_objects([(k, CB, B, ("decrement", (3, 1)))])
                break
            except pkg.Rights:
                continue
        else:
            raise AssertionError("transferred rights never became "
                                 "spendable")
        out.append(node1.read_objects([(k, CB, B)])[0])
        hub.pump()
        for _ in range(50):
            m0.refresh_peer_clocks(), m1.refresh_peer_clocks()
            vals = c0.read_objects([(k, CB, B)])[0]
            if vals == [7]:
                break
            hub.pump()
        out.append(vals)
    finally:
        m0.close(), m1.close()
    return out


@pytest.mark.parametrize("pkg", [_Jax, _Port], ids=["jax", "port"])
def test_interdc_from_clustered_dc(pkg):
    got = _interdc_script(pkg)
    assert got[:3] == [[3, ["cross"]], [9], ["cross", "lost"]]
    # every chain of DC0 routes to its modular owner, epoch 0
    assert got[3] == [(0, s, [s % 2, 0]) for s in range(4)]


def test_interdc_from_clustered_dc_matches_jax():
    assert _interdc_script(_Port) == _interdc_script(_Jax)


@pytest.mark.parametrize("pkg", [_Jax, _Port], ids=["jax", "port"])
def test_cluster_bcounter_transfer_from_clustered_dc(pkg):
    assert _transfer_script(pkg) == [[10], 1, [7], [7]]


# ---------------------------------------------------------------------------
# a port cluster and a JAX single-node DC over sockets
# ---------------------------------------------------------------------------
@pytest.fixture
def jax_pump(tmp_path):
    """The JAX package's native pump, its library built into this test's
    own directory."""
    from antidote_tpu.interdc import native_pump as jnp_

    mp = pytest.MonkeyPatch()
    mp.setattr(jnp_, "_SO", tmp_path / "_pump.so")
    mp.setattr(jnp_, "_lib", None)
    mp.setattr(jnp_, "_lib_tried", False)
    yield jnp_
    mp.undo()


def test_port_cluster_replicates_with_jax_dc_over_tcp(jax_pump):
    from antidote_tpu.interdc.tcp import TcpFabric as JaxFabric

    members = _Port.members()
    members[0].connect(1, *members[1].address)
    members[1].connect(0, *members[0].address)
    pfabs = [TcpFabric() for _ in members]
    reps = [attach_interdc(m, f) for m, f in zip(members, pfabs)]
    jfab = JaxFabric()
    jnode = _Jax.single(1)
    jrep = JaxReplica(jnode, jfab)
    jrep.route_query = jax_router({0: 2}, KW["n_shards"])
    stop = threading.Event()

    def pump_loop(f):
        while not stop.is_set():
            f.pump(timeout=0.02)

    loops = [threading.Thread(target=pump_loop, args=(f,), daemon=True)
             for f in pfabs]
    try:
        for f, r in zip(pfabs, reps):
            f.connect_remote(1, *jfab.address_of(1))
            jfab.connect_remote(r.fabric_id, *f.address_of(r.fabric_id))
        for f, r in zip(pfabs, reps):
            f.subscribe(r.fabric_id, 1, r._on_message)
            jfab.subscribe(1, r.fabric_id, jrep._on_message)
        for t in loops:
            t.start()
        coords = [ClusterNode(m) for m in members]
        want = {}
        vc = None
        for i in range(8):
            ups = [(i, C, B, ("increment", i + 1)),
                   (100 + i, S, B, ("add_all", [f"a{i}", f"b{i}"]))]
            vc = coords[i % 2].update_objects(ups, clock=vc)
            want[(i, C, B)] = i + 1
            want[(100 + i, S, B)] = [f"a{i}", f"b{i}"]
        vc = coords[1].update_objects([(100, S, B, ("remove", "a0"))],
                                      clock=vc)
        want[(100, S, B)] = ["b0"]
        objs = list(want)
        vals, _ = jnode.read_objects(objs, clock=vc)
        assert [sorted(v) if isinstance(v, list) else v
                for v in vals] == list(want.values())
        # and back: the JAX DC writes, the port cluster reads at its clock
        vc1 = jnode.update_objects([(7, C, B, ("increment", 50)),
                                    (105, S, B, ("add", "jax"))])
        # the JAX DC's idle shards' safe times (its pump is not looping)
        jrep.heartbeat()
        vals, _ = coords[0].read_objects([(7, C, B), (105, S, B)],
                                         clock=vc1)
        assert [vals[0], sorted(vals[1])] == [58, ["a5", "b5", "jax"]]
        vals, _ = coords[1].read_objects([(7, C, B)], clock=vc1)
        assert vals == [58]
    finally:
        stop.set()
        for t in loops:
            t.join(timeout=10)
        for f in pfabs:
            f.close()
        jfab.close()
        for m in members:
            m.close()
