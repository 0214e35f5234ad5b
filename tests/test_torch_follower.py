"""Follower read replicas of the port: image bootstrap, session-token
failover, divergence detection and repair.

The thirteen single-owner cases of ``tests/test_follower.py`` on port
nodes (``device="cpu"``).  Part A drives ``FollowerReplica`` over the
``LoopbackHub``: the bootstrap modes (image, tail, delta), the repair below
the compaction floor, divergence caught and healed, crash rejoin, a
bit-rotted newest image, the session gate's park and redirect.  Part B runs
the wire stack — owner and followers on ``TcpFabric``s with
``ProtocolServer``s — and holds the ``SessionClient``'s read-your-writes
across a follower kill and rejoin.  Part D holds the port against the JAX
package over ``TcpFabric``: a port follower of a JAX owner and a JAX
follower of a port owner bootstrap by image to equal values, ``ckpt_fetch``
chunks are byte-equal, ``install_image(shards=)`` gives equal rows; and no
published epoch claims a clock the follower has not applied.  Part E
follows a clustered owner: the port of
``test_clustered_owner_fleet_shadowing_and_live_shard_move`` on port
members, a port follower of a JAX clustered owner through a shard move
(equal values, clean digests), the descriptor refusals that stay, and a
joiner whose imports were sealed by delta links shipping an image that
covers them.  Every wait is a bounded deadline loop.  Tolerance: exact
values and bytes.
"""

import os
import threading
import time

import numpy as np
import pytest

from antidote_tpu_torch import faults
from antidote_tpu_torch.api import AntidoteNode
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.interdc import DCReplica, FollowerReplica, LoopbackHub
from antidote_tpu_torch.store.kv import shard_digest

@pytest.fixture
def cfg():
    # same shapes as the chaos/tcp suites: the XLA compile cache is warm
    return AntidoteConfig(
        n_shards=2, max_dcs=3, ops_per_key=8, snap_versions=2,
        set_slots=4, keys_per_table=16,
    )


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.uninstall()


def mk_owner(cfg, hub, tmp_path, name="owner"):
    node = AntidoteNode(cfg, dc_id=0, log_dir=str(tmp_path / name), device="cpu")
    rep = DCReplica(node, hub, "dc0")
    return node, rep


def mk_follower(cfg, hub, tmp_path, owner_rep, name="f1", fid=77,
                recover=False, **kw):
    node = AntidoteNode(cfg, dc_id=0, log_dir=str(tmp_path / name),
                        recover=recover, device="cpu")
    fol = FollowerReplica(node, hub, name,
                          owner_client_addr=("owner-host", 1234),
                          fabric_id=fid, **kw)
    mode = fol.attach(owner_rep.descriptor())
    return node, fol, mode


def converge(owner, owner_rep, hub, follower_node, objs, rounds=40):
    """Heartbeat + pump until the follower's stable snapshot covers the
    owner's max clock, then return both sides' values there."""
    for _ in range(rounds):
        owner_rep.heartbeat()
        hub.pump()
        target = owner.store.dc_max_vc()
        if (follower_node.store.stable_vc() >= target).all():
            break
    else:
        raise AssertionError(
            f"follower never converged: {follower_node.store.stable_vc()}"
            f" < {owner.store.dc_max_vc()}")
    target = owner.store.dc_max_vc()
    want, _ = owner.read_objects(objs, clock=target)
    got, _ = follower_node.read_objects(objs, clock=target)
    return want, got, target


# ---------------------------------------------------------------------------
# Part A — deterministic (LoopbackHub)
# ---------------------------------------------------------------------------
def test_image_bootstrap_then_tail_replication(cfg, tmp_path):
    hub = LoopbackHub()
    owner, orep = mk_owner(cfg, hub, tmp_path)
    for i in range(6):
        owner.update_objects([("k", "counter_pn", "b", ("increment", 1)),
                              ("s", "set_aw", "b", ("add", f"e{i}"))])
    owner.checkpoint_now()
    owner.update_objects([("k", "counter_pn", "b", ("increment", 10))])

    fnode, fol, mode = mk_follower(cfg, hub, tmp_path, orep)
    assert mode == "image"
    assert fol.state == "serving"
    assert fnode.metrics.follower_bootstrap.value(mode="image") == 1
    objs = [("k", "counter_pn", "b"), ("s", "set_aw", "b")]
    want, got, _ = converge(owner, orep, hub, fnode, objs)
    assert got == want and want[0] == 16
    # live tail keeps flowing through the ordinary chain machinery
    owner.update_objects([("k", "counter_pn", "b", ("increment", 1))])
    want, got, _ = converge(owner, orep, hub, fnode, objs)
    assert got == want and want[0] == 17
    # the image bootstrap sealed itself with a LOCAL checkpoint, so the
    # follower's own crash recovery is self-sufficient
    from antidote_tpu_torch.log import checkpoint as ckpt

    assert ckpt.list_checkpoints(
        ckpt.checkpoint_root(fnode.store.log.dir))
    # digests agree at equal clocks
    assert all(v == "ok" for v in fol.check_divergence().values())
    owner.store.log.close(), fnode.store.log.close()


def test_tail_bootstrap_without_owner_checkpoint(cfg, tmp_path):
    hub = LoopbackHub()
    owner, orep = mk_owner(cfg, hub, tmp_path)
    owner.update_objects([("k", "counter_pn", "b", ("increment", 5))])
    fnode, fol, mode = mk_follower(cfg, hub, tmp_path, orep)
    assert mode == "tail"  # no image published: whole-chain catch-up
    want, got, _ = converge(owner, orep, hub, fnode,
                            [("k", "counter_pn", "b")])
    assert got == want == [5]
    owner.store.log.close(), fnode.store.log.close()


def test_below_compaction_floor_repairs_via_image_delta(cfg, tmp_path,
                                                        monkeypatch):
    """A follower whose chain position fell
    below the owner's compaction floor converges via image shipping
    instead of a refused catch-up — byte-identical to the owner."""
    # a tiny egress window so the partition outlives the in-memory
    # catch-up fast path (in production that's SENT_WINDOW commits of
    # uptime, or any owner restart) and the WAL path's floor refusal is
    # what the follower actually meets
    monkeypatch.setattr(DCReplica, "SENT_WINDOW", 2)
    hub = LoopbackHub()
    owner, orep = mk_owner(cfg, hub, tmp_path)
    owner.update_objects([("k", "counter_pn", "b", ("increment", 1))])
    fnode, fol, mode = mk_follower(cfg, hub, tmp_path, orep)
    objs = [("k", "counter_pn", "b"), ("s", "set_aw", "b")]
    converge(owner, orep, hub, fnode, [objs[0]])
    pre_position = dict(fol.last_seen)
    # partition the stream (every published frame to the follower is
    # lost) while the owner commits past a NEW checkpoint floor
    hub.drop_next(0, fol.fabric_id, n=1_000_000)
    for i in range(5):
        owner.update_objects([("k", "counter_pn", "b", ("increment", 1)),
                              ("s", "set_aw", "b", ("add", f"x{i}"))])
    owner.checkpoint_now()
    owner.update_objects([("k", "counter_pn", "b", ("increment", 100))])
    assert owner.store.log.chain_floor.sum() > 0
    # the follower's position is now below the floor: a plain catch-up
    # is refused there (what the image repair answers)
    shard = owner.store.directory[("k", "b")][1]
    with pytest.raises(RuntimeError, match="compaction floor"):
        orep._serve_log_query(shard, 0,
                              pre_position.get((0, shard), 0))
    # heal the link: the next heartbeat reveals the gap, the refused
    # catch-up triggers the image-delta repair on the delivery path
    hub.drop[(0, fol.fabric_id)] = 0
    want, got, _ = converge(owner, orep, hub, fnode, objs)
    assert got == want and want[0] == 106
    assert fol.last_bootstrap_mode == "delta"
    assert fnode.metrics.follower_bootstrap.value(mode="delta") == 1
    assert all(v == "ok" for v in fol.check_divergence().values())
    owner.store.log.close(), fnode.store.log.close()


def test_divergence_detected_and_self_healed(cfg, tmp_path):
    """A deliberately corrupted follower row is caught by the digest
    comparison; the follower quarantines (session reads redirect) and
    re-bootstraps from the image — it never serves the corrupt value to
    a session-token read."""
    from antidote_tpu_torch.overload import ReplicaLagging

    hub = LoopbackHub()
    owner, orep = mk_owner(cfg, hub, tmp_path)
    for i in range(4):
        owner.update_objects([("k", "counter_pn", "b", ("increment", 1)),
                              ("r", "register_lww", "b",
                               ("assign", f"v{i}"))])
    owner.checkpoint_now()
    fnode, fol, _mode = mk_follower(cfg, hub, tmp_path, orep)
    objs = [("k", "counter_pn", "b"), ("r", "register_lww", "b")]
    converge(owner, orep, hub, fnode, objs)
    assert all(v == "ok" for v in fol.check_divergence().values())
    # corrupt the follower's device row for "k" (silent bit damage)
    tname, shard, row = fnode.store.directory[("k", "b")]
    t = fnode.store.tables[tname]
    field = next(iter(t.head))
    t.head[field][shard, row] = 999
    token = [int(x) for x in owner.store.dc_max_vc()]
    res = fol.check_divergence()
    assert res.get(shard) == "mismatch", res
    assert fnode.metrics.divergence_checks.value(result="mismatch") == 1
    assert fol.last_bootstrap_mode == "image"
    # healed: the session-token read serves the TRUE value
    got, _ = fnode.read_objects(objs, clock=token)
    want, _ = owner.read_objects(objs, clock=token)
    assert got == want and want[0] == 4
    assert all(v == "ok" for v in fol.check_divergence().values())
    # while quarantined, the gate redirects instead of serving
    fol.state = "healing"
    with pytest.raises(ReplicaLagging):
        fol.gate_read(objs, np.asarray(token))
    fol.state = "serving"
    owner.store.log.close(), fnode.store.log.close()


def test_follower_crash_rejoins_from_local_state(cfg, tmp_path):
    """A killed follower rejoins fast from its OWN WAL + local
    checkpoint (mode tail) and converges byte-identical."""
    hub = LoopbackHub()
    owner, orep = mk_owner(cfg, hub, tmp_path)
    for i in range(5):
        owner.update_objects([("k", "counter_pn", "b", ("increment", 1))])
    owner.checkpoint_now()
    fnode, fol, mode = mk_follower(cfg, hub, tmp_path, orep)
    assert mode == "image"
    converge(owner, orep, hub, fnode, [("k", "counter_pn", "b")])
    # SIGKILL-equivalent: drop the live objects, keep only the disk
    hub.unregister(fol.fabric_id)
    fnode.store.log.close()
    del fnode, fol
    # the owner moves on meanwhile
    owner.update_objects([("k", "counter_pn", "b", ("increment", 10))])
    f2, fol2, mode2 = mk_follower(cfg, hub, tmp_path, orep, name="f1",
                                  fid=78, recover=True)
    assert mode2 == "tail"  # local image + WAL carried it to the floor
    want, got, clock = converge(owner, orep, hub, f2,
                                [("k", "counter_pn", "b")])
    assert got == want == [15]
    with owner.txm.commit_lock:
        own_digest = shard_digest(owner.store,
                                  owner.store.directory[("k", "b")][1])
    with f2.txm.commit_lock:
        fol_digest = shard_digest(f2.store,
                                  f2.store.directory[("k", "b")][1])
    assert own_digest == fol_digest
    owner.store.log.close(), f2.store.log.close()


def test_corrupt_newest_owner_image_falls_back_older(cfg, tmp_path):
    """Image shipping survives a bit-rotted newest image on the owner:
    the follower's fetch fails CRC verification and falls back to the
    next OLDER retained image (the owner's own recovery discipline),
    then replays the longer tail to the same state."""
    hub = LoopbackHub()
    owner, orep = mk_owner(cfg, hub, tmp_path)
    owner.update_objects([("k", "counter_pn", "b", ("increment", 3))])
    owner.checkpoint_now()
    owner.update_objects([("k", "counter_pn", "b", ("increment", 4))])
    owner.checkpoint_now()
    # bit-rot the newest image (id 2) on the owner's disk
    import os

    from antidote_tpu_torch.log import checkpoint as ckpt

    newest = ckpt.image_path(owner.store.log.dir, 2)
    with open(newest, "r+b") as f:
        f.seek(16)
        f.write(b"\xff\xff\xff\xff")
    assert os.path.exists(ckpt.image_path(owner.store.log.dir, 1))
    fnode, fol, mode = mk_follower(cfg, hub, tmp_path, orep)
    assert mode == "image"
    want, got, _ = converge(owner, orep, hub, fnode,
                            [("k", "counter_pn", "b")])
    assert got == want == [7]
    assert all(v == "ok" for v in fol.check_divergence().values())
    owner.store.log.close(), fnode.store.log.close()


def test_apb_dialect_refused_on_follower(cfg, tmp_path):
    """The follower's apb edge stays safe without a proxy plane: with
    ``--no-server-proxy`` every apb write/txn request answers the
    typed not_owner redirect (never an acked-then-discarded write).
    With the plane attached but the owner UNREACHABLE, forwarding
    exhausts its send-phase dial budget and degrades to the SAME typed
    redirect — the fabric never invents a third failure mode."""
    import socket
    import struct

    from antidote_tpu_torch.proto import apb as apb_mod
    from antidote_tpu_torch.proto.client import ApbClient, RemoteNotOwner
    from antidote_tpu_torch.proto.server import ProtocolServer

    hub = LoopbackHub()
    owner, orep = mk_owner(cfg, hub, tmp_path)
    owner.update_objects([("k", "counter_pn", "b", ("increment", 1))])
    fnode, fol, _ = mk_follower(cfg, hub, tmp_path, orep)
    srv = ProtocolServer(fnode, port=0, follower=fol,
                         server_proxy=False)
    try:
        code = sorted(apb_mod.APB_REQUEST_CODES)[0]
        sock = socket.create_connection((srv.host, srv.port), timeout=10)
        body = bytes([code])
        sock.sendall(struct.pack(">I", len(body)) + body)
        hdr = sock.recv(4)
        (n,) = struct.unpack(">I", hdr)
        reply = b""
        while len(reply) < n:
            reply += sock.recv(n - len(reply))
        assert b"not_owner" in reply, reply
        sock.close()
        # plane attached, owner unreachable (the fake bootstrap addr):
        # a well-formed apb write exhausts the dial budget and surfaces
        # the typed redirect carrying the owner endpoint
        srv2 = ProtocolServer(fnode, port=0, follower=fol)
        try:
            fc = ApbClient(srv2.host, srv2.port)
            with pytest.raises(RemoteNotOwner) as ei:
                fc.update_objects([(b"k", "counter_pn", b"b",
                                    ("increment", 1))])
            assert ei.value.redirect == ["owner-host", 1234]
            fc.close()
        finally:
            srv2.close()
        # a follower server also refuses the unsafe inline-read mode
        with pytest.raises(ValueError, match="batch_static"):
            ProtocolServer(fnode, port=0, follower=fol,
                           batch_static=False)
    finally:
        srv.close()
        owner.store.log.close(), fnode.store.log.close()


def test_gate_read_parks_then_redirects(cfg, tmp_path):
    from antidote_tpu_torch.overload import ReplicaLagging

    hub = LoopbackHub()
    owner, orep = mk_owner(cfg, hub, tmp_path)
    owner.update_objects([("k", "counter_pn", "b", ("increment", 1))])
    fnode, fol, _ = mk_follower(cfg, hub, tmp_path, orep,
                                park_s=0.05)
    converge(owner, orep, hub, fnode, [("k", "counter_pn", "b")])
    # a token the follower covers: gate passes without parking
    fol.gate_read([("k", "counter_pn", "b")],
                  np.asarray(fnode.store.dc_max_vc()))
    # a token ahead of everything the follower applied: parks ~park_s,
    # then the typed redirect carries the owner endpoint + retry hint
    ahead = owner.store.dc_max_vc().astype(np.int64) + 50
    t0 = time.monotonic()
    with pytest.raises(ReplicaLagging) as ei:
        fol.gate_read([("k", "counter_pn", "b")], ahead)
    assert time.monotonic() - t0 >= 0.04
    assert ei.value.redirect == ["owner-host", 1234]
    assert ei.value.retry_after_ms > 0
    assert fnode.metrics.session_redirects.value(
        kind="lagging", dialect="native") >= 1
    owner.store.log.close(), fnode.store.log.close()


def test_owner_replica_registry_and_liveness(cfg, tmp_path):
    hub = LoopbackHub()
    owner, orep = mk_owner(cfg, hub, tmp_path)
    owner.update_objects([("k", "counter_pn", "b", ("increment", 1))])
    fnode, fol, _ = mk_follower(cfg, hub, tmp_path, orep)
    st = orep.replica_status()
    assert st["role"] == "owner" and st["followers"]["f1"]["state"] == "ok"
    assert st["followers"]["f1"]["lag"] == 0
    # reports age out into the typed DOWN state
    orep.REPLICA_DOWN_S = 0.0
    time.sleep(0.01)
    assert orep.replica_status()["followers"]["f1"]["state"] == "down"
    orep.REPLICA_DOWN_S = DCReplica.REPLICA_DOWN_S
    fol._send_report()
    assert orep.replica_status()["followers"]["f1"]["state"] == "ok"
    # decommission: the registry forgets it and refuses its reports
    out = orep.replica_admin({"op": "remove", "name": "f1"})
    assert "f1" not in out["followers"]
    fol._send_report()
    assert "f1" not in orep.replica_status()["followers"]
    # re-add clears the tombstone (shows down until it reports again)
    out = orep.replica_admin({"op": "add", "name": "f1",
                              "addr": ["h", 9]})
    assert out["followers"]["f1"]["state"] == "down"
    fol._send_report()
    assert orep.replica_status()["followers"]["f1"]["state"] == "ok"
    owner.store.log.close(), fnode.store.log.close()


# ---------------------------------------------------------------------------
# Part C — geo owners, the apb session tier, streak-scaled gate hints
# ---------------------------------------------------------------------------
def test_geo_owner_shadowing_peer_chains(cfg, tmp_path):
    """A follower of a GEO-REPLICATED owner subscribes to the peer DC's
    stream too (its descriptor is part of the fleet), applies the peer's
    origin chain through the same causal gate the owner does, and
    converges byte-identical — divergence digests clean across every
    lane at equal applied clocks."""
    hub = LoopbackHub()
    owner, orep = mk_owner(cfg, hub, tmp_path)
    peer = AntidoteNode(cfg, dc_id=1, log_dir=str(tmp_path / "peer"), device="cpu")
    prep = DCReplica(peer, hub, "dc1")
    orep.observe_dc(prep)
    prep.observe_dc(orep)
    for i in range(3):
        owner.update_objects([("k", "counter_pn", "b", ("increment", 1))])
        peer.update_objects([("k", "counter_pn", "b", ("increment", 10))])
    owner.checkpoint_now()
    fnode = AntidoteNode(cfg, dc_id=0, log_dir=str(tmp_path / "gf"), device="cpu")
    fol = FollowerReplica(fnode, hub, "gf1",
                          owner_client_addr=("owner-host", 1234),
                          fabric_id=99)
    mode = fol.attach([orep.descriptor(), prep.descriptor()])
    assert mode == "image"
    assert sorted(fol.fleet_by_dc) == [0, 1]
    objs = [("k", "counter_pn", "b")]
    # the live tail: both origins' later commits reach the follower over
    # its OWN subscriptions (the owner never re-publishes peer effects)
    owner.update_objects([("k", "counter_pn", "b", ("increment", 1))])
    peer.update_objects([("k", "counter_pn", "b", ("increment", 10))])
    deadline = time.monotonic() + 30
    while True:
        orep.heartbeat()
        prep.heartbeat()
        hub.pump()
        target = np.maximum(owner.store.dc_max_vc(),
                            peer.store.dc_max_vc())
        if (fnode.store.stable_vc() >= target).all():
            break
        assert time.monotonic() < deadline
    want, _ = owner.read_objects(objs, clock=target)
    got, _ = fnode.read_objects(objs, clock=target)
    assert got == want == [44]
    res = fol.check_divergence()
    assert all(v == "ok" for v in res.values()), res
    assert fol.replica_status()["fleet"]["peer_dcs"] == [1]
    owner.store.log.close()
    peer.store.log.close()
    fnode.store.log.close()


def test_apb_session_tier_on_follower(cfg, tmp_path):
    """The apb protobuf dialect gets the SAME session discipline the
    msgpack dialect has on a follower — and with the
    proxy plane the follower is a safe apb
    entrypoint: writes FORWARD to the owner write plane instead of
    bouncing on a typed not_owner, a token-ahead read fails over
    server-side to the owner instead of surfacing typed lagging, and
    the session tier keeps read-your-writes either way."""
    from antidote_tpu_torch.proto.client import ApbClient, SessionClient
    from antidote_tpu_torch.proto.server import ProtocolServer

    hub = LoopbackHub()
    owner, orep = mk_owner(cfg, hub, tmp_path)
    owner.update_objects([("k", "counter_pn", "b", ("increment", 1))])
    owner.checkpoint_now()
    fnode, fol, _ = mk_follower(cfg, hub, tmp_path, orep, park_s=0.05)
    osrv = ProtocolServer(owner, port=0, interdc=orep)
    fsrv = ProtocolServer(fnode, port=0, follower=fol)
    fol.owner_client_addr = (osrv.host, osrv.port)
    try:
        # apb write at the follower: forwarded to the owner write plane
        # with RYW at the returned commit clock (the apb keyspace is
        # bytes — distinct from the native str "k" above)
        fc = ApbClient(fsrv.host, fsrv.port)
        vc = fc.update_objects([(b"k", "counter_pn", b"b",
                                 ("increment", 1))])
        vals, _ = fc.read_objects([(b"k", "counter_pn", b"b")],
                                  clock=vc)
        assert vals == [1]
        assert fnode.metrics.session_redirects.value(
            kind="not_owner", dialect="apb") == 0
        assert fsrv.proxy.counts["write"] >= 1
        # apb session over the fleet: write owner, read follower, RYW
        sc = SessionClient((osrv.host, osrv.port),
                           [(fsrv.host, fsrv.port)], dialect="apb")
        total = 0
        for i in range(4):
            sc.update_objects([(b"ak", "counter_pn", b"b",
                                ("increment", 1))])
            total += 1
            # converge the follower so the gate admits promptly
            for _ in range(40):
                orep.heartbeat()
                hub.pump()
                if (fnode.store.dc_max_vc()
                        >= owner.store.dc_max_vc()).all():
                    break
            vals, _ = sc.read_objects([(b"ak", "counter_pn", b"b")])
            assert vals == [total], (i, vals, total)
        assert sc.served_by.get((fsrv.host, fsrv.port), 0) >= 1
        # a token ahead of the replica (in the owner's own lane): the
        # gate refuses locally but the fabric fails over SERVER-SIDE to
        # the owner — the bare apb client gets the value, not typed
        # lagging, and the proxied reply teaches it the ring
        ahead = [int(x) for x in owner.store.dc_max_vc()]
        ahead[0] += 50
        fc2 = ApbClient(fsrv.host, fsrv.port)
        vals, _ = fc2.read_objects([(b"ak", "counter_pn", b"b")],
                                   clock=ahead)
        assert vals == [total]
        assert fsrv.proxy.counts["read"] >= 1
        assert fc2.ring_hint is not None
        assert fc2.ring_hint["owner"] == [osrv.host, osrv.port]
        fc.close(), fc2.close(), sc.close()
    finally:
        fsrv.close()
        osrv.close()
        owner.store.log.close(), fnode.store.log.close()


def test_gate_retry_hint_scales_with_refusal_streak(cfg, tmp_path):
    """The follower gate's retry hint scales with the
    refusal streak since the last admitted read (25..500 ms, the
    AdmissionGate discipline) — a parked fleet backs off instead of
    hammering a lagging follower on a fixed hint."""
    from antidote_tpu_torch.overload import ReplicaLagging

    hub = LoopbackHub()
    owner, orep = mk_owner(cfg, hub, tmp_path)
    owner.update_objects([("k", "counter_pn", "b", ("increment", 1))])
    fnode, fol, _ = mk_follower(cfg, hub, tmp_path, orep, park_s=0.0)
    converge(owner, orep, hub, fnode, [("k", "counter_pn", "b")])
    ahead = owner.store.dc_max_vc().astype(np.int64) + 50
    hints = []
    for _ in range(40):
        with pytest.raises(ReplicaLagging) as ei:
            fol.gate_read([("k", "counter_pn", "b")], ahead)
        hints.append(ei.value.retry_after_ms)
    assert hints[0] == 25
    assert hints[-1] > hints[0]
    assert max(hints) <= 500
    # an admitted read resets the streak — hints start over
    fol.gate_read([("k", "counter_pn", "b")],
                  np.asarray(fnode.store.dc_max_vc()))
    with pytest.raises(ReplicaLagging) as ei:
        fol.gate_read([("k", "counter_pn", "b")], ahead)
    assert ei.value.retry_after_ms == 25
    owner.store.log.close(), fnode.store.log.close()


# ---------------------------------------------------------------------------
# Part B — the wire stack (TCP fabrics + ProtocolServers + SessionClient)
# ---------------------------------------------------------------------------
class _Pump:
    def __init__(self, *fabrics):
        self.stop = threading.Event()
        self.threads = [
            threading.Thread(target=self._loop, args=(f,), daemon=True)
            for f in fabrics
        ]
        for t in self.threads:
            t.start()

    def _loop(self, fabric):
        while not self.stop.is_set():
            try:
                fabric.pump(timeout=0.05)
            except OSError:
                time.sleep(0.02)

    def close(self):
        self.stop.set()
        for t in self.threads:
            t.join(timeout=10)


def _wire_follower(cfg, tmp_path, owner_srv, name, fid, recover=False,
                   park_s=0.3):
    from antidote_tpu_torch.interdc.tcp import TcpFabric
    from antidote_tpu_torch.proto.client import AntidoteClient
    from antidote_tpu_torch.proto.server import ProtocolServer

    fabric = TcpFabric(backoff_base=0.05, backoff_max=0.5)
    node = AntidoteNode(cfg, dc_id=0, log_dir=str(tmp_path / name),
                        recover=recover, device="cpu")
    fol = FollowerReplica(node, fabric, name,
                          owner_client_addr=(owner_srv.host,
                                             owner_srv.port),
                          fabric_id=fid, park_s=park_s)
    srv = ProtocolServer(node, port=0, follower=fol)
    fol.client_addr = (srv.host, srv.port)
    c = AntidoteClient(owner_srv.host, owner_srv.port)
    desc = c.get_connection_descriptor()
    c.close()
    mode = fol.attach(desc)
    return {"node": node, "fol": fol, "srv": srv, "fabric": fabric,
            "mode": mode}


def test_wire_session_survives_follower_kill_and_rejoin(cfg, tmp_path):
    """The main flow end-to-end on real sockets: write on the
    owner, read own writes via followers with a session token, SIGKILL
    one follower mid-session (client fails over with read-your-writes
    held), rejoin it from its image, converge byte-identical."""
    from antidote_tpu_torch.interdc.tcp import TcpFabric
    from antidote_tpu_torch.proto.client import AntidoteClient, SessionClient
    from antidote_tpu_torch.proto.server import ProtocolServer

    ofab = TcpFabric(backoff_base=0.05, backoff_max=0.5)
    owner = AntidoteNode(cfg, dc_id=0, log_dir=str(tmp_path / "owner"), device="cpu")
    orep = DCReplica(owner, ofab, "dc0")
    osrv = ProtocolServer(owner, port=0, interdc=orep)
    pump = _Pump(ofab)
    f1 = f2 = None
    try:
        oc = AntidoteClient(osrv.host, osrv.port)
        for i in range(4):
            oc.update_objects([("k", "counter_pn", "b", ("increment", 1))])
        oc.checkpoint_now()
        f1 = _wire_follower(cfg, tmp_path, osrv, "wf1", 101)
        f2 = _wire_follower(cfg, tmp_path, osrv, "wf2", 102)
        assert f1["mode"] == "image" and f2["mode"] == "image"
        pump2 = _Pump(f1["fabric"], f2["fabric"])
        try:
            # a write sent AT a follower FORWARDS to the owner write
            # plane: the ring-oblivious client gets a commit
            # clock and read-your-writes, not a typed redirect
            fc = AntidoteClient(f1["srv"].host, f1["srv"].port)
            vc = fc.update_objects([("k", "counter_pn", "b",
                                     ("increment", 1))])
            vals, _ = fc.read_objects([("k", "counter_pn", "b")],
                                      clock=vc)
            assert vals == [5]
            fc.close()
            sc = SessionClient(
                (osrv.host, osrv.port),
                [(f1["srv"].host, f1["srv"].port),
                 (f2["srv"].host, f2["srv"].port)],
            )
            # session loop: every read (served by a follower) must see
            # the session's own writes
            total = 5
            for i in range(6):
                sc.update_objects([("k", "counter_pn", "b",
                                    ("increment", 1))])
                total += 1
                vals, _ = sc.read_objects([("k", "counter_pn", "b")])
                assert vals == [total], (i, vals, total)
            assert sc.failovers == 0
            # kill follower 1 mid-session: its replication stops (fabric
            # closed) and its server winds down — the session keeps
            # holding read-your-writes by redirecting/failing over (f2,
            # then owner).  A real SIGKILL (a dead-socket failover) is
            # a process-level chaos run's job.
            f1["srv"].close()
            f1["fabric"].close()
            f1["node"].store.log.close()
            f1_addr = (f1["srv"].host, f1["srv"].port)
            served_dead_before = sc.served_by.get(f1_addr, 0)
            re_before, fo_before = sc.redirects, sc.failovers
            for i in range(4):
                sc.update_objects([("k", "counter_pn", "b",
                                    ("increment", 1))])
                total += 1
                vals, _ = sc.read_objects([("k", "counter_pn", "b")])
                assert vals == [total], (i, vals, total)
            # ring semantics under the proxy plane:
            # after the wind-down the follower either drops off (dead
            # socket / one last typed redirect — the client fails over
            # and its served_by counter stops moving) or its
            # still-draining server keeps the session alive by
            # RESCUING gate refusals through the proxy plane — its
            # applied clock is frozen (fabric closed), so any read it
            # still answered MUST have crossed the proxy to the owner.
            # Which branch runs depends on whether the fleet reports
            # had distributed before the kill; both hold RYW.
            served_delta = (sc.served_by.get(f1_addr, 0)
                            - served_dead_before)
            if served_delta:
                assert f1["srv"].proxy is not None
                assert (f1["srv"].proxy.counts["read"]
                        >= served_delta)
            elif sc.ring.preferred("k", "b") == f1_addr:
                assert (sc.redirects - re_before
                        + sc.failovers - fo_before) >= 1
            # rejoin follower 1 from its local image + the owner's tail
            f1b = _wire_follower(cfg, tmp_path, osrv, "wf1", 103,
                                 recover=True)
            pump3 = _Pump(f1b["fabric"])
            try:
                assert f1b["mode"] in ("tail", "delta", "image")
                token = [int(x) for x in oc.node_status()["stable_vc"]]
                sc2 = SessionClient((osrv.host, osrv.port),
                                    [(f1b["srv"].host, f1b["srv"].port)])
                sc2.observe(token)
                deadline = time.monotonic() + 30
                while True:
                    vals, _ = sc2.read_objects([("k", "counter_pn", "b")])
                    if sc2.redirects == 0 and sc2.failovers == 0:
                        break  # served by the rejoined follower itself
                    sc2.redirects = sc2.failovers = 0
                    assert time.monotonic() < deadline
                    time.sleep(0.1)
                assert vals == [total]
                # byte-identical: digests agree on every shard
                deadline = time.monotonic() + 30
                while True:
                    res = f1b["fol"].check_divergence()
                    assert "mismatch" not in res.values(), res
                    if all(v == "ok" for v in res.values()):
                        break
                    assert time.monotonic() < deadline
                    time.sleep(0.1)
                # owner-side registry sees both live followers
                st = oc.replica_admin("status")
                assert st["followers"]["wf1"]["state"] == "ok"
                assert st["followers"]["wf2"]["state"] == "ok"
                sc2.close()
            finally:
                pump3.close()
                f1b["srv"].close()
                f1b["fabric"].close()
                f1b["node"].store.log.close()
            sc.close()
        finally:
            pump2.close()
            f2["srv"].close()
            f2["fabric"].close()
            f2["node"].store.log.close()
        oc.close()
    finally:
        pump.close()
        osrv.close()
        ofab.close()
        owner.store.log.close()


# ---------------------------------------------------------------------------
# Part D — across the packages, and the epoch guard
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


def _jcfg():
    from antidote_tpu.config import AntidoteConfig as JConfig

    return JConfig(n_shards=2, max_dcs=3, ops_per_key=8, snap_versions=2,
                   set_slots=4, keys_per_table=16, batch_buckets=(8,))


def _seeded_writes(node, seed, n, start=0):
    """``n`` seeded transactions of counters, sets and multi-value
    registers (no wall-clock types: the two packages' owners differ)."""
    rng = np.random.default_rng(seed)
    for i in range(start, start + n):
        k = int(rng.integers(12))
        node.update_objects([
            (f"c{k}", "counter_pn", "b",
             ("increment", int(rng.integers(-5, 9)))),
            (f"s{k % 5}", "set_aw", "b",
             ("add" if rng.random() < 0.8 else "remove",
              int(rng.integers(6)))),
            (f"m{k % 3}", "register_mv", "b", ("assign", f"v{i}")),
        ])


_OBJS = ([(f"c{k}", "counter_pn", "b") for k in range(12)]
         + [(f"s{k}", "set_aw", "b") for k in range(5)]
         + [(f"m{k}", "register_mv", "b") for k in range(3)])


def _norm_vals(vals):
    return [sorted(v, key=repr) if isinstance(v, list) else v
            for v in vals]


def _follow(owner, ping, fnode, fabric, timeout=60.0):
    """Heartbeat the owner and pump the follower's fabric until the
    follower's stable snapshot covers the owner's clock (bounded)."""
    deadline = time.monotonic() + timeout
    while True:
        ping()
        fabric.pump(timeout=0.05)
        target = np.asarray(owner.store.dc_max_vc())
        if (fnode.store.stable_vc() >= target).all():
            return [int(x) for x in target]
        assert time.monotonic() < deadline, (
            f"follower never converged: {fnode.store.stable_vc()} < "
            f"{target}")


def test_port_follower_of_a_jax_owner_bootstraps_by_image(cfg, tmp_path,
                                                          jax_pump):
    from antidote_tpu.api import AntidoteNode as JNode
    from antidote_tpu.interdc import DCReplica as JReplica
    from antidote_tpu.interdc.tcp import TcpFabric as JFabric
    from antidote_tpu_torch.interdc.tcp import TcpFabric

    jfab, pfab = JFabric(), TcpFabric()
    owner = JNode(_jcfg(), dc_id=0, log_dir=str(tmp_path / "jowner"))
    orep = JReplica(owner, jfab, "dc0")
    try:
        _seeded_writes(owner, 31, 20)
        owner.checkpoint_now()
        _seeded_writes(owner, 32, 6, start=20)
        fnode = AntidoteNode(cfg, dc_id=0, log_dir=str(tmp_path / "pf"),
                             device="cpu")
        fol = FollowerReplica(fnode, pfab, "pf", fabric_id=201,
                              owner_client_addr=("owner-host", 1))
        mode = fol.attach(orep.descriptor().to_wire())
        assert mode == "image" and fol.state == "serving"
        clock = _follow(owner, orep.heartbeat, fnode, pfab)
        want, _ = owner.read_objects(_OBJS, clock=clock)
        got, _ = fnode.read_objects(_OBJS, clock=clock)
        assert _norm_vals(got) == _norm_vals(want)
        # the Merkle roots the port computes equal the JAX owner's
        assert set(fol.check_divergence().values()) == {"ok"}
        assert "pf" in orep.replica_status()["followers"]
        fnode.store.log.close()
    finally:
        pfab.close()
        jfab.close()
        owner.store.log.close()


def test_jax_follower_of_a_port_owner_bootstraps_by_image(cfg, tmp_path,
                                                          jax_pump):
    from antidote_tpu.api import AntidoteNode as JNode
    from antidote_tpu.interdc import FollowerReplica as JFollower
    from antidote_tpu.interdc.tcp import TcpFabric as JFabric
    from antidote_tpu_torch.interdc.tcp import TcpFabric

    pfab, jfab = TcpFabric(), JFabric()
    owner = AntidoteNode(cfg, dc_id=0, log_dir=str(tmp_path / "powner"),
                         device="cpu")
    orep = DCReplica(owner, pfab, "dc0")
    try:
        _seeded_writes(owner, 41, 20)
        owner.checkpoint_now()
        _seeded_writes(owner, 42, 6, start=20)
        fnode = JNode(_jcfg(), dc_id=0, log_dir=str(tmp_path / "jf"))
        fol = JFollower(fnode, jfab, "jf", fabric_id=202,
                        owner_client_addr=("owner-host", 1))
        mode = fol.attach(orep.descriptor().to_wire())
        assert mode == "image" and fol.state == "serving"
        clock = _follow(owner, orep.heartbeat, fnode, jfab)
        want, _ = owner.read_objects(_OBJS, clock=clock)
        got, _ = fnode.read_objects(_OBJS, clock=clock)
        assert _norm_vals(got) == _norm_vals(want)
        # the JAX follower's Merkle roots equal the port owner's
        assert set(fol.check_divergence().values()) == {"ok"}
        assert orep.replica_status()["followers"]["jf"]["state"] == "ok"
        fnode.store.log.close()
    finally:
        jfab.close()
        pfab.close()
        owner.store.log.close()


def test_ckpt_fetch_chunks_are_byte_equal_across_packages(tmp_path):
    """The port's ``ckpt_meta``/``ckpt_fetch`` and the JAX package's,
    served over one published directory with a cold sidecar: equal
    metadata, and byte-equal chunks at every offset and chunk size (the
    shipped bytes are the file's)."""
    from types import SimpleNamespace

    from antidote_tpu.interdc.replica import DCReplica as JReplica
    from antidote_tpu_torch.log import checkpoint as ckpt

    ccfg = AntidoteConfig(n_shards=2, max_dcs=3, ops_per_key=8,
                          snap_versions=2, set_slots=4, keys_per_table=64)
    d = str(tmp_path / "o")
    node = AntidoteNode(ccfg, dc_id=0, log_dir=d, resident_rows=8,
                        device="cpu")
    for i in range(40):
        node.update_objects([(f"k{i}", "counter_pn", "b",
                              ("increment", i))])
    node.checkpoint_now()
    assert node.store.cold.evict_now(max_rows=20) > 0
    node.checkpoint_now(full=True)
    rep = DCReplica(node, LoopbackHub(), "dc0")
    fake = SimpleNamespace(node=SimpleNamespace(store=node.store),
                           shards=rep.shards,
                           CKPT_SHIP_CHUNK=DCReplica.CKPT_SHIP_CHUNK)
    meta = rep._serve_ckpt_meta({})
    assert meta == JReplica._serve_ckpt_meta(fake, {})
    assert meta["cold_keys"] > 0 and meta["cold_bytes"] > 0
    older = rep._serve_ckpt_meta({"before_id": meta["id"]})
    assert older == JReplica._serve_ckpt_meta(
        fake, {"before_id": meta["id"]})
    for file, size in (("image", meta["image_bytes"]),
                       ("cold", meta["cold_bytes"])):
        path = (ckpt.image_path(d, meta["id"]) if file == "image"
                else ckpt.cold_path(d, meta["id"]))
        with open(path, "rb") as f:
            whole = f.read()
        assert len(whole) == size
        for n in (1, 777, 4096, size):
            off, got = 0, b""
            while True:
                req = {"id": meta["id"], "off": off, "n": n, "file": file}
                mine = rep._serve_ckpt_fetch(req)
                assert mine == JReplica._serve_ckpt_fetch(fake, req)
                got += mine["data"]
                off += len(mine["data"])
                if mine["eof"]:
                    break
            assert got == whole, (file, n)
    rep.hub.unregister(rep.fabric_id)
    node.close()


def test_install_image_restricted_to_shards_equals_the_jax_install(
        tmp_path):
    """One image installed per shard set — the composition a follower's
    bootstrap uses — into a fresh port store and a fresh JAX store: equal
    rows, directory, clocks and floors, and the composition equals the
    whole-store install."""
    from antidote_tpu.log import LogManager as JLog
    from antidote_tpu.log.checkpoint import install_image as jinstall
    from antidote_tpu.store.kv import KVStore as JStore
    from antidote_tpu.txn.manager import TransactionManager as JTxm
    from antidote_tpu_torch.log import LogManager
    from antidote_tpu_torch.log import checkpoint as ckpt
    from antidote_tpu_torch.store.kv import KVStore
    from antidote_tpu_torch.txn.manager import TransactionManager

    ccfg = AntidoteConfig(n_shards=4, max_dcs=3, ops_per_key=8,
                          snap_versions=2, set_slots=4, keys_per_table=16)
    jcfg = _jcfg().__class__(n_shards=4, max_dcs=3, ops_per_key=8,
                             snap_versions=2, set_slots=4,
                             keys_per_table=16, batch_buckets=(8,))
    src = AntidoteNode(ccfg, dc_id=0, log_dir=str(tmp_path / "src"),
                       device="cpu")
    _seeded_writes(src, 51, 30)
    src.checkpoint_now()
    image = ckpt.load_latest(str(tmp_path / "src"))[0]
    src.close()

    def port_store(name, parts):
        st = KVStore(ccfg, device="cpu",
                     log=LogManager(ccfg, str(tmp_path / name)))
        txm = TransactionManager(st, my_dc=0)
        for shards in parts:
            ckpt.install_image(st, txm, image, shards=shards)
        return st

    def jax_store(name, parts):
        st = JStore(jcfg, log=JLog(jcfg, str(tmp_path / name)))
        txm = JTxm(st, my_dc=0)
        for shards in parts:
            jinstall(st, txm, image, shards=shards)
        return st

    parts = [[0, 2], [1], [3]]
    mine, theirs = port_store("p", parts), jax_store("j", parts)
    whole = port_store("w", [None])
    for other in (theirs, whole):
        assert dict(mine.directory) == dict(other.directory)
        assert np.array_equal(mine.applied_vc, np.asarray(other.applied_vc))
        assert np.array_equal(mine.log.floor_seqs, other.log.floor_seqs)
        assert np.array_equal(mine.log.chain_floor, other.log.chain_floor)
        for tname, t in mine.tables.items():
            o = other.tables[tname]
            assert np.array_equal(t.used_rows, o.used_rows), tname
            for dk, (tn, s, r) in mine.directory.items():
                if tn != tname:
                    continue
                for f, x in t.head.items():
                    assert np.array_equal(x[s, r].numpy(),
                                          np.asarray(o.head[f][s, r])), dk
                assert np.array_equal(t.head_vc[s, r].numpy(),
                                      np.asarray(o.head_vc[s, r])), dk
    for st in (mine, theirs, whole):
        st.log.close()


def _assert_epoch_within_applied(store):
    """The serving epoch claims no lane past the applied cut it captured,
    and that cut is no later than what the store has applied."""
    ep = store.serving_epoch
    cut = np.asarray(ep.applied)
    assert (np.asarray(ep.vc) <= cut.max(axis=0)).all(), (ep.vc, cut)
    assert (cut <= store.applied_vc).all(), (cut, store.applied_vc)


def test_no_epoch_claims_a_clock_the_follower_has_not_applied(cfg,
                                                              tmp_path):
    """Every epoch a follower publishes — the drain's, the gate's and the
    server ticker's — is stamped at most the applied clock, even with the
    commit counter pushed past it; and its per-shard cut is the applied
    one."""
    from antidote_tpu_torch.proto.server import ProtocolServer

    hub = LoopbackHub()
    owner, orep = mk_owner(cfg, hub, tmp_path)
    owner.update_objects([("k", "counter_pn", "b", ("increment", 1))])
    owner.checkpoint_now()
    fnode, fol, _ = mk_follower(cfg, hub, tmp_path, orep)
    srv = ProtocolServer(fnode, port=0, follower=fol, epoch_tick_ms=5)
    try:
        for i in range(4):
            owner.update_objects([("k", "counter_pn", "b",
                                   ("increment", 1)),
                                  (f"x{i}", "set_aw", "b", ("add", i))])
            converge(owner, orep, hub, fnode, [("k", "counter_pn", "b")])
            with fnode.txm.commit_lock:
                fnode.txm.commit_counter += 1000  # a bogus local claim
                fol.publish_applied_epoch_locked()
                _assert_epoch_within_applied(fnode.store)
                ep = fnode.store.serving_epoch
                fnode.txm.commit_counter += 1000
            # the ticker publishes through the same path
            deadline = time.monotonic() + 10
            seen = ep.id
            while fnode.store.serving_epoch.id == seen:
                with fnode.txm.commit_lock:
                    fnode.txm.commit_counter += 1000
                    fnode.store.mutation_epoch += 1  # force a re-freeze
                assert time.monotonic() < deadline
                time.sleep(0.01)
            with fnode.txm.commit_lock:
                _assert_epoch_within_applied(fnode.store)
    finally:
        srv.close()
        owner.store.log.close(), fnode.store.log.close()


def test_follower_fabric_without_the_native_pump_refuses(cfg, tmp_path):
    from antidote_tpu_torch.interdc.native_pump import NativePumpUnavailable
    from antidote_tpu_torch.interdc.tcp import TcpFabric

    faults.install(faults.FaultPlan(seed=1).error("native_pump.load"))
    with pytest.raises(NativePumpUnavailable):
        TcpFabric()


# ---------------------------------------------------------------------------
# Part E — followers of a clustered owner
# ---------------------------------------------------------------------------
def _ccfg():
    return AntidoteConfig(n_shards=4, max_dcs=3, ops_per_key=8,
                          snap_versions=2, set_slots=4, keys_per_table=32)


def _port_members(ccfg, tmp_path, n=2):
    from antidote_tpu_torch.cluster.member import ClusterMember

    ms = [ClusterMember(ccfg, dc_id=0, member_id=i, n_members=n,
                        log_dir=str(tmp_path / f"m{i}"), device="cpu")
          for i in range(n)]
    for a in ms:
        for b in ms:
            if a is not b:
                a.connect(b.member_id, *b.address)
    return ms


def _converge_fleet(ms, reps, fabrics, fnode, objs, expect, timeout=60.0):
    """Heartbeat the members and pump every fabric until the follower's
    stable snapshot covers the members' clock and its reads there equal
    ``expect`` (bounded); returns that clock."""
    deadline = time.monotonic() + timeout
    while True:
        for r in reps:
            r.heartbeat()
        for m in ms:
            m.refresh_peer_clocks()
        for f in fabrics:
            f.pump(timeout=0.05)
        target = np.maximum.reduce([m.node.store.dc_max_vc() for m in ms])
        if (fnode.store.stable_vc() >= target).all():
            got, _ = fnode.read_objects(objs, clock=target)
            if got == expect:
                return target
        assert time.monotonic() < deadline, (
            f"fleet follower never converged: {fnode.store.stable_vc()} "
            f"< {target}")


def test_clustered_owner_fleet_shadowing_and_live_shard_move(tmp_path):
    """A follower shadows a 2-member clustered owner: the bootstrap
    composes both members' images (each restricted to its owned shards),
    the tail flows over per-member subscriptions, reads equal the
    owner's at equal applied clocks (the digest clean on every shard
    against whichever member owns it), and a live shard move mid-stream
    re-points catch-up and digest routing through the ownership gossip
    with no reconnect."""
    from antidote_tpu_torch.cluster import ClusterNode, attach_interdc
    from antidote_tpu_torch.cluster.join import _move_shard
    from antidote_tpu_torch.cluster.rpc import RpcClient
    from antidote_tpu_torch.interdc.tcp import TcpFabric

    ccfg = _ccfg()
    fab = TcpFabric(backoff_base=0.05, backoff_max=0.5)
    ffab = TcpFabric(backoff_base=0.05, backoff_max=0.5)
    ms = _port_members(ccfg, tmp_path)
    reps = [attach_interdc(m, fab) for m in ms]
    coord = ClusterNode(ms[0])
    fnode = None
    try:
        n_keys = 8
        for _r in range(3):
            for k in range(n_keys):
                coord.update_objects([(k, "counter_pn", "b",
                                       ("increment", 1))])
        for m in ms:
            m.node.checkpoint_now()
        fnode = AntidoteNode(ccfg, dc_id=0, log_dir=str(tmp_path / "fol"),
                             device="cpu")
        fol = FollowerReplica(fnode, ffab, "cf1",
                              owner_client_addr=("owner-host", 1),
                              fabric_id=301)
        mode = fol.attach([r.descriptor() for r in reps])
        assert mode == "image" and fol.state == "serving"
        assert fol.member_fids == [r.fabric_id for r in reps]
        assert fol.owner_fid == reps[0].fabric_id
        assert sorted(fol.boot_stats["members"]) == fol.member_fids
        assert fol.replica_status()["fleet"]["owner_members"] == 2
        objs = [(k, "counter_pn", "b") for k in range(n_keys)]
        _converge_fleet(ms, reps, (fab, ffab), fnode, objs, [3] * n_keys)
        res = fol.check_divergence()
        assert set(res.values()) == {"ok"}, res
        # the live tail keeps flowing from both members
        for k in range(n_keys):
            coord.update_objects([(k, "counter_pn", "b", ("increment", 1))])
        _converge_fleet(ms, reps, (fab, ffab), fnode, objs, [4] * n_keys)
        # a live shard move, member 1 -> member 0: the open subscriptions
        # keep delivering and the gossip re-points the routes
        moved = next(s for s in range(ccfg.n_shards) if s in ms[1].shards)
        assert fol._route(0, moved) == reps[1].fabric_id
        clients = {m.member_id: RpcClient(*m.address) for m in ms}
        try:
            _move_shard(clients, moved, 1, 0, 2)
        finally:
            for c in clients.values():
                c.close()
        assert moved in ms[0].shards and moved not in ms[1].shards
        for k in range(n_keys):
            coord.update_objects([(k, "counter_pn", "b", ("increment", 1))])
        _converge_fleet(ms, reps, (fab, ffab), fnode, objs, [5] * n_keys)
        assert fol.shard_route[(0, moved)][0] == 0
        res = fol.check_divergence()
        assert set(res.values()) == {"ok"}, res
        assert fol._route(0, moved) == reps[0].fabric_id
        # both members' registries saw the follower's reports
        for r in reps:
            assert "cf1" in r.replica_status()["followers"]
    finally:
        for m in ms:
            m.close()
        fab.close()
        ffab.close()
        if fnode is not None:
            fnode.close()


def test_fleet_descriptor_refusals(tmp_path):
    """What ``attach`` still refuses with a fleet: a descriptor list
    without the owner DC, and a follower fabric id that collides with a
    fleet endpoint's."""
    from antidote_tpu_torch.interdc.messages import Descriptor

    hub = LoopbackHub()
    node = AntidoteNode(_ccfg(), dc_id=0, log_dir=str(tmp_path / "f"),
                        device="cpu")
    try:
        fol = FollowerReplica(node, hub, "fx", fabric_id=301)
        peers = [Descriptor(1, "dc1", 4, fabric_id=1),
                 Descriptor(1, "dc1m1", 4, fabric_id=(1 << 16) | 1)]
        with pytest.raises(ValueError, match="no descriptor for the owner"):
            fol.attach(peers)
        with pytest.raises(ValueError, match="collides"):
            fol.attach([Descriptor(0, "dc0", 4, fabric_id=0),
                        Descriptor(0, "dc0m1", 4, fabric_id=301)])
        assert fol.owner_fid is None and not fol.member_fids
    finally:
        node.close()


def test_a_joiner_ships_an_image_covering_its_sealed_imports(tmp_path):
    """A live join imports compacted shards into the joiner, sealed by a
    full image and then delta links; the members' inter-DC endpoints come
    up after it (their chains start empty).  A follower attached with no
    further checkpoint composes images covering every owned shard: the
    joiner publishes a full image at the follower's ``ckpt_meta`` (the
    JAX member's imports are full images already), so every value equals
    the members' and the digest is clean.  Shipping the joiner's older
    full image instead reads the shards of the later imports as
    empty."""
    from antidote_tpu_torch.cluster import ClusterNode, attach_interdc
    from antidote_tpu_torch.cluster.join import live_join
    from antidote_tpu_torch.cluster.member import ClusterMember
    from antidote_tpu_torch.interdc.tcp import TcpFabric
    from antidote_tpu_torch.log import checkpoint as ckpt

    ccfg = AntidoteConfig(n_shards=8, max_dcs=3, ops_per_key=8,
                          snap_versions=2, set_slots=4, keys_per_table=32)
    ms = _port_members(ccfg, tmp_path)
    fab = TcpFabric(backoff_base=0.05, backoff_max=0.5)
    ffab = TcpFabric(backoff_base=0.05, backoff_max=0.5)
    fnode = None
    try:
        coord = ClusterNode(ms[0])
        for k in range(16):
            coord.update_objects([(k, "counter_pn", "b",
                                   ("increment", k + 1))])
        for m in ms:
            m.node.checkpoint_now()
        joiner = ClusterMember(ccfg, dc_id=0, member_id=2, n_members=3,
                               shards=[], log_dir=str(tmp_path / "m2"),
                               device="cpu")
        ms.append(joiner)
        for a in ms:
            for b in ms:
                if a is not b and b.member_id not in a.peers:
                    a.connect(b.member_id, *b.address)
        assert live_join({m.member_id: tuple(m.address) for m in ms},
                         2) == 2
        cp = joiner.node.checkpointer
        assert cp.chain_len == 1 and cp.sealed_links == 1
        reps = [attach_interdc(m, fab) for m in ms]
        fnode = AntidoteNode(ccfg, dc_id=0, log_dir=str(tmp_path / "fol"),
                             device="cpu")
        fol = FollowerReplica(fnode, ffab, "cf2",
                              owner_client_addr=("owner-host", 1),
                              fabric_id=302)
        assert fol.attach([r.descriptor() for r in reps]) == "image"
        objs = [(k, "counter_pn", "b") for k in range(16)]
        _converge_fleet(ms, reps, (fab, ffab), fnode, objs,
                        [k + 1 for k in range(16)], timeout=20.0)
        res = fol.check_divergence()
        assert set(res.values()) == {"ok"}, res
        assert cp.sealed_links == 0 and cp.chain_len == 0
        shipped = fol.boot_stats["members"][reps[2].fabric_id]["id"]
        assert shipped == cp.last["id"] == 3
        assert ckpt.manifest_kind(ckpt.load_manifest(os.path.join(
            ckpt.checkpoint_root(str(tmp_path / "m2")),
            f"ckpt_{shipped}"))) == "full"
        # a second follower's request finds nothing sealed since: no image
        assert reps[2]._serve_ckpt_meta()["id"] == 3
    finally:
        for m in ms:
            m.close()
        fab.close()
        ffab.close()
        if fnode is not None:
            fnode.close()


def test_port_follower_of_a_jax_clustered_owner_follows_a_shard_move(
        tmp_path, jax_pump):
    """A port follower of a JAX clustered owner (two JAX members, each
    with its inter-DC endpoint): the bootstrap composes both members'
    images, the tail flows through a ``_move_shard`` between the JAX
    members, the digest is clean on every shard against its owner, and
    reads at equal applied clocks equal the JAX members' values exactly
    (before and after the move)."""
    from antidote_tpu.cluster import ClusterNode as JNode
    from antidote_tpu.cluster import attach_interdc as jattach
    from antidote_tpu.cluster.join import _move_shard as jmove
    from antidote_tpu.cluster.member import ClusterMember as JMember
    from antidote_tpu.cluster.rpc import RpcClient as JRpc
    from antidote_tpu.config import AntidoteConfig as JConfig
    from antidote_tpu.interdc.tcp import TcpFabric as JFabric
    from antidote_tpu_torch.interdc.tcp import TcpFabric

    jcfg = JConfig(n_shards=4, max_dcs=3, ops_per_key=8, snap_versions=2,
                   set_slots=4, keys_per_table=32, batch_buckets=(8,))
    jfab, pfab = JFabric(), TcpFabric()
    ms = [JMember(jcfg, dc_id=0, member_id=i, n_members=2,
                  log_dir=str(tmp_path / f"jm{i}")) for i in range(2)]
    fnode = None
    try:
        for a in ms:
            for b in ms:
                if a is not b:
                    a.connect(b.member_id, *b.address)
        reps = [jattach(m, jfab) for m in ms]
        coord = JNode(ms[0])
        _seeded_writes(coord, 61, 24)
        for m in ms:
            m.node.checkpoint_now()
        _seeded_writes(coord, 62, 8, start=24)
        fnode = AntidoteNode(_ccfg(), dc_id=0, log_dir=str(tmp_path / "pf"),
                             device="cpu")
        fol = FollowerReplica(fnode, pfab, "pcf", fabric_id=303,
                              owner_client_addr=("owner-host", 1))
        mode = fol.attach([r.descriptor().to_wire() for r in reps])
        assert mode == "image" and fol.state == "serving"
        assert fol.member_fids == [r.fabric_id for r in reps]
        assert sorted(fol.boot_stats["members"]) == fol.member_fids

        def follow(timeout=60.0):
            deadline = time.monotonic() + timeout
            while True:
                for r in reps:
                    r.heartbeat()
                for m in ms:
                    m.refresh_peer_clocks()
                jfab.pump(timeout=0.05)
                pfab.pump(timeout=0.05)
                target = np.maximum.reduce(
                    [np.asarray(m.node.store.dc_max_vc()) for m in ms])
                if (fnode.store.stable_vc() >= target).all():
                    return [int(x) for x in target]
                assert time.monotonic() < deadline, (
                    f"follower never converged: {fnode.store.stable_vc()}"
                    f" < {target}")

        def same_at(clock):
            want, _ = coord.read_objects(_OBJS, clock=clock)
            got, _ = fnode.read_objects(_OBJS, clock=clock)
            assert _norm_vals(got) == _norm_vals(want)

        same_at(follow())
        assert set(fol.check_divergence().values()) == {"ok"}
        moved = next(s for s in range(jcfg.n_shards) if s in ms[1].shards)
        clients = {m.member_id: JRpc(*m.address) for m in ms}
        try:
            jmove(clients, moved, 1, 0, 2)
        finally:
            for c in clients.values():
                c.close()
        assert moved in ms[0].shards and moved not in ms[1].shards
        _seeded_writes(coord, 63, 12, start=32)
        deadline = time.monotonic() + 30
        while fol.shard_route.get((0, moved), (None,))[0] != 0:
            follow()
            assert time.monotonic() < deadline, fol.shard_route
        same_at(follow())
        res = fol.check_divergence()
        assert set(res.values()) == {"ok"}, res
        assert fol._route(0, moved) == reps[0].fabric_id
        for r in reps:
            assert "pcf" in r.replica_status()["followers"]
    finally:
        for m in ms:
            m.close()
        pfab.close()
        jfab.close()
        if fnode is not None:
            fnode.close()


def test_a_member_commit_on_two_shards_never_pings_ahead_of_a_link(
        tmp_path):
    """A transaction touching two shards of one member commits as two
    links applied in one group.  With a safe-time ping due at every
    commit, the first link's publish must not ping the second link's
    shard at its ts before the second link's message: a follower takes
    such a ping, then drops the message as a duplicate and never applies
    it.  (The member published links after moving every link's clock;
    the JAX member applies and publishes link by link.)"""
    from antidote_tpu_torch.cluster import ClusterNode, attach_interdc

    ccfg = _ccfg()
    hub = LoopbackHub()
    ms = _port_members(ccfg, tmp_path)
    fnode = None
    try:
        reps = [attach_interdc(m, hub) for m in ms]
        for r in reps:
            r.HEARTBEAT_EVERY_COMMITS = 1  # a ping due at every commit
        coord = ClusterNode(ms[0])
        a, b = sorted(ms[1].shards)[:2]  # two shards of member 1
        objs = [(a, "counter_pn", "b"), (b, "counter_pn", "b")]
        coord.update_objects([(k, t, bk, ("increment", 1))
                              for k, t, bk in objs])
        for m in ms:
            m.node.checkpoint_now()
        fnode = AntidoteNode(ccfg, dc_id=0, log_dir=str(tmp_path / "fol"),
                             device="cpu")
        fol = FollowerReplica(fnode, hub, "cf3", fabric_id=304)
        assert fol.attach([r.descriptor() for r in reps]) == "image"
        for i in range(2, 6):
            coord.update_objects([(k, t, bk, ("increment", i))
                                  for k, t, bk in objs])
        want = [1 + 2 + 3 + 4 + 5] * 2
        deadline = time.monotonic() + 30
        while True:
            for r in reps:
                r.heartbeat()
            hub.pump()
            target = np.maximum.reduce([m.node.store.dc_max_vc()
                                        for m in ms])
            if (fnode.store.stable_vc() >= target).all():
                break
            assert time.monotonic() < deadline
        assert coord.read_objects(objs, clock=target)[0] == want
        assert fnode.read_objects(objs, clock=target)[0] == want
        assert set(fol.check_divergence([a, b]).values()) == {"ok"}
    finally:
        for m in ms:
            m.close()
        if fnode is not None:
            fnode.close()
