"""The proxy plane of the port: any follower is a safe entrypoint.

The twelve cases of ``tests/test_proxy.py`` on port nodes
(``device="cpu"``), each node with its own ``TcpFabric`` (the native
receive pump) and ``ProtocolServer``.  Units pin the fleet-health table
(cooldowns, membership rebuilds, unseeded placement against seeded
failover tails) and the deadline propagation of the plane.  Wire cases
drive ring-oblivious clients — native and apb — through one arbitrary
follower under mixed read, write and transaction load: no typed redirect
surfaces, read-your-writes holds, and the forwarded-traffic counters move.
Then the one-hop loop guard, the send-phase redial and exhaustion at the
``proxy.forward`` fault site, server-side read failover around a killed
arc owner, ring-hint learning, the ``server_proxy=False`` opt-out, and an
escrow refusal forwarded at most once.  Tolerance: exact values.
"""

import threading
import time
from contextlib import contextmanager
from types import SimpleNamespace

import pytest

from antidote_tpu_torch import faults
from antidote_tpu_torch.api import AntidoteNode
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.interdc import DCReplica, FollowerReplica
from antidote_tpu_torch.interdc.tcp import TcpFabric
from antidote_tpu_torch.obs.metrics import NodeMetrics
from antidote_tpu_torch.overload import DeadlineExceeded
from antidote_tpu_torch.proto.client import (AntidoteClient, ApbClient,
                                       RemoteInsufficientRights,
                                       RemoteLagging, RemoteNotOwner,
                                       SessionClient)
from antidote_tpu_torch.proto.proxy import FleetHealth, ProxyPlane
from antidote_tpu_torch.proto.server import ProtocolServer

@pytest.fixture
def cfg():
    # same shapes as the follower/chaos suites: warm XLA compile cache
    return AntidoteConfig(
        n_shards=2, max_dcs=3, ops_per_key=8, snap_versions=2,
        set_slots=4, keys_per_table=16,
    )


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.uninstall()


# ---------------------------------------------------------------------------
# Part A — units (no sockets)
# ---------------------------------------------------------------------------
def test_remaining_ms_propagates_instead_of_resetting():
    """The inner hop gets the budget LEFT, not a fresh one — queue time
    burned on the proxying node is never granted back."""
    assert ProxyPlane._remaining_ms(None) is None
    now = time.monotonic()
    ms = ProxyPlane._remaining_ms(now + 0.5)
    assert 250.0 <= ms <= 500.0
    # an already-blown deadline clamps to the 1 ms floor (the target's
    # own check_deadline then refuses it typed)
    assert ProxyPlane._remaining_ms(now - 5.0) == 1.0


def test_expired_deadline_refuses_without_dialing():
    """A dead deadline is refused typed BEFORE any channel is dialed —
    a proxy must not spend sockets on work the client already gave up
    on.  (The fake owner addr would hang a real dial.)"""
    fol = SimpleNamespace(owner_client_addr=("203.0.113.9", 9),
                          client_addr=("203.0.113.1", 1),
                          fleet_table={}, fleet_table_v=0)
    plane = ProxyPlane(fol, NodeMetrics())
    past = time.monotonic() - 1.0
    try:
        with pytest.raises(DeadlineExceeded):
            plane.proxy_read([("k", "counter_pn", "b")], None, past)
        with pytest.raises(DeadlineExceeded):
            plane.forward_update([("k", "counter_pn", "b",
                                   ("increment", 1))], None, past)
    finally:
        plane.close()


def test_fleet_health_membership_cooldown_and_agreement():
    fh = FleetHealth(vnodes=16, seed=7)
    fleet = {
        "f1": {"addr": ["h1", 1], "state": "ok"},
        "f2": {"addr": ["h2", 2], "state": "ok"},
        "f3": {"addr": ["h3", 3], "state": "down"},
    }
    fh.update_fleet(fleet)
    # a registry-DOWN follower never makes the serving ring
    assert ("h3", 3) not in fh.ring.endpoints
    cands = fh.candidates("k", "b")
    assert set(cands) == {("h1", 1), ("h2", 2)}
    pref = fh.preferred("k", "b")
    assert cands[0] == pref
    # a local connect/timeout observation kills the arc for DEAD_S
    fh.mark_dead(pref)
    assert not fh.alive(pref)
    assert fh.candidates("k", "b") == [ep for ep in cands if ep != pref]
    # cooldown expiry brings the arc back without a registry round-trip
    fh._dead[pref] = time.monotonic() - 0.01
    assert fh.alive(pref)
    assert fh.preferred("k", "b") == pref
    # placement is UNSEEDED: differently-seeded nodes agree on the
    # preferred arc owner (fleet-wide agreement), only the failover
    # tail is per-node jittered
    fh_b = FleetHealth(vnodes=16, seed=991)
    fh_b.update_fleet(fleet)
    for key in ("k", "a", "z9", "session/7"):
        assert fh_b.preferred(key, "b") == fh.preferred(key, "b")


def test_apb_errmsg_fleet_param_round_trips():
    from antidote_tpu_torch.proto import apb

    text = apb.error_text("lagging", "behind the token", 40, ["h", 1],
                          fleet=[["fa", 10], ["fb", 11]])
    out = apb.parse_error_text(text)
    assert out["kind"] == "lagging"
    assert out["redirect"] == ["h", 1]
    assert out["fleet"] == [["fa", 10], ["fb", 11]]
    assert out["detail"] == "behind the token"
    # a foreign server's malformed fleet never crashes the parse
    out = apb.parse_error_text(b"lagging fleet=oops: x")
    assert out["kind"] == "lagging" and out["fleet"] is None


# ---------------------------------------------------------------------------
# Part B — the wire fabric (owner + followers on real sockets)
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


def _wire_follower(cfg, tmp_path, owner_srv, name, fid, park_s=0.1,
                   **srv_kw):
    fabric = TcpFabric(backoff_base=0.05, backoff_max=0.5)
    node = AntidoteNode(cfg, dc_id=0, log_dir=str(tmp_path / name), device="cpu")
    fol = FollowerReplica(node, fabric, name,
                          owner_client_addr=(owner_srv.host,
                                             owner_srv.port),
                          fabric_id=fid, park_s=park_s)
    srv = ProtocolServer(node, port=0, follower=fol, **srv_kw)
    fol.client_addr = (srv.host, srv.port)
    c = AntidoteClient(owner_srv.host, owner_srv.port)
    desc = c.get_connection_descriptor()
    c.close()
    mode = fol.attach(desc)
    return {"node": node, "fol": fol, "srv": srv, "fabric": fabric,
            "mode": mode}


@contextmanager
def _cluster(cfg, tmp_path, followers=2, **srv_kw):
    """Owner + N wire followers, fabrics pumped, fleet tables primed
    (two report rounds: register everyone, then distribute the
    complete registry snapshot to every node)."""
    ofab = TcpFabric(backoff_base=0.05, backoff_max=0.5)
    owner = AntidoteNode(cfg, dc_id=0, log_dir=str(tmp_path / "owner"), device="cpu")
    orep = DCReplica(owner, ofab, "dc0")
    osrv = ProtocolServer(owner, port=0, interdc=orep)
    pumps = [_Pump(ofab)]
    fs = []
    oc = None
    try:
        oc = AntidoteClient(osrv.host, osrv.port)
        oc.update_objects([("seed", "counter_pn", "b", ("increment", 1))])
        oc.checkpoint_now()
        for i in range(followers):
            fs.append(_wire_follower(cfg, tmp_path, osrv, f"pf{i + 1}",
                                     111 + i, **srv_kw))
        pumps.append(_Pump(*[f["fabric"] for f in fs]))
        for _round in range(2):
            for f in fs:
                f["fol"]._send_report()
        yield {"owner": owner, "orep": orep, "osrv": osrv, "oc": oc,
               "fs": fs}
    finally:
        if oc is not None:
            oc.close()
        for p in reversed(pumps):
            p.close()
        for f in fs:
            f["srv"].close()
            f["fabric"].close()
            f["node"].store.log.close()
        osrv.close()
        ofab.close()
        owner.store.log.close()


def test_ring_oblivious_native_client_mixed_load(cfg, tmp_path):
    """The main flow: a bare AntidoteClient that knows ONE
    arbitrary follower and nothing about the ring drives writes, static
    reads, and an interactive transaction — every op succeeds (zero
    typed redirects), read-your-writes holds at the session token, and
    the follower's forwarded-traffic counters account for the hops."""
    with _cluster(cfg, tmp_path, followers=2) as cl:
        f1 = cl["fs"][0]
        assert f1["fol"].fleet_table_v >= 1  # fleet learned via reports
        fc = AntidoteClient(f1["srv"].host, f1["srv"].port)
        total, vc = 0, None
        for i in range(6):
            vc = fc.update_objects(
                [("k", "counter_pn", "b", ("increment", 1)),
                 ("s", "set_aw", "b", ("add", f"e{i}"))], clock=vc)
            total += 1
            vals, vc = fc.read_objects(
                [("k", "counter_pn", "b"), ("s", "set_aw", "b")],
                clock=vc)
            assert vals[0] == total, (i, vals)
            assert len(vals[1]) == total
        # interactive txn through the same follower: forwarded over the
        # sticky owner channel
        txn = fc.start_transaction(clock=vc)
        txn.update_objects([("k", "counter_pn", "b", ("increment", 1))])
        assert txn.read_objects([("k", "counter_pn", "b")]) == [total + 1]
        cc = txn.commit()
        total += 1
        vals, _ = fc.read_objects([("k", "counter_pn", "b")], clock=cc)
        assert vals == [total]
        # zero typed redirects surfaced to this ring-oblivious client:
        # every op above succeeded in place.  (The gate's internal
        # lagging refusals were rescued server-side — they show up as
        # proxy failovers, never as client errors.)
        m = f1["node"].metrics
        assert m.session_redirects.value(kind="not_owner",
                                         dialect="native") == 0
        st = fc.node_status()["pipeline"]["proxy"]
        assert st["forwarded"]["write"] >= 6
        assert st["forwarded"]["txn"] >= 4
        fc.close()


def test_ring_oblivious_apb_client_mixed_load(cfg, tmp_path):
    """The apb dialect gets the same any-node entrypoint —
    static writes forward, interactive txns ride the sticky channel,
    reads hold RYW, and typed errors never surface while the owner is
    reachable.  (apb keys are raw bytes — a distinct keyspace from the
    native str keys.)"""
    import msgpack

    from antidote_tpu_torch.proto import apb

    with _cluster(cfg, tmp_path, followers=2) as cl:
        f1 = cl["fs"][0]
        ac = ApbClient(f1["srv"].host, f1["srv"].port)
        total, vc = 0, None
        for i in range(4):
            vc = ac.update_objects(
                [(b"pk", "counter_pn", b"b", ("increment", 1))], clock=vc)
            total += 1
            vals, vc = ac.read_objects([(b"pk", "counter_pn", b"b")],
                                       clock=vc)
            assert vals == [total], (i, vals)
        # interactive apb txn, raw frames: START / UPDATE / READ / COMMIT
        name, resp = ac._call("ApbStartTransaction",
                              {"timestamp": msgpack.packb(
                                  [int(x) for x in vc])})
        assert name == "ApbStartTransactionResp" and resp["success"]
        td = resp["transaction_descriptor"]
        name, resp = ac._call("ApbUpdateObjects", {
            "transaction_descriptor": td,
            "updates": [apb.update_op_from_native(
                (b"pk", "counter_pn", b"b", ("increment", 1)))],
        })
        assert name == "ApbOperationResp" and resp["success"]
        name, resp = ac._call("ApbReadObjects", {
            "transaction_descriptor": td,
            "boundobjects": [{"key": b"pk",
                              "type": apb.TYPE_IDS["counter_pn"],
                              "bucket": b"b"}],
        })
        assert name == "ApbReadObjectsResp"
        assert resp["objects"][0]["counter"]["value"] == total + 1
        name, resp = ac._call("ApbCommitTransaction",
                              {"transaction_descriptor": td})
        assert name == "ApbCommitResp" and resp["success"]
        total += 1
        cc = msgpack.unpackb(resp["commit_time"], raw=False)
        vals, _ = ac.read_objects([(b"pk", "counter_pn", b"b")], clock=cc)
        assert vals == [total]
        m = f1["node"].metrics
        assert m.session_redirects.value(kind="not_owner",
                                         dialect="apb") == 0
        ac.close()


def test_session_client_learns_ring_from_hints(cfg, tmp_path):
    """A SessionClient seeded with ONE follower rebuilds
    its fleet in place from the ring-hint riding proxied replies —
    no refresh_fleet round trip — and converges to the full ring."""
    with _cluster(cfg, tmp_path, followers=2) as cl:
        f1 = cl["fs"][0]
        sc = SessionClient((cl["osrv"].host, cl["osrv"].port),
                           [(f1["srv"].host, f1["srv"].port)])
        assert len(sc.ring) == 1
        deadline = time.monotonic() + 30
        i = 0
        while sc.hints_applied == 0:
            assert time.monotonic() < deadline, "no ring hint absorbed"
            sc.update_objects([(f"hk{i}", "counter_pn", "b",
                                ("increment", 1))])
            vals, _ = sc.read_objects([(f"hk{i}", "counter_pn", "b")])
            assert vals == [1], (i, vals)
            i += 1
        assert sc.stats()["ring_size"] == 2
        assert sc.redirects == 0
        sc.close()


def test_proxied_flag_is_a_one_hop_loop_guard(cfg, tmp_path):
    """A request already marked ``proxied`` is NEVER re-proxied or
    re-forwarded: the first hop owns failover, so a partitioned fleet
    degrades to the typed vocabulary instead of a forwarding cycle.
    The typed replies still carry the ring hint (teach-don't-bounce)."""
    with _cluster(cfg, tmp_path, followers=2) as cl:
        f1 = cl["fs"][0]
        fc = AntidoteClient(f1["srv"].host, f1["srv"].port)
        ahead = [int(x) + 50
                 for x in cl["owner"].store.dc_max_vc()]
        with pytest.raises(RemoteLagging) as ei:
            fc.read_objects([("k", "counter_pn", "b")], clock=ahead,
                            proxied=True)
        assert ei.value.retry_after_ms > 0
        with pytest.raises(RemoteNotOwner) as ei:
            fc.update_objects([("k", "counter_pn", "b",
                                ("increment", 1))], proxied=True)
        assert ei.value.redirect == [cl["osrv"].host, cl["osrv"].port]
        # both typed refusals taught the client the fleet anyway
        assert fc.ring_hint is not None
        assert len(fc.ring_hint["followers"]) == 2
        fc.close()


def test_forward_redials_send_phase_faults_then_surfaces_typed(cfg,
                                                              tmp_path):
    """At-most-once discipline at the ``proxy.forward`` chaos site: a
    send-phase hop death redials within the bounded budget (the write
    still commits, counted as a failover); exhausting every attempt
    surfaces the typed not_owner redirect — never a blind resend."""
    with _cluster(cfg, tmp_path, followers=1) as cl:
        f1 = cl["fs"][0]
        ep = f"{cl['osrv'].host}:{cl['osrv'].port}"
        fc = AntidoteClient(f1["srv"].host, f1["srv"].port)
        faults.install(
            faults.FaultPlan(seed=3).error("proxy.forward", key=ep,
                                           times=1))
        vc = fc.update_objects([("fk", "counter_pn", "b",
                                 ("increment", 1))])
        faults.uninstall()
        vals, _ = fc.read_objects([("fk", "counter_pn", "b")], clock=vc)
        assert vals == [1]
        st = fc.node_status()["pipeline"]["proxy"]
        assert st["forwarded"]["failover"] >= 1
        # every attempt dead: typed redirect with the owner endpoint
        faults.install(
            faults.FaultPlan(seed=4).error("proxy.forward", key=ep,
                                           times=ProxyPlane.FORWARD_ATTEMPTS))
        with pytest.raises(RemoteNotOwner) as ei:
            fc.update_objects([("fk", "counter_pn", "b",
                                ("increment", 1))])
        assert ei.value.redirect == [cl["osrv"].host, cl["osrv"].port]
        faults.uninstall()
        # the fabric heals as soon as the fault plan is gone
        vc = fc.update_objects([("fk", "counter_pn", "b",
                                 ("increment", 1))])
        vals, _ = fc.read_objects([("fk", "counter_pn", "b")], clock=vc)
        assert vals == [2]
        fc.close()


def test_server_side_read_failover_around_dead_arc_owner(cfg, tmp_path):
    """When the arc owner dies, the node holding the
    client's socket fails the read over server-side — local DEAD_S
    observation plus the seeded failover tail — and the ring-oblivious
    client never sees a typed error."""
    with _cluster(cfg, tmp_path, followers=2) as cl:
        f1, f2 = cl["fs"]
        plane = f1["srv"].proxy
        f2_ep = (f2["srv"].host, f2["srv"].port)
        key = next(f"rk{i}" for i in range(64)
                   if plane.route([(f"rk{i}", "counter_pn", "b")])
                   == f2_ep)
        fc = AntidoteClient(f1["srv"].host, f1["srv"].port)
        vc = fc.update_objects([(key, "counter_pn", "b",
                                 ("increment", 1))])
        # SIGKILL-equivalent for an in-process test: server + fabric die
        f2["srv"].close()
        f2["fabric"].close()
        f2["node"].store.log.close()
        cl["fs"].remove(f2)
        vals, _ = fc.read_objects([(key, "counter_pn", "b")], clock=vc)
        assert vals == [1]
        assert not plane.health.alive(f2_ep)  # local observation
        st = fc.node_status()["pipeline"]["proxy"]
        assert st["forwarded"]["failover"] >= 1
        assert f"{f2_ep[0]}:{f2_ep[1]}" in st["fleet"]["locally_dead"]
        fc.close()


def test_no_server_proxy_opt_out_preserves_typed_vocabulary(cfg,
                                                            tmp_path):
    """The ``--no-server-proxy`` operator escape hatch: a plane-less
    follower answers the typed redirects (ring-aware clients
    keep their client-side failover), it just stops being a safe
    entrypoint for bare clients."""
    with _cluster(cfg, tmp_path, followers=1,
                  server_proxy=False) as cl:
        f1 = cl["fs"][0]
        assert f1["srv"].proxy is None
        fc = AntidoteClient(f1["srv"].host, f1["srv"].port)
        with pytest.raises(RemoteNotOwner) as ei:
            fc.update_objects([("k", "counter_pn", "b",
                                ("increment", 1))])
        assert ei.value.redirect == [cl["osrv"].host, cl["osrv"].port]
        ahead = [int(x) + 50
                 for x in cl["owner"].store.dc_max_vc()]
        with pytest.raises(RemoteLagging) as ei:
            fc.read_objects([("k", "counter_pn", "b")], clock=ahead)
        assert ei.value.retry_after_ms > 0
        fc.close()


def test_forwarded_bcounter_refusal_is_typed_and_at_most_once(cfg,
                                                              tmp_path):
    """a counter_b decrement through a ring-oblivious follower
    forwards to the owner; an escrow shortfall comes back as the typed
    ``insufficient_rights`` refusal (retry hint intact) with EXACTLY one
    forwarded attempt — the proxy never blind-resends a refused spend —
    and a covered decrement on the same socket commits."""
    with _cluster(cfg, tmp_path, followers=1) as cl:
        f1 = cl["fs"][0]
        fc = AntidoteClient(f1["srv"].host, f1["srv"].port)
        vc = fc.update_objects([("sku", "counter_b", "b",
                                 ("increment", (3, 0)))])
        base = fc.node_status()["pipeline"]["proxy"]["forwarded"]["write"]
        with pytest.raises(RemoteInsufficientRights) as ei:
            fc.update_objects([("sku", "counter_b", "b",
                                ("decrement", (5, 0)))], clock=vc)
        assert ei.value.retry_after_ms > 0
        assert "need 5, hold 3" in str(ei.value)
        st = fc.node_status()["pipeline"]["proxy"]
        # at-most-once: one client call, one forwarded attempt — the
        # refusal surfaced instead of being retried into an oversell
        assert st["forwarded"]["write"] == base + 1
        assert cl["owner"].txm.bcounters.refused_total == 1
        # the owner queued the shortfall for its transfer loop
        assert cl["owner"].txm.bcounters.shortfall() == 5
        # a covered decrement on the same socket commits and retires
        # nothing it shouldn't (value 3-2=1)
        vc = fc.update_objects([("sku", "counter_b", "b",
                                ("decrement", (2, 0)))], clock=vc)
        vals, _ = fc.read_objects([("sku", "counter_b", "b")], clock=vc)
        assert vals == [1]
        # escrow block rides node status (the refusal was the owner's)
        esc = cl["owner"].status()["escrow"]
        assert esc["refused_total"] == 1
        assert "escrow" in fc.node_status()  # surfaced on the wire too
        fc.close()


def _hold_interpreter_lock(seconds: int) -> None:
    """One C call that keeps the interpreter lock for ``seconds``: libc's
    ``sleep`` through ``ctypes.PyDLL``, which (unlike ``CDLL``) does not
    release the lock around the call — what a profiler digesting its trace
    does to every other thread of its process."""
    import ctypes

    ctypes.PyDLL(None).sleep(int(seconds))


@pytest.mark.parametrize("hold_s,fails", [(2, False), (7, True)],
                         ids=["inside", "past"])
def test_interpreter_lock_held_past_the_dial_timeout_fails_a_forward(
        cfg, tmp_path, hold_s, fails):
    """A forwarded write waits for its owner's reply for at most
    ``ProxyPlane.DIAL_TIMEOUT_S``.  The interpreter lock held in one C call
    while the owner handles the write (the owner and its follower share
    the process, as in ``chip_smoke.py``'s follower phase) stops every
    thread: held past the timeout, the follower's wait ends first and the
    client gets the typed ``ForwardFailed`` although the owner commits the
    write; held inside it, the write is acknowledged."""
    from antidote_tpu_torch.proto.client import RemoteForwardFailed

    assert ProxyPlane.DIAL_TIMEOUT_S < 7
    with _cluster(cfg, tmp_path, followers=1) as cl:
        fc = AntidoteClient(cl["fs"][0]["srv"].host,
                            cl["fs"][0]["srv"].port)
        fc.update_objects([("g", "counter_pn", "b", ("increment", 1))])
        # the owner's write plane stages every static write through its
        # manager's update_objects
        owner = cl["owner"].txm
        plain = owner.update_objects
        armed = [True]

        def stalled(*a, **kw):
            if armed[0]:
                armed[0] = False
                _hold_interpreter_lock(hold_s)
            return plain(*a, **kw)

        owner.update_objects = stalled
        try:
            if fails:
                with pytest.raises(RemoteForwardFailed):
                    fc.update_objects(
                        [("g", "counter_pn", "b", ("increment", 1))])
            else:
                fc.update_objects([("g", "counter_pn", "b",
                                    ("increment", 1))])
        finally:
            owner.update_objects = plain
        assert not armed[0]
        # either way the owner executed the write exactly once
        deadline = time.monotonic() + 10
        while cl["oc"].read_objects([("g", "counter_pn", "b")])[0] != [2]:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        fc.close()
