"""The port's multi-tenant QoS on the CPU: weighted-fair lanes,
per-tenant quotas, and the noisy-neighbor isolation contract.

Counterparts of ``tests/test_tenancy.py``.  Part A drives the primitives
deterministically (spec parsing, identity derivation, the TenantLanes DRR
properties — proportional shares, work conservation, no starvation of an
under-quota tenant — ``batch_rounds`` and the admission gate's per-key
streak discipline).  Part B puts the typed ``tenant_busy`` vocabulary on
real sockets: the msgpack dialect and the apb errmsg encoding.  The
forwarding follower of the JAX tests comes with inter-DC replication.
Part C holds the port manager's ``_tenant_rounds`` split equal to the
JAX manager's on one group.
"""

import queue
import threading
import time

import numpy as np
import pytest

from antidote_tpu_torch.api.node import AntidoteNode as _Node
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.overload import AdmissionGate, BusyError, TenantBusyError
from antidote_tpu_torch.proto.client import (
    AntidoteClient,
    ApbClient,
    RemoteBusy,
    RemoteTenantBusy,
)
from antidote_tpu_torch.proto.server import ProtocolServer
from antidote_tpu_torch.tenancy import (
    DEFAULT_TENANT,
    TenantLanes,
    TenantRegistry,
    TenantSpec,
    batch_rounds,
    parse_tenant_spec,
)


def AntidoteNode(*a, **kw):
    """The port's node on the CPU."""
    kw.setdefault("device", "cpu")
    return _Node(*a, **kw)


# ---------------------------------------------------------------------------
# Part A — primitives
# ---------------------------------------------------------------------------
@pytest.mark.smoke
def test_parse_tenant_spec_grammar():
    s = parse_tenant_spec("acme:3,max_in_flight=64,max_backlog=512")
    assert (s.name, s.weight, s.max_in_flight, s.max_backlog) == \
        ("acme", 3, 64, 512)
    s = parse_tenant_spec("free")  # weight optional
    assert (s.name, s.weight, s.max_in_flight, s.max_backlog) == \
        ("free", 1, None, None)
    for bad in ("acme:x", "acme:1,wat=3", "acme:1,max_backlog=q",
                "", "a b:1", "acme:0"):
        with pytest.raises(ValueError):
            parse_tenant_spec(bad)


@pytest.mark.smoke
def test_registry_identity_derivation():
    reg = TenantRegistry([TenantSpec("gold", 3), TenantSpec("bronze", 1)])
    assert reg.names[0] == DEFAULT_TENANT and reg.multi
    # bucket-namespace derivation: registered prefix wins, str or bytes
    assert reg.tenant_of("gold/orders") == "gold"
    assert reg.tenant_of(b"bronze/x") == "bronze"
    # unregistered prefixes and flat buckets ride the default lane —
    # a hostile client inventing prefixes cannot allocate lanes
    assert reg.tenant_of("mallory/x") == DEFAULT_TENANT
    assert reg.tenant_of("plain") == DEFAULT_TENANT
    # explicit registered tag wins over buckets; unregistered tag falls
    # back to bucket derivation
    assert reg.resolve("gold", ["bronze/x"]) == "gold"
    assert reg.resolve("mallory", ["bronze/x"]) == "bronze"
    assert reg.resolve(None, ["plain", "gold/x"]) == "gold"
    assert reg.resolve(None, ["plain"]) == DEFAULT_TENANT
    # label clamp: wire-fed values collapse onto the bounded set
    assert reg.label("gold") == "gold"
    assert reg.label("mallory") == DEFAULT_TENANT
    # an untenanted registry is just the default lane
    assert not TenantRegistry().multi


@pytest.mark.smoke
def test_untenanted_lanes_keep_plain_queue_contract():
    """With only the default lane, TenantLanes IS the old shared queue:
    FIFO order, queue.Full past maxsize (the classic global-busy reply),
    never tenant_busy."""
    lanes = TenantLanes(TenantRegistry(), maxsize=3, name="t")
    for i in range(3):
        lanes.put_nowait(i, DEFAULT_TENANT)
    with pytest.raises(queue.Full):
        lanes.put_nowait(3, DEFAULT_TENANT)
    assert [lanes.get_nowait() for _ in range(3)] == [0, 1, 2]
    with pytest.raises(queue.Empty):
        lanes.get_nowait()


def test_wfq_shares_proportional_to_weights():
    """Contended dequeue shares converge to the weight ratio: gold:3 vs
    bronze:1 backlogged together → any served window splits within 25%
    of 3:1."""
    reg = TenantRegistry([TenantSpec("gold", 3), TenantSpec("bronze", 1)])
    lanes = TenantLanes(reg, maxsize=200, name="t")
    for i in range(40):
        lanes.put_nowait(("g", i), "gold")
        lanes.put_nowait(("b", i), "bronze")
    served = [lanes.get_nowait() for _ in range(40)]
    g = sum(1 for s in served if s[0] == "g")
    b = sum(1 for s in served if s[0] == "b")
    assert g + b == 40
    # configured share of gold = 3/4; achieved within 25% relative
    assert abs(g / 40 - 0.75) <= 0.25 * 0.75
    # FIFO within each lane
    assert [s[1] for s in served if s[0] == "g"] == sorted(
        s[1] for s in served if s[0] == "g")


def test_wfq_work_conservation():
    """An idle sibling's capacity flows to the backlogged tenant: with
    only bronze queued, every dequeue serves bronze back-to-back (no
    idle credit accounting, no waiting on gold's empty lane)."""
    reg = TenantRegistry([TenantSpec("gold", 7),
                          TenantSpec("bronze", 1, max_backlog=64)])
    lanes = TenantLanes(reg, maxsize=100, name="t")
    for i in range(20):
        lanes.put_nowait(i, "bronze")
    assert [lanes.get_nowait() for _ in range(20)] == list(range(20))
    # a lane with leftover DRR credit but nothing queued is skipped,
    # not waited on: gold serves once (leaving unspent credit), then
    # bronze-only traffic flows without a stall
    lanes.put_nowait("g0", "gold")
    assert lanes.get_nowait() == "g0"
    for i in range(5):
        lanes.put_nowait(("b2", i), "bronze")
    assert [lanes.get_nowait() for _ in range(5)] == \
        [("b2", i) for i in range(5)]


def test_per_tenant_bound_never_starves_under_quota_sibling():
    """A saturated lane refuses typed WITHOUT touching its siblings:
    gold full → gold sheds tenant_busy, bronze (under quota) still
    admits and still gets served."""
    reg = TenantRegistry([TenantSpec("gold", 1, max_backlog=2),
                          TenantSpec("bronze", 1)])
    lanes = TenantLanes(reg, maxsize=16, name="t")
    lanes.put_nowait("g0", "gold")
    lanes.put_nowait("g1", "gold")
    with pytest.raises(TenantBusyError) as e:
        lanes.put_nowait("g2", "gold")
    assert e.value.tenant == "gold" and e.value.retry_after_ms >= 25
    # the victim lane is untouched
    lanes.put_nowait("b0", "bronze")
    served = [lanes.get_nowait() for _ in range(3)]
    assert "b0" in served
    assert lanes.shed_counts["gold"] == 1
    assert lanes.shed_counts["bronze"] == 0
    # repeated refusals deepen the lane's OWN pressure hint
    lanes.put_nowait("g2", "gold")
    lanes.put_nowait("g3", "gold")  # lane back at its cap of 2
    hints = []
    for _ in range(8):
        with pytest.raises(TenantBusyError) as e:
            lanes.put_nowait("gX", "gold")
        hints.append(e.value.retry_after_ms)
    assert hints[-1] > hints[0]


def test_control_items_bypass_lane_bounds():
    """Shutdown sentinels ride the control deque: they enqueue into a
    SATURATED lanes object without raising and dequeue first — a full
    lane must never wedge close()."""
    reg = TenantRegistry([TenantSpec("gold", 1, max_backlog=1)])
    lanes = TenantLanes(reg, maxsize=1, name="t")
    lanes.put_nowait("work", "gold")
    sentinel = object()
    lanes.put_nowait(sentinel)  # tenant=None: control plane
    assert lanes.get_nowait() is sentinel
    assert lanes.get_nowait() == "work"


@pytest.mark.smoke
def test_batch_rounds_weight_proportional_and_work_conserving():
    reg = TenantRegistry([TenantSpec("gold", 3), TenantSpec("bronze", 1)])
    # single tenant: one round, zero extra lock cycles
    only = [("gold", i) for i in range(8)]
    assert batch_rounds(only, lambda t: t[0], reg) == [only]
    # storm tenant way past its share: gold's round-1 slice is capped
    # at its weight-proportional quota and the victim rides round 1
    items = [("gold", i) for i in range(20)] + [("bronze", i)
                                               for i in range(2)]
    rounds = batch_rounds(items, lambda t: t[0], reg)
    flat = [x for r in rounds for x in r]
    assert sorted(map(str, flat)) == sorted(map(str, items))  # nothing lost
    assert len(rounds) >= 2
    # the victim's whole (small) backlog commits in round 1 — it never
    # waits behind the aggressor's full queue
    assert sum(1 for t in rounds[0] if t[0] == "bronze") == 2
    g1 = sum(1 for t in rounds[0] if t[0] == "gold")
    assert g1 <= (len(items) * 3) // 4  # weight-proportional cap
    # relative order within each tenant is preserved
    g = [i for (t, i) in flat if t == "gold"]
    assert g == sorted(g)


@pytest.mark.smoke
def test_admission_gate_tenant_caps_and_per_key_streaks():
    reg = TenantRegistry([TenantSpec("gold", 2, max_in_flight=1)])
    g = AdmissionGate(max_in_flight=8, max_per_client=8, tenants=reg)
    g.tenant_enter("gold")
    with pytest.raises(TenantBusyError) as e:
        g.tenant_enter("gold")
    assert e.value.tenant == "gold"
    # uncapped tenants are accounted but never refused
    for _ in range(5):
        g.tenant_enter(DEFAULT_TENANT)
    assert g.tenant_in_flight(DEFAULT_TENANT) == 5
    g.tenant_exit("gold")
    g.tenant_enter("gold")  # freed slot readmits


def test_gate_streaks_are_per_client_not_global():
    """The pressure hint tracks EACH caller's refusals
    since ITS last admission — a hot client hammering the gate must not
    inflate a first-time client's backoff to the 500 ms ceiling."""
    clk = [0.0]
    g = AdmissionGate(max_in_flight=1, max_per_client=1,
                      clock=lambda: clk[0])
    g.enter("hot")
    hot_hints = []
    for _ in range(80):  # hot client hammers the full gate
        with pytest.raises(BusyError) as e:
            g.enter("hot2")
        hot_hints.append(e.value.retry_after_ms)
    assert hot_hints[-1] == 500  # deep streak hit the ceiling
    with pytest.raises(BusyError) as e:
        g.enter("newcomer")  # first refusal: the 25 ms floor
    assert e.value.retry_after_ms == 25
    # admission pops the key's OWN streak: hot2 finally gets in, then a
    # fresh refusal restarts it at the floor, not the 500 ms ceiling
    g.exit("hot")
    g.enter("hot2")
    with pytest.raises(BusyError) as e:
        g.enter("hot2")  # per-client cap (max_per_client=1)
    assert e.value.retry_after_ms == 25
    # TTL prune: advance past STREAK_TTL_S — stale streaks are forgotten
    # on the next refusal sweep once the map is large enough
    from antidote_tpu_torch import overload as ov
    for i in range(70):
        g._streaks[f"k{i}"] = (9, clk[0])
    clk[0] += ov.STREAK_TTL_S + 1
    with g._lock:
        g._retry_hint_locked("probe")
    assert all(not k.startswith("k") for k in g._streaks)


def test_streak_map_hard_cap_under_key_flood():
    g = AdmissionGate(max_in_flight=1, max_per_client=1)
    g.enter("w")
    from antidote_tpu_torch import overload as ov
    for i in range(ov._STREAK_MAP_MAX + 10):
        with pytest.raises(BusyError):
            g.enter(f"flood{i}")
    assert len(g._streaks) <= ov._STREAK_MAP_MAX


# ---------------------------------------------------------------------------
# Part B — the wire (typed tenant_busy end-to-end, both dialects)
# ---------------------------------------------------------------------------
def mk_cfg():
    return AntidoteConfig(
        n_shards=2, max_dcs=2, ops_per_key=8, snap_versions=2,
        set_slots=8, rga_slots=16, keys_per_table=64,
    )


def _mk_server(**kw):
    tenants = TenantRegistry.from_flags(
        kw.pop("tenant_flags", ["gold:3,max_in_flight=1", "bronze:1"]))
    node = AntidoteNode(mk_cfg())
    return node, ProtocolServer(node, port=0, tenants=tenants, **kw)


def test_tenant_busy_typed_native_and_isolated():
    """The acceptance contract on the native dialect: a tenant at its
    own cap gets ``tenant_busy`` (RemoteTenantBusy, tenant named,
    pressure-scaled hint) while an untagged client keeps being served —
    and the global busy stays a DISTINCT type."""
    node, srv = _mk_server()
    a = AntidoteClient(port=srv.port)
    b = AntidoteClient(port=srv.port)
    try:
        # seed commit: publishes a serving epoch so victim reads ride
        # the lock-free epoch path while the write plane is wedged
        b.update_objects([("seed", "counter_pn", "plain",
                           ("increment", 1))])
        res = {}
        with node.txm.commit_lock:  # wedge the write plane
            t = threading.Thread(target=lambda: res.update(
                ok=a.update_objects(
                    [("k", "counter_pn", "gold/b", ("increment", 1))])))
            t.start()
            deadline = time.monotonic() + 10
            while srv.admission.tenant_in_flight("gold") < 1:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            # gold is at max_in_flight=1: its next request refuses TYPED
            # with the lane named — bucket-derived identity
            with pytest.raises(RemoteTenantBusy) as e:
                b.update_objects(
                    [("k2", "counter_pn", "gold/b", ("increment", 1))])
            assert e.value.tenant == "gold"
            assert e.value.retry_after_ms >= 25
            assert isinstance(e.value, RemoteBusy)  # generic loops work
            # explicit connection tag maps to the same lane
            with pytest.raises(RemoteTenantBusy) as e2:
                b.update_objects(
                    [("k3", "counter_pn", "plain", ("increment", 1))],
                    tenant="gold")
            assert e2.value.tenant == "gold"
            # the VICTIM lane is untouched: untagged reads serve fine
            # while gold is wedged (noisy-neighbor isolation)
            vals, _vc = b.read_objects([("k", "counter_pn", "plain")])
            assert vals == [0]
        t.join(timeout=30)
        assert "ok" in res  # the in-flight gold write completed
        # per-tenant observability: node status carries the lane block
        st = b.node_status()
        assert st["tenants"]["multi"] is True
        assert "gold" in st["tenants"]["tenants"]
        gold = st["tenants"]["tenants"]["gold"]
        assert gold["weight"] == 3 and gold["max_in_flight"] == 1
    finally:
        a.close()
        b.close()
        srv.close()


def test_tenant_busy_rides_apb_errmsg():
    """The apb dialect derives tenant from the bucket namespace and
    round-trips the refusal through the errmsg grammar: kind
    ``tenant_busy``, ``tenant=`` kv, retry hint — decoded into the SAME
    RemoteTenantBusy the native client raises."""
    from antidote_tpu_torch.proto import apb

    # grammar round-trip first (no server)
    text = apb.error_text("tenant_busy", "lane full", 75, tenant="gold")
    out = apb.parse_error_text(text)
    assert out["kind"] == "tenant_busy" and out["tenant"] == "gold"
    assert out["retry_after_ms"] == 75 and out["detail"] == "lane full"
    # absent kv stays None (older peers)
    assert apb.parse_error_text(b"busy retry_after_ms=50: x")["tenant"] is None

    node, srv = _mk_server()
    a = AntidoteClient(port=srv.port)
    c = ApbClient(port=srv.port)
    try:
        res = {}
        with node.txm.commit_lock:
            t = threading.Thread(target=lambda: res.update(
                ok=a.update_objects(
                    [("k", "counter_pn", "gold/b", ("increment", 1))])))
            t.start()
            deadline = time.monotonic() + 10
            while srv.admission.tenant_in_flight("gold") < 1:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            with pytest.raises(RemoteTenantBusy) as e:
                c.update_objects(
                    [("k2", "counter_pn", "gold/b", ("increment", 1))])
            assert e.value.tenant == "gold"
            assert e.value.retry_after_ms >= 25
        t.join(timeout=30)
        assert "ok" in res
    finally:
        a.close()
        c.close()
        srv.close()


def test_tenant_shed_metrics_stay_bounded_and_labeled():
    """Refusals land in the tenant-labeled shed counter under the
    clamped label set, and the global shed counter distinguishes the
    tenant plane from server_queue/admission."""
    node, srv = _mk_server()
    a = AntidoteClient(port=srv.port)
    b = AntidoteClient(port=srv.port)
    try:
        m = node.metrics
        with node.txm.commit_lock:
            t = threading.Thread(target=lambda: a.update_objects(
                [("k", "counter_pn", "gold/b", ("increment", 1))]))
            t.start()
            deadline = time.monotonic() + 10
            while srv.admission.tenant_in_flight("gold") < 1:
                assert time.monotonic() < deadline
                time.sleep(0.005)
            with pytest.raises(RemoteTenantBusy):
                b.update_objects(
                    [("k2", "counter_pn", "gold/b", ("increment", 1))])
        t.join(timeout=30)
        assert m.tenant_shed.value(tenant="gold", plane="admission") >= 1
        assert m.shed.value(plane="tenant") >= 1
        # request latency observed per (clamped) tenant
        assert ("gold",) in m.tenant_request_seconds._children
    finally:
        a.close()
        b.close()
        srv.close()


# ---------------------------------------------------------------------------
# Part C — the manager's round split against the JAX manager's
# ---------------------------------------------------------------------------
def test_tenant_rounds_split_equals_the_jax_manager():
    from antidote_tpu.api.node import AntidoteNode as JNode
    from antidote_tpu.config import AntidoteConfig as JConfig
    from antidote_tpu.tenancy import TenantRegistry as JRegistry

    flags = ["gold:3,max_in_flight=8", "bronze:1"]
    kw = dict(n_shards=2, max_dcs=2, keys_per_table=64)
    jn = JNode(JConfig(**kw))
    tn = AntidoteNode(AntidoteConfig(**kw))
    jn.txm.tenants = JRegistry.from_flags(flags)
    tn.txm.tenants = TenantRegistry.from_flags(flags)
    # a mixed group: a gold storm, a few bronze writes, default ones and
    # an unregistered prefix (the default lane)
    buckets = (["gold/b"] * 9 + ["bronze/b"] * 3 + ["b"] * 4
               + ["other/b"] * 2)
    order = [int(i) for i in np.random.default_rng(5).permutation(
        len(buckets))]
    groups = {}
    for name, node in (("jax", jn), ("torch", tn)):
        txns = []
        for i in order:
            t = node.txm.start_transaction()
            node.txm.update_objects(
                [(f"k{i}", "counter_pn", buckets[i], ("increment", 1))], t)
            txns.append(t)
        rounds = node.txm._tenant_rounds(txns)
        pos = {id(t): j for j, t in enumerate(txns)}
        groups[name] = [[pos[id(t)] for t in r] for r in rounds]
        outs = node.txm.commit_transactions_group(txns)
        assert all(not isinstance(o, Exception) for o in outs)
    assert groups["torch"] == groups["jax"]
    assert len(groups["torch"]) > 1
    # the values after the rounds are the same too
    objs = [(f"k{i}", "counter_pn", buckets[i]) for i in order]
    assert tn.read_objects(objs)[0] == jn.read_objects(objs)[0] == [1] * len(
        objs)
