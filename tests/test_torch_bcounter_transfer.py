"""Bounded-counter rights transfers between the port's DCs.

The transfer cases of ``tests/test_bcounter.py`` on port nodes
(``device="cpu"``) over the loopback hub: the requester loop moves rights
from richer DCs, grace-period throttling, a broke granter refuses, lane
and rights checks on decrements and client transfers, queue retirement,
concurrent decrements that never go negative, refusal streaks scaling
the hint and the rebalancing ask, pruning and status, rights
conservation under seeded interleavings, and the batched round trip.
Tolerance: exact values.
"""

import pytest

from antidote_tpu_torch.api import AntidoteNode
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.interdc import DCReplica, LoopbackHub
from antidote_tpu_torch.overload import InsufficientRightsError
from antidote_tpu_torch.txn.manager import AbortError


@pytest.fixture
def cfg():
    return AntidoteConfig(
        n_shards=2, max_dcs=3, ops_per_key=8, snap_versions=2,
        set_slots=4, keys_per_table=16,
    )


@pytest.fixture
def dcs(cfg):
    hub = LoopbackHub()
    nodes = [AntidoteNode(cfg, dc_id=i, device="cpu") for i in range(3)]
    reps = [DCReplica(n, hub, f"dc{i}") for i, n in enumerate(nodes)]
    DCReplica.connect_all(reps)
    return hub, nodes, reps


def test_transfer_loop_moves_rights_between_dcs(dcs):
    """DC1 cannot decrement until DC0 grants rights via the query channel
    (the new_dc / transfer flow of bcountermgr_SUITE)."""
    hub, nodes, reps = dcs
    vc = nodes[0].update_objects([("c", "counter_b", "b", ("increment", (10, 0)))])
    hub.pump()
    # DC1 sees the value but holds no rights
    vals, _ = nodes[1].read_objects([("c", "counter_b", "b")], clock=vc)
    assert vals[0] == 10
    with pytest.raises(InsufficientRightsError):
        nodes[1].update_objects([("c", "counter_b", "b", ("decrement", (4, 1)))])
    # transfer loop: DC1 asks DC0 (the richest lane); DC0 commits a
    # transfer; replication delivers it back to DC1
    sent = reps[1].bcounter_tick()
    assert sent == 1
    hub.pump()
    nodes[1].update_objects([("c", "counter_b", "b", ("decrement", (4, 1)))])
    hub.pump()
    for n in nodes:
        vals, _ = n.read_objects([("c", "counter_b", "b")],
                                 clock=nodes[1].txm.store.dc_max_vc())
        assert vals[0] == 6
    assert nodes[1].txm.bcounters.pending == {}


def test_transfer_request_throttled_by_grace_period(dcs):
    hub, nodes, reps = dcs
    t = [0.0]
    nodes[1].txm.bcounters.clock = lambda: t[0]
    nodes[0].update_objects([("c", "counter_b", "b", ("increment", (10, 0)))])
    hub.pump()
    with pytest.raises(InsufficientRightsError):
        nodes[1].update_objects([("c", "counter_b", "b", ("decrement", (20, 1)))])
    # drop the granted transfer so the shortfall persists
    hub.drop_next(0, 1, n=10)
    assert reps[1].bcounter_tick() == 1
    hub.pump()
    # same instant: throttled, no second request
    with pytest.raises(InsufficientRightsError):
        nodes[1].update_objects([("c", "counter_b", "b", ("decrement", (20, 1)))])
    assert reps[1].bcounter_tick() == 0
    # after the grace period the request is retried
    t[0] += 2.0
    assert reps[1].bcounter_tick() >= 1


def test_granter_refuses_when_broke(dcs):
    hub, nodes, reps = dcs
    nodes[0].update_objects([("c", "counter_b", "b", ("increment", (2, 0)))])
    hub.pump()
    granted = nodes[0].txm.bcounters.process_transfer(
        nodes[0].txm, "c", "b", 5, 1
    )
    assert granted == 2  # grants only what it holds
    granted = nodes[2].txm.bcounters.process_transfer(
        nodes[2].txm, "c", "b", 5, 1
    )
    assert granted == 0  # DC2 holds nothing


def test_foreign_lane_decrement_rejected(dcs):
    """A decrement naming another replica's lane would spend rights this
    replica does not own — must abort even if that lane is rich."""
    hub, nodes, _ = dcs
    vc = nodes[0].update_objects([("c", "counter_b", "b", ("increment", (9, 0)))])
    hub.pump()
    with pytest.raises(AbortError, match="lane"):
        nodes[1].update_objects(
            [("c", "counter_b", "b", ("decrement", (1, 0)))], clock=vc
        )


def test_client_transfer_requires_local_rights(dcs):
    """A client-issued transfer must originate at the owning replica and
    be covered by its rights — otherwise DC1 could steal DC0's escrow."""
    hub, nodes, _ = dcs
    vc = nodes[0].update_objects([("c", "counter_b", "b", ("increment", (5, 0)))])
    hub.pump()
    # theft attempt: DC1 names DC0 as the source
    with pytest.raises(AbortError, match="lane"):
        nodes[1].update_objects(
            [("c", "counter_b", "b", ("transfer", (5, 1, 0)))], clock=vc
        )
    # over-transfer from own (empty) lane
    with pytest.raises(InsufficientRightsError, match="insufficient rights"):
        nodes[1].update_objects(
            [("c", "counter_b", "b", ("transfer", (1, 0, 1)))], clock=vc
        )
    # legitimate transfer from the owner works
    nodes[0].update_objects([("c", "counter_b", "b", ("transfer", (2, 1, 0)))])
    hub.pump()
    nodes[1].update_objects([("c", "counter_b", "b", ("decrement", (2, 1)))])


def test_transfer_queue_retires_when_rights_arrive(dcs):
    """Once grants land, the tick drops the queue entry instead of
    re-requesting forever (abandoned-client scenario)."""
    hub, nodes, reps = dcs
    nodes[0].update_objects([("c", "counter_b", "b", ("increment", (10, 0)))])
    hub.pump()
    with pytest.raises(InsufficientRightsError):
        nodes[1].update_objects([("c", "counter_b", "b", ("decrement", (4, 1)))])
    assert reps[1].bcounter_tick() == 1   # request sent, grant replicates
    hub.pump()
    # client never retries; the next tick sees the rights and retires the
    # entry without another request
    assert reps[1].bcounter_tick() == 0
    assert nodes[1].txm.bcounters.pending == {}


def test_concurrent_decrements_never_go_negative(dcs):
    """Escrow safety: both DCs decrement concurrently from their own
    rights; the merged value stays ≥ 0."""
    hub, nodes, reps = dcs
    vc = nodes[0].update_objects([
        ("c", "counter_b", "b", ("increment", (6, 0))),
        ("c", "counter_b", "b", ("transfer", (3, 1, 0))),
    ])
    hub.pump()
    nodes[0].update_objects([("c", "counter_b", "b", ("decrement", (3, 0)))])
    nodes[1].update_objects([("c", "counter_b", "b", ("decrement", (3, 1)))],
                            clock=vc)
    hub.pump()
    for n in nodes:
        vals, _ = n.read_objects([("c", "counter_b", "b")],
                                 clock=n.txm.store.dc_max_vc())
        assert vals[0] == 0
    # both replicas are now dry: further decrements refuse everywhere
    for i in (0, 1):
        with pytest.raises(InsufficientRightsError):
            nodes[i].update_objects(
                [("c", "counter_b", "b", ("decrement", (1, i)))]
            )


def test_refusal_streak_scales_hint_and_rebalance(dcs):
    """Repeated refusals on the same key build a streak: the retry hint
    grows with it and the transfer loop over-asks (proactive rebalance)
    once the streak crosses the threshold."""
    from antidote_tpu_torch.txn import bcounter as bc
    hub, nodes, reps = dcs
    nodes[0].update_objects([("c", "counter_b", "b", ("increment", (100, 0)))])
    hub.pump()
    mgr = nodes[1].txm.bcounters
    base = int(bc.TRANSFER_FREQ * 1e3)
    for streak in (1, 2, 3):
        with pytest.raises(InsufficientRightsError) as ei:
            nodes[1].update_objects(
                [("c", "counter_b", "b", ("decrement", (5, 1)))]
            )
        assert ei.value.retry_after_ms == min(
            bc.HINT_CAP_MS, base * (1 + streak)
        )
    # streak 3 >= REBALANCE_STREAK: the request over-asks by the factor
    # (exercise the per-key fallback; the batched twin has its own test)
    captured = []
    mgr.request_transfer_many = None
    mgr.request_transfer = lambda dc, key, bucket, n: captured.append(n)
    reps[1].bcounter_tick()
    assert captured == [5 * min(bc.REBALANCE_MAX_FACTOR, 3)]
    assert mgr.refused_total == 3
    assert mgr.requests_sent_total == 1


def test_refusal_state_prunes_and_status(dcs):
    """_last_request and stale streaks are pruned each tick; status()
    reports the live escrow picture (bounded observability)."""
    from antidote_tpu_torch.txn import bcounter as bc
    hub, nodes, reps = dcs
    t = [0.0]
    mgr = nodes[1].txm.bcounters
    mgr.clock = lambda: t[0]
    nodes[0].update_objects([("c", "counter_b", "b", ("increment", (10, 0)))])
    hub.pump()
    with pytest.raises(InsufficientRightsError):
        nodes[1].update_objects([("c", "counter_b", "b", ("decrement", (4, 1)))])
    st = mgr.status()
    assert st["pending_keys"] == 1 and st["shortfall"] == 4
    assert st["refused_total"] == 1
    assert reps[1].bcounter_tick() == 1
    assert (("c", "b"), 0) in mgr._last_request
    hub.pump()
    # grant landed: the next tick retires the entry and its streak
    assert reps[1].bcounter_tick() == 0
    assert mgr.pending == {} and mgr._refusals == {}
    # throttle entries older than the grace period are pruned
    t[0] += bc.GRACE_PERIOD + 0.1
    reps[1].bcounter_tick()
    assert mgr._last_request == {}
    assert mgr.status()["shortfall"] == 0


def test_rights_conservation_under_seeded_interleavings(dcs):
    """Property: across seeded transfer/decrement interleavings the
    global invariant holds at every converged point — value equals total
    increments minus total successful decrements, never negative, and
    rights are conserved (transfers move, never mint)."""
    import random

    hub, nodes, reps = dcs
    for seed in (1, 7, 42):
        rng = random.Random(seed)
        key = f"inv{seed}"
        total = 60
        nodes[0].update_objects(
            [("c", "counter_b", key, ("increment", (total, 0)))]
        )
        hub.pump()
        sold = 0
        for step in range(30):
            dc = rng.randrange(2)
            n = rng.randint(1, 5)
            action = rng.random()
            try:
                if action < 0.6:
                    nodes[dc].update_objects(
                        [("c", "counter_b", key, ("decrement", (n, dc)))]
                    )
                    sold += n
                else:
                    to = 1 - dc
                    nodes[dc].update_objects(
                        [("c", "counter_b", key, ("transfer", (n, to, dc)))]
                    )
            except InsufficientRightsError:
                pass
            if rng.random() < 0.3:
                hub.pump()
                for r in reps:
                    r.bcounter_tick()
        hub.pump()
        for r in reps:
            r.bcounter_tick()
        hub.pump()
        assert sold <= total
        vc = nodes[0].txm.store.dc_max_vc()
        for n_ in nodes:
            vals, _ = n_.read_objects([("c", "counter_b", key)], clock=vc)
            assert vals[0] == total - sold
            assert vals[0] >= 0
        # conservation: transfers move rights, never mint — the per-lane
        # holdings always sum to the value, and the mint total (diagonal)
        # never changes
        import numpy as np

        from antidote_tpu_torch.crdt import get_type

        ty = get_type("counter_b")
        st = nodes[0].txm.store.read_states([("c", "counter_b", key)], vc)[0]
        d = np.asarray(st["used"]).shape[0]
        assert sum(ty.local_rights(st, dc) for dc in range(d)) == total - sold
        assert int(np.trace(np.asarray(st["rights"]))) == total
        assert all(ty.local_rights(st, dc) >= 0 for dc in range(d))


def test_transfer_requests_batch_into_one_round_trip(dcs):
    """Many shortfall keys aimed at the same
    granter ride ONE ``bcounter_many`` query-channel round trip.  The
    throttle is stamped at accumulation time, so batching changes the
    FRAMING, not the retry contract — a second tick in the same grace
    period sends nothing."""
    hub, nodes, reps = dcs
    t = [0.0]
    mgr = nodes[1].txm.bcounters
    mgr.clock = lambda: t[0]
    for k in ("c1", "c2", "c3"):
        nodes[0].update_objects(
            [(k, "counter_b", "b", ("increment", (10, 0)))])
    hub.pump()
    for k in ("c1", "c2", "c3"):
        with pytest.raises(InsufficientRightsError):
            nodes[1].update_objects(
                [(k, "counter_b", "b", ("decrement", (4, 1)))])
    assert len(mgr.pending) == 3
    captured = []
    mgr.request_transfer_many = (
        lambda dc, entries: captured.append((dc, list(entries))))
    assert reps[1].bcounter_tick() == 3  # per-ask accounting unchanged
    # one call, one target DC, all three asks inside
    assert len(captured) == 1
    dc, entries = captured[0]
    assert dc == 0
    assert sorted(k for k, _b, _n in entries) == ["c1", "c2", "c3"]
    assert all(b == "b" and n == 4 for _k, b, n in entries)
    assert mgr.requests_sent_total == 3
    # same instant: every ask is inside its grace period — no frame
    assert reps[1].bcounter_tick() == 0
    assert captured == [(dc, entries)]
    # after the grace period the batch is re-framed
    t[0] += 2.0
    assert reps[1].bcounter_tick() == 3
    assert len(captured) == 2


def test_batched_transfer_grants_end_to_end(dcs):
    """The ``bcounter_many`` frame round-trips over the real query
    channel: one request carries three shortfalls, the granter commits
    three transfers, replication delivers the rights, and the blocked
    decrements succeed."""
    hub, nodes, reps = dcs
    calls = []
    orig = hub.request

    def counting(target_dc, kind, payload):
        calls.append(kind)
        return orig(target_dc, kind, payload)

    hub.request = counting
    for k in ("c1", "c2", "c3"):
        nodes[0].update_objects(
            [(k, "counter_b", "b", ("increment", (10, 0)))])
    hub.pump()
    for k in ("c1", "c2", "c3"):
        with pytest.raises(InsufficientRightsError):
            nodes[1].update_objects(
                [(k, "counter_b", "b", ("decrement", (4, 1)))])
    assert reps[1].bcounter_tick() == 3
    assert calls == ["bcounter_many"]  # ONE round trip for all three
    hub.pump()
    for k in ("c1", "c2", "c3"):
        nodes[1].update_objects(
            [(k, "counter_b", "b", ("decrement", (4, 1)))])
    hub.pump()
    vc = nodes[1].txm.store.dc_max_vc()
    for k in ("c1", "c2", "c3"):
        vals, _ = nodes[0].read_objects([(k, "counter_b", "b")], clock=vc)
        assert vals[0] == 6
    assert nodes[1].txm.bcounters.pending == {}
