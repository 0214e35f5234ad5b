"""Inter-DC replication of the port on a loopback fabric, and across the
two packages.

The ten cases of ``tests/test_interdc.py`` on port nodes (``device="cpu"``):
replication, multi-shard transactions, causality across three DCs, the
causal gate with a ping-revealed gap, catch-up after message loss,
convergence of concurrent writes and counters, heartbeats advancing the
stable snapshot, atomicity and last-writer-wins.  Then the cross-package
cases: one seeded transaction stream replicated into three JAX DCs and
three port DCs gives equal values for every key, under ClockSI and under
GentleRain (equal snapshots step for step); a seeded GentleRain
``counter_b`` stream gives equal refusals, rights requests, grants and
escrow odometers, with batched and with per-key asks; equal messages
encode to equal bytes, and a port DC and a JAX DC replicate to each other
over ``TcpFabric``.  Tolerance: exact equality of every value and every
byte.
"""

from __future__ import annotations

import numpy as np
import pytest

from antidote_tpu.api import AntidoteNode as JNode
from antidote_tpu.config import AntidoteConfig as JConfig
from antidote_tpu.interdc import DCReplica as JReplica
from antidote_tpu.interdc import LoopbackHub as JHub
from antidote_tpu.interdc.messages import TxnMessage as JMsg
from antidote_tpu.interdc.tcp import TcpFabric as JFabric
from antidote_tpu.store.kv import Effect as JEffect
from antidote_tpu_torch.api import AntidoteNode
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.interdc import DCReplica, LoopbackHub
from antidote_tpu_torch.interdc.messages import TxnMessage
from antidote_tpu_torch.interdc.tcp import TcpFabric
from antidote_tpu_torch.store.kv import Effect

KW = dict(n_shards=4, max_dcs=3, ops_per_key=8, snap_versions=2,
          set_slots=8, mv_slots=4, rga_slots=16, keys_per_table=64)


@pytest.fixture
def dcs():
    hub = LoopbackHub()
    nodes = [AntidoteNode(AntidoteConfig(**KW), dc_id=i, device="cpu")
             for i in range(3)]
    reps = [DCReplica(n, hub, f"dc{i}") for i, n in enumerate(nodes)]
    DCReplica.connect_all(reps)
    return hub, nodes, reps


def _join(nodes):
    return np.max(np.stack([n.store.dc_max_vc() for n in nodes]), axis=0)


def test_replication_basic(dcs):
    hub, nodes, reps = dcs
    vc = nodes[0].update_objects([("k", "counter_pn", "b", ("increment", 5))])
    hub.pump()
    for n in nodes[1:]:
        vals, _ = n.read_objects([("k", "counter_pn", "b")], clock=vc)
        assert vals == [5]


def test_replication_multi_shard_txn(dcs):
    hub, nodes, reps = dcs
    ups = [(i, "counter_pn", "b", ("increment", i + 1)) for i in range(10)]
    vc = nodes[0].update_objects(ups)
    hub.pump()
    objs = [(i, "counter_pn", "b") for i in range(10)]
    vals, _ = nodes[2].read_objects(objs, clock=vc)
    assert vals == [i + 1 for i in range(10)]


def test_causality_chain_across_dcs(dcs):
    hub, nodes, reps = dcs
    vc0 = nodes[0].update_objects([("k", "set_aw", "b", ("add", "a"))])
    hub.pump()
    vals, vc1 = nodes[1].read_objects([("k", "set_aw", "b")], clock=vc0)
    assert vals == [["a"]]
    vc2 = nodes[1].update_objects([("k", "set_aw", "b", ("remove", "a"))],
                                  clock=vc1)
    hub.pump()
    vals, _ = nodes[2].read_objects([("k", "set_aw", "b")], clock=vc2)
    assert vals == [[]]


def test_causal_gate_and_ping_revealed_gap(dcs):
    hub, nodes, reps = dcs
    # lose the txn message AND the deferred heartbeat flush of the next
    # pump (whose chain head would reveal the gap at once)
    hub.drop_next(0, 2, n=1 + nodes[0].cfg.n_shards)
    vc0 = nodes[0].update_objects([("x", "counter_pn", "b",
                                    ("increment", 1))])
    hub.pump()
    vc1 = nodes[1].read_objects([("x", "counter_pn", "b")], clock=vc0)[1]
    vc2 = nodes[1].update_objects([("y", "counter_pn", "b",
                                    ("increment", 2))], clock=vc1)
    hub.pump()
    assert nodes[2].store.stable_vc()[0] < vc0[0]
    reps[0].heartbeat()
    hub.pump()
    vals, _ = nodes[2].read_objects(
        [("x", "counter_pn", "b"), ("y", "counter_pn", "b")], clock=vc2)
    assert vals == [1, 2]
    assert reps[2].catchups > 0


def test_message_loss_triggers_catch_up(dcs):
    hub, nodes, reps = dcs
    nodes[0].update_objects([("k", "counter_pn", "b", ("increment", 1))])
    hub.pump()
    hub.drop_next(0, 1, n=nodes[0].cfg.n_shards)
    nodes[0].update_objects([("k", "counter_pn", "b", ("increment", 10))])
    hub.pump()
    vc = nodes[0].update_objects([("k", "counter_pn", "b",
                                   ("increment", 100))])
    hub.pump()
    vals, _ = nodes[1].read_objects([("k", "counter_pn", "b")], clock=vc)
    assert vals == [111]
    assert hub.dropped > 0


def test_concurrent_writes_converge(dcs):
    hub, nodes, reps = dcs
    for i, n in enumerate(nodes):
        n.update_objects([("s", "set_aw", "b", ("add", f"a{i}"))])
    hub.pump()
    target = _join(nodes)
    for n in nodes:
        vals, _ = n.read_objects([("s", "set_aw", "b")], clock=target)
        assert vals == [["a0", "a1", "a2"]]


def test_concurrent_counter_increments_sum(dcs):
    hub, nodes, reps = dcs
    for i, n in enumerate(nodes):
        n.update_objects([("c", "counter_pn", "b", ("increment", 10 ** i))])
    hub.pump()
    target = _join(nodes)
    for n in nodes:
        vals, _ = n.read_objects([("c", "counter_pn", "b")], clock=target)
        assert vals == [111]


def test_stable_snapshot_advances_via_heartbeats(dcs):
    hub, nodes, reps = dcs
    nodes[0].update_objects([("k", "counter_pn", "b", ("increment", 1))])
    hub.pump()
    assert nodes[1].store.stable_vc()[0] >= 1


def test_atomicity_across_dcs(dcs):
    hub, nodes, reps = dcs
    vc = nodes[0].update_objects([
        ("a", "counter_pn", "b", ("increment", 1)),
        ("b", "counter_pn", "b", ("increment", 1)),
    ])
    hub.pump()
    vals, _ = nodes[1].read_objects(
        [("a", "counter_pn", "b"), ("b", "counter_pn", "b")], clock=vc)
    assert vals == [1, 1]


def test_lww_register_across_dcs(dcs):
    hub, nodes, reps = dcs
    nodes[0].update_objects([("r", "register_lww", "b", ("assign", "first"))])
    hub.pump()
    nodes[1].update_objects([("r", "register_lww", "b",
                              ("assign", "second"))])
    hub.pump()
    target = _join(nodes)
    for n in nodes:
        vals, _ = n.read_objects([("r", "register_lww", "b")], clock=target)
        assert vals == ["second"]


# ---------------------------------------------------------------------------
# across the packages
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


def _stream(seed: int, n_txns: int = 48):
    """A seeded stream: (dc, updates, then) per transaction, where
    ``then`` is "pump", ("drop", from, to) or None."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_txns):
        ups = []
        for _ in range(int(rng.integers(1, 4))):
            kind, k = int(rng.integers(4)), int(rng.integers(10))
            if kind == 0:
                ups.append((f"c{k}", "counter_pn", "b",
                            ("increment", int(rng.integers(1, 100)))))
            elif kind == 1:
                ups.append((f"s{k}", "set_aw", "b",
                            ("add", int(rng.integers(40)))))
            elif kind == 2:
                ups.append((f"s{k}", "set_aw", "b",
                            ("remove", int(rng.integers(40)))))
            else:
                ups.append((f"r{k}", "register_lww", "b",
                            ("assign", f"v{t}")))
        r = int(rng.integers(6))
        then = ("pump" if r < 3 else
                ("drop", int(rng.integers(3)), int(rng.integers(3)))
                if r == 3 else None)
        out.append((int(rng.integers(3)), ups, then))
    return out


def _escrow_steps(seed: int, n_steps: int = 120):
    """A seeded GentleRain escrow stream over ``counter_b`` keys: each DC
    increments rights onto its own lane and decrements from it (refused
    when it holds too little, which queues a shortfall), the rights loop
    ticks at DCs, the loop's clock moves across the grace period, and
    DCs heartbeat, pump, lose messages and read at their snapshots."""
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(n_steps):
        r, dc = int(rng.integers(12)), int(rng.integers(3))
        k = f"e{int(rng.integers(4))}"
        if r < 2:
            steps.append(("txn", dc, [(k, "counter_b", "b",
                                       ("increment",
                                        (int(rng.integers(1, 20)), dc)))]))
        elif r < 5:
            steps.append(("txn", dc, [(k, "counter_b", "b",
                                       ("decrement",
                                        (int(rng.integers(1, 25)), dc)))]))
        elif r < 7:
            steps.append(("tick", dc))
        elif r == 7:
            steps.append(("clock", float(rng.choice([0.25, 0.6, 1.5]))))
        elif r == 8:
            steps.append(("pump",))
        elif r == 9:
            steps.append(("hb", dc))
        elif r == 10:
            steps.append(("drop", dc, (dc + 1 + int(rng.integers(2))) % 3))
        else:
            steps.append(("read", dc, [k]))
    return steps


def _replay(steps, side, monkeypatch, protocol="clocksi",
                  batched=True):
    """Run replay ``steps`` through three DCs of one package (``side`` is
    "jax" or "port"), every bounded-counter clock on one stepped clock.
    Returns a trace (per step: the acting DC's snapshot VC, then the commit
    clock, "refused", the requests a tick sent or the values read), the
    published frames, each DC's escrow odometers and queue, and each DC's
    values of every key after the end's heartbeats: under ClockSI at the
    join of the DCs' clocks, under GentleRain at the DC's own snapshot
    (its GST stays below a lane other DCs wrote more often)."""
    if side == "jax":
        from antidote_tpu.crdt import registers as regs
        from antidote_tpu.meta import MetaDataStore as Meta
        from antidote_tpu.overload import InsufficientRightsError as Refused

        cfg = JConfig(batch_buckets=(16, 64), **KW)
        hub_cls, rep_cls = JHub, JReplica

        def make(i, meta):
            return JNode(cfg, dc_id=i, meta=meta)
    else:
        from antidote_tpu_torch.crdt import registers as regs
        from antidote_tpu_torch.meta import MetaDataStore as Meta
        from antidote_tpu_torch.overload import (
            InsufficientRightsError as Refused)

        hub_cls, rep_cls = LoopbackHub, DCReplica

        def make(i, meta):
            return AntidoteNode(AntidoteConfig(**KW), dc_id=i, meta=meta,
                                device="cpu")
    ticks = iter(range(1_000_000, 2_000_000))
    monkeypatch.setattr(regs, "_now_micros", lambda: next(ticks))
    hub = hub_cls()
    frames = []
    publish = hub.publish

    def record(from_dc, data):
        frames.append((from_dc, bytes(data)))
        publish(from_dc, data)

    hub.publish = record
    nodes = []
    for i in range(3):
        meta = Meta()
        meta.set_env("txn_prot", protocol)
        nodes.append(make(i, meta))
    assert all(n.txm.protocol == protocol for n in nodes)
    reps = [rep_cls(n, hub, f"dc{i}") for i, n in enumerate(nodes)]
    now = [0.0]
    for n, r in zip(nodes, reps):
        # heartbeats on commit counts and pump ticks only: no wall clock
        r.HEARTBEAT_INTERVAL_S = 1e9
        n.txm.bcounters.clock = lambda: now[0]
        if not batched:
            n.txm.bcounters.request_transfer_many = None
    rep_cls.connect_all(reps)
    trace = []
    for step in steps:
        op = step[0]
        if op in ("txn", "read", "tick"):
            trace.append(tuple(int(x)
                               for x in nodes[step[1]].txm._snapshot_vc()))
        if op == "txn":
            try:
                vc = nodes[step[1]].update_objects(step[2])
                trace.append(tuple(int(x) for x in vc))
            except Refused:
                trace.append("refused")
        elif op == "read":
            objs = [(k, "counter_b", "b") for k in step[2]]
            vals, vc = nodes[step[1]].read_objects(objs)
            trace.append((vals, tuple(int(x) for x in vc)))
        elif op == "tick":
            trace.append(reps[step[1]].bcounter_tick())
        elif op == "clock":
            now[0] += step[1]
        elif op == "pump":
            hub.pump()
        elif op == "hb":
            reps[step[1]].heartbeat()
        elif op == "drop":
            hub.drop_next(step[1], step[2], n=2)
    for _ in range(2):
        for r in reps:
            r.heartbeat()
        hub.pump()
    escrow = [(n.txm.bcounters.status(), dict(n.txm.bcounters.pending))
              for n in nodes]
    keys = sorted({(k, t) for s in steps if s[0] == "txn"
                   for k, t, _b, _o in s[2]})
    objs = [(k, t, "b") for k, t in keys]
    target = None
    if protocol == "clocksi":
        target = np.max(np.stack([n.store.dc_max_vc() for n in nodes]),
                        axis=0)
    values = [n.read_objects(objs, clock=target) for n in nodes]
    values = [(v, tuple(int(x) for x in vc)) for v, vc in values]
    return trace, frames, escrow, values


def _stream_steps(stream):
    """The (dc, updates, then) stream of ``_stream`` as replay steps."""
    steps = []
    for dc, ups, then in stream:
        steps.append(("txn", dc, ups))
        if then == "pump":
            steps.append(("pump",))
        elif then is not None and then[1] != then[2]:
            steps.append(("drop", then[1], then[2]))
    return steps


def test_equal_streams_give_equal_stores_in_both_packages(monkeypatch):
    steps = _stream_steps(_stream(11))
    j = _replay(steps, "jax", monkeypatch)
    p = _replay(steps, "port", monkeypatch)
    assert p[0] == j[0]  # snapshots and commit clocks, step for step
    assert p[3][0][0] == p[3][1][0] == p[3][2][0]  # the port's DCs converge
    assert p[3] == j[3]  # and equal the JAX DCs, key for key
    assert len(p[1]) == len(j[1]) and p[1] == j[1]  # every frame, bytewise


def test_gentlerain_streams_give_equal_stores_in_both_packages(monkeypatch):
    """The seeded stream of the ClockSI case under ``txn_prot=gr``: each
    step's scalar GST snapshot, the commit clocks, every frame and every
    DC's values at its GST snapshot are equal in both packages."""
    steps = _stream_steps(_stream(11))
    j = _replay(steps, "jax", monkeypatch, protocol="gr")
    p = _replay(steps, "port", monkeypatch, protocol="gr")
    assert p[0] == j[0]  # snapshots and commit clocks, step for step
    assert p[3] == j[3]  # values at each DC's GST snapshot
    assert len(p[1]) == len(j[1]) and p[1] == j[1]  # every frame, bytewise
    # GentleRain: each snapshot is one scalar on every remote lane
    txn_dcs = [s[1] for s in steps if s[0] == "txn"]
    for dc, snap in zip(txn_dcs, p[0][0::2]):
        assert len({x for i, x in enumerate(snap) if i != dc}) == 1


@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched_asks", "per_key_asks"])
def test_escrow_streams_give_equal_transfers_in_both_packages(
        monkeypatch, batched):
    """A seeded GentleRain ``counter_b`` stream with refusals, rights-loop
    ticks across the grace period, lost messages and reads: the refusals,
    the requests each tick sent (with the refusal-streak factor), the
    grants the granters committed (frames, bytewise), the escrow
    odometers and queues, and every value are equal in both packages."""
    steps = _escrow_steps(23)
    j = _replay(steps, "jax", monkeypatch, protocol="gr",
                      batched=batched)
    p = _replay(steps, "port", monkeypatch, protocol="gr",
                      batched=batched)
    assert p[0] == j[0]  # step for step
    assert p[2] == j[2]  # escrow odometers and queues
    assert p[3] == j[3]  # values
    assert len(p[1]) == len(j[1]) and p[1] == j[1]  # every frame, bytewise
    # the stream reaches every part of the transfer path
    status = [s for s, _pending in p[2]]
    assert sum(s["refused_total"] for s in status) > 0
    assert sum(s["requests_sent_total"] for s in status) > 0
    assert sum(s["grants_arrived_total"] for s in status) > 0
    assert any(isinstance(t, int) and t > 1 for t in p[0])


def test_equal_messages_encode_to_equal_bytes():
    rng = np.random.default_rng(5)
    a = rng.integers(-2**40, 2**40, 6, dtype=np.int64)
    b = rng.integers(-2**20, 2**20, 3, dtype=np.int32)
    common = dict(origin=1, shard=3, prev_opid=7, last_opid=8,
                  commit_vc=np.asarray([4, 9, 0], np.int32),
                  snapshot_vc=np.asarray([4, 0, 0], np.int32), timestamp=9)
    pm = TxnMessage(effects=[Effect(("t", 1), "set_aw", "b", a, b,
                                    [(12345, b"blob")])], **common)
    jm = JMsg(effects=[JEffect(("t", 1), "set_aw", "b", a, b,
                               [(12345, b"blob")])], **common)
    assert pm.to_bytes() == jm.to_bytes()
    # decode either side's bytes with the other package and re-encode
    assert TxnMessage.from_bytes(jm.to_bytes()).to_bytes() == jm.to_bytes()
    assert JMsg.from_bytes(pm.to_bytes()).to_bytes() == pm.to_bytes()
    ping = dict(common, commit_vc=np.zeros(3, np.int32),
                snapshot_vc=np.zeros(3, np.int32))
    assert (TxnMessage(effects=[], owner=2, oepoch=5, **ping).to_bytes()
            == JMsg(effects=[], owner=2, oepoch=5, **ping).to_bytes())


def _pump_both(fabrics, rounds=6):
    for _ in range(rounds):
        if sum(f.pump(timeout=0.2) for f in fabrics) == 0:
            return


def test_port_dc_and_jax_dc_replicate_over_tcp(jax_pump):
    cfg_kw = dict(KW, max_dcs=2)
    jf, pf = JFabric(), TcpFabric()
    try:
        jn = JNode(JConfig(batch_buckets=(16, 64), **cfg_kw), dc_id=0)
        pn = AntidoteNode(AntidoteConfig(**cfg_kw), dc_id=1, device="cpu")
        jr, pr = JReplica(jn, jf, "dc0"), DCReplica(pn, pf, "dc1")
        assert jf._np is not None and pf._np is not None  # native pumps
        # bootstrap from wire descriptors, as connect_to_dcs does
        jr.observe_descriptor(pr.descriptor().to_wire())
        pr.observe_descriptor(jr.descriptor().to_wire())
        vc0 = jn.update_objects([("x", "set_aw", "b", ("add", "from-jax")),
                                 ("c", "counter_pn", "b", ("increment", 3))])
        _pump_both([jf, pf])
        vals, vc1 = pn.read_objects([("x", "set_aw", "b"),
                                     ("c", "counter_pn", "b")], clock=vc0)
        assert vals == [["from-jax"], 3]
        vc2 = pn.update_objects([("x", "set_aw", "b", ("add", "from-port")),
                                 ("c", "counter_pn", "b", ("increment", 4))],
                                clock=vc1)
        _pump_both([jf, pf])
        vals, _ = jn.read_objects([("x", "set_aw", "b"),
                                   ("c", "counter_pn", "b")], clock=vc2)
        assert vals == [["from-jax", "from-port"], 7]
    finally:
        jf.close()
        pf.close()


def test_read_never_sees_part_of_a_remote_transaction():
    """A remote transaction applies on the pump's thread, writing the
    tables in place; a head's state fields land before its clock.  A read
    beside that window would gather the new head as "fresh" for a key of
    one table while a key of another table still reads old: half a
    transaction.  With a replica attached, reads hold the commit lock the
    drain holds, so this read waits and sees neither or both."""
    import threading

    hub = LoopbackHub()
    nodes = [AntidoteNode(AntidoteConfig(**KW), dc_id=i, device="cpu")
             for i in range(2)]
    reps = [DCReplica(n, hub) for n in nodes]
    DCReplica.connect_all(reps)
    objs = [("a", "counter_pn", "b"), ("s", "set_aw", "b")]
    # bind both keys at DC1 before the remote transaction arrives
    nodes[1].store.locate_many(objs)
    table = nodes[1].store.table(nodes[1].store.directory[("a", "b")][0])
    reached, go = threading.Event(), threading.Event()
    orig = table._head_update

    class _PausedClock:
        """The head clock tensor, pausing the one write of it."""

        def __init__(self, t):
            self.t = t

        def __getitem__(self, k):
            return self.t[k]

        def __setitem__(self, k, v):
            reached.set()
            assert go.wait(10)
            self.t[k] = v

    def paused(*a):
        real = table.head_vc
        table.head_vc = _PausedClock(real)
        try:
            return orig(*a)
        finally:
            table.head_vc = real

    table._head_update = paused
    nodes[0].update_objects([("a", "counter_pn", "b", ("increment", 1)),
                             ("s", "set_aw", "b", ("add", "x"))])
    drain = threading.Thread(target=hub.pump)
    drain.start()
    assert reached.wait(10)
    seen = []
    reader = threading.Thread(
        target=lambda: seen.append(nodes[1].read_objects(objs)[0]))
    reader.start()
    reader.join(0.5)  # a read beside the window returns inside it
    go.set()
    drain.join(10)
    reader.join(10)
    assert not drain.is_alive() and not reader.is_alive()
    assert seen[0] in ([0, []], [1, ["x"]])


def test_gated_transaction_applies_when_the_own_lane_rises(dcs):
    """A remote transaction whose snapshot depends on this DC's own lane
    on a shard no local commit has touched waits in the causal gate.  The
    local commit (or heartbeat) that raises the lane drains the gate at
    once; it does not wait for the next message of some chain."""
    hub, nodes, reps = dcs
    for r in reps:
        r.HEARTBEAT_INTERVAL_S = 1e9
    n0 = nodes[0]
    vc1 = nodes[1].update_objects([("g", "counter_pn", "b",
                                    ("increment", 5))])
    shard = n0.store.locate("g", "counter_pn", "b")[1]
    msgs = [(cb, data) for to, cb, data in hub.queues if to == 0]
    hub.queues.clear()
    raw = TxnMessage.from_bytes(msgs[0][1])
    assert raw.shard == shard and not raw.is_ping
    raw.snapshot_vc = raw.snapshot_vc.copy()
    raw.snapshot_vc[0] = 1  # it saw DC0's first commit
    reps[0]._on_message(raw.to_bytes())
    assert sum(len(q) for q in reps[0].gate.values()) == 1  # gated
    # DC0's first commit, on the same shard: its own lane there rises
    k = next(f"k{i}" for i in range(1000)
             if n0.store.locate(f"k{i}", "counter_pn", "b")[1] == shard)
    n0.update_objects([(k, "counter_pn", "b", ("increment", 1))])
    assert sum(len(q) for q in reps[0].gate.values()) == 0
    assert int(n0.store.applied_vc[shard, 1]) == int(vc1[1])
    txn = n0.start_transaction()
    txn.snapshot_vc = np.asarray(n0.store.applied_vc[shard], np.int32)
    assert n0.read_objects([("g", "counter_pn", "b")], txn) == [5]
    n0.abort_transaction(txn)


def test_apply_remote_equals_the_jax_manager():
    """``TransactionManager.apply_remote`` of the same remote effects (a
    transaction of another DC) gives both packages' nodes the same values
    at the remote commit clock."""
    jn = JNode(JConfig(batch_buckets=(16, 64), **KW), dc_id=0)
    pn = AntidoteNode(AntidoteConfig(**KW), dc_id=0, device="cpu")
    src = [JNode(JConfig(batch_buckets=(16, 64), **KW), dc_id=1),
           AntidoteNode(AntidoteConfig(**KW), dc_id=1, device="cpu")]
    ups = [("c", "counter_pn", "b", ("increment", 7)),
           ("s", "set_aw", "b", ("add", "x")),
           ("s", "set_aw", "b", ("add", "y"))]
    got = []
    for dst, origin in ((jn, src[0]), (pn, src[1])):
        txn = origin.txm.start_transaction()
        origin.txm.update_objects(ups, txn)
        effects = [e for e, _ in txn.writeset]
        vc = np.asarray(origin.txm.commit_transaction(txn), np.int32)
        dst.txm.apply_remote(effects, vc, 1)
        t = dst.txm.start_transaction()
        t.snapshot_vc = vc.copy()
        got.append(dst.txm.read_objects([("c", "counter_pn", "b"),
                                         ("s", "set_aw", "b")], t))
    assert got[0] == got[1] == [7, ["x", "y"]]
