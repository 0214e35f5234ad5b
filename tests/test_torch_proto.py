"""The port's wire protocol over real TCP sockets, on the CPU.

Counterparts of ``tests/test_proto.py`` (the analogue of the reference's
``pb_client_SUITE``: per-CRDT coverage through the client, interactive
transactions, abort, error replies, causal-clock chaining, the static
batch gate, group-commit abort isolation) and ``tests/test_pipeline.py``
(lock-split epoch reads, the hot-key snapshot cache, bounded publication
cost, the staged server), against a port server over a ``device="cpu"``
node.  Then the same wire across the packages: one seeded script of
frames in both dialects through a JAX server and a port server, every
reply frame byte-equal; every typed refusal reaching the clients of
either package; and each package's clients against the other's server.
"""

from __future__ import annotations

import itertools
import socket
import struct
import threading
import time

import numpy as np
import pytest

from antidote_tpu import overload as j_overload
from antidote_tpu.api.node import AntidoteNode as JNode
from antidote_tpu.config import AntidoteConfig as JConfig
from antidote_tpu.proto import client as j_client
from antidote_tpu.proto.server import ProtocolServer as JServer
from antidote_tpu.txn.manager import AbortError as JAbortError
from antidote_tpu.txn.manager import Transaction as JTransaction
from antidote_tpu_torch import overload as t_overload
from antidote_tpu_torch.api.node import AntidoteNode as _Node
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.proto import apb
from antidote_tpu_torch.proto import client as t_client
from antidote_tpu_torch.proto.client import (AntidoteClient, RemoteAbort,
                                             RemoteError)
from antidote_tpu_torch.proto.codec import (MessageCode, decode, encode,
                                            read_frame_buffered)
from antidote_tpu_torch.proto.server import ProtocolServer
from antidote_tpu_torch.txn.manager import AbortError, Transaction


def AntidoteNode(*a, **kw):
    """The port's node on the CPU."""
    kw.setdefault("device", "cpu")
    return _Node(*a, **kw)


@pytest.fixture(scope="module")
def server():
    cfg = AntidoteConfig(
        n_shards=2, max_dcs=2, ops_per_key=8, snap_versions=2,
        set_slots=8, rga_slots=16, keys_per_table=64,
    )
    node = AntidoteNode(cfg)
    srv = ProtocolServer(node, port=0)
    yield srv
    srv.close()


@pytest.fixture()
def client(server):
    c = AntidoteClient(port=server.port)
    yield c
    c.close()


def test_static_counter_roundtrip(client):
    clock = client.update_objects([("pbc", "counter_pn", "b", ("increment", 4))])
    vals, _ = client.read_objects([("pbc", "counter_pn", "b")], clock=clock)
    assert vals[0] == 4


def test_interactive_txn(client):
    txn = client.start_transaction()
    txn.update_objects([("pbi", "counter_pn", "b", ("increment", 2))])
    # read-your-writes inside the txn
    assert txn.read_objects([("pbi", "counter_pn", "b")])[0] == 2
    clock = txn.commit()
    vals, _ = client.read_objects([("pbi", "counter_pn", "b")], clock=clock)
    assert vals[0] == 2


def test_abort_discards_writes(client):
    txn = client.start_transaction()
    txn.update_objects([("pba", "counter_pn", "b", ("increment", 9))])
    txn.abort()
    vals, _ = client.read_objects([("pba", "counter_pn", "b")])
    assert vals[0] == 0


def test_per_crdt_coverage(client):
    clock = client.update_objects([
        ("s", "set_aw", "b", ("add", 7)),
        ("s", "set_aw", "b", ("add", 9)),
        ("r", "register_lww", "b", ("assign", "hello")),
        ("mv", "register_mv", "b", ("assign", 5)),
        ("f", "flag_ew", "b", ("enable", None)),
        ("seq", "rga", "b", ("add_right", (0, "x"))),
    ])
    vals, _ = client.read_objects(
        [("s", "set_aw", "b"), ("r", "register_lww", "b"),
         ("mv", "register_mv", "b"), ("f", "flag_ew", "b"),
         ("seq", "rga", "b")],
        clock=clock,
    )
    assert sorted(vals[0]) == [7, 9]
    assert vals[1] == "hello"
    assert vals[2] == [5]
    assert vals[3] is True
    assert vals[4] == ["x"]


def test_map_rr_over_wire(client):
    clock = client.update_objects([
        ("m", "map_rr", "b",
         ("update", [(("cnt", "counter_pn"), ("increment", 3)),
                     (("who", "register_lww"), ("assign", "ada"))])),
    ])
    vals, _ = client.read_objects([("m", "map_rr", "b")], clock=clock)
    assert vals[0][("cnt", "counter_pn")] == 3
    assert vals[0][("who", "register_lww")] == "ada"


def test_certification_conflict_is_remote_abort(client):
    # read-bearing txns: blind increments would take the
    # commutativity bypass and both commit (see next test)
    t1 = client.start_transaction()
    t2 = client.start_transaction()
    t1.read_objects([("cert", "counter_pn", "b")])
    t2.read_objects([("cert", "counter_pn", "b")])
    t1.update_objects([("cert", "counter_pn", "b", ("increment", 1))])
    t2.update_objects([("cert", "counter_pn", "b", ("increment", 1))])
    t1.commit()
    with pytest.raises(RemoteAbort):
        t2.commit()


def test_blind_interactive_commits_merge_without_conflict(client):
    """Interactive BLIND commits ride the locked worker's merge point
    and the commutativity bypass: concurrent increments to one hot key
    all land (no first-committer aborts), and the value adds up."""
    t1 = client.start_transaction()
    t2 = client.start_transaction()
    t1.update_objects([("blind", "counter_pn", "b", ("increment", 2))])
    t2.update_objects([("blind", "counter_pn", "b", ("increment", 3))])
    t1.commit()
    t2.commit()
    vals, _ = client.read_objects([("blind", "counter_pn", "b")])
    assert vals[0] == 5


def test_error_reply_keeps_connection(client):
    with pytest.raises(RemoteError):
        client.update_objects([("x", "no_such_type", "b", ("inc", 1))])
    # connection still usable
    clock = client.update_objects([("x2", "counter_pn", "b", ("increment", 1))])
    vals, _ = client.read_objects([("x2", "counter_pn", "b")], clock=clock)
    assert vals[0] == 1


def test_unknown_txid_is_error(client):
    with pytest.raises(RemoteError):
        client._call_unknown_commit()


# minimal helper used above — keeps the client API surface clean
def _call_unknown_commit(self):
    return self._call(MessageCode.COMMIT_TRANSACTION, {"txid": 10**9})


AntidoteClient._call_unknown_commit = _call_unknown_commit


def test_concurrent_clients(server):
    """Many clients hammer the acceptor pool concurrently; every increment
    must land exactly once (the dispatcher serializes the commit stream)."""
    n_clients, n_ops = 8, 10
    errs = []

    def work(i):
        try:
            c = AntidoteClient(port=server.port)
            for _ in range(n_ops):
                c.update_objects([("conc", "counter_pn", "b", ("increment", 1))])
            c.close()
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs
    c = AntidoteClient(port=server.port)
    vals, _ = c.read_objects([("conc", "counter_pn", "b")])
    c.close()
    assert vals[0] == n_clients * n_ops


# ---------------------------------------------------------------------------
# cross-connection static batch gate
# ---------------------------------------------------------------------------
def test_static_batch_concurrent_reads_and_updates():

    cfg = AntidoteConfig(n_shards=4, max_dcs=2, keys_per_table=64)
    node = AntidoteNode(cfg)
    srv = ProtocolServer(node, port=0)
    assert srv.batch_static
    try:
        n_cli, per = 8, 12
        errs = []

        def worker(i):
            try:
                c = AntidoteClient(srv.host, srv.port)
                for j in range(per):
                    c.update_objects([(i * 1000 + j, "counter_pn", "b",
                                       ("increment", 1))])
                    vals, _vc = c.read_objects(
                        [(i * 1000 + j, "counter_pn", "b")])
                    assert vals[0] == 1, vals
                c.close()
            except Exception as e:  # pragma: no cover
                errs.append(repr(e))

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(n_cli)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errs, errs
        # all writes landed: a single merged read sees every counter
        c = AntidoteClient(srv.host, srv.port)
        objs = [(i * 1000 + j, "counter_pn", "b")
                for i in range(n_cli) for j in range(per)]
        vals, _vc = c.read_objects(objs)
        assert all(v == 1 for v in vals)
        c.close()
    finally:
        srv.close()


def test_group_commit_abort_isolation():
    """Two conflicting updates in one group: first commits, second aborts;
    an unrelated update in the same group is untouched."""

    cfg = AntidoteConfig(n_shards=4, max_dcs=2, keys_per_table=64)
    node = AntidoteNode(cfg)
    txm = node.txm
    # stage two txns on the same key with the same snapshot, plus one
    # disjoint — drive the group commit directly
    t1 = txm.start_transaction()
    t2 = txm.start_transaction()
    t3 = txm.start_transaction()
    # t1/t2 are read-bearing (rmw) so they keep certification — blind
    # increments would take the bypass and all commit
    txm.read_objects([("k", "counter_pn", "b")], t1)
    txm.read_objects([("k", "counter_pn", "b")], t2)
    txm.update_objects([("k", "counter_pn", "b", ("increment", 1))], t1)
    txm.update_objects([("k", "counter_pn", "b", ("increment", 5))], t2)
    txm.update_objects([("x", "counter_pn", "b", ("increment", 9))], t3)
    outs = txm.commit_transactions_group([t1, t2, t3])
    assert isinstance(outs[0], np.ndarray)
    assert isinstance(outs[1], AbortError)
    assert isinstance(outs[2], np.ndarray)
    vals, _ = node.read_objects(
        [("k", "counter_pn", "b"), ("x", "counter_pn", "b")]
    )
    assert vals == [1, 9]


# ---------------------------------------------------------------------------
# the serving pipeline
# ---------------------------------------------------------------------------
def _mk(**kw):
    cfg = AntidoteConfig(n_shards=4, max_dcs=2, keys_per_table=256, **kw)
    node = AntidoteNode(cfg)
    srv = ProtocolServer(node, port=0, epoch_tick_ms=25)
    return node, srv


def _wait_epoch_covers(node, timeout=5.0):
    """Wait until the published serving epoch covers every acked commit
    (rapid write batches defer inline publishes behind the rate
    limit; the ticker covers them within a tick)."""
    txm = node.txm
    deadline = time.monotonic() + timeout
    while (node.store.serving_epoch is None
           or int(node.store.serving_epoch.vc[txm.my_dc])
           < txm.commit_counter):
        assert time.monotonic() < deadline, "epoch never covered commits"
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# lock-split: reads never park behind the commit/server locks
# ---------------------------------------------------------------------------
def test_epoch_reads_not_stalled_by_held_commit_lock():
    node, srv = _mk()
    c = AntidoteClient(srv.host, srv.port, timeout=30)
    try:
        c.update_objects([("hot", "counter_pn", "b", ("increment", 7))])
        c.update_objects([("cold", "counter_pn", "b", ("increment", 3))])
        # two quick writes may defer the second's inline publish (the
        # idle-plane rate window): let the ticker cover them first, so
        # the priming read fills the cache from the epoch plane
        _wait_epoch_covers(node)
        c.read_objects([("hot", "counter_pn", "b")])  # prime the cache
        assert node.store.serving_epoch is not None
        # wedge BOTH locks the old path parked behind: a publication
        # tick / commit group in progress must not stall epoch reads
        with node.txm.commit_lock, srv._lock:
            c2 = AntidoteClient(srv.host, srv.port, timeout=5)
            t0 = time.monotonic()
            vals, _ = c2.read_objects([("hot", "counter_pn", "b")])
            assert vals == [7]  # cache plane
            vals, _ = c2.read_objects([("cold", "counter_pn", "b")])
            assert vals == [3]  # gather plane (first read of this key)
            elapsed = time.monotonic() - t0
            c2.close()
        assert elapsed < 4.0, f"reads stalled {elapsed:.1f}s behind locks"
    finally:
        c.close()
        srv.close()


# ---------------------------------------------------------------------------
# read/write concurrency: epoch-consistent snapshots, no torn reads
# ---------------------------------------------------------------------------
def test_concurrent_commits_and_epoch_reads_see_consistent_snapshots():
    node, srv = _mk()
    stop = time.monotonic() + 3.0
    errors: list = []
    pair = [("a", "counter_pn", "b"), ("b", "counter_pn", "b")]

    def writer():
        try:
            c = AntidoteClient(srv.host, srv.port)
            while time.monotonic() < stop:
                # ONE txn bumps both keys: any epoch-consistent snapshot
                # shows them EQUAL — a mismatch is a torn read
                c.update_objects([
                    ("a", "counter_pn", "b", ("increment", 1)),
                    ("b", "counter_pn", "b", ("increment", 1)),
                ])
            c.close()
        except Exception as e:  # pragma: no cover - failure detail
            errors.append(repr(e))

    def reader():
        try:
            c = AntidoteClient(srv.host, srv.port)
            last_v = -1
            last_vc = None
            while time.monotonic() < stop:
                vals, vc = c.read_objects(pair)
                if vals[0] != vals[1]:
                    errors.append(f"torn read: {vals}")
                    break
                if vals[0] < last_v:
                    errors.append(f"snapshot went backwards: {vals[0]} "
                                  f"< {last_v}")
                    break
                if last_vc is not None and any(
                        n < o for n, o in zip(vc, last_vc)):
                    errors.append(f"clock went backwards: {vc} < {last_vc}")
                    break
                last_v, last_vc = vals[0], vc
            c.close()
        except Exception as e:  # pragma: no cover - failure detail
            errors.append(repr(e))

    ts = [threading.Thread(target=writer)] + [
        threading.Thread(target=reader) for _ in range(3)
    ]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    srv.close()
    assert not errors, errors
    # the epoch plane actually served (not everything fell to locked)
    m = node.metrics
    assert (m.serving_reads.value(path="cache")
            + m.serving_reads.value(path="gather")) > 0


def test_write_then_clockless_read_sees_the_write():
    node, srv = _mk()
    c = AntidoteClient(srv.host, srv.port)
    try:
        for i in range(1, 40):
            c.update_objects([("rw", "counter_pn", "b", ("increment", 1))])
            vals, _ = c.read_objects([("rw", "counter_pn", "b")])
            assert vals == [i], (i, vals)
    finally:
        c.close()
        srv.close()


# ---------------------------------------------------------------------------
# snapshot cache correctness
# ---------------------------------------------------------------------------
def test_cache_hit_after_epoch_advance_on_written_key_misses():
    node, srv = _mk()
    c = AntidoteClient(srv.host, srv.port)
    try:
        c.update_objects([("k", "set_aw", "b", ("add", 1))])
        vals, _ = c.read_objects([("k", "set_aw", "b")])
        assert vals[0] == [1]
        m = node.metrics
        hits0 = m.snapshot_cache.value(event="hit")
        # same-epoch re-read: a hit
        vals, _ = c.read_objects([("k", "set_aw", "b")])
        assert vals[0] == [1]
        assert m.snapshot_cache.value(event="hit") == hits0 + 1
        # the write advances the epoch and re-freezes k's row: the
        # cached entry MUST miss (serving it would lose the new element)
        c.update_objects([("k", "set_aw", "b", ("add", 2))])
        hits1 = m.snapshot_cache.value(event="hit")
        vals, _ = c.read_objects([("k", "set_aw", "b")])
        assert sorted(vals[0]) == [1, 2]
        assert m.snapshot_cache.value(event="hit") == hits1
    finally:
        c.close()
        srv.close()


def test_cache_revalidates_across_unrelated_epoch_advances():
    node, srv = _mk()
    c = AntidoteClient(srv.host, srv.port)
    try:
        # two priming writes first: the double buffer's first TWO
        # publishes are whole-table copies (both slots must exist), and
        # a copy in the history chain correctly blocks revalidation
        c.update_objects([("warm0", "set_aw", "b", ("add", 1))])
        c.update_objects([("warm1", "set_aw", "b", ("add", 1))])
        c.update_objects([("stable", "set_aw", "b", ("add", 9))])
        _wait_epoch_covers(node)  # rapid writes defer inline publishes
        # (rate limit); the cache fill needs a covering epoch
        vals, _ = c.read_objects([("stable", "set_aw", "b")])
        assert vals[0] == [9]
        ep0 = node.store.serving_epoch.id
        # many unrelated writes advance the epoch (rapid-fire batches
        # defer behind the inline-publish rate limit, — the
        # ticker covers them within a tick, so wait for the advance and
        # for the epoch to cover every acked commit)
        for i in range(10):
            c.update_objects([(f"other{i}", "set_aw", "b", ("add", i))])
        _wait_epoch_covers(node)
        assert node.store.serving_epoch.id > ep0
        m = node.metrics
        hits0 = m.snapshot_cache.value(event="hit")
        vals, _ = c.read_objects([("stable", "set_aw", "b")])
        assert vals[0] == [9]
        assert m.snapshot_cache.value(event="hit") == hits0 + 1, (
            "untouched key failed to revalidate across unrelated epochs")
    finally:
        c.close()
        srv.close()


# ---------------------------------------------------------------------------
# publication cost: scales with writes, capped, never stalls readers
# ---------------------------------------------------------------------------
def test_publish_cost_scales_with_rows_written_not_table_size():
    cfg = AntidoteConfig(n_shards=4, max_dcs=2, keys_per_table=512)
    node = AntidoteNode(cfg)
    txm = node.txm
    store = node.store
    m = node.metrics
    # seed + the first two publishes are whole-table copies (both slots
    # of the double buffer must exist before incremental freezes begin)
    node.update_objects([("seed", "counter_pn", "b", ("increment", 1))])
    assert store.publish_serving_epoch(txm.serving_epoch_vc()) == "published"
    node.update_objects([("seed", "counter_pn", "b", ("increment", 1))])
    assert store.publish_serving_epoch(txm.serving_epoch_vc()) == "published"
    assert m.epoch_publish.value(mode="copy") == 2
    # k rows written => the next publish scatters the rows written
    # since the SPARE slot's freeze (two publish windows: the one seed
    # row from before the second copy, plus the k fresh rows) —
    # independent of the table's 4*512 row capacity
    k = 7
    node.update_objects([
        (f"k{i}", "counter_pn", "b", ("increment", 1)) for i in range(k)
    ])
    rows0 = m.epoch_rows.value(mode="scatter")
    assert store.publish_serving_epoch(txm.serving_epoch_vc()) == "published"
    assert m.epoch_rows.value(mode="scatter") - rows0 == k + 1
    assert m.epoch_publish.value(mode="copy") == 2  # still no full copy
    # noop when nothing changed
    assert store.publish_serving_epoch(txm.serving_epoch_vc()) == "noop"
    # past the dirty cap the freeze degrades to an EXPLICIT full copy
    # (a 10k-row scatter stops beating the copy) — the cost cap is
    # visible in the mode counters either way
    t = store.table("counter_pn")
    t._SERVING_DIRTY_CAP = 4
    node.update_objects([
        (f"w{i}", "counter_pn", "b", ("increment", 1)) for i in range(6)
    ])
    assert store.publish_serving_epoch(txm.serving_epoch_vc()) == "published"
    assert m.epoch_publish.value(mode="copy") == 3


def test_table_epoch_ladder_budget_one_per_tick():
    cfg = AntidoteConfig(n_shards=4, max_dcs=2, keys_per_table=256)
    node = AntidoteNode(cfg)
    srv = ProtocolServer(node, port=0, epoch_tick_ms=0)
    # stop the ticker (it drives the ladder even with the epoch plane
    # off) so the budgeted calls below can't race it
    srv._ticker_stop.set()
    srv._ticker.join(timeout=5)
    c = AntidoteClient(srv.host, srv.port)
    try:
        store = node.store
        # two dirty tables, both eligible for a ladder publish
        c.update_objects([("x", "counter_pn", "b", ("increment", 1))])
        c.update_objects([("y", "set_aw", "b", ("add", 1))])
        for t in store.tables.values():
            t.slow_serves += 1
            t._pub_at = 0.0
            if hasattr(t, "_pub_slow_serves"):
                del t._pub_slow_serves
        n_tables = len(store.tables)
        assert n_tables >= 2
        # each tick publishes AT MOST one table's full-head epoch copy
        assert srv._publish_table_epochs_capped() == 1
        assert srv._publish_table_epochs_capped() == 1
        assert sum(
            1 for t in store.tables.values() if t.epochs
        ) == 2
    finally:
        c.close()
        srv.close()


# ---------------------------------------------------------------------------
# epoch ticker: publication without static-batch traffic
# ---------------------------------------------------------------------------
def test_ticker_publishes_without_any_static_traffic():
    cfg = AntidoteConfig(n_shards=4, max_dcs=2, keys_per_table=256)
    node = AntidoteNode(cfg)
    # data lands BEFORE the server exists (no publish hooks active)
    node.update_objects([("pre", "counter_pn", "b", ("increment", 5))])
    assert node.store.serving_epoch is None
    srv = ProtocolServer(node, port=0, epoch_tick_ms=25)
    try:
        deadline = time.monotonic() + 5.0
        while node.store.serving_epoch is None:
            assert time.monotonic() < deadline, (
                "ticker never published an epoch")
            time.sleep(0.05)
        assert int(node.store.serving_epoch.vc[0]) >= 1
    finally:
        srv.close()


def test_epoch_tick_zero_disables_the_epoch_plane():
    cfg = AntidoteConfig(n_shards=4, max_dcs=2, keys_per_table=256)
    node = AntidoteNode(cfg)
    srv = ProtocolServer(node, port=0, epoch_tick_ms=0)
    c = AntidoteClient(srv.host, srv.port)
    try:
        assert not srv._epoch_reads
        c.update_objects([("k", "counter_pn", "b", ("increment", 2))])
        vals, _ = c.read_objects([("k", "counter_pn", "b")])
        assert vals == [2]
        assert node.store.serving_epoch is None
    finally:
        c.close()
        srv.close()


# ---------------------------------------------------------------------------
# promotion: the serving epoch survives a tier crossing
# ---------------------------------------------------------------------------
def test_promotion_keeps_serving_epoch_and_reads_stay_exact():
    node, srv = _mk()
    c = AntidoteClient(srv.host, srv.port)
    try:
        store = node.store
        cap = store.cfg.set_slots
        # grow one set key across at least one slot-tier boundary while
        # reading it back between writes
        n = cap * 3
        for i in range(n):
            c.update_objects([("grow", "set_aw", "b", ("add", i))])
            if i % 7 == 0:
                vals, _ = c.read_objects([("grow", "set_aw", "b")])
                assert sorted(vals[0]) == list(range(i + 1))
        assert store.promotions >= 1
        # the fix under test: a promotion no longer nukes the serving
        # epoch (no whole-table copy republish storm)
        assert store.serving_epoch is not None
        vals, _ = c.read_objects([("grow", "set_aw", "b")])
        assert sorted(vals[0]) == list(range(n))
        # reads of OTHER keys kept their cache/gather plane alive
        c.update_objects([("bystander", "set_aw", "b", ("add", 1))])
        vals, _ = c.read_objects([("bystander", "set_aw", "b")])
        assert vals[0] == [1]
    finally:
        c.close()
        srv.close()


# ---------------------------------------------------------------------------
# clocked reads against the epoch plane
# ---------------------------------------------------------------------------
def test_clocked_read_at_returned_epoch_clock():
    node, srv = _mk()
    c = AntidoteClient(srv.host, srv.port)
    try:
        c.update_objects([("ck", "counter_pn", "b", ("increment", 4))])
        vals, vc = c.read_objects([("ck", "counter_pn", "b")])
        assert vals == [4]
        # hand the epoch clock back as the causal clock: still served,
        # still exact (covered => epoch-eligible)
        vals2, vc2 = c.read_objects([("ck", "counter_pn", "b")], clock=vc)
        assert vals2 == [4]
        assert all(b >= a for a, b in zip(vc, vc2))
        # a clock AHEAD of the epoch falls back to the locked path
        ahead = list(vc)
        ahead[0] += 1
        c.update_objects([("ck", "counter_pn", "b", ("increment", 1))])
        vals3, _ = c.read_objects([("ck", "counter_pn", "b")], clock=ahead)
        assert vals3 == [5]
    finally:
        c.close()
        srv.close()


def test_wrong_type_read_raises_even_when_cached():
    """Cache residency must never change observable behavior: a read of
    a key under the WRONG CRDT type raises the same TypeError whether
    the key's value sits in the snapshot cache or not."""
    node, srv = _mk()
    c = AntidoteClient(srv.host, srv.port)
    try:
        c.update_objects([("typed", "counter_pn", "b", ("increment", 3))])
        vals, _ = c.read_objects([("typed", "counter_pn", "b")])
        assert vals == [3]  # cached now
        with pytest.raises(RemoteError, match="bound"):
            c.read_objects([("typed", "set_aw", "b")])
    finally:
        c.close()
        srv.close()


def test_pipeline_status_block_exposed():
    node, srv = _mk()
    c = AntidoteClient(srv.host, srv.port)
    try:
        c.update_objects([("s", "counter_pn", "b", ("increment", 1))])
        c.read_objects([("s", "counter_pn", "b")])
        st = c.node_status()
        pl = st["pipeline"]
        assert pl["epoch_reads"] is True
        assert set(pl["stages"]) == {"decode", "parked", "launch",
                                     "writeback"}
        for s in pl["stages"].values():
            assert {"count", "sum_ms", "mean_us", "p50_us",
                    "p99_us"} <= set(s)
        assert pl["serving_epoch_id"] >= 1
        assert "hit" in pl["snapshot_cache"] or pl["snapshot_cache"]
    finally:
        c.close()
        srv.close()


# ---------------------------------------------------------------------------
# across the packages: the JAX server and the port's server on one script
# ---------------------------------------------------------------------------
def _cross_cfgs():
    kw = dict(n_shards=2, max_dcs=2, ops_per_key=8, snap_versions=2,
              set_slots=8, mv_slots=4, rga_slots=16, keys_per_table=64)
    return JConfig(**kw, batch_buckets=(8, 64)), AntidoteConfig(**kw)


@pytest.fixture(params=[{"batch_static": False},
                        {"batch_static": True, "epoch_tick_ms": 0}],
                ids=["inline", "pipeline"])
def twin_servers(request, monkeypatch):
    """A JAX server and a port server over equal fresh nodes, with both
    packages' transaction ids starting equal: every reply frame of a
    sequential script is then determined by the script.  The serving
    epochs are off (their commit clocks follow the ticker's timing); the
    pipeline case still runs every static op through the batch gate, the
    locked worker and its group-commit merge."""
    monkeypatch.setattr(JTransaction, "_ids", itertools.count(7000))
    monkeypatch.setattr(Transaction, "_ids", itertools.count(7000))
    jcfg, tcfg = _cross_cfgs()
    jsrv = JServer(JNode(jcfg), port=0, **request.param)
    try:
        tsrv = ProtocolServer(AntidoteNode(tcfg), port=0, **request.param)
        try:
            yield jsrv, tsrv
        finally:
            tsrv.close()
    finally:
        jsrv.close()


def _raw_call(sock, rfile, frame: bytes) -> bytes:
    """Send one frame body (code byte + payload); return the reply frame
    body exactly as it came off the socket."""
    sock.sendall(struct.pack(">I", len(frame)) + frame)
    return read_frame_buffered(rfile)


def _msg(code, body) -> bytes:
    return encode(code, body)[4:]


def _apb(name, body) -> bytes:
    return apb.encode_frame_body(name, body)


def _script(seed: int):
    """A seeded single-client script of request frames in both dialects:
    static updates and reads over several types, interactive
    transactions (commit, abort, a certification conflict), map values,
    typed and untyped error replies, and the DC-management requests a
    node without inter-DC replication refuses."""
    rng = np.random.default_rng(seed)
    M = MessageCode
    out = []
    keys = [f"k{i}" for i in range(6)]
    for i in range(12):
        k = keys[int(rng.integers(len(keys)))]
        n = int(rng.integers(1, 9))
        out.append(("msg", _msg(M.STATIC_UPDATE_OBJECTS, {
            "updates": [[k, "counter_pn", "b", ["increment", n]],
                        [f"s{k}", "set_aw", "b",
                         ["add" if i % 3 else "remove", n]],
                        [f"m{k}", "register_mv", "b", ["assign", n]],
                        [f"f{k}", "flag_ew", "b",
                         ["enable" if n % 2 else "disable", None]]],
            "clock": None})))
        out.append(("msg", _msg(M.STATIC_READ_OBJECTS, {
            "objects": [[k, "counter_pn", "b"], [f"s{k}", "set_aw", "b"],
                        [f"m{k}", "register_mv", "b"],
                        [f"f{k}", "flag_ew", "b"]],
            "clock": None})))
    out.append(("msg", _msg(M.STATIC_UPDATE_OBJECTS, {
        "updates": [["map", "map_rr", "b", ["update", [
            [["cnt", "counter_pn"], ["increment", 3]],
            [["who", "register_lww"], ["assign", "ada"]]]]],
                    ["lww", "register_lww", "b", ["assign", "x"]],
                    ["seq", "rga", "b", ["add_right", [0, "a"]]]],
        "clock": None})))
    out.append(("msg", _msg(M.STATIC_READ_OBJECTS, {
        "objects": [["map", "map_rr", "b"], ["lww", "register_lww", "b"],
                    ["seq", "rga", "b"], ["none", "counter_pn", "b"]],
        "clock": [3, 0]})))
    # interactive: commit, abort, a certification conflict (txids start
    # at the patched counter's next value, the same in both packages)
    out.append(("msg", _msg(M.START_TRANSACTION, {"clock": None,
                                                  "props": None})))
    out.append(("txn", None))
    # errors: an unknown type, an unknown txid, a malformed body
    out.append(("msg", _msg(M.STATIC_UPDATE_OBJECTS, {
        "updates": [["x", "no_such_type", "b", ["inc", 1]]],
        "clock": None})))
    out.append(("msg", _msg(M.COMMIT_TRANSACTION, {"txid": 10 ** 9})))
    out.append(("msg", _msg(M.ABORT_TRANSACTION, {"txid": 10 ** 9})))
    out.append(("msg", _msg(M.READ_OBJECTS, {"txid": 10 ** 9,
                                             "objects": []})))
    out.append(("msg", _msg(M.GET_CONNECTION_DESCRIPTOR, {})))
    out.append(("msg", _msg(M.CONNECT_TO_DCS, {"descriptors": [{}]})))
    out.append(("msg", _msg(M.CREATE_DC, {"nodes": ["n1"]})))
    out.append(("msg", _msg(M.CREATE_DC, {"nodes": ["n1", "n2"]})))
    out.append(("msg", _msg(M.REPLICA_ADMIN, {"op": "status"})))
    out.append(("msg", _msg(M.CHECKPOINT_NOW, {})))
    # the apb dialect
    for i in range(6):
        k = f"a{int(rng.integers(4))}".encode()
        n = int(rng.integers(1, 9))
        out.append(("apb", _apb("ApbStaticUpdateObjects", {
            "transaction": {},
            "updates": [apb.update_op_from_native(u) for u in [
                (k, "counter_pn", b"b", ("increment", n)),
                (b"s" + k, "set_aw", b"b", ("add", str(n).encode())),
                (b"r" + k, "register_mv", b"b",
                 ("assign", str(n).encode()))]]})))
        out.append(("apb", _apb("ApbStaticReadObjects", {
            "transaction": {},
            "objects": [{"key": k, "type": apb.TYPE_IDS["counter_pn"],
                         "bucket": b"b"},
                        {"key": b"s" + k, "type": apb.TYPE_IDS["set_aw"],
                         "bucket": b"b"},
                        {"key": b"r" + k,
                         "type": apb.TYPE_IDS["register_mv"],
                         "bucket": b"b"}]})))
    out.append(("apb", _apb("ApbStartTransaction", {})))
    out.append(("apbtxn", None))
    out.append(("apb", _apb("ApbCommitTransaction", {
        "transaction_descriptor": b"999999999"})))
    out.append(("apb", _apb("ApbGetConnectionDescriptor", {})))
    out.append(("apb", _apb("ApbCreateDC", {"nodes": [b"n1", b"n2"]})))
    out.append(("apb", _apb("ApbStaticUpdateObjects", {
        "transaction": {},
        "updates": [{"boundobject": {"key": b"z", "type": 99,
                                     "bucket": b"b"},
                     "operation": {"counterop": {"inc": 1}}}]})))
    return out


def _txn_frames(txid: int):
    """An interactive session on ``txid`` plus a second, conflicting one
    (``txid + 1``, started inside): both read the key, both increment it,
    the first commits and the second aborts."""
    M = MessageCode
    ob = ["tk", "counter_pn", "b"]
    return [
        _msg(M.UPDATE_OBJECTS, {"txid": txid, "updates": [
            ob + [["increment", 2]]]}),
        _msg(M.READ_OBJECTS, {"txid": txid, "objects": [ob]}),
        _msg(M.START_TRANSACTION, {"clock": None, "props": None}),
        _msg(M.READ_OBJECTS, {"txid": txid + 1, "objects": [ob]}),
        _msg(M.UPDATE_OBJECTS, {"txid": txid + 1, "updates": [
            ob + [["increment", 5]]]}),
        _msg(M.COMMIT_TRANSACTION, {"txid": txid}),
        _msg(M.COMMIT_TRANSACTION, {"txid": txid + 1}),
        _msg(M.START_TRANSACTION, {"clock": None, "props": None}),
        _msg(M.UPDATE_OBJECTS, {"txid": txid + 2, "updates": [
            ob + [["increment", 100]]]}),
        _msg(M.ABORT_TRANSACTION, {"txid": txid + 2}),
        _msg(M.STATIC_READ_OBJECTS, {"objects": [ob], "clock": None}),
    ]


def _apb_txn_frames(txid: int):
    d = str(txid).encode()
    bo = {"key": b"atk", "type": apb.TYPE_IDS["set_aw"], "bucket": b"b"}
    return [
        _apb("ApbUpdateObjects", {"transaction_descriptor": d, "updates": [
            {"boundobject": bo, "operation": {"setop": {
                "optype": 1, "adds": [b"e1", b"e2"]}}}]}),
        _apb("ApbReadObjects", {"transaction_descriptor": d,
                                "boundobjects": [bo]}),
        _apb("ApbCommitTransaction", {"transaction_descriptor": d}),
        _apb("ApbStartTransaction", {}),
        _apb("ApbAbortTransaction",
             {"transaction_descriptor": str(txid + 1).encode()}),
        _apb("ApbReadObjects", {"transaction_descriptor": d,
                                "boundobjects": [bo]}),
    ]


def _run_script(addr, script):
    """Every reply frame of ``script`` from the server at ``addr``, each
    with its dialect ("msg" or "apb")."""
    sock = socket.create_connection(addr, timeout=30)
    rfile = sock.makefile("rb")
    replies = []
    try:
        for kind, frame in script:
            if kind == "txn":
                _c, body = decode(replies[-1][1])
                for f in _txn_frames(body["txid"]):
                    replies.append(("msg", _raw_call(sock, rfile, f)))
                continue
            if kind == "apbtxn":
                _n, body = apb.decode_frame_body(replies[-1][1])
                txid = int(body["transaction_descriptor"])
                for f in _apb_txn_frames(txid):
                    replies.append(("apb", _raw_call(sock, rfile, f)))
                continue
            replies.append((kind, _raw_call(sock, rfile, frame)))
    finally:
        rfile.close()
        sock.close()
    return replies


@pytest.mark.parametrize("seed", [3, 11])
def test_reply_frames_byte_equal_to_the_jax_server(twin_servers, seed):
    """One seeded single-client script, both dialects, through the JAX
    server and the port's: every reply frame is byte-equal, error replies
    included."""
    jsrv, tsrv = twin_servers
    script = _script(seed)
    j_rep = _run_script((jsrv.host, jsrv.port), script)
    t_rep = _run_script((tsrv.host, tsrv.port), script)
    assert len(j_rep) == len(t_rep)
    for i, (a, b) in enumerate(zip(j_rep, t_rep)):
        assert a == b, (i, a, b)
    # the script really reached the error replies of both dialects, the
    # certification conflict among them
    errors = [decode(r)[1]["error"] for d, r in t_rep
              if d == "msg" and r[0] == MessageCode.ERROR_RESP]
    assert "aborted" in errors and "RuntimeError" in errors, errors
    apb_errors = [apb.decode_frame_body(r)[1]["errmsg"] for d, r in t_rep
                  if d == "apb" and r[0] == apb.MSG_CODES["ApbErrorResp"]]
    assert len(apb_errors) >= 3, apb_errors


def _typed_errors(pkg):
    """One instance of every typed refusal a node or server raises, from
    the overload module of ``pkg`` (the JAX package's or the port's)."""
    return {
        "busy": pkg.BusyError("server at max_in_flight=4",
                              retry_after_ms=75),
        "tenant_busy": pkg.TenantBusyError("tenant gold at max_in_flight=2",
                                           tenant="gold",
                                           retry_after_ms=50),
        "deadline": pkg.DeadlineExceeded(
            "request deadline passed before dispatch; not executed"),
        "read_only": pkg.ReadOnlyError("ENOSPC on shard 0"),
        "cold_miss": pkg.ColdMiss("fault-in rate cap", retry_after_ms=40,
                                  permanent=False),
        "insufficient_rights": pkg.InsufficientRightsError(
            "needs 5, holds 2", retry_after_ms=100),
    }


#: the client error each typed reply must raise, per dialect (the apb
#: client of either package has no cold_miss branch: it raises the
#: generic RemoteError carrying the kind)
_MSG_REMOTE = {"busy": "RemoteBusy", "tenant_busy": "RemoteTenantBusy",
               "deadline": "RemoteDeadline", "read_only": "RemoteReadOnly",
               "cold_miss": "RemoteColdMiss",
               "insufficient_rights": "RemoteInsufficientRights",
               "aborted": "RemoteAbort"}
_APB_REMOTE = dict(_MSG_REMOTE, cold_miss="RemoteError",
                   aborted="RemoteError")


@pytest.fixture
def twin_plain_servers():
    jcfg, tcfg = _cross_cfgs()
    jsrv = JServer(JNode(jcfg), port=0)
    try:
        tsrv = ProtocolServer(AntidoteNode(tcfg), port=0)
        try:
            yield {"jax": jsrv, "torch": tsrv}
        finally:
            tsrv.close()
    finally:
        jsrv.close()


@pytest.mark.parametrize("kind", sorted(_MSG_REMOTE))
def test_typed_errors_cross_the_packages(twin_plain_servers, monkeypatch,
                                         kind):
    """Each typed refusal, raised inside the server of one package, reaches
    the client of either package as the same ``Remote*`` error, in both
    dialects, and the two servers' reply frames are byte-equal."""
    servers = twin_plain_servers
    errs = {"jax": _typed_errors(j_overload), "torch": _typed_errors(
        t_overload)}
    aborts = {"jax": JAbortError("certification failed on ('k', 'b')"),
              "torch": AbortError("certification failed on ('k', 'b')")}
    raw = {}
    for pkg, srv in servers.items():
        e = aborts[pkg] if kind == "aborted" else errs[pkg][kind]

        def boom(*_a, _e=e, **_k):
            raise _e

        monkeypatch.setattr(srv, "_process", boom)
        monkeypatch.setattr(srv, "static_read", boom)
        sock = socket.create_connection((srv.host, srv.port), timeout=30)
        rfile = sock.makefile("rb")
        try:
            raw[pkg] = (
                _raw_call(sock, rfile, _msg(MessageCode.STATIC_READ_OBJECTS,
                                            {"objects": [], "clock": None})),
                _raw_call(sock, rfile, _apb("ApbStaticReadObjects", {
                    "transaction": {}, "objects": []})))
        finally:
            rfile.close()
            sock.close()
        for cpkg, mod in (("jax", j_client), ("torch", t_client)):
            c = mod.AntidoteClient(srv.host, srv.port, timeout=30)
            a = mod.ApbClient(srv.host, srv.port, timeout=30)
            try:
                with pytest.raises(getattr(mod, _MSG_REMOTE[kind])) as ei:
                    c.read_objects([("k", "counter_pn", "b")])
                assert type(ei.value).__name__ == _MSG_REMOTE[kind]
                if hasattr(e, "retry_after_ms") and kind != "aborted":
                    assert ei.value.retry_after_ms == e.retry_after_ms
                if kind == "tenant_busy":
                    assert ei.value.tenant == "gold"
                with pytest.raises(getattr(mod, _APB_REMOTE[kind])) as ei:
                    a.read_objects([(b"k", "counter_pn", b"b")])
                assert type(ei.value).__name__ == _APB_REMOTE[kind]
                if _APB_REMOTE[kind] == "RemoteError":
                    assert kind in str(ei.value) or "AbortError" in str(
                        ei.value)
            finally:
                c.close()
                a.close()
    assert raw["jax"] == raw["torch"]


def test_clients_of_either_package_against_either_server(
        twin_plain_servers):
    """The JAX package's clients drive the port's server and the port's
    clients drive the JAX server: static and interactive transactions in
    the msgpack dialect, static ones in the apb dialect, a certification
    conflict as RemoteAbort and an admission shed as RemoteBusy."""
    for spkg, srv in twin_plain_servers.items():
        for cpkg, mod in (("jax", j_client), ("torch", t_client)):
            tag = f"{spkg}-{cpkg}"
            c = mod.AntidoteClient(srv.host, srv.port, timeout=30)
            a = mod.ApbClient(srv.host, srv.port, timeout=30)
            try:
                vc = c.update_objects([
                    (f"c{tag}", "counter_pn", "b", ("increment", 4)),
                    (f"s{tag}", "set_aw", "b", ("add", 7))])
                vals, _ = c.read_objects(
                    [(f"c{tag}", "counter_pn", "b"),
                     (f"s{tag}", "set_aw", "b")], clock=vc)
                assert vals == [4, [7]]
                t1 = c.start_transaction(clock=vc)
                t2 = c.start_transaction(clock=vc)
                for t in (t1, t2):
                    assert t.read_objects(
                        [(f"c{tag}", "counter_pn", "b")]) == [4]
                    t.update_objects(
                        [(f"c{tag}", "counter_pn", "b", ("increment", 1))])
                vc = t1.commit()
                with pytest.raises(mod.RemoteAbort):
                    t2.commit()
                vals, _ = c.read_objects([(f"c{tag}", "counter_pn", "b")],
                                         clock=vc)
                assert vals == [5]
                avc = a.update_objects(
                    [(f"a{tag}".encode(), "counter_pn", b"b",
                      ("increment", 3))], clock=vc)
                vals, _ = a.read_objects(
                    [(f"a{tag}".encode(), "counter_pn", b"b")], clock=avc)
                assert vals == [3]
            finally:
                c.close()
                a.close()
        gate = srv.admission
        gate.max_in_flight, keep = 0, gate.max_in_flight
        try:
            for mod in (j_client, t_client):
                c = mod.AntidoteClient(srv.host, srv.port, timeout=30)
                try:
                    with pytest.raises(mod.RemoteBusy) as ei:
                        c.read_objects([("k", "counter_pn", "b")])
                    assert ei.value.retry_after_ms >= 25
                finally:
                    c.close()
        finally:
            gate.max_in_flight = keep


def _probe(port, frame: bytes):
    """One request frame on a fresh connection: ("reply", body) or
    ("closed", None) when the server dropped the connection."""
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    rf = s.makefile("rb")
    try:
        s.sendall(struct.pack(">I", len(frame)) + frame)
        try:
            return "reply", read_frame_buffered(rf)
        except ConnectionError:
            return "closed", None
    finally:
        rf.close()
        s.close()


def test_frontend_recv_faults_match_the_jax_server(twin_plain_servers):
    """The ``frontend.recv`` fault site: a drop rule closes the
    connection, a truncate rule mangles the frame into a typed error
    reply (byte-equal to the JAX server's), and with the rules spent the
    server serves again — each package under its own fault injector."""
    from antidote_tpu import faults as j_faults
    from antidote_tpu_torch import faults as t_faults

    req = _msg(MessageCode.STATIC_READ_OBJECTS,
               {"objects": [["k", "counter_pn", "b"]], "clock": None})
    seen = {}
    for pkg, mod in (("jax", j_faults), ("torch", t_faults)):
        plan = mod.FaultPlan(seed=11)
        plan.drop("frontend.recv", times=1)
        plan.truncate("frontend.recv", times=1, keep=5)
        inj = mod.install(plan)
        try:
            port = twin_plain_servers[pkg].port
            seen[pkg] = [_probe(port, req) for _ in range(3)]
            assert inj.fired("frontend.recv") == 2
        finally:
            mod.uninstall()
    for pkg in seen:
        (k0, _), (k1, b1), (k2, b2) = seen[pkg]
        assert (k0, k1, k2) == ("closed", "reply", "reply")
        assert decode(b1)[0] == MessageCode.ERROR_RESP
        assert decode(b2)[0] == MessageCode.READ_OBJECTS_RESP
    assert seen["torch"][1] == seen["jax"][1]


def test_codec_helpers_match_the_jax_package():
    """The msgpack codec's helpers give the JAX codec's frames and
    values: frames, tagged map values, frozen keys, session clocks."""
    from antidote_tpu.proto import codec as jc
    from antidote_tpu_torch.proto import codec as tc

    vals = [3, [1, "a"], {("f", "counter_pn"): 2,
                          ("g", "set_aw"): [b"x", 4]}, None, True]
    for v in vals:
        assert tc.encode_value(v) == jc.encode_value(v)
        enc = tc.encode_value(v)
        assert tc.decode_value(enc) == jc.decode_value(enc)
    body = {"updates": [["k", "counter_pn", "b", ["increment", 1]]],
            "clock": [1, 2]}
    for code in tc.MessageCode:
        frame = tc.encode(code, body)
        assert frame == jc.encode(jc.MessageCode(int(code)), body)
        assert frame == tc.encode_with(tc.msgpack.Packer(use_bin_type=True),
                                       code, body)
        assert tc.decode(frame[4:]) == jc.decode(frame[4:])
    assert [int(c) for c in tc.MessageCode] == [int(c) for c in
                                                jc.MessageCode]
    assert tc.freeze([1, [2, [3]]]) == jc.freeze([1, [2, [3]]])
    for a, b in ([None, None], [[1, 2], None], [None, [3]], [[1, 5], [2]],
                 [[1], [0, 7]]):
        assert tc.merge_clock(a, b) == jc.merge_clock(a, b)
