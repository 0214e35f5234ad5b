"""The serving read plane against the JAX package, at the store and table
level (the wire server is a later slice).

One scripted op sequence runs into a JAX ``KVStore`` and a port
``KVStore(device="cpu")``, each behind its package's
``TransactionManager``, with serving-epoch publishes at the same points:
publish results (published / noop / deferred under a pin), freeze modes
and rows, epoch ids and ``touched`` sets, epoch-read values and fallback
indices, and snapshot-cache hit / miss counts must be equal —
revalidation across unrelated publishes, a miss on a written key and the
promotion fallback included.  Then the store-level forms of the JAX
serving-pipeline tests, the table-epoch ladder tests against a JAX table
fed the same ops, and a reader thread that serves epoch reads while
another thread commits, never taking the commit lock."""

import threading
import time

import numpy as np
import pytest

from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu.crdt import get_type as jax_type
from antidote_tpu.obs import NodeMetrics as JaxMetrics
from antidote_tpu.store.kv import KVStore as JaxStore
from antidote_tpu.store import TypedTable as JaxTable
from antidote_tpu.txn.manager import TransactionManager as JaxTxm
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.crdt.blob import BlobStore
from antidote_tpu_torch.obs import NodeMetrics
from antidote_tpu_torch.store import KVStore, TypedTable
from antidote_tpu_torch.txn.manager import TransactionManager

KW = dict(n_shards=4, max_dcs=3, ops_per_key=16, snap_versions=2,
          set_slots=8, keys_per_table=64)
S, C = "set_aw", "counter_pn"


def _pair():
    """(JAX side, port side): each a (store, manager, metrics) triple."""
    out = []
    for store, txm, met in (
            (JaxStore(JaxConfig(**KW, batch_buckets=(16, 64))), JaxTxm,
             JaxMetrics),
            (KVStore(AntidoteConfig(**KW), device="cpu"),
             TransactionManager, NodeMetrics)):
        m = met()
        store.metrics = m
        out.append((store, txm(store), m))
    return out


def _touched(ep):
    return {t: (None if v is None else sorted(v))
            for t, v in ep.touched.items()}


def _publish(side):
    store, txm, m = side
    res = store.publish_serving_epoch(txm.serving_epoch_vc())
    ep = store.serving_epoch
    mp, mr = m.epoch_publish, m.epoch_rows
    return (res, ep.id, ep.vc.tolist(), _touched(ep),
            {k: mp.value(mode=k) for k in ("copy", "scatter", "defer")},
            {k: mr.value(mode=k) for k in ("copy", "scatter")})


def _read(side, objs):
    store = side[0]
    ep = store.pin_serving_epoch()
    try:
        pend, fb = store.epoch_read_launch(objs, ep)
        vals = store.epoch_read_finish(pend)
    finally:
        store.unpin_serving_epoch(ep)
    sc = side[2].snapshot_cache
    return (vals, fb, sc.value(event="hit"), sc.value(event="miss"),
            side[2].serving_reads.value(path="gather"),
            side[2].serving_reads.value(path="cache"))


def _script(side):
    store, txm, _ = side
    out = []
    w = txm.update_objects_static
    w([(f"s{i}", S, "b", ("add", i)) for i in range(6)]
      + [(f"c{i}", C, "b", ("increment", i + 1)) for i in range(4)])
    out.append(_publish(side))                      # copy
    objs = ([(f"s{i}", S, "b") for i in range(6)]
            + [(f"c{i}", C, "b") for i in range(4)]
            + [("never", S, "b"), ("m", "map_rr", "b"), ("c0", S, "b")])
    out.append(_read(side, objs))                   # gathers + fallbacks
    out.append(_read(side, objs))                   # all hits
    w([("s0", S, "b", ("add", 100))])
    out.append(_publish(side))                      # copy (second slot)
    out.append(_publish(side))                      # noop
    out.append(_read(side, objs))                   # s0 misses, rest hit
    w([("c1", C, "b", ("increment", 5)), ("late", C, "b", ("increment", 1))])
    out.append(_publish(side))                      # scatter
    for i in range(4):                              # unrelated advances
        w([(f"o{i}", C, "b", ("increment", 1))])
        out.append(_publish(side))
    out.append(_read(side, objs + [("late", C, "b")]))  # revalidations
    # a pinned reader holds the epoch that the next publish retires
    pinned = store.pin_serving_epoch()
    w([("s1", S, "b", ("add", 101))])
    out.append(_publish(side))                      # published, old pinned
    w([("s2", S, "b", ("add", 102))])
    out.append(_publish(side))                      # deferred
    born = [("born", C, "b")]
    w([("born", C, "b", ("increment", 9))])
    pend, fb = store.epoch_read_launch(born + objs[:3], pinned)
    out.append((store.epoch_read_finish(pend), fb))  # born after the pin
    store.unpin_serving_epoch(pinned)
    out.append(_publish(side))                      # published
    # promotion: s3 outgrows its slots under a pinned epoch
    pinned = store.pin_serving_epoch()
    w([("s3", S, "b", ("add_all", list(range(200, 212))))])
    pend, fb = store.epoch_read_launch([("s3", S, "b"), ("s4", S, "b")],
                                       pinned)
    out.append((store.epoch_read_finish(pend), fb, store.promotions))
    out.append(store.epoch_cache_read([("s3", S, "b")], pinned))
    store.unpin_serving_epoch(pinned)
    out.append(_publish(side))
    out.append(_read(side, [("s3", S, "b"), ("s4", S, "b")]))
    out.append(store.epoch_cache_read([("s4", S, "b"), ("never", C, "b")],
                                      store.serving_epoch))
    out.append(store.epoch_cache_read([("s3", S, "b"), ("s5", S, "b")],
                                      store.serving_epoch))
    # every epoch read equals the locked read at the epoch's clock
    ep = store.serving_epoch
    got = _read(side, objs[:10])[0]
    want = [v for v in txm.read_objects_static(objs[:10], clock=ep.vc)[0]]
    out.append(got == want)
    return out


def test_scripted_epochs_match_jax():
    jax_side, port_side = _pair()
    want, got = _script(jax_side), _script(port_side)
    assert len(got) == len(want)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g == w, f"step {i}"
    # the script reached each outcome it is about
    results = [x[0] for x in got
               if isinstance(x, tuple) and isinstance(x[0], str)]
    assert {"published", "noop", "deferred"} <= set(results)
    modes = port_side[2].epoch_publish
    assert modes.value(mode="scatter") > 0 and modes.value(mode="copy") >= 2
    assert port_side[0].promotions == 1
    assert got[-1] is True


# ---------------------------------------------------------------------------
# store-level forms of the JAX serving-pipeline tests
# ---------------------------------------------------------------------------
def _port():
    store = KVStore(AntidoteConfig(**KW), device="cpu")
    store.metrics = NodeMetrics()
    txm = TransactionManager(store)
    txm.metrics = store.metrics
    return store, txm, store.metrics


def _epoch_read(store, objs):
    ep = store.pin_serving_epoch()
    try:
        pend, fb = store.epoch_read_launch(objs, ep)
        return store.epoch_read_finish(pend), fb
    finally:
        store.unpin_serving_epoch(ep)


def test_cache_hit_after_epoch_advance_on_written_key_misses():
    store, txm, m = _port()
    txm.update_objects_static([("k", S, "b", ("add", 1))])
    txm.publish_serving_epoch()
    assert _epoch_read(store, [("k", S, "b")])[0] == [[1]]
    hits0 = m.snapshot_cache.value(event="hit")
    assert _epoch_read(store, [("k", S, "b")])[0] == [[1]]  # a hit
    assert m.snapshot_cache.value(event="hit") == hits0 + 1
    # the write re-freezes k's row: the cached entry MUST miss
    txm.update_objects_static([("k", S, "b", ("add", 2))])
    txm.publish_serving_epoch()
    hits1 = m.snapshot_cache.value(event="hit")
    assert sorted(_epoch_read(store, [("k", S, "b")])[0][0]) == [1, 2]
    assert m.snapshot_cache.value(event="hit") == hits1


def test_cache_revalidates_across_unrelated_epoch_advances():
    store, txm, m = _port()
    # the first TWO publishes are copies (both slots must exist), and a
    # copy in the history chain correctly blocks revalidation
    for k in ("warm0", "warm1", "stable"):
        txm.update_objects_static([(k, S, "b", ("add", 9))])
        txm.publish_serving_epoch()
    assert _epoch_read(store, [("stable", S, "b")])[0] == [[9]]
    ep0 = store.serving_epoch.id
    for i in range(10):
        txm.update_objects_static([(f"other{i}", S, "b", ("add", i))])
        txm.publish_serving_epoch()
    assert store.serving_epoch.id == ep0 + 10
    hits0 = m.snapshot_cache.value(event="hit")
    assert _epoch_read(store, [("stable", S, "b")])[0] == [[9]]
    assert m.snapshot_cache.value(event="hit") == hits0 + 1


def test_publish_cost_scales_with_rows_written_not_table_size():
    store, txm, m = _port()
    txm.update_objects_static([("seed", C, "b", ("increment", 1))])
    assert txm.publish_serving_epoch() == "published"
    txm.update_objects_static([("seed", C, "b", ("increment", 1))])
    assert txm.publish_serving_epoch() == "published"
    assert m.epoch_publish.value(mode="copy") == 2
    # k rows written => the next publish scatters the rows written since
    # the SPARE slot's freeze (the seed row and the k fresh rows)
    k = 7
    txm.update_objects_static([(f"k{i}", C, "b", ("increment", 1))
                               for i in range(k)])
    rows0 = m.epoch_rows.value(mode="scatter")
    assert txm.publish_serving_epoch() == "published"
    assert m.epoch_rows.value(mode="scatter") - rows0 == k + 1
    assert m.epoch_publish.value(mode="copy") == 2
    assert txm.publish_serving_epoch() == "noop"
    # past the dirty cap the freeze copies
    store.table(C)._SERVING_DIRTY_CAP = 4
    txm.update_objects_static([(f"w{i}", C, "b", ("increment", 1))
                               for i in range(6)])
    assert txm.publish_serving_epoch() == "published"
    assert m.epoch_publish.value(mode="copy") == 3


def test_promotion_keeps_serving_epoch_and_reads_stay_exact():
    store, txm, _ = _port()
    txm.enable_serving_epochs()
    n = store.cfg.set_slots * 3
    for i in range(n):
        txm.update_objects_static([("grow", S, "b", ("add", i))])
        txm.publish_serving_epoch()  # what a ticker would do
        if i % 7 == 0:
            vals, fb = _epoch_read(store, [("grow", S, "b")])
            if fb:  # promoted since the epoch: the locked path serves
                vals = txm.read_objects_static([("grow", S, "b")])[0]
            assert sorted(vals[0]) == list(range(i + 1))
    assert store.promotions >= 1
    assert store.serving_epoch is not None  # a promotion keeps the plane
    vals, fb = _epoch_read(store, [("grow", S, "b")])
    assert fb == [] and sorted(vals[0]) == list(range(n))
    txm.update_objects_static([("bystander", S, "b", ("add", 1))])
    txm.publish_serving_epoch()
    assert _epoch_read(store, [("bystander", S, "b")]) == ([[1]], [])


def test_epoch_read_at_the_epoch_clock_equals_the_locked_read():
    store, txm, _ = _port()
    txm.enable_serving_epochs()
    txm.update_objects_static([("ck", C, "b", ("increment", 4))])
    ep = store.serving_epoch
    assert _epoch_read(store, [("ck", C, "b")])[0] == [4]
    txm.update_objects_static([("ck", C, "b", ("increment", 1))])
    # the old epoch's clock, handed back: the locked path at it agrees
    vals, _ = txm.read_objects_static([("ck", C, "b")], clock=ep.vc)
    assert vals == [5]  # a causal lower bound: the snapshot is newer
    assert store.read_values([("ck", C, "b")], ep.vc) == [4]
    assert _epoch_read(store, [("ck", C, "b")])[0] == [5]


def test_wrong_type_read_raises_even_when_cached():
    store, txm, _ = _port()
    txm.update_objects_static([("typed", C, "b", ("increment", 3))])
    txm.publish_serving_epoch()
    assert _epoch_read(store, [("typed", C, "b")]) == ([3], [])  # cached
    ep = store.serving_epoch
    assert store.epoch_cache_read([("typed", S, "b")], ep) is None
    _, fb = _epoch_read(store, [("typed", S, "b")])
    assert fb == [0]  # the locked path raises it
    with pytest.raises(TypeError, match="bound"):
        txm.read_objects_static([("typed", S, "b")])


def test_growth_drops_the_serving_epoch():
    store, txm, _ = _port()
    txm.update_objects_static([(i, C, "b", ("increment", 1))
                               for i in range(8)])
    txm.publish_serving_epoch()
    assert store.serving_epoch is not None
    # enough keys on one shard to grow the table
    txm.update_objects_static([(4 * i, C, "b", ("increment", 1))
                               for i in range(2, 80)])
    assert store.table(C).n_rows > KW["keys_per_table"]
    assert store.serving_epoch is None
    assert txm.publish_serving_epoch() == "published"
    assert _epoch_read(store, [(4 * 79, C, "b")]) == ([1], [])


# ---------------------------------------------------------------------------
# table epochs: rung 2 of the ladder, against a JAX table
# ---------------------------------------------------------------------------
class _TwinTables:
    """One-shard commit helper over a JAX and a port table fed the same
    effects (commit VCs on lane 0)."""

    def __init__(self, name):
        self.cfg = AntidoteConfig(**KW)
        self.jcfg = JaxConfig(**KW, batch_buckets=(16, 64))
        self.ty = get_type(name)
        self.jt = JaxTable(jax_type(name), self.jcfg, n_rows=8, n_shards=1)
        self.t = TypedTable(self.ty, self.cfg, n_rows=8, n_shards=1,
                            device="cpu")
        self.blobs = BlobStore()
        self.clock = np.zeros(self.cfg.max_dcs, np.int32)

    def commit(self, row, op):
        state = None
        if self.ty.require_state_downstream(op):
            st, _, _ = self.t.read(np.asarray([0]), np.asarray([row]),
                                   self.clock[None])
            state = {f: x[0] for f, x in st.items()}
        for a, b, _ in self.ty.downstream(op, state, self.blobs, self.cfg):
            self.clock[0] += 1
            args = (np.asarray([0]), np.asarray([row]), a[None], b[None],
                    self.clock.copy()[None], np.asarray([0], np.int32))
            self.jt.append(*args)
            self.t.append(*args)

    def read(self, rows, vcs):
        """Both tables' flat reads, held equal; returns the port's."""
        rows = np.asarray(rows)
        vcs = np.broadcast_to(np.asarray(vcs, np.int32),
                              (len(rows), self.cfg.max_dcs)).copy()
        zero = np.zeros(len(rows), np.int64)
        w_res, w_fresh, w_comp = self.jt.read_resolved_flat(zero, rows, vcs)
        g_res, g_fresh, g_comp = self.t.read_resolved_flat(zero, rows, vcs)
        for f in w_res:
            np.testing.assert_array_equal(np.asarray(w_res[f]),
                                          g_res[f].numpy(), err_msg=f)
        np.testing.assert_array_equal(np.asarray(w_fresh), g_fresh)
        np.testing.assert_array_equal(np.asarray(w_comp), g_comp)
        return ({f: x.numpy() for f, x in g_res.items()}, g_fresh, g_comp)

    def publish(self):
        self.jt.publish_epoch()
        self.t.publish_epoch()


def test_epoch_pinned_reads_survive_writes():
    d = _TwinTables(C)
    d.commit(0, ("increment", 5))
    d.commit(1, ("increment", 7))
    pin = d.clock.copy()
    d.publish()
    assert len(d.t.epochs) == 1
    for _ in range(20):
        d.commit(0, ("increment", 1))
    res, fresh, complete = d.read([0], pin)  # rung 2: a frozen gather
    assert fresh.all() and complete.all() and int(res["value"][0]) == 5
    assert d.t.slow_serves == d.jt.slow_serves == 0
    res, _, _ = d.read([0], d.clock)
    assert int(res["value"][0]) == 25
    below = pin.copy()
    below[0] -= 1  # excludes row 1's commit: the two-phase fold
    res, _, complete = d.read([1], below)
    assert complete.all() and int(res["value"][0]) == 0
    assert d.t.slow_serves == d.jt.slow_serves == 1
    assert d.t.fold_dispatches == {"kernel_counter": 1}


def test_epoch_mixed_batch_two_phase():
    d = _TwinTables(S)
    d.commit(0, ("add", 11))
    d.commit(1, ("add", 22))
    pin = d.clock.copy()
    expect_pin, _, c0 = d.read([0, 1], pin)
    assert c0.all()
    d.publish()
    d.commit(0, ("add", 33))
    after_w = d.clock.copy()
    d.publish()
    assert len(d.t.epochs) == 2
    expect_w, _, _ = d.read([0, 1], after_w)
    d.commit(1, ("add", 44))
    got, fresh, complete = d.read([0, 1], pin)  # the old epoch's cap
    assert complete.all() and fresh.all()
    for f in expect_pin:
        np.testing.assert_array_equal(got[f], expect_pin[f])
    got, fresh, complete = d.read([0, 1], after_w)
    assert complete.all() and fresh.all()
    for f in expect_w:
        np.testing.assert_array_equal(got[f], expect_w[f])
    below = pin.copy()
    below[0] -= 1  # below both pins: the fold, from the older epoch
    _, fresh, complete = d.read([0, 1], below)
    assert complete.all() and not fresh.all()
    assert d.t.fold_dispatches == {"kernel_set_aw": 1}


def test_epoch_invalidated_on_growth():
    d = _TwinTables(C)
    d.commit(0, ("increment", 3))
    d.publish()
    d.t._grow()
    assert d.t.epochs == []


def test_epoch_lru_retention():
    d = _TwinTables(C)
    d.commit(0, ("increment", 1))
    pin0 = d.clock.copy()
    d.publish()
    d.commit(0, ("increment", 1))
    d.publish()
    for _ in range(3):  # keep epoch 0 hot: a pinned reader at its cap
        d.read([0], pin0)
    d.commit(0, ("increment", 1))
    d.publish()  # evicts the UNUSED middle epoch, not the hot pin
    for t in (d.t, d.jt):
        caps = sorted(int(e["cap"][0]) for e in t.epochs)
        assert int(pin0[0]) in caps and len(t.epochs) == 2
    assert ([int(e["cap"][0]) for e in d.t.epochs]
            == [int(e["cap"][0]) for e in d.jt.epochs])


# ---------------------------------------------------------------------------
# threads: epoch reads never take the commit lock
# ---------------------------------------------------------------------------
class _WatchedLock:
    """The manager's commit lock, recording which threads acquire it."""

    def __init__(self, lock):
        self._lock = lock
        self.owners = set()

    def acquire(self, *a, **kw):
        got = self._lock.acquire(*a, **kw)
        if got:
            self.owners.add(threading.get_ident())
        return got

    def release(self):
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()


def test_epoch_reads_run_beside_commits_without_the_commit_lock():
    store, txm, _ = _port()
    txm.enable_serving_epochs()
    keys = [f"k{i}" for i in range(12)]
    txm.update_objects_static([(k, S, "b", ("add", 0)) for k in keys])
    watched = _WatchedLock(txm.commit_lock)
    txm.commit_lock = watched
    done, started = threading.Event(), threading.Event()
    errors, batches = [], []

    def writer():
        try:
            started.wait(30)  # the reader holds the first epoch's batch
            for r in range(1, 13):
                txm.update_objects_static([(keys[(r + j) % 12], S, "b",
                                            ("add", r)) for j in range(3)])
                time.sleep(0.001)  # let the reader run
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)
        finally:
            done.set()

    def reader():
        try:
            while True:
                last = done.is_set()  # one more batch after the writer
                ep = store.pin_serving_epoch()
                try:
                    pend, fb = store.epoch_read_launch(
                        [(k, S, "b") for k in keys], ep)
                    vals = store.epoch_read_finish(pend)
                finally:
                    store.unpin_serving_epoch(ep)
                assert fb == []
                batches.append((ep.id, ep.vc.copy(), vals))
                started.set()
                if last and len(batches) >= 3:
                    break
                time.sleep(0.001)  # let the writer run
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)
            started.set()

    rt = threading.Thread(target=reader)
    wt = threading.Thread(target=writer)
    rt.start()
    wt.start()
    wt.join(60)
    rt.join(60)
    assert not errors, errors
    assert rt.ident not in watched.owners and wt.ident in watched.owners
    # every batch equals the locked read at its epoch's clock
    seen = {}
    for eid, vc_, vals in batches:
        if eid not in seen:
            seen[eid] = store.read_values([(k, S, "b") for k in keys], vc_)
        assert vals == seen[eid]
    assert len(seen) >= 2  # the reader saw epochs advance under it
    # and a held commit lock does not stall an epoch read
    with watched:
        out = []
        t = threading.Thread(target=lambda: out.append(_epoch_read(
            store, [(k, S, "b") for k in keys])))
        t.start()
        t.join(10)
        assert not t.is_alive() and out[0][1] == []
