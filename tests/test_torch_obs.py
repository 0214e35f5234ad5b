"""The port's metrics registry against the JAX package's: the same bumps
give byte-identical prometheus exposition text from both ``NodeMetrics``
(each package's process-wide fabric counters replaced by fresh ones for
the comparison); a scripted workload bumps the manager's counters of both
nodes alike; and ``AntidoteNode(device="cpu").metrics`` works, its store
and manager counting into it, served over HTTP by ``serve_metrics``."""

import urllib.request

import pytest

from antidote_tpu.api import AntidoteNode as JaxNode
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu.obs import metrics as jax_metrics
from antidote_tpu.txn.manager import AbortError as JaxAbort
from antidote_tpu_torch.api import AbortError, AntidoteNode
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.obs import Timer, metrics, trace_span

KW = dict(n_shards=2, max_dcs=3, ops_per_key=4, snap_versions=2, set_slots=8,
          keys_per_table=8)


@pytest.fixture
def fresh_net(monkeypatch):
    """Both packages' process-wide fabric counters, fresh (other tests of
    the process may have bumped the JAX package's)."""
    monkeypatch.setattr(jax_metrics, "_NET", jax_metrics.NetMetrics())
    monkeypatch.setattr(metrics, "_NET", metrics.NetMetrics())


def _bump(m):
    m.operations.inc(3, type="read")
    m.operations.inc(type="update")
    m.open_transactions.inc()
    m.open_transactions.dec()
    m.open_transactions.inc(2)
    m.aborted_transactions.inc()
    m.snapshot_cache.inc(5, event="hit")
    m.snapshot_cache.inc(event="miss")
    m.serving_reads.inc(7, path="gather")
    m.epoch_publish.inc(mode="copy")
    m.epoch_rows.inc(4096, mode="copy")
    m.serving_epoch_id.set(12)
    m.fold_dispatch.inc(2, strategy="assoc")
    m.wal_segment_depth.set(77, segment="1")
    for v in (0.0004, 0.002, 0.3, 7.0):
        m.commit_seconds.observe(v)
    m.commit_batch_size.observe(3)
    m.commit_merge_width.observe(2)
    m.fold_seconds.observe(0.004, strategy="serial", type="set_aw")
    m.tenant_request_seconds.observe(0.2, tenant="gold")
    m.escrow_shortfall.set(5)
    m.shed.inc(plane="txn")
    m.cert_bypass.inc(4)
    m.observe_staleness(33.0)


def test_exposition_is_byte_identical(fresh_net):
    want, got = jax_metrics.NodeMetrics(), metrics.NodeMetrics()
    assert want.registry.expose() == got.registry.expose()  # all at zero
    _bump(want)
    _bump(got)
    jax_metrics.net_metrics().rpc_retries.inc(2)
    metrics.net_metrics().rpc_retries.inc(2)
    assert want.registry.expose() == got.registry.expose()
    assert got.snapshot_cache.value(event="hit") == 5
    assert got.commit_seconds.summary() == want.commit_seconds.summary()


def test_primitives_match_jax():
    texts = []
    for mod in (jax_metrics, metrics):
        r = mod.MetricsRegistry()
        c = r.counter("c_total", "a counter", ("k",))
        g = r.gauge("g", "a gauge")
        h = r.histogram("h_seconds", "a histogram", buckets=(0.1, 1.0))
        with pytest.raises(ValueError, match="already registered"):
            r.counter("c_total")
        c.inc(k="x")
        g.set(2.5)
        h.observe(0.5)
        h.observe(3.0)
        texts.append(r.expose())
    assert texts[0] == texts[1]
    assert h.percentile(0.5) == 1.0 and h.percentile(0.99) == float("inf")


def _script(node, abort_cls):
    node.update_objects([("c", "counter_pn", "b", ("increment", 2)),
                         ("s", "set_aw", "b", ("add", "x"))])
    node.read_objects([("c", "counter_pn", "b"), ("s", "set_aw", "b")])
    t1, t2 = node.start_transaction(), node.start_transaction()
    for t in (t1, t2):
        node.read_objects([("c", "counter_pn", "b")], txn=t)
        node.update_objects([("c", "counter_pn", "b", ("increment", 1))],
                            txn=t)
    node.commit_transaction(t1)
    with pytest.raises(abort_cls):
        node.commit_transaction(t2)
    t3 = node.start_transaction()
    node.abort_transaction(t3)
    node.update_objects([("m", "map_rr", "b", ("update", {
        ("f", "counter_pn"): ("increment", 1)}))])


def test_manager_counters_match_jax(fresh_net):
    jn = JaxNode(JaxConfig(**KW))
    tn = AntidoteNode(AntidoteConfig(**KW), device="cpu")
    _script(jn, JaxAbort)
    _script(tn, AbortError)
    for name in ("antidote_open_transactions",
                 "antidote_aborted_transactions_total",
                 "antidote_operations_total", "antidote_cert_bypass_total",
                 "antidote_escrow_refusals_total", "antidote_shed_total"):
        want = jn.metrics.registry.get(name).expose()
        assert tn.metrics.registry.get(name).expose() == want, name
    for name in ("commit_batch_size", "commit_merge_width",
                 "commit_seconds"):
        assert (getattr(tn.metrics, name).count
                == getattr(jn.metrics, name).count), name
    assert tn.metrics.open_transactions.value() == 0
    assert tn.metrics.aborted_transactions.value() == 2


def test_node_metrics_work_and_are_served():
    node = AntidoteNode(AntidoteConfig(**KW), device="cpu")
    assert isinstance(node.metrics, metrics.NodeMetrics)
    assert node.store.metrics is node.metrics is node.txm.metrics
    node.update_objects([("f", "flag_ew", "b", ("enable", None))])
    node.update_objects([("f", "flag_ew", "b", ("disable", None))])
    t = node.start_transaction()
    node.update_objects([("f", "flag_ew", "b", ("enable", None))])
    # the txn's snapshot is below the head: the read folds the ring
    assert node.read_objects([("f", "flag_ew", "b")], txn=t) == [False]
    node.commit_transaction(t)
    assert node.metrics.fold_dispatch.value(strategy="assoc") == 1
    assert node.store.materializer_status()["serving_folds"] == {"assoc": 1}
    srv = node.serve_metrics(port=0)
    try:
        assert node.serve_metrics(port=0) is srv
        url = f"http://127.0.0.1:{srv.port}/metrics"
        # no proxy: the request stays on this host
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        with opener.open(url, timeout=10) as resp:
            body = resp.read().decode()
        assert body == node.metrics.registry.expose()
        assert 'antidote_fold_dispatch_total{strategy="assoc"} 1' in body
        assert 'antidote_operations_total{type="update"} 3' in body
    finally:
        srv.close()


def test_timer_and_span_feed_histograms():
    h = metrics.MetricsRegistry().histogram("t_seconds", buckets=(1.0,))
    with Timer(h) as tm:
        pass
    with trace_span("read", h):
        pass
    assert h.count == 2 and tm.elapsed >= 0.0
