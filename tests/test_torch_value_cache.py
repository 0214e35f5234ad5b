"""The decoded-value cache and the manager's serving-epoch decisions,
against the JAX package: the value-cache scenarios of the JAX node's own
tests (invalidation on write, historical reads bypassing the cache,
isolation from client mutation, nested maps) run on both nodes with
equal results, and the port's cache is shown to serve; then the same
commits through two managers with serving epochs on, ``time.monotonic``
patched to one scripted clock in both packages, make the same inline
publish decisions (epoch ids, lag floors, publish modes)."""

import time

import numpy as np
import pytest

from antidote_tpu.api import AntidoteNode as JaxNode
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu_torch.api import AntidoteNode
from antidote_tpu_torch.config import AntidoteConfig

KW = dict(n_shards=4, max_dcs=3, ops_per_key=8, snap_versions=2,
          set_slots=8, keys_per_table=64)


@pytest.fixture
def nodes():
    return JaxNode(JaxConfig(**KW)), AntidoteNode(AntidoteConfig(**KW),
                                                  device="cpu")


def _both(nodes, fn):
    """Run ``fn(node)`` on both nodes; the results must be equal."""
    want, got = fn(nodes[0]), fn(nodes[1])
    assert got == want
    return got


def _cached(node, key, bucket="b"):
    return (key, bucket) in node.store._value_cache


def test_value_cache_invalidation_on_write(nodes):
    def script(node):
        out = []
        node.update_objects([("c", "counter_pn", "b", ("increment", 1))])
        for _ in range(3):
            out.append(node.read_objects([("c", "counter_pn", "b")])[0])
            out.append(_cached(node, "c"))
            out.append(node.read_objects([("c", "counter_pn", "b")])[0])
            node.update_objects([("c", "counter_pn", "b", ("increment", 1))])
            out.append(_cached(node, "c"))  # the write dropped the entry
        node.update_objects([("m", "map_rr", "b", ("update", {
            ("k", "counter_pn"): ("increment", 5)}))])
        out.append(node.read_objects([("m", "map_rr", "b")])[0])
        out.append(_cached(node, "m"))  # the assembled map, whole
        out.append(node.read_objects([("m", "map_rr", "b")])[0])
        node.update_objects([("m", "map_rr", "b", ("update", {
            ("k", "counter_pn"): ("increment", 2)}))])
        out.append(_cached(node, "m"))  # a field write drops the parent
        out.append(node.read_objects([("m", "map_rr", "b")])[0])
        return out

    out = _both(nodes, script)
    assert [out[i] for i in (0, 2, 4, 6, 8, 10)] == [[1], [1], [2], [2],
                                                     [3], [3]]
    assert out[1] and not out[3]
    assert out[-1][0][("k", "counter_pn")] == 7
    assert out[-4] and not out[-2]


def test_value_cache_historical_reads_bypass(nodes):
    def script(node):
        node.update_objects([("s", "set_aw", "b", ("add", "x"))])
        txn = node.start_transaction()  # snapshot: only x
        node.update_objects([("s", "set_aw", "b", ("add", "y"))])
        out = [node.read_objects([("s", "set_aw", "b")])[0][0]]
        out.append(_cached(node, "s"))
        out.append(node.read_objects([("s", "set_aw", "b")], txn)[0])
        node.commit_transaction(txn)
        out.append(node.read_objects([("s", "set_aw", "b")])[0][0])
        return out

    assert _both(nodes, script) == [["x", "y"], True, ["x"], ["x", "y"]]


def test_value_cache_client_mutation_isolated(nodes):
    def script(node):
        node.update_objects([("s2", "set_aw", "b",
                              ("add_all", ["a", "b"]))])
        vals, _ = node.read_objects([("s2", "set_aw", "b")])
        vals[0].append("EVIL")
        out = [node.read_objects([("s2", "set_aw", "b")])[0][0]]
        node.update_objects([("m2", "map_rr", "b", ("update", {
            ("t", "set_aw"): ("add", "z")}))])
        mv, _ = node.read_objects([("m2", "map_rr", "b")])
        mv[0][("t", "set_aw")].append("EVIL")
        mv[0][("extra", "counter_pn")] = 666
        out.append(node.read_objects([("m2", "map_rr", "b")])[0][0])
        return out

    assert _both(nodes, script) == [["a", "b"], {("t", "set_aw"): ["z"]}]


def test_value_cache_nested_map_mutation_isolated(nodes):
    def script(node):
        node.update_objects([("mm", "map_rr", "b", ("update", {
            ("n", "map_rr"): ("update", {
                ("c", "counter_pn"): ("increment", 1)}),
        }))])
        v, _ = node.read_objects([("mm", "map_rr", "b")])
        v[0][("n", "map_rr")][("c", "counter_pn")] = 999
        out = [node.read_objects([("mm", "map_rr", "b")])[0][0]]
        # a write to the NESTED field drops both ancestors' entries
        node.update_objects([("mm", "map_rr", "b", ("update", {
            ("n", "map_rr"): ("update", {
                ("c", "counter_pn"): ("increment", 1)}),
        }))])
        out.append(_cached(node, "mm"))
        out.append(node.read_objects([("mm", "map_rr", "b")])[0][0])
        return out

    got = _both(nodes, script)
    assert got[0] == {("n", "map_rr"): {("c", "counter_pn"): 1}}
    assert got[1] is False
    assert got[2] == {("n", "map_rr"): {("c", "counter_pn"): 2}}


def test_value_cache_serves_without_the_device(nodes, monkeypatch):
    """A repeated latest read is a cache hit: the store's device read is
    not called again; a fill racing a commit is dropped."""
    node = nodes[1]
    node.update_objects([("h", "counter_pn", "b", ("increment", 4))])
    assert node.read_objects([("h", "counter_pn", "b")])[0] == [4]

    def no_read(*a, **kw):
        raise AssertionError("the device read ran on a cache hit")

    monkeypatch.setattr(node.store, "read_resolved", no_read)
    assert node.read_objects([("h", "counter_pn", "b")])[0] == [4]
    monkeypatch.undo()
    store = node.store
    epoch = store.mutation_epoch
    node.update_objects([("h2", "counter_pn", "b", ("increment", 1))])
    store.value_cache_fill("h2", "b", 0, store.applied_max_tuple(), epoch)
    assert ("h2", "b") not in store._value_cache
    assert node.read_objects([("h2", "counter_pn", "b")])[0] == [1]


# ---------------------------------------------------------------------------
# inline publish decisions under one scripted clock
# ---------------------------------------------------------------------------
class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_inline_publish_decisions_match_jax(nodes, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    for n in nodes:
        n.txm.enable_serving_epochs()
    assert all(n.txm.serving_epochs for n in nodes)

    def state(node):
        ep = node.store.serving_epoch
        m = node.metrics.epoch_publish
        return (None if ep is None else ep.id,
                None if ep is None else ep.vc.tolist(),
                node.txm.epoch_lag_counter, node.txm.commit_counter,
                m.value(mode="copy"), m.value(mode="scatter"),
                m.value(mode="defer"))

    def epoch_read(node, keys):
        st = node.store
        ep = st.pin_serving_epoch()
        try:
            pend, fb = st.epoch_read_launch(
                [(k, "counter_pn", "b") for k in keys], ep)
            return st.epoch_read_finish(pend), fb
        finally:
            st.unpin_serving_epoch(ep)

    steps = [("w", 0.0), ("w", 0.010), ("w", 0.010), ("w", 0.030),
             ("r", 0.0), ("w", 0.001), ("w", 0.001), ("r", 0.0),
             ("pin", 0.0), ("w", 0.001), ("w", 0.030), ("tick", 0.0),
             ("unpin", 0.0), ("tick", 0.0), ("w", 0.040), ("w", 0.001),
             ("tick", 0.0)]
    trace = {0: [], 1: []}
    pins = {}
    for i, (kind, dt) in enumerate(steps):
        clock.t += dt
        for j, node in enumerate(nodes):
            if kind == "w":
                node.update_objects([(f"k{i % 3}", "counter_pn", "b",
                                      ("increment", i + 1))])
            elif kind == "r":
                trace[j].append(epoch_read(node, ["k0", "k1", "k2"]))
            elif kind == "pin":
                pins[j] = node.store.pin_serving_epoch()
            elif kind == "unpin":
                node.store.unpin_serving_epoch(pins[j])
            else:
                trace[j].append(node.txm.publish_serving_epoch())
            trace[j].append(state(node))
    assert trace[1] == trace[0]
    lags = [s[2] for s in trace[1] if isinstance(s, tuple) and len(s) == 7]
    assert max(lags) > 0  # some rounds skipped their publish
    assert any(s[6] > 0 for s in trace[1] if isinstance(s, tuple)
               and len(s) == 7)  # and some deferred under the pin
    final = nodes[1].read_objects([("k0", "counter_pn", "b")])[0]
    assert final == nodes[0].read_objects([("k0", "counter_pn", "b")])[0]
    assert np.asarray(nodes[1].store.serving_epoch.vc).tolist() == \
        nodes[1].txm.serving_epoch_vc().tolist()
