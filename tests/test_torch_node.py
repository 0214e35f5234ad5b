"""The slice as a whole: one scripted workload runs on the JAX package's
in-memory ``AntidoteNode`` and on the port's node (``device="cpu"``).
Values, commit VCs, aborts and ``stable_vc`` must be identical.  The JAX
node's store is then carried across (``carry.store_from_numpy``) and read
back through the port."""

import numpy as np
import pytest

from antidote_tpu.api import AntidoteNode as JaxNode
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu.txn.manager import AbortError as JaxAbort
from antidote_tpu_torch.api import AbortError, AntidoteNode
from antidote_tpu_torch.carry import store_from_numpy, table_arrays
from antidote_tpu_torch.config import AntidoteConfig

KW = dict(n_shards=2, max_dcs=3, ops_per_key=4, snap_versions=2, set_slots=8,
          keys_per_table=8)
S, C, B = "set_aw", "counter_pn", "bkt"


def _plain(x):
    """Comparable form of a script result (arrays become lists)."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _script(node, abort_cls):
    out = []

    def log(tag, x):
        out.append((tag, _plain(x)))

    log("static", node.update_objects([
        ("s1", S, B, ("add", "a")), ("c1", C, B, ("increment", 5)),
        (7, S, B, ("add_all", [1, 2, 3])),
    ]))
    old = node.start_transaction()  # snapshot kept for historical reads
    # interactive txn with read-your-writes
    t = node.start_transaction()
    node.update_objects([("s1", S, B, ("add", "b")),
                         ("c1", C, B, ("decrement", 2))], txn=t)
    log("ryw", node.read_objects([("s1", S, B), ("c1", C, B)], txn=t))
    node.update_objects([("s1", S, B, ("remove", "a"))], txn=t)
    log("ryw2", node.read_objects([("s1", S, B)], txn=t))
    log("commit", node.commit_transaction(t))
    # two racing read-modify-write txns: the second first-committer-aborts
    t1, t2 = node.start_transaction(), node.start_transaction()
    for tx in (t1, t2):
        log("rmw-read", node.read_objects([("c2", C, B)], txn=tx))
        node.update_objects([("c2", C, B, ("increment", 1))], txn=tx)
    log("rmw1", node.commit_transaction(t1))
    try:
        node.commit_transaction(t2)
        log("rmw2", "committed")
    except abort_cls:
        log("rmw2", "aborted")
    # blind commutative writers never abort each other
    b1, b2 = node.start_transaction(), node.start_transaction()
    for tx, n in ((b1, 3), (b2, 4)):
        node.update_objects([("c2", C, B, ("increment", n))], txn=tx)
    log("blind", [node.commit_transaction(b1), node.commit_transaction(b2)])
    # a set past its slot budget: promoted to a wider tier, then churned
    log("grow", node.update_objects([
        ("big", S, B, ("add_all", [f"e{i}" for i in range(20)]))]))
    log("shrink", node.update_objects([
        ("big", S, B, ("remove_all", [f"e{i}" for i in range(0, 20, 3)]))]))
    mid = node.start_transaction()
    # more commits on one key than its ring holds (GC folds)
    for i in range(11):
        op = ("increment", i + 1) if i % 3 else ("decrement", 2 * i)
        node.update_objects([("c3", C, B, op), ("s3", S, B, ("add", i % 5))])
        if i % 4 == 3:
            node.update_objects([("s3", S, B, ("remove", (i + 1) % 5))])
    log("latest", node.read_objects([("c1", C, B), ("c2", C, B),
                                     ("c3", C, B), ("s1", S, B),
                                     ("s3", S, B), ("big", S, B),
                                     (7, S, B), ("never", S, B)]))
    # reads at older snapshots: through the ring fold
    log("old", node.read_objects([("s1", S, B), ("c1", C, B), (7, S, B),
                                  ("c2", C, B)], txn=old))
    log("mid", node.read_objects([("c2", C, B), ("big", S, B)], txn=mid))
    for tx in (old, mid):
        node.commit_transaction(tx)
    log("stable", node.stable_vc())
    return out


@pytest.fixture(scope="module")
def nodes():
    jn = JaxNode(JaxConfig(**KW, batch_buckets=(16, 64)))
    tn = AntidoteNode(AntidoteConfig(**KW), device="cpu")
    return jn, tn, _script(jn, JaxAbort), _script(tn, AbortError)


def test_script_matches_jax(nodes):
    jn, tn, want, got = nodes
    assert [t for t, _ in got] == [t for t, _ in want]
    for (tag, w), (_, g) in zip(want, got):
        assert g == w, tag
    assert dict(want)["rmw2"] == "aborted"
    assert tn.store.promotions == jn.store.promotions >= 1
    assert set(tn.store.tables) == set(jn.store.tables)
    assert dict(tn.store.directory) == dict(jn.store.directory)
    for s in range(KW["n_shards"]):
        assert (set(tn.store.directory.shard_keys(s))
                == set(jn.store.directory.shard_keys(s)))


def test_carried_store_reads_like_jax(nodes):
    jn, tn, _, _ = nodes
    js = jn.store
    carried = store_from_numpy(
        AntidoteConfig(**KW),
        {name: table_arrays(t) for name, t in js.tables.items()},
        dict(js.directory), js.applied_vc,
        {h: js.blobs.bytes_of(h) for h in js.blobs._by_handle}, device="cpu")
    objs = [(k, tn.store.directory[(k, b)][0].split("#")[0], b)
            for k, b in tn.store.directory]
    assert len(objs) == 7
    # at an early VC, only keys whose history was never GC'd are readable
    # without the log; the others raise in both packages
    early = [o for o in objs if o[0] in ("s1", "c1", 7, "c2")]
    for vc, ob in ((js.stable_vc(), objs),
                   (np.asarray([3, 0, 0], np.int32), early)):
        want = js.read_values(ob, vc)
        assert carried.read_values(ob, vc) == want
        assert tn.store.read_values(ob, vc) == want
    gcd = [o for o in objs if o[0] == "c3"]
    for store in (js, carried):
        with pytest.raises(RuntimeError, match="no log attached"):
            store.read_values(gcd, np.asarray([3, 0, 0], np.int32))


def test_unported_node_options_raise(nodes):
    tn = nodes[1]
    # the durable log, store adoption, the cold tier and the metadata
    # store are ported (tests/test_torch_log.py, test_torch_handoff.py,
    # test_torch_coldtier.py, test_torch_meta.py): a store adopts, and a
    # residency bound without a log raises as the JAX node's does
    adopted = AntidoteNode(store=tn.store)
    assert adopted.store is tn.store and adopted.cfg is tn.store.cfg
    with pytest.raises(RuntimeError, match="log_dir"):
        AntidoteNode(AntidoteConfig(**KW), resident_rows=10, device="cpu")
    # the metadata store is ported: ``meta=`` is the node's own
    from antidote_tpu_torch.meta import MetaDataStore

    meta = MetaDataStore()
    assert AntidoteNode(AntidoteConfig(**KW), meta=meta,
                        device="cpu").meta is meta
    with pytest.raises(NotImplementedError):
        tn.txm.__class__(tn.store, protocol="gr")
    assert tn.is_type("rga") and not tn.is_type("nope")
    # the escrow rights-transfer loop rides the inter-DC channel
    with pytest.raises(NotImplementedError, match="inter-DC"):
        tn.txm.bcounters.transfer_periodic(None, None)

