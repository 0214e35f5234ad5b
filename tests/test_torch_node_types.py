"""The node over all 13 types: one script of static and interactive
transactions runs through the JAX package's ``AntidoteNode`` and the
port's (``device="cpu"``) — nested maps, a map_rr remove and re-add, rga
inserts and deletes in one transaction, a counter_b commit group in which
exactly one member is refused, slot promotion of set_rw, register_mv and
rga keys, read-your-writes, concurrent (uncertified) writers and reads at
older snapshots.  Values, commit VCs, errors and the stores' directories
must be identical.  The JAX node's store is then carried across
(``carry.store_from_numpy``) and read back through the port."""

import itertools

import numpy as np
import pytest

from antidote_tpu.api import AntidoteNode as JaxNode
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu.crdt import registers as jax_registers
from antidote_tpu_torch.api import AntidoteNode
from antidote_tpu_torch.carry import store_from_numpy, table_arrays
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt import registers
from antidote_tpu_torch.txn.manager import TransactionManager

KW = dict(n_shards=2, max_dcs=3, ops_per_key=6, snap_versions=2, set_slots=4,
          mv_slots=2, rga_slots=8, keys_per_table=8)
Bk = "bkt"
NOCERT = {"certify": False}


def _plain(x):
    """Comparable form of a script result (arrays become lists, errors
    their class name and message)."""
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, BaseException):
        return (type(x).__name__, str(x))
    if isinstance(x, dict):
        return sorted(((_plain(k), _plain(v)) for k, v in x.items()),
                      key=repr)
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _script(node):
    out = []

    def log(tag, x):
        out.append((tag, _plain(x)))

    def attempt(tag, fn):
        try:
            log(tag, fn())
        except Exception as e:  # noqa: BLE001 — the error is the result
            log(tag, e)

    upd, read = node.update_objects, node.read_objects
    start, commit = node.start_transaction, node.commit_transaction
    every = [("cf", "counter_fat", Bk), ("cb", "counter_b", Bk),
             ("lww", "register_lww", Bk), ("mv", "register_mv", Bk),
             ("rw", "set_rw", Bk), ("go", "set_go", Bk),
             ("ew", "flag_ew", Bk), ("dw", "flag_dw", Bk),
             ("doc", "rga", Bk), ("m1", "map_rr", Bk), ("g1", "map_go", Bk),
             ("cp", "counter_pn", Bk), ("aw", "set_aw", Bk)]

    # --- one static txn over every type -------------------------------
    log("static", upd([
        ("cf", "counter_fat", Bk, ("increment", 5)),
        ("cb", "counter_b", Bk, ("increment", (10, 0))),
        ("lww", "register_lww", Bk, ("assign", "v1")),
        ("mv", "register_mv", Bk, ("assign", "x")),
        ("rw", "set_rw", Bk, ("add_all", ["a", "b"])),
        ("go", "set_go", Bk, ("add", 1)),
        ("ew", "flag_ew", Bk, ("enable", None)),
        ("dw", "flag_dw", Bk, ("enable", None)),
        ("doc", "rga", Bk, ("insert", (0, "h"))),
        ("m1", "map_rr", Bk, ("update", {
            ("clicks", "counter_pn"): ("increment", 3),
            ("name", "register_lww"): ("assign", "user"),
            ("tags", "set_aw"): ("add_all", ["t1", "t2"]),
            ("sub", "map_rr"): ("update", {
                ("on", "flag_ew"): ("enable", None),
                ("n", "counter_fat"): ("increment", 2)})})),
        ("g1", "map_go", Bk, ("update", [
            (("f", "set_go"), ("add_all", [1, 2])),
            (("v", "register_mv"), ("assign", "mv1"))])),
        ("cp", "counter_pn", Bk, ("increment", 1)),
        ("aw", "set_aw", Bk, ("add", "z")),
    ]))
    log("latest0", read(every))
    old = start()  # kept open for reads at this snapshot

    # --- interactive: rga inserts and deletes, read-your-writes --------
    t = start()
    upd([("doc", "rga", Bk, ("insert", (1, "a"))),
         ("doc", "rga", Bk, ("insert", (2, "b"))),
         ("doc", "rga", Bk, ("delete", 0)),
         ("doc", "rga", Bk, ("insert", (0, "c"))),
         ("m1", "map_rr", Bk, ("update", {("tags", "set_aw"): ("add", "t3")})),
         ("cf", "counter_fat", Bk, ("reset", None)),
         ("cf", "counter_fat", Bk, ("increment", 4)),
         ("mv", "register_mv", Bk, ("assign", "y")),
         ("dw", "flag_dw", Bk, ("disable", None))], txn=t)
    log("ryw", read(every, txn=t))
    upd([("doc", "rga", Bk, ("insert", (3, "d"))),
         ("m1", "map_rr", Bk, ("remove", ("name", "register_lww")))], txn=t)
    log("ryw2", read([("doc", "rga", Bk), ("m1", "map_rr", Bk)], txn=t))
    log("commit-ryw", commit(t))

    # --- map_rr: remove a field, re-add it; a concurrent uncertified
    # update wins over a concurrent remove (add-wins membership) --------
    log("rm-field", upd([("m1", "map_rr", Bk,
                          ("remove_all", [("tags", "set_aw"),
                                          ("sub", "map_rr")]))]))
    log("after-rm", read([("m1", "map_rr", Bk)]))
    log("re-add", upd([("m1", "map_rr", Bk, ("update", {
        ("tags", "set_aw"): ("add", "t9")}))]))
    ta, tb = start(props=NOCERT), start(props=NOCERT)
    upd([("m1", "map_rr", Bk, ("update", {
        ("clicks", "counter_pn"): ("increment", 10)}))], txn=ta)
    upd([("m1", "map_rr", Bk, ("remove", ("clicks", "counter_pn")))], txn=tb)
    log("rr-concurrent", [commit(tb), commit(ta)])
    log("after-concurrent", read([("m1", "map_rr", Bk),
                                  ("g1", "map_go", Bk)]))

    # --- counter_b: a commit group whose middle member is refused (the
    # members skip certification, so the escrow pass alone decides) -----
    t1, t2, t3 = (start(props=NOCERT) for _ in range(3))
    upd([("cb", "counter_b", Bk, ("decrement", (5, 0)))], txn=t1)
    upd([("cb", "counter_b", Bk, ("decrement", (6, 0))),
         ("cf", "counter_fat", Bk, ("increment", 100))], txn=t2)
    upd([("cb", "counter_b", Bk, ("decrement", (4, 0)))], txn=t3)
    res = node.txm.commit_transactions_group([t1, t2, t3])
    log("escrow-group", res)
    log("escrow-error", [(type(r).__name__, r.needed, r.held,
                          r.retry_after_ms)
                         for r in res if isinstance(r, Exception)])
    # increments of the same txn cover its own decrement; a transfer
    # moves rights to lane 1, past which lane 0 is refused
    log("escrow-net", upd([("cb", "counter_b", Bk, ("increment", (3, 0))),
                           ("cb", "counter_b", Bk, ("decrement", (3, 0)))]))
    log("transfer", upd([("cb", "counter_b", Bk, ("transfer", (1, 1, 0)))]))
    attempt("overspend", lambda: upd([("cb", "counter_b", Bk,
                                       ("decrement", (1, 0)))]))
    attempt("other-lane", lambda: upd([("cb", "counter_b", Bk,
                                        ("decrement", (1, 1)))]))
    log("escrow-status", node.txm.bcounters.status())

    mid = start()
    # --- slot promotion: set_rw, register_mv (concurrent assigns), rga -
    log("rw-grow", upd([("rw", "set_rw", Bk,
                         ("add_all", [f"e{i}" for i in range(6)]))]))
    log("rw-rm", upd([("rw", "set_rw", Bk, ("remove_all", ["e1", "a"]))]))
    mvs = [start(props=NOCERT) for _ in range(3)]
    for i, tx in enumerate(mvs):
        upd([("mv", "register_mv", Bk, ("assign", f"c{i}"))], txn=tx)
    log("mv-concurrent", [commit(tx) for tx in mvs])
    for i in range(3):
        log(f"doc-grow{i}", upd([("doc", "rga", Bk, ("insert", (j, f"g{i}{j}")))
                                 for j in range(4)]))
    log("doc-delete", upd([("doc", "rga", Bk, ("delete", 2))]))
    # concurrent enable / disable of both flags, add / remove of set_rw
    fa, fb = start(props=NOCERT), start(props=NOCERT)
    upd([("ew", "flag_ew", Bk, ("enable", None)),
         ("dw", "flag_dw", Bk, ("enable", None)),
         ("rw", "set_rw", Bk, ("add", "e3"))], txn=fa)
    upd([("ew", "flag_ew", Bk, ("disable", None)),
         ("dw", "flag_dw", Bk, ("disable", None)),
         ("rw", "set_rw", Bk, ("remove", "e3"))], txn=fb)
    log("flags-concurrent", [commit(fa), commit(fb)])
    # more commits on a few keys than their rings hold (GC folds)
    for i in range(6):
        upd([("cf", "counter_fat", Bk, ("increment", i)),
             ("lww", "register_lww", Bk, ("assign", f"v{i}")),
             ("go", "set_go", Bk, ("add", i % 3))])
    log("latest", read(every))
    # at the old snapshot, keys whose history was GC'd past the retained
    # versions raise in both packages (no log to replay)
    for tag, snap in (("old", old), ("mid", mid)):
        for o in every:
            attempt(f"{tag}-{o[0]}", lambda: read([o], txn=snap))
        commit(snap)
    log("stable", node.stable_vc())
    return out


def _run(node_cls, cfg, patch_target, **kw):
    node = node_cls(cfg, **kw)
    ticks = itertools.count(10_000, 7)
    with pytest.MonkeyPatch.context() as mp:
        # the LWW downstream reads the wall clock: one tape for both
        mp.setattr(patch_target, "_now_micros", lambda: next(ticks))
        return node, _script(node)


@pytest.fixture(scope="module")
def nodes():
    jn, want = _run(JaxNode, JaxConfig(**KW, batch_buckets=(16, 64)),
                    jax_registers)
    tn, got = _run(AntidoteNode, AntidoteConfig(**KW), registers,
                   device="cpu")
    return jn, tn, want, got


def test_script_over_every_type_matches_jax(nodes):
    jn, tn, want, got = nodes
    assert [t for t, _ in got] == [t for t, _ in want]
    for (tag, w), (_, g) in zip(want, got):
        assert g == w, tag
    log = dict(want)
    # the script reached its edges in the reference itself
    assert [r for r in log["escrow-group"] if isinstance(r, list)
            and r[0] == "InsufficientRightsError"] == []
    assert log["escrow-error"][0][:3] == ["InsufficientRightsError", 6, 5]
    assert log["overspend"][0] == "InsufficientRightsError"
    assert log["other-lane"][0] == "AbortError"
    assert len(log["mv-concurrent"]) == 3
    assert jn.store.promotions == tn.store.promotions >= 3
    assert {n.split("#")[0] for n in tn.store.tables if "#" in n} >= {
        "set_rw", "register_mv", "rga"}
    assert set(tn.store.tables) == set(jn.store.tables)
    assert dict(tn.store.directory) == dict(jn.store.directory)


def test_carried_store_reads_every_type_like_jax(nodes):
    """The JAX node's store — every device type, promoted tiers, map
    membership and field keys — carried into the port: the maps and the
    plain objects read the same through a port manager over it."""
    jn, tn, _, _ = nodes
    js = jn.store
    carried = store_from_numpy(
        AntidoteConfig(**KW),
        {name: table_arrays(t) for name, t in js.tables.items()},
        dict(js.directory), js.applied_vc,
        {h: js.blobs.bytes_of(h) for h in js.blobs._by_handle}, device="cpu")
    assert {n.split("#")[0] for n in carried.tables} == {
        "counter_fat", "counter_b", "register_lww", "register_mv", "set_rw",
        "set_go", "flag_ew", "flag_dw", "rga", "counter_pn", "set_aw"}
    objs = [(k, tn.store.directory[(k, b)][0].split("#")[0], b)
            for k, b in tn.store.directory]
    objs += [("m1", "map_rr", Bk), ("g1", "map_go", Bk)]
    clock = js.dc_max_vc()
    txm = TransactionManager(carried)
    want, _ = jn.read_objects(objs, clock=clock)
    got, _ = txm.read_objects_static(objs, clock=clock)
    assert _plain(got) == _plain(want)
    assert _plain(tn.read_objects(objs, clock=clock)[0]) == _plain(want)
