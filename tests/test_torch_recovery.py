"""Durability across packages: a log directory written by either package
recovers in the other to the same state.

  * a JAX node writes WAL, a full checkpoint, a delta link and a tail; the
    port recovers it (and the reverse), and both recovered nodes agree on
    the recovery digest, on every value at every clock of the script
    (a read below the compaction horizon raises in both), and on
    ``carry.table_arrays`` of every table;
  * the same without a checkpoint (whole-log recovery), both ways;
  * read-only mode under an armed ``wal.append`` ENOSPC, one script on
    each package;
  * ``_replay_read_many`` states and fold rungs equal to the JAX store's;
  * a grouped apply with one member refused by the WAL: the store's
    clocks, dirty-key window, directory and tables equal the JAX store's;
  * the two repairs of this slice: ``TypedTable.max_abs_delta`` and
    ``KVStore.apply_effect_groups`` returning ``(errors, ticket)``.

All state is integer, so every comparison is exact equality."""

import dataclasses

import numpy as np
import pytest

from antidote_tpu import faults as jfaults
from antidote_tpu.api import AntidoteNode as JaxNode
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu.crdt import get_type as jget_type
from antidote_tpu.log import LogManager as JaxLogManager
from antidote_tpu.store import TypedTable as JaxTable
from antidote_tpu.store.kv import Effect as JaxEffect
from antidote_tpu.store.kv import KVStore as JaxStore
from antidote_tpu_torch import faults
from antidote_tpu_torch.api import AntidoteNode
from antidote_tpu_torch.carry import table_arrays
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.log import LogManager
from antidote_tpu_torch.log import checkpoint as ckpt
from antidote_tpu_torch.log.wal import FsyncTicket
from antidote_tpu_torch.store import TypedTable
from antidote_tpu_torch.store.kv import Effect, KVStore

KW = dict(n_shards=4, max_dcs=3, ops_per_key=8, snap_versions=2, set_slots=8,
          mv_slots=4, rga_slots=16, keys_per_table=16, wal_segments=2)


def _cfgs(**over):
    kw = dict(KW, **over)
    return AntidoteConfig(**kw), JaxConfig(batch_buckets=(16, 64), **kw)


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faults.uninstall()
    jfaults.uninstall()


def _open(pkg, cfgs, log_dir, recover=False):
    cfg, jcfg = cfgs
    if pkg == "jax":
        return JaxNode(jcfg, log_dir=log_dir, recover=recover)
    return AntidoteNode(cfg, log_dir=log_dir, recover=recover, device="cpu")


OBJS = [("c", "counter_pn", "b"), ("c2", "counter_pn", "b"),
        ("s", "set_aw", "b"), ("big", "set_aw", "b"),
        ("r", "register_lww", "b"), ("m", "map_rr", "b"),
        ("f", "flag_ew", "b"), (("t", 7), "set_aw", "b"),
        ("mv", "register_mv", "b")]


def _write_script(node, checkpoints: bool):
    """Writes with a full image and a delta link taken midway (when
    ``checkpoints``) and a tail after; returns every commit clock."""
    rng = np.random.default_rng(7)
    vcs = []

    def w(ups):
        vcs.append(np.asarray(node.update_objects(ups)).copy())

    for i in range(6):
        w([("c", "counter_pn", "b", ("increment", int(rng.integers(1, 9)))),
           (f"k{i}", "counter_pn", "b", ("increment", -i - 1)),
           ("s", "set_aw", "b", ("add_all", [f"a{i}", f"b{i % 2}"])),
           ("r", "register_lww", "b", ("assign", f"v{i}"))])
    w([("big", "set_aw", "b", ("add_all", [f"e{i}" for i in range(20)]))])
    w([("m", "map_rr", "b", ("update", {("x", "counter_pn"):
                                        ("increment", 2)})),
       ("f", "flag_ew", "b", ("enable", ())),
       (("t", 7), "set_aw", "b", ("add", 1)),
       ("mv", "register_mv", "b", ("assign", "m1"))])
    if checkpoints:
        node.start_checkpointer(interval_s=0.0, rebase_every=64)
        assert node.checkpoint_now(full=True)["kind"] == "full"
    for i in range(5):
        w([("c", "counter_pn", "b", ("increment", 1)),
           ("c2", "counter_pn", "b", ("increment", 10 + i)),
           ("s", "set_aw", "b", ("remove", f"a{i}"))])
    w([("big", "set_aw", "b", ("add_all", [f"g{i}" for i in range(12)])),
       ("f", "flag_ew", "b", ("disable", ())),
       ("m", "map_rr", "b", ("update", {("y", "set_aw"): ("add", "q")}))])
    if checkpoints:
        assert node.checkpoint_now()["kind"] == "delta"
    for i in range(4):
        w([("c", "counter_pn", "b", ("increment", 2)),
           ("s", "set_aw", "b", ("add", f"tail{i}")),
           ("mv", "register_mv", "b", ("assign", f"m{i + 2}"))])
    return vcs


def _digest(node):
    return {"op_ids": node.store.log.op_ids.tolist(),
            "seqs": node.store.log.seqs.tolist(),
            "floors": node.store.log.floor_seqs.tolist(),
            "stable": [int(x) for x in node.stable_vc()],
            "commit_counter": int(node.txm.commit_counter),
            # keys, not their locations: a replay that applies several
            # commits in one batch may promote a key the live node kept
            # (the JAX package's rule too; both recoveries agree, which
            # the table comparison holds)
            "keys": sorted(map(repr, node.store.directory)),
            "committed": sorted(map(repr, node.txm.committed_keys.items()))}


def _read_at(node, vc):
    """Each object's value at ``vc``, or the error's class name (one
    object per read: a horizon error fails its whole batch)."""
    out = []
    for obj in OBJS:
        txn = node.start_transaction()
        txn.snapshot_vc = np.asarray(vc, np.int32)
        try:
            out.append(node.read_objects([obj], txn)[0])
        except RuntimeError as e:
            assert "compaction horizon" in str(e)
            out.append("horizon")
        finally:
            node.abort_transaction(txn)
    return out


def _tables(node):
    return {name: table_arrays(t) for name, t in node.store.tables.items()}


def _assert_tables_equal(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        ta, tb = a[name], b[name]
        for field, x in ta.items():
            y = tb[field]
            if isinstance(x, dict):
                assert sorted(x) == sorted(y), (name, field)
                for f in x:
                    assert np.array_equal(x[f], y[f]), (name, field, f)
            else:
                assert np.array_equal(np.asarray(x), np.asarray(y)), (
                    name, field)


def _close(node):
    node.store.log.close()


@pytest.mark.parametrize("checkpoints", [True, False],
                         ids=["image+delta+tail", "whole-log"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_directory_recovers_in_both_packages(tmp_path, writer, checkpoints):
    cfgs = _cfgs()
    d = str(tmp_path / "wal")
    live = _open(writer, cfgs, d)
    vcs = _write_script(live, checkpoints)
    want_latest = live.read_objects(OBJS)[0]
    want_digest = _digest(live)
    _close(live)
    if checkpoints:
        chain = ckpt.load_chain(d)
        assert chain is not None and len(chain[2]) == 1
    nodes = {pkg: _open(pkg, cfgs, d, recover=True)
             for pkg in ("jax", "port")}
    for pkg, node in nodes.items():
        assert node.read_objects(OBJS)[0] == want_latest, pkg
        got = _digest(node)
        assert got == want_digest, pkg
    per_clock = {pkg: [_read_at(n, vc) for vc in vcs]
                 for pkg, n in nodes.items()}
    assert per_clock["port"] == per_clock["jax"]
    flat = [v for row in per_clock["port"] for v in row]
    assert ("horizon" in flat) == checkpoints
    _assert_tables_equal(_tables(nodes["jax"]), _tables(nodes["port"]))
    # a commit after recovery mints a clock above every recovered one
    for node in nodes.values():
        vc = node.update_objects([("c", "counter_pn", "b",
                                   ("increment", 1))])
        assert vc[0] == vcs[-1][0] + 1
        _close(node)


def _ro_script(node, fmod, ro_error):
    """Writes under an armed ``wal.append`` ENOSPC; returns what each step
    observed."""
    out = []

    def attempt(tag, k):
        try:
            node.update_objects([(k, "counter_pn", "b", ("increment", 1))])
            out.append((tag, "ok"))
        except ro_error as e:
            out.append((tag, "read-only", "ENOSPC" in e.reason))

    attempt("before", "a")
    fmod.install(fmod.FaultPlan(seed=5).enospc("wal.append", times=2))
    attempt("armed", "a")
    out.append(("reason", node.txm.read_only_reason is not None,
                node.metrics.degraded_read_only.value()))
    out.append(("reads", node.read_objects([("a", "counter_pn", "b")])[0]))
    attempt("within-probe-interval", "b")
    node.txm._ro_probe_at = 0.0
    attempt("probe-fires", "b")  # the probe consumes the second firing
    node.txm._ro_probe_at = 0.0
    attempt("healed", "b")
    out.append(("after", node.read_objects([("a", "counter_pn", "b"),
                                            ("b", "counter_pn", "b")])[0],
                node.txm.read_only_reason,
                node.metrics.degraded_read_only.value(),
                node.metrics.shed.value(plane="read_only")))
    fmod.uninstall()
    return out


def test_read_only_mode_matches_jax(tmp_path):
    from antidote_tpu.overload import ReadOnlyError as JaxReadOnly
    from antidote_tpu_torch.overload import ReadOnlyError

    cfgs = _cfgs(wal_segments=1)
    jn = _open("jax", cfgs, str(tmp_path / "j"))
    pn = _open("port", cfgs, str(tmp_path / "p"))
    want = _ro_script(jn, jfaults, JaxReadOnly)
    got = _ro_script(pn, faults, ReadOnlyError)
    assert got == want
    assert ("healed", "ok") in got and ("armed", "read-only", True) in got
    for node in (jn, pn):
        _close(node)
    # the refused increments never reached the log either
    for pkg, sub in (("jax", "j"), ("port", "p")):
        n = _open(pkg, cfgs, str(tmp_path / sub), recover=True)
        assert n.read_objects([("a", "counter_pn", "b"),
                               ("b", "counter_pn", "b")])[0] == [1, 1]
        _close(n)


LADDER = [("lc", "counter_pn"), ("ladd", "set_aw"), ("lser", "set_aw"),
          ("llong", "set_aw"), ("lflag", "flag_ew")]


def _ladder_writes(node):
    """Logs that overrun the 8-op ring: a counter and an add-only set
    (``assoc``), a short set log with removes (``serial``), a set log with
    removes past ``fold_chunk`` (``long``), a flag (``assoc``)."""
    rng = np.random.default_rng(11)
    pool = [f"e{i}" for i in range(6)]
    vcs = []
    plan = ([("lc", ("increment", int(x))) for x in rng.integers(-5, 9, 90)]
            + [("ladd", ("add", pool[i % 6])) for i in range(20)]
            + [("lflag", ("enable", ()) if i % 3 else ("disable", ()))
               for i in range(20)])
    for name, n_ops in (("lser", 20), ("llong", 60)):
        for i in range(n_ops):
            plan.append((name, ("remove", pool[(i - 1) % 6]) if i % 4 == 3
                         else ("add", pool[i % 6])))
    order = rng.permutation(len(plan))
    ty_of = dict(LADDER)
    for j in order:
        key, op = plan[j]
        vcs.append(np.asarray(node.update_objects(
            [(key, ty_of[key], "b", op)])).copy())
    return vcs


def test_replay_ladder_matches_jax(tmp_path):
    cfgs = _cfgs(fold_chunk=32)
    nodes = {pkg: _open(pkg, cfgs, str(tmp_path / pkg))
             for pkg in ("jax", "port")}
    vcs = {pkg: _ladder_writes(n) for pkg, n in nodes.items()}
    assert [v.tolist() for v in vcs["jax"]] == [v.tolist()
                                                for v in vcs["port"]]
    read_vc = vcs["port"][len(vcs["port"]) * 3 // 4]
    results = {}
    for pkg, node in nodes.items():
        store = node.store
        by_shard = {}
        for j, (key, _ty) in enumerate(LADDER):
            tname, shard, _row = store.directory[(key, "b")]
            by_shard.setdefault(shard, []).append((j, key, tname, "b"))
        states = {}
        for shard, wants in by_shard.items():
            states.update(store._replay_read_many(shard, wants, read_vc))
        results[pkg] = (states, dict(store.replay_fold_dispatches))
    (js, jr), (ps, pr) = results["jax"], results["port"]
    assert pr == jr == {"assoc": 3, "serial": 1, "long": 1}
    for j in range(len(LADDER)):
        assert sorted(js[j]) == sorted(ps[j])
        for f in js[j]:
            assert np.array_equal(np.asarray(js[j][f]), ps[j][f]), (j, f)
    # the same reads through the node: values equal the JAX node's
    for pkg, node in nodes.items():
        txn = node.start_transaction()
        txn.snapshot_vc = np.asarray(read_vc, np.int32)
        results[pkg] = node.read_objects(
            [(k, t, "b") for k, t in LADDER], txn)
        node.abort_transaction(txn)
        _close(node)
    assert results["port"] == results["jax"]


def test_typed_table_tracks_max_abs_delta():
    """The repair: ``max_abs_delta`` follows every append (lane 0 of the
    effect, absolute), as the JAX table's does, and rides in the image."""
    cfg, jcfg = _cfgs()
    pt = TypedTable(get_type("counter_pn"), cfg, device="cpu")
    jt = JaxTable(jget_type("counter_pn"), jcfg)
    rng = np.random.default_rng(3)
    bw = get_type("counter_pn").eff_b_width(cfg)
    for _ in range(4):
        m = 6
        args = (rng.integers(0, 4, m), rng.integers(0, 16, m),
                rng.integers(-1000, 1000, (m, 1)),
                np.zeros((m, bw), np.int32),
                np.tile(np.arange(1, m + 1, dtype=np.int32)[:, None],
                        (1, 3)), np.zeros(m, np.int32))
        pt.append(*args)
        jt.append(*args)
        assert pt.max_abs_delta == jt.max_abs_delta > 0


def test_image_carries_max_abs_delta(tmp_path):
    cfg, _ = _cfgs()
    node = AntidoteNode(cfg, log_dir=str(tmp_path / "w"), device="cpu")
    node.update_objects([("c", "counter_pn", "b", ("increment", 5)),
                         ("d", "counter_pn", "b", ("decrement", 9))])
    node.checkpoint_now()
    image, _m = ckpt.load_latest(str(tmp_path / "w"))
    assert image["tables"]["counter_pn"]["max_abs_delta"] == 9
    node.close()
    n2 = AntidoteNode(cfg, log_dir=str(tmp_path / "w"), recover=True,
                      device="cpu")
    assert n2.store.tables["counter_pn"].max_abs_delta == 9
    n2.close()


def _groups(eff_cls):
    vc = np.asarray([1, 0, 0], np.int32)
    vc2 = np.asarray([2, 0, 0], np.int32)

    def eff(key):
        return eff_cls(key, "counter_pn", "b", np.asarray([3], np.int64),
                       np.zeros((0,), np.int32))

    return [([eff("x")], [vc], [0]), ([eff("y"), eff("z")], [vc2, vc2],
                                      [0, 0])]


def test_apply_effect_groups_returns_errors_and_ticket(tmp_path):
    """The repair: ``(errors, ticket)`` as the JAX store returns them —
    all ``None`` and no ticket without a log; a ticket with one; a refused
    sub-group NACKed alone (its sibling applies) under an armed fault."""
    cfg, jcfg = _cfgs(wal_segments=1)
    errors, ticket = KVStore(cfg, device="cpu").apply_effect_groups(
        _groups(Effect))
    assert errors == [None, None] and ticket is None
    port = KVStore(cfg, device="cpu", log=LogManager(cfg, str(tmp_path / "p")))
    jax_ = JaxStore(jcfg, log=JaxLogManager(jcfg, str(tmp_path / "j")))
    errors, ticket = port.apply_effect_groups(_groups(Effect))
    jerr, jtk = jax_.apply_effect_groups(_groups(JaxEffect))
    assert errors == jerr == [None, None]
    assert isinstance(ticket, FsyncTicket) and jtk is not None
    ticket.wait()
    # arm: the first sub-group's append is refused, the second lands
    shard_x = port.directory[("x", "b")][1]
    for fmod, store, eff_cls in ((faults, port, Effect),
                                 (jfaults, jax_, JaxEffect)):
        fmod.install(fmod.FaultPlan(seed=1).enospc(
            "wal.append", key=f"shard_{shard_x}.wal", times=1))
        groups = _groups(eff_cls)
        groups[0][1][0] = np.asarray([3, 0, 0], np.int32)
        groups[1][1][:] = [np.asarray([4, 0, 0], np.int32)] * 2
        errs, tk = store.apply_effect_groups(groups)
        fmod.uninstall()
        assert [type(e).__name__ if e else None for e in errs] == [
            "OSError", None]
        tk.wait()
    assert port.applied_vc.tolist() == jax_.applied_vc.tolist()
    for store in (port, jax_):
        store.log.close()


def test_grouped_apply_with_a_refused_member_matches_jax(tmp_path):
    """One batch of five sub-groups through both stores with a log: set
    adds past a key's slot capacity (it promotes), counter increments, a
    map field's increment (its parent map's cached value must drop), a
    register_mv write whose observed-id lanes only a wider tier holds (as
    a promoted key's replayed or remote effect has: it promotes), and a
    second sub-group whose only shard's WAL append is refused.  The
    errors, the partition clocks, the checkpoint dirty-key windows, the
    directory and every table's arrays are equal; the survivors' cached
    values are dropped and the refused key's is kept."""
    from antidote_tpu.crdt import maps as jmaps
    from antidote_tpu_torch.crdt import maps
    from antidote_tpu_torch.store.kv import key_to_shard

    cfg, jcfg = _cfgs(wal_segments=1)
    n = cfg.n_shards
    # the refused member's key owns a shard no other member touches
    others = ["s", "c", "c2", "m", "v"]
    taken = {key_to_shard(k, "b", n) for k in others}
    taken.add(key_to_shard(maps.field_key("m", "f", "counter_pn"), "b", n))
    lone = next(f"r{i}" for i in range(64)
                if key_to_shard(f"r{i}", "b", n) not in taken)
    d = cfg.max_dcs

    def groups(eff_cls, mod):
        def vc(t):
            return np.asarray([t, 0, 0], np.int32)

        adds = [eff_cls("s", "set_aw", "b", np.asarray([100 + i], np.int64),
                        np.zeros((1 + d,), np.int32))
                for i in range(cfg.set_slots + 2)]

        def inc(key):
            return eff_cls(key, "counter_pn", "b", np.asarray([5], np.int64),
                           np.zeros((0,), np.int32))

        mv = get_type("register_mv")
        wide = np.zeros((2 + 4 * cfg.mv_slots,), np.int64)
        wide[0] = 77
        write = eff_cls("v", "register_mv", "b", wide,
                        np.zeros((mv.eff_b_width(cfg),), np.int32))
        field = eff_cls(mod.field_key("m", "f", "counter_pn"), "counter_pn",
                        "b", np.asarray([7], np.int64),
                        np.zeros((0,), np.int32))
        refused = eff_cls(lone, "counter_pn", "b", np.asarray([9], np.int64),
                          np.zeros((0,), np.int32))
        return [(adds, [vc(1)] * len(adds), [0] * len(adds)),
                ([refused], [vc(2)], [0]),
                ([inc("c"), inc("c2")], [vc(3), vc(3)], [0, 0]),
                ([field], [vc(4)], [0]),
                ([write], [vc(5)], [0])]

    port = KVStore(cfg, device="cpu", log=LogManager(cfg, str(tmp_path / "p")))
    jax_ = JaxStore(jcfg, log=JaxLogManager(jcfg, str(tmp_path / "j")))
    out = []
    for fmod, store, eff_cls, mod in ((faults, port, Effect, maps),
                                      (jfaults, jax_, JaxEffect, jmaps)):
        # every key bound before the batch, the window then consumed (as
        # a checkpoint stamp does): the batch's writes alone refill it
        store.locate_many([(e.key, e.type_name, e.bucket)
                           for g in groups(eff_cls, mod) for e in g[0]])
        store.ckpt_dirty_keys = set()
        for dk in (("m", "b"), (lone, "b"), ("c", "b"), ("c2", "b")):
            store._value_cache[dk] = ("stale",)
        fmod.install(fmod.FaultPlan(seed=1).enospc(
            "wal.append", key=f"shard_{key_to_shard(lone, 'b', n)}.wal",
            times=1))
        try:
            errs, tk = store.apply_effect_groups(groups(eff_cls, mod))
        finally:
            fmod.uninstall()
        tk.wait()
        assert sorted(store._value_cache) == [(lone, "b")]
        out.append(([type(e).__name__ if e else None for e in errs],
                    store.applied_vc.tolist(), store.ckpt_dirty_keys,
                    dict(store.directory)))
        store.log.close()
    assert out[0] == out[1]
    assert out[0][0] == [None, "OSError", None, None, None]
    assert (lone, "b") not in out[0][2] and ("c2", "b") in out[0][2]
    # both promoted to a wider tier
    assert out[0][3][("s", "b")][0] != "set_aw"
    assert out[0][3][("v", "b")][0] != "register_mv"
    _assert_tables_equal(
        {name: table_arrays(t) for name, t in port.tables.items()},
        {name: table_arrays(t) for name, t in jax_.tables.items()})


def test_freeze_key_matches_jax_across_msgpack():
    """Keys cross the log and the image as msgpack, where tuples become
    lists: the port's ``freeze_key`` restores what the JAX one restores
    for every key shape the store binds, map-derived keys included."""
    import msgpack

    from antidote_tpu.crdt import maps as jmaps
    from antidote_tpu.store.kv import freeze_key as jfreeze
    from antidote_tpu_torch.crdt import maps
    from antidote_tpu_torch.store.kv import freeze_key

    keys = [7, -3, "k", b"raw", ("t", 7), ("a", ("b", 1)), 2**40]
    for mod in (maps, jmaps):
        keys += [mod.member_key("m"), mod.field_key("m", "f", "counter_pn"),
                 mod.field_key(mod.field_key("m", "n", "map_rr"), "g",
                               "set_aw"),
                 mod.member_key(mod.field_key(("t", 2), "n", "map_go"))]
    for k in keys:
        wire = msgpack.unpackb(msgpack.packb(k, use_bin_type=True),
                               raw=False)
        assert freeze_key(wire) == jfreeze(wire) == k, k


def test_images_equal_across_packages(tmp_path):
    """One deterministic script on each package's node, then a full image
    each: the images hold the same fields, dtypes, shapes and bytes in
    every table, the same directory and the same clocks — the image format
    is the JAX package's, not a lookalike."""
    cfgs = _cfgs(wal_segments=1)
    images = {}
    for pkg in ("jax", "port"):
        node = _open(pkg, cfgs, str(tmp_path / pkg))
        for i in range(12):
            node.update_objects([
                (i % 5, "counter_pn", "b", ("increment", i - 4)),
                (("s", i % 3), "set_aw", "b", ("add_all", [i, i + 1])),
                ("f", "flag_dw", "b", ("enable" if i % 2 else "disable",
                                       ())),
                ("m", "map_rr", "b", ("update", {("x", "counter_pn"):
                                                 ("increment", 1)}))])
        node.update_objects([(("s", 0), "set_aw", "b", ("remove", 3))])
        node.checkpoint_now(full=True)
        images[pkg] = ckpt.load_latest(str(tmp_path / pkg))[0]
        _close(node)
    ji, pi = images["jax"], images["port"]
    assert sorted(ji) == sorted(pi)
    for f in ("stamp_vc", "floor_seqs", "chain_floor", "op_ids"):
        assert ji[f].dtype == pi[f].dtype and np.array_equal(ji[f], pi[f])
    assert sorted(map(repr, ji["directory"])) == sorted(
        map(repr, pi["directory"]))
    assert sorted(map(repr, ji["blobs"])) == sorted(map(repr, pi["blobs"]))
    assert sorted(ji["tables"]) == sorted(pi["tables"])
    for name, jt in ji["tables"].items():
        pt = pi["tables"][name]
        assert sorted(jt) == sorted(pt), name
        for field, x in jt.items():
            y = pt[field]
            if isinstance(x, dict):
                assert sorted(x) == sorted(y)
                for g in x:
                    assert x[g].dtype == y[g].dtype, (name, g)
                    assert np.array_equal(x[g], y[g]), (name, g)
            elif isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), (
                    name, field)
            else:
                assert x == y, (name, field)
