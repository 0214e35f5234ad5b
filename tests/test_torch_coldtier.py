"""The cold tier on the port (``device="cpu"``), held to the JAX package.

  * the cases of ``tests/test_coldtier.py`` that need no Merkle tree,
    follower or wire server, run on the port's node: eviction only drops
    rows whose live head_vc equals the anchor sidecar's stamp, reads fault
    evicted rows back in exactly (values and head VC stamps), refusals
    (rate cap, injected fault, CRC failure) are a typed ColdMiss and never
    a bottom read, the budget holds under writes, cold keys recover cold,
    and a chain whose links record evictions recovers without a budget;
  * one seeded script through both packages' nodes: the same evicted key
    sets under the same budget, byte-equal ``cold.bin`` files, images that
    agree table by table, the same values;
  * a directory with cold sidecars written by either package recovers in
    the other with the same cold keys, which fault in to equal values;
  * a reused row never serves its previous tenant's bytes, through every
    rung of the read ladder, the serving epochs and both value caches;
  * a checkpoint stamp's head copy taken before an eviction keeps the
    evicted rows' bytes;
  * ``.evict_rows(`` is called only by the cold tier (or with a written
    ``# evict-ok:`` reason).

All state is integer, so every comparison is exact."""

import os
import re
from pathlib import Path

import numpy as np
import pytest

from antidote_tpu import faults as jfaults
from antidote_tpu.api import AntidoteNode as JaxNode
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu_torch import faults
from antidote_tpu_torch.api import AntidoteNode
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.log import checkpoint as ckpt
from antidote_tpu_torch.overload import ColdMiss
from antidote_tpu_torch.store.coldtier import COLD_BIN

ROOT = Path(__file__).resolve().parent.parent
KW = dict(n_shards=4, max_dcs=3, ops_per_key=8, snap_versions=2, set_slots=8,
          mv_slots=4, rga_slots=16, keys_per_table=64, wal_segments=3)


@pytest.fixture
def dcfg():
    return AntidoteConfig(**KW)


@pytest.fixture(autouse=True)
def _no_leftover_faults():
    yield
    faults.uninstall()
    jfaults.uninstall()


def node_at(cfg, log_dir, **kw):
    return AntidoteNode(cfg, log_dir=str(log_dir), device="cpu", **kw)


def populate(node, n, start=0, mult=1):
    for i in range(start, start + n):
        node.update_objects([(i, "counter_pn", "b",
                              ("increment", (i + 1) * mult))])


def head_vc_of(node, dk):
    tname, shard, row = node.store.directory[dk]
    return np.asarray(node.store.tables[tname].head_vc[shard, row]).copy()


# ---------------------------------------------------------------------------
# tests/test_coldtier.py's cold-tier cases on the port
# ---------------------------------------------------------------------------
def test_evict_fault_read_roundtrip_exact_vc(dcfg, tmp_path):
    """Evicted keys fault back in exactly: values AND head VC stamps."""
    node = node_at(dcfg, tmp_path / "w", resident_rows=1 << 30)
    populate(node, 32)
    vcs = {i: head_vc_of(node, (i, "b")) for i in range(32)}
    node.checkpoint_now()
    cold = node.store.cold
    cold.budget = 8
    evicted = cold.evict_now(max_rows=1024)
    assert evicted >= 24, evicted
    assert cold.resident_rows() <= 8
    assert len(cold.cold_set) == evicted
    # a cold key has NO directory entry (the lock-free planes fall back)
    cold_key = next(iter(cold.cold_set))[0]
    assert (cold_key, "b") not in node.store.directory
    vals, _ = node.read_objects([(cold_key, "counter_pn", "b")])
    assert vals == [cold_key + 1]
    assert (head_vc_of(node, (cold_key, "b")) == vcs[cold_key]).all()
    assert cold.faults == 1
    assert node.metrics.coldtier_events.value(event="fault") == 1
    vals, _ = node.read_objects([(i, "counter_pn", "b") for i in range(32)])
    assert vals == [i + 1 for i in range(32)]
    node.close()


def test_budget_enforced_under_sustained_writes(dcfg, tmp_path):
    """The budget holds on the commit path once an image covers eviction
    candidates; writes are never refused."""
    node = node_at(dcfg, tmp_path / "w", resident_rows=24)
    populate(node, 24)
    node.checkpoint_now()
    populate(node, 72, start=24)
    cold = node.store.cold
    # the 24 image-covered keys went cold as the budget demanded; the
    # uncovered rest waits for the next stamp (pressure asked for one)
    assert len(cold.cold_set) == 24
    node.checkpoint_now(full=True)
    populate(node, 8, start=96)
    assert cold.resident_rows() <= 24 + 8
    vals, _ = node.read_objects([(i, "counter_pn", "b")
                                 for i in range(104)])
    assert vals == [i + 1 for i in range(104)]
    node.close()


def test_dirty_rows_are_not_evictable(dcfg, tmp_path):
    """A row written since the anchor stamp fails the head_vc probe and
    stays resident: eviction never loses a write."""
    node = node_at(dcfg, tmp_path / "w", resident_rows=1 << 30)
    populate(node, 8)
    node.checkpoint_now()
    node.update_objects([(3, "counter_pn", "b", ("increment", 100))])
    cold = node.store.cold
    cold.budget = 1
    cold.evict_now(max_rows=1024)
    assert (3, "b") in node.store.directory  # dirty: kept resident
    assert (5, "b") not in node.store.directory  # clean: evicted
    vals, _ = node.read_objects([(3, "counter_pn", "b"),
                                 (5, "counter_pn", "b")])
    assert vals == [104, 6]
    node.close()


def test_cold_fault_rate_cap_and_injected_fault_typed(dcfg, tmp_path):
    """Past the rate cap, or behind an injected ``coldtier.fault``, a read
    is refused with a typed ColdMiss carrying a retry hint; the key is
    never served bottom."""
    node = node_at(dcfg, tmp_path / "w", resident_rows=1 << 30)
    populate(node, 12)
    node.checkpoint_now()
    cold = node.store.cold
    cold.budget = 2
    cold.evict_now(max_rows=1024)
    cold.budget = 1 << 30  # stop re-evicting what faults in
    cold.fault_rate_cap = 2.0
    ok, refused = 0, 0
    for i in range(6):
        if (i, "b") not in cold.cold_set:
            continue
        try:
            vals, _ = node.read_objects([(i, "counter_pn", "b")])
            assert vals == [i + 1]  # exact, never bottom
            ok += 1
        except ColdMiss as e:
            assert e.retry_after_ms >= 25 and not e.permanent
            refused += 1
    assert ok == 2 and refused >= 1
    assert node.metrics.coldtier_events.value(event="refused") >= 1
    cold.fault_rate_cap = 0.0
    victim = next(iter(cold.cold_set))
    faults.install(faults.FaultPlan(seed=5).io_error("coldtier.fault",
                                                     times=1))
    with pytest.raises(ColdMiss):
        node.read_objects([(victim[0], "counter_pn", "b")])
    faults.uninstall()
    vals, _ = node.read_objects([(victim[0], "counter_pn", "b")])
    assert vals == [victim[0] + 1]
    node.close()


def test_cold_sidecar_row_crc_catches_bit_rot(dcfg, tmp_path):
    """A flipped byte in a sidecar row is caught by the per-row CRC at
    fault-in: a typed ColdMiss and a forced rebase, never a wrong value;
    the rebase tombstones the lost row typed-permanent."""
    node = node_at(dcfg, tmp_path / "w", resident_rows=1 << 30)
    populate(node, 8)
    node.checkpoint_now()
    cold = node.store.cold
    cold.budget = 1
    cold.evict_now(max_rows=1024)
    cold.budget = 1 << 30
    victim = sorted(cold.cold_set)[0]
    ref = cold.refs[victim]
    sc = cold._sidecar(ref.src)
    tman = sc.man["tables"][ref.tname]
    spec = tman["fields"][sorted(tman["fields"])[0]]
    rb = int(np.dtype(spec["dtype"]).itemsize
             * max(1, int(np.prod(spec["shape"]))))
    off = spec["off"] + (ref.shard * tman["rows"] + ref.srow) * rb
    with open(ckpt.cold_path(node.store.log.dir, ref.src), "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    cold._drop_sidecar_cache()
    with pytest.raises(ColdMiss, match="verification"):
        node.read_objects([(victim[0], "counter_pn", "b")])
    assert node.metrics.coldtier_events.value(event="crc_fail") == 1
    assert node.checkpointer.force_rebase is True
    node.checkpoint_now()
    with pytest.raises(ColdMiss, match="peer") as ei:
        node.read_objects([(victim[0], "counter_pn", "b")])
    assert ei.value.permanent
    assert victim in cold.lost
    others = [i for i in range(8) if (i, "b") != victim]
    vals, _ = node.read_objects([(i, "counter_pn", "b") for i in others])
    assert vals == [i + 1 for i in others]
    node.close()


def test_cold_keys_recover_cold_and_fault_on_demand(dcfg, tmp_path):
    """Recovery of an image with cold keys installs only the resident
    set; the cold keys register fault-in refs and read exactly."""
    node = node_at(dcfg, tmp_path / "w", resident_rows=1 << 30)
    populate(node, 40)
    node.checkpoint_now()
    cold = node.store.cold
    cold.budget = 10
    cold.evict_now(max_rows=1024)
    n_cold = len(cold.cold_set)
    assert n_cold >= 24
    node.checkpoint_now(full=True)  # the image carries the cold appendix
    node.close()
    n2 = node_at(dcfg, tmp_path / "w", recover=True, resident_rows=1 << 30)
    assert len(n2.store.cold.cold_set) == n_cold
    assert len(n2.store.directory) == 40 - n_cold
    vals, _ = n2.read_objects([(i, "counter_pn", "b") for i in range(40)])
    assert vals == [i + 1 for i in range(40)]
    assert n2.store.cold.faults == n_cold
    n2.close()


def test_chain_with_evictions_recovers_without_resident_rows_flag(
        dcfg, tmp_path):
    """A chain whose delta links record evictions recovers exactly even
    without a resident budget: ``install_delta`` attaches a cold tier
    rather than dropping the evicted keys into silent bottoms."""
    node = node_at(dcfg, tmp_path / "w", resident_rows=12)
    node.start_checkpointer(interval_s=0.0, rebase_every=64)
    populate(node, 12)
    node.checkpoint_now(full=True)
    populate(node, 24, start=12)  # evicts the first 12 (anchored)
    assert len(node.store.cold.cold_set) == 12
    assert node.checkpoint_now()["kind"] == "delta"
    node.close()
    n2 = node_at(dcfg, tmp_path / "w", recover=True)
    assert n2.store.cold is not None  # attached by the chain compose
    vals, _ = n2.read_objects([(i, "counter_pn", "b") for i in range(36)])
    assert vals == [i + 1 for i in range(36)]
    n2.close()


def test_budget_after_recovery_and_typed_errors_need_a_log(dcfg, tmp_path):
    """A restart with a resident budget evicts down to it before it
    serves; the cold tier refuses to attach without a log."""
    node = node_at(dcfg, tmp_path / "w", resident_rows=1 << 30)
    populate(node, 30)
    node.checkpoint_now()
    node.close()
    n2 = node_at(dcfg, tmp_path / "w", recover=True, resident_rows=10)
    assert n2.store.cold.resident_rows() <= 10
    assert n2.metrics.coldtier_resident_rows.value() <= 10
    assert n2.metrics.coldtier_cold_keys.value() == 20
    vals, _ = n2.read_objects([(i, "counter_pn", "b") for i in range(30)])
    assert vals == [i + 1 for i in range(30)]
    n2.close()
    with pytest.raises(RuntimeError, match="log_dir"):
        AntidoteNode(dcfg, resident_rows=5, device="cpu")


# ---------------------------------------------------------------------------
# one script through both packages
# ---------------------------------------------------------------------------
def _cfgs(**over):
    kw = dict(KW, **over)
    return AntidoteConfig(**kw), JaxConfig(batch_buckets=(16, 64), **kw)


def _open(pkg, cfgs, log_dir, **kw):
    cfg, jcfg = cfgs
    if pkg == "jax":
        return JaxNode(jcfg, log_dir=str(log_dir), **kw)
    return AntidoteNode(cfg, log_dir=str(log_dir), device="cpu", **kw)


def _close(node):
    if node.checkpointer is not None:
        node.checkpointer.stop()
    node.store.log.close()


OBJS = ([(i, "counter_pn", "b") for i in range(40)]
        + [(("s", i), "set_aw", "b") for i in range(13)])


def _cold_script(node):
    """Writes, a full image with a sidecar, evictions by budget on the
    commit path, fault-ins by reads, a delta link recording evictions and
    a full image carrying cold rows forward.  Returns what it observed."""
    seen = []
    for i in range(40):
        node.update_objects([(i, "counter_pn", "b", ("increment", i + 1)),
                             (("s", i % 13), "set_aw", "b", ("add", i))])
    # a key past its slot tier: the sidecar holds two set tables
    node.update_objects([(("s", 0), "set_aw", "b",
                          ("add_all", list(range(100, 112))))])
    node.start_checkpointer(interval_s=0.0, rebase_every=64)
    node.checkpoint_now(full=True)
    cold = node.store.cold
    cold.budget = 20
    node.update_objects([(3, "counter_pn", "b", ("increment", 7))])
    seen.append(sorted(map(repr, cold.cold_set)))
    vals, _ = node.read_objects([(5, "counter_pn", "b"),
                                 (("s", 4), "set_aw", "b")])
    seen.append(vals)
    seen.append(sorted(map(repr, cold.cold_set)))
    assert node.checkpoint_now()["kind"] == "delta"
    for i in range(40, 48):
        node.update_objects([(i, "counter_pn", "b", ("increment", 1))])
    seen.append(sorted(map(repr, cold.cold_set)))
    node.checkpoint_now(full=True)
    seen.append(sorted(map(repr, cold.cold_set)))
    seen.append(cold.resident_rows())
    return seen


def _ckpt_dir(d, kind="full"):
    root = ckpt.checkpoint_root(str(d))
    return [p for _i, p in ckpt.list_checkpoints(root)
            if ckpt.manifest_kind(ckpt.load_manifest(p)) == kind]


def test_one_script_both_packages_cold_bin_byte_equal(tmp_path):
    cfgs = _cfgs()
    seen, vals = {}, {}
    for pkg in ("jax", "port"):
        node = _open(pkg, cfgs, tmp_path / pkg, resident_rows=1 << 30)
        seen[pkg] = _cold_script(node)
        vals[pkg] = node.read_objects(OBJS)[0]
        _close(node)
    assert seen["port"] == seen["jax"]
    assert vals["port"] == vals["jax"]
    assert len(seen["port"][-2]) > 20  # cold keys carried forward
    fulls = {pkg: _ckpt_dir(tmp_path / pkg) for pkg in seen}
    assert len(fulls["port"]) == len(fulls["jax"]) == 2
    for jp, pp in zip(fulls["jax"], fulls["port"]):
        jb = Path(jp, COLD_BIN).read_bytes()
        pb = Path(pp, COLD_BIN).read_bytes()
        assert jb == pb
        jm, pm = ckpt.load_manifest(jp), ckpt.load_manifest(pp)
        assert jm["cold"] == pm["cold"]
        assert jm["cold_keys"] == pm["cold_keys"]
        assert jm["n_keys"] == pm["n_keys"]
    ji = ckpt.load_latest(str(tmp_path / "jax"))[0]
    pi = ckpt.load_latest(str(tmp_path / "port"))[0]
    assert sorted(map(repr, ji["cold_directory"])) == sorted(
        map(repr, pi["cold_directory"]))
    assert sorted(map(repr, ji["directory"])) == sorted(
        map(repr, pi["directory"]))
    for name, jt in ji["tables"].items():
        pt = pi["tables"][name]
        for field in ("used_rows", "head_vc", "slots_ub", "max_commit_vc"):
            assert np.array_equal(jt[field], pt[field]), (name, field)
        for f, x in jt["head"].items():
            assert x.dtype == pt["head"][f].dtype
            assert np.array_equal(x, pt["head"][f]), (name, f)
    jd = ckpt.load_chain(str(tmp_path / "jax"))
    assert jd is not None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cold_directory_recovers_in_both_packages(tmp_path, writer):
    """A directory whose images and link carry cold keys recovers in
    either package with the same cold keys, which fault in to equal
    values."""
    cfgs = _cfgs()
    d = tmp_path / "w"
    node = _open(writer, cfgs, d, resident_rows=1 << 30)
    node.start_checkpointer(interval_s=0.0, rebase_every=64)
    for i in range(40):
        node.update_objects([(i, "counter_pn", "b", ("increment", i + 1)),
                             (("s", i % 13), "set_aw", "b", ("add", i))])
    node.checkpoint_now(full=True)
    node.store.cold.budget = 16
    node.store.cold.evict_now(max_rows=1024)
    node.checkpoint_now(full=True)  # cold rows carried forward
    node.update_objects([(1, "counter_pn", "b", ("increment", 5))])
    node.store.cold.evict_now(max_rows=1024)
    assert node.checkpoint_now()["kind"] == "delta"
    node.update_objects([(2, "counter_pn", "b", ("increment", 9))])
    want = node.read_objects(OBJS)[0]
    _close(node)
    recovered = {}
    for pkg in ("jax", "port"):
        n = _open(pkg, cfgs, d, recover=True)
        recovered[pkg] = sorted(map(repr, n.store.cold.cold_set))
        assert n.read_objects(OBJS)[0] == want, pkg
        assert not n.store.cold.cold_set
        _close(n)
    assert recovered["port"] == recovered["jax"]
    assert len(recovered["port"]) >= 30


# ---------------------------------------------------------------------------
# row reuse, the stamp's copy
# ---------------------------------------------------------------------------
def _epoch_read(store, objs, ep):
    pend, fallback = store.epoch_read_launch(objs, ep)
    vals = store.epoch_read_finish(pend)
    return vals, fallback


def test_reused_row_never_serves_stale_bytes(dcfg, tmp_path):
    """Evict keys, let a new key take a freed row, then read the old keys
    and the new one through every plane: a serving epoch published (and
    pinned) before the eviction, both value caches filled before it, the
    live head (rung 1), a table epoch (rung 2), the ring fold at an older
    clock (rung 3) and a serving epoch published after.  The JAX package
    serves the new key its row's previous tenant from the pinned epoch's
    frozen slot; the port marks a key born on a freed row for the locked
    path."""
    from antidote_tpu_torch.store.kv import key_to_shard

    node = node_at(dcfg, tmp_path / "w", resident_rows=1 << 30)
    store, txm = node.store, node.txm
    objs = [(("old", i), "set_aw", "b") for i in range(8)]
    for i, o in enumerate(objs):
        node.update_objects([(o[0], "set_aw", "b", ("add_all", [i, 100 + i]))])
    node.checkpoint_now()
    want_old = node.read_objects(objs)[0]  # fills the value cache
    assert txm.publish_serving_epoch() == "published"
    e1 = store.pin_serving_epoch()
    assert _epoch_read(store, objs, e1) == (want_old, [])  # snapshot cache
    t = store.tables["set_aw"]
    t.publish_epoch()
    cold = store.cold
    cold.budget = 1
    with txm.commit_lock:
        assert cold.evict_now(max_rows=8) == 8
    cold.budget = 1 << 30
    assert t.epochs == [] and not store.snapshot_cache
    assert store.value_cache_get(("old", 0), "b", (1 << 30,) * 3) is not None
    freed = {s: set(rows) for s, rows in t.free_rows.items()}
    shard = next(iter(freed))
    new = next(k for k in (("new", j) for j in range(10_000))
               if key_to_shard(k, "b", dcfg.n_shards) == shard)
    vc_new = node.update_objects([(new, "set_aw", "b", ("add", 7))])
    _tn, s_new, r_new = store.directory[(new, "b")]
    assert s_new == shard and r_new in freed[shard]
    everything = objs + [(new, "set_aw", "b")]
    # the epoch pinned before the eviction: all nine take the locked path
    vals, fallback = _epoch_read(store, everything, e1)
    assert sorted(fallback) == list(range(9))
    assert store.epoch_cache_read([(new, "set_aw", "b")], e1) is None
    store.unpin_serving_epoch(e1)
    # rung 1 (every key faults in or reads its own row)
    assert node.read_objects(everything)[0] == want_old + [[7]]
    # rung 3: below the new key's commit, its reused row folds to bottom
    txn = node.start_transaction()
    txn.snapshot_vc = np.asarray(vc_new, np.int32) - np.asarray(
        [1, 0, 0], np.int32)
    slow = t.slow_serves
    assert node.read_objects(everything, txn) == want_old + [[]]
    assert t.slow_serves == slow + 1
    node.abort_transaction(txn)
    # rung 2: a table epoch, read at its cap after a later commit
    t.publish_epoch()
    cap = t.epochs[-1]["cap"].copy()
    node.update_objects([(("other", 0), "set_aw", "b", ("add", 1))])
    txn = node.start_transaction()
    txn.snapshot_vc = cap
    slow = t.slow_serves
    assert node.read_objects(everything, txn) == want_old + [[7]]
    assert t.slow_serves == slow
    node.abort_transaction(txn)
    # a serving epoch published after everything serves every key
    assert txm.publish_serving_epoch() == "published"
    e2 = store.pin_serving_epoch()
    assert _epoch_read(store, everything, e2) == (want_old + [[7]], [])
    store.unpin_serving_epoch(e2)
    node.close()


def test_stamp_copy_taken_before_an_eviction_keeps_the_rows(dcfg,
                                                           tmp_path):
    """A full stamp's head copy is issued before an eviction zeroes rows
    in place: the image written from it holds the pre-evict bytes."""
    node = node_at(dcfg, tmp_path / "w", resident_rows=1 << 30)
    populate(node, 16)
    node.start_checkpointer(interval_s=0.0, rebase_every=64)
    node.checkpoint_now(full=True)
    cp, store = node.checkpointer, node.store
    with node.txm.checkpoint_barrier:
        cap, frozen = cp._capture_locked()
        store.cold.budget = 1
        assert store.cold.evict_now(max_rows=64) == 16
    cp._scan_chains(cap)
    cp._write_atomic(cap, frozen)
    image = ckpt._load_verified(
        os.path.join(cp.root, f"ckpt_{cap['id']}"),
        ckpt.load_manifest(os.path.join(cp.root, f"ckpt_{cap['id']}")))
    tb = image["tables"]["counter_pn"]
    for key, bucket, tname, shard, row in image["directory"]:
        assert int(tb["head"]["cnt"][shard, row]) == key + 1
    assert int(store.tables["counter_pn"].head["cnt"].abs().sum()) == 0
    node.close()


# ---------------------------------------------------------------------------
# the guarded drop
# ---------------------------------------------------------------------------
def _unguarded_evicts(root: Path):
    owners = {root / "store" / "coldtier.py", root / "store" / "typed_table.py"}
    bad = []
    for path in sorted(root.rglob("*.py")):
        if path in owners:
            continue
        lines = path.read_text().splitlines()
        for i, ln in enumerate(lines):
            code = ln.split("#", 1)[0]
            if ".evict_rows(" not in code:
                continue
            window = lines[max(0, i - 3):i + 1]
            if not any("evict-ok:" in w for w in window):
                bad.append(f"{path.relative_to(root)}:{i + 1}")
    return bad


def test_evict_rows_called_only_by_the_cold_tier(tmp_path):
    """``.evict_rows(`` outside ``store/coldtier.py`` (and its defining
    module) carries an ``# evict-ok: <reason>`` note on its line or the
    three before it; the scan itself catches an unannotated call."""
    pkg = ROOT / "antidote_tpu_torch"
    assert _unguarded_evicts(pkg) == []
    fake = tmp_path / "pkg"
    (fake / "store").mkdir(parents=True)
    (fake / "mod.py").write_text("def f(t):\n    t.evict_rows([0], [1])\n")
    (fake / "ok.py").write_text(
        "def f(t):\n    # evict-ok: a reason\n    t.evict_rows([0], [1])\n")
    assert _unguarded_evicts(fake) == ["mod.py:2"]
    assert re.search(r"evict-ok:", (pkg / "log" / "checkpoint.py")
                     .read_text())
