"""Kernels on the card: each hand-written kernel against its plain
PyTorch version on the same CUDA tensors, and a CUDA table and node
against their CPU twins.  Marked ``cuda``; without a CUDA device every test
here skips (the CPU tests cover the plain versions against the JAX package).

Run on a machine with the card:
    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from antidote_tpu_torch.api import AntidoteNode
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.materializer import cuda_kernels as ck
from antidote_tpu_torch.store import TypedTable

pytestmark = pytest.mark.cuda
D = 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _set_batch(rng, b, k, e):
    pool = rng.integers(1, 2**62, size=(b, 12), dtype=np.int64)
    elems = np.take_along_axis(pool, rng.integers(0, 12, (b, e)), 1)
    elems[rng.random((b, e)) < 0.4] = 0
    state = {"elems": elems,
             "addvc": rng.integers(0, 6, (b, e, D)).astype(np.int32),
             "rmvc": rng.integers(0, 6, (b, e, D)).astype(np.int32),
             "ovf": rng.integers(0, 2, b).astype(np.int32)}
    ops_b = np.concatenate([(rng.random((b, k, 1)) < 0.3),
                            rng.integers(0, 8, (b, k, D))], -1)
    ring = [np.take_along_axis(pool, rng.integers(0, 12, (b, k)), 1)[..., None],
            ops_b.astype(np.int32),
            rng.integers(0, 9, (b, k, D)).astype(np.int32),
            rng.integers(0, D, (b, k)).astype(np.int32),
            rng.integers(0, k + 1, b).astype(np.int32),
            rng.integers(0, 3, (b, D)).astype(np.int32),
            rng.integers(4, 9, (b, D)).astype(np.int32)]
    return state, ring


def _same(a, b):
    if isinstance(a, dict):
        return all(_same(a[f], b[f]) for f in a)
    if isinstance(a, (tuple, list)):
        return all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a.cpu(), b.cpu())


# random batches at the main path's widths, then (B, K, E, D) batches of
# the edge rows (n_ops = 0, every op excluded, overflow, repeated adds and
# removes of absent handles, negative handles): every tier width up to 256
# and widths that fill no whole segment of lanes, 1 to 12 clock lanes,
# rings of one op and past one warp, an odd B (a packed warp holds one key
# alone)
@pytest.mark.parametrize("b,k,e,d,edges", [
    (1000, 16, 16, 4, False), (300, 16, 64, 4, False), (77, 5, 40, 4, False),
    (1000, 16, 16, 4, True), (300, 16, 64, 4, True), (77, 5, 40, 4, True),
    (999, 16, 8, 4, True), (999, 16, 17, 4, True), (201, 16, 256, 4, True),
    (999, 16, 16, 1, True), (999, 16, 16, 3, True), (999, 16, 16, 8, True),
    (301, 16, 64, 8, True), (999, 1, 16, 4, True), (999, 33, 16, 4, True),
    (499, 33, 40, 3, True), (99, 16, 1024, 4, True), (199, 16, 16, 12, True),
])
def test_kernels_equal_plain_versions_on_the_card(dev, b, k, e, d, edges):
    from antidote_tpu_torch.materializer.fold_cases import set_aw_edge_batch

    rng = np.random.default_rng(e + d if edges else e)
    state, ring = (set_aw_edge_batch(rng, b, k, e, d) if edges
                   else _set_batch(rng, b, k, e))
    st_d = {f: torch.as_tensor(x, device=dev) for f, x in state.items()}
    ring_d = [torch.as_tensor(x, device=dev) for x in ring]
    before = dict(ck.LAUNCHES)
    got = ck.set_aw_fold(st_d, *ring_d)
    want = ck.set_aw_fold_plain(st_d, *ring_d)
    assert _same(got, want)
    pres = (st_d["addvc"], st_d["rmvc"], st_d["elems"])
    assert _same(ck.orset_presence(*pres), ck.orset_presence_plain(*pres))
    deltas = torch.randint(-2**40, 2**40, (b, k), device=dev)
    cargs = (torch.zeros(b, dtype=torch.int64, device=dev), deltas,
             ring_d[2], ring_d[4], ring_d[5], ring_d[6])
    assert _same(ck.counter_fold(*cargs), ck.counter_fold_plain(*cargs))
    clocks = ring_d[2].reshape(-1, d)
    assert _same(ck.stable_min(clocks), ck.stable_min_plain(clocks))
    torch.cuda.synchronize()
    assert all(ck.LAUNCHES[n] == before[n] + 1 for n in before)


@pytest.mark.parametrize("n,d", [(2048, 4), (2047, 4), (1 << 20, 4),
                                 (1000, 1), (777, 3), (3001, 8), (5, 300),
                                 (0, 4)])
def test_stable_min_equals_plain_on_the_card(dev, n, d):
    rng = np.random.default_rng(n + d)
    x = rng.integers(-2**31, 2**31 - 1, size=(n, d),
                     dtype=np.int64).astype(np.int32)
    x[rng.random(n) < 0.3] = 2**31 - 1  # identity rows
    xd = torch.as_tensor(x, device=dev)
    got = ck.stable_min(xd)
    assert _same(got, ck.stable_min_plain(xd))
    want = x.min(axis=0) if n else np.full(d, 2**31 - 1, np.int32)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    allmax = torch.full((n, d), 2**31 - 1, dtype=torch.int32, device=dev)
    assert _same(ck.stable_min(allmax), ck.stable_min_plain(allmax))


@pytest.mark.parametrize("n", [2048, 1 << 20])
def test_stable_min_misaligned_view_on_the_card(dev, n):
    """A view one word into its allocation: no 16-byte loads."""
    rng = np.random.default_rng(n)
    flat = rng.integers(-2**31, 2**31 - 1, size=n * D + 1,
                        dtype=np.int64).astype(np.int32)
    xd = torch.as_tensor(flat, device=dev)[1:].view(n, D)
    assert xd.data_ptr() % 16 == 4
    got = ck.stable_min(xd)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  flat[1:].reshape(n, D).min(axis=0))
    assert _same(got, ck.stable_min_plain(xd))


def _misaligned(x):
    """A copy of ``x`` as a view one element into its allocation."""
    flat = torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                      x.reshape(-1)])
    return flat[1:].view(x.shape)


# orset_edge_batch rows (counts 0, top and past top, empty slots with
# present clocks, handles 1 << 32 and negatives) at the tier widths and
# widths that fill no whole group of lanes, 1 to 8 clock lanes; both forms
# with top 0, the resolve's 4 and past E
@pytest.mark.parametrize("e,d", [(8, 4), (16, 4), (17, 4), (40, 4), (64, 4),
                                 (256, 4), (16, 1), (16, 3), (40, 3), (16, 8),
                                 (64, 8)])
def test_orset_forms_equal_plain_on_the_card(dev, e, d):
    from antidote_tpu_torch.materializer.fold_cases import orset_edge_batch

    rng = np.random.default_rng(100 + e + d)
    el, av, rv = (torch.as_tensor(x, device=dev)
                  for x in orset_edge_batch(rng, 999, e, d))
    before = ck.LAUNCHES["orset_presence"]
    assert _same(ck.orset_presence(av, rv, el),
                 ck.orset_presence_plain(av, rv, el))
    for top in (0, 4, e + 3):
        got = ck.orset_resolve(el, av, rv, top)
        assert got[0].shape == (999, min(top, e))
        assert _same(got, ck.orset_resolve_plain(el, av, rv, top))
    torch.cuda.synchronize()
    assert ck.LAUNCHES["orset_presence"] == before + 4


@pytest.mark.parametrize("e", [16, 64])
def test_orset_misaligned_views_on_the_card(dev, e):
    """Clock rows 4 bytes past a 16-byte boundary: no 16-byte loads."""
    from antidote_tpu_torch.materializer.fold_cases import orset_edge_batch

    rng = np.random.default_rng(e)
    el, av, rv = (torch.as_tensor(x, device=dev)
                  for x in orset_edge_batch(rng, 1001, e, D))
    av, rv = _misaligned(av), _misaligned(rv)
    assert av.data_ptr() % 16 == 4 and rv.data_ptr() % 16 == 4
    assert _same(ck.orset_presence(av, rv, el),
                 ck.orset_presence_plain(av, rv, el))
    assert _same(ck.orset_resolve(el, av, rv, 4),
                 ck.orset_resolve_plain(el, av, rv, 4))


# counter_edge_batch rows (n_ops 0 and past K, deltas past int32, every op
# excluded): rings of one op, the path's 16 and one past a warp; the
# deltas contiguous, as lane 0 of a [B, K, 3] ring, and (D = 4) with
# misaligned clock views
@pytest.mark.parametrize("k,d", [(1, 4), (16, 4), (33, 4), (16, 1), (16, 3),
                                 (33, 8)])
def test_counter_fold_forms_equal_plain_on_the_card(dev, k, d):
    from antidote_tpu_torch.materializer.fold_cases import counter_edge_batch

    rng = np.random.default_rng(200 + k + d)
    args = [torch.as_tensor(x, device=dev)
            for x in counter_edge_batch(rng, 999, k, d)]
    want = ck.counter_fold_plain(*args)
    wide = torch.zeros((999, k, 3), dtype=torch.int64, device=dev)
    wide[..., 0] = args[1]
    strided = wide[..., 0]
    assert not strided.is_contiguous()
    assert _same(ck.counter_fold(*args), want)
    assert _same(ck.counter_fold(args[0], strided, *args[2:]), want)
    if d == 4:
        views = [_misaligned(x) for x in args[2:]]
        assert views[0].data_ptr() % 16 == 4
        assert _same(ck.counter_fold(args[0], strided, *views), want)


def test_set_aw_resolve_on_the_card_is_one_launch_and_no_sort(dev):
    """SetAW.resolve on a CUDA state: one orset_presence launch, no torch
    sort, the CPU state's result."""
    from torch.overrides import TorchFunctionMode

    from antidote_tpu_torch.materializer.fold_cases import orset_edge_batch

    rng = np.random.default_rng(3)
    el, av, rv = orset_edge_batch(rng, 600, 16, D)
    ty = get_type("set_aw")
    states = [{"elems": torch.as_tensor(el, device=d),
               "addvc": torch.as_tensor(av, device=d),
               "rmvc": torch.as_tensor(rv, device=d),
               "ovf": torch.zeros(600, dtype=torch.int32, device=d)}
              for d in ("cpu", dev)]
    seen = []

    class Record(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            seen.append(getattr(func, "__name__", repr(func)))
            return func(*args, **(kwargs or {}))

    before = ck.LAUNCHES["orset_presence"]
    with Record():
        got = ty.resolve(None, states[1])
    assert ck.LAUNCHES["orset_presence"] == before + 1
    assert not [f for f in seen if "sort" in f], seen
    want = ty.resolve(None, states[0])
    assert _same(got, want)


def test_cuda_cluster_stable_vc_launches_the_kernel(dev):
    from antidote_tpu_torch.cluster import ClusterMember

    cfg = AntidoteConfig(n_shards=2048, max_dcs=D, keys_per_table=16)
    ms = [ClusterMember(cfg, 0, i, 2, device=dev) for i in range(2)]
    ms[0].connect(1, *ms[1].address)
    ms[1].connect(0, *ms[0].address)
    try:
        n0 = ms[0].coordinator()
        vc = n0.update_objects([(1, "counter_pn", "b", ("increment", 3)),
                                (2, "set_aw", "b", ("add", "x"))])
        before = ck.LAUNCHES["stable_min"]
        for m in ms:
            m.refresh_peer_clocks()
        vals, snap = ms[1].coordinator().read_objects(
            [(1, "counter_pn", "b"), (2, "set_aw", "b")], clock=vc)
        assert vals == [3, ["x"]]
        assert [int(x) for x in ms[0].stable_vc()] == [1, 0, 0, 0]
        assert ck.LAUNCHES["stable_min"] >= before + 2
    finally:
        for m in ms:
            m.close()


def test_cuda_table_reads_like_a_cpu_table(dev):
    cfg = AntidoteConfig(n_shards=2, max_dcs=D, ops_per_key=4, set_slots=8,
                         keys_per_table=8)
    tabs = [TypedTable(get_type("set_aw"), cfg, device=d)
            for d in ("cpu", dev)]
    rng = np.random.default_rng(1)
    clock = np.zeros(D, np.int32)
    clocks = []
    for t in tabs:
        t.used_rows[:] = 8
    for _ in range(30):
        m = 6
        vcs = np.zeros((m, D), np.int32)
        for i in range(m):
            clock[0] += 1
            vcs[i] = clock
        args = (rng.integers(0, 2, m), rng.integers(0, 8, m),
                rng.integers(1, 9, (m, 1)),
                np.concatenate([rng.random((m, 1)) < 0.3,
                                rng.integers(0, clock[0], (m, D))], -1),
                vcs, np.zeros(m, np.int32))
        for t in tabs:
            t.append(*args)
        clocks.append(clock.copy())
    shards, rows = np.repeat([0, 1], 8), np.tile(np.arange(8), 2)
    for c in (clocks[-1], clocks[-3], clocks[-6]):
        vcs = np.broadcast_to(c, (16, D))
        outs = [t.read_resolved(shards, rows, vcs) for t in tabs]
        for f in outs[0][0]:
            np.testing.assert_array_equal(outs[0][0][f], outs[1][0][f])
        np.testing.assert_array_equal(outs[0][2], outs[1][2])


def test_cuda_node_reads_back(dev):
    node = AntidoteNode(AntidoteConfig(n_shards=2, max_dcs=D), device=dev)
    node.update_objects([("s", "set_aw", "b", ("add_all", list(range(20)))),
                         ("c", "counter_pn", "b", ("increment", 2**40))])
    vals, _ = node.read_objects([("s", "set_aw", "b"),
                                 ("c", "counter_pn", "b")])
    assert vals == [sorted(range(20), key=repr), 2**40]
    assert node.store.promotions == 1


# ---------------------------------------------------------------------------
# the other device types: batched apply, resolve and a table on the card
# against the same calls on the CPU (the CPU tests hold the CPU path to the
# JAX package)
# ---------------------------------------------------------------------------
TYPES_CFG = AntidoteConfig(n_shards=4, max_dcs=D, ops_per_key=16,
                           snap_versions=2, set_slots=16, mv_slots=4,
                           rga_slots=64, keys_per_table=256)


def _on(state, d):
    return {f: torch.as_tensor(np.asarray(x), device=d)
            for f, x in state.items()}


@pytest.mark.parametrize("name", ["counter_fat", "counter_b", "register_lww",
                                  "register_mv", "set_rw", "set_go",
                                  "flag_ew", "flag_dw", "rga"])
def test_type_apply_and_resolve_on_the_card_equal_cpu(dev, name):
    """Steps of one effect per row from seeded states, then rows that are
    all full (the argmax of an all-false row) and all empty (argmax ties),
    each applied and resolved on the card and on the CPU."""
    from antidote_tpu_torch.crdt.type_cases import (clock_batch, edge_states,
                                                    effect_batch,
                                                    state_batch)

    ty, cfg, b = get_type(name), TYPES_CFG, 777
    rng = np.random.default_rng(17)
    state = state_batch(name, rng, b, cfg)
    edges = edge_states(name, rng, state, cfg)

    def step(st, tag):
        a, eb = effect_batch(name, rng, st, cfg)
        v, o = clock_batch(rng, b, cfg, hi=2**20)
        outs = [ty.apply(cfg, _on(st, d), *(torch.as_tensor(x, device=d)
                                            for x in (a, eb, v, o)))
                for d in ("cpu", dev)]
        assert _same(outs[0], outs[1]), (name, tag)
        if ty.resolve_spec(cfg) is not None:
            assert _same(ty.resolve(cfg, outs[0]), ty.resolve(cfg, outs[1]))
        return {f: x.numpy() for f, x in outs[0].items()}

    for i in range(20):
        state = step(state, f"step {i}")
    for tag, st in edges.items():
        step(st, tag)


@pytest.mark.parametrize("name", ["counter_fat", "counter_b", "register_lww",
                                  "register_mv", "set_rw", "set_go",
                                  "flag_ew", "flag_dw", "rga"])
def test_type_table_on_the_card_reads_like_a_cpu_table(dev, name):
    """A seeded three-lane op stream with concurrent clocks (every ring GCs
    once) into a CUDA table and a CPU table: fresh and historical resolved
    reads of every key are equal, and complete."""
    from antidote_tpu_torch.crdt.type_cases import populate_stream

    cfg, n_keys, rounds = TYPES_CFG, 1024, 20
    p = cfg.n_shards
    st = populate_stream(name, np.random.default_rng(5), n_keys, rounds, cfg)
    tabs = [TypedTable(get_type(name), cfg, device=d) for d in ("cpu", dev)]
    for t in tabs:
        t.used_rows[:] = n_keys // p
        for lo in range(0, len(st["keys"]), 4096):
            sl = slice(lo, lo + 4096)
            k = st["keys"][sl]
            t.append(k % p, k // p, st["eff_a"][sl], st["eff_b"][sl],
                     st["vcs"][sl], st["origins"][sl])
    keys = np.arange(n_keys)
    for cut in (rounds * n_keys - 1, 18 * n_keys - 1):
        vcs = np.broadcast_to(st["cum"][cut], (n_keys, D))
        outs = [t.read_resolved(keys % p, keys // p, vcs) for t in tabs]
        assert outs[0][2].all() and outs[1][2].all()
        for f in outs[0][0]:
            np.testing.assert_array_equal(outs[0][0][f], outs[1][0][f])
    if name in ("flag_ew", "flag_dw"):
        # the historical read folded the ring with the monoid reduction
        assert tabs[1].fold_dispatches == tabs[0].fold_dispatches \
            == {"assoc": 1}


# ---------------------------------------------------------------------------
# the serving read plane: long-log folds, serving epochs and caches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["counter_pn", "flag_ew", "flag_dw",
                                  "set_go", "set_aw"])
def test_long_log_folds_on_the_card_equal_cpu(dev, name):
    """``assoc_fold`` and ``fold_long`` on the card equal the same calls on
    the CPU and the card's own ``fold_batch`` (1,024-op logs)."""
    from antidote_tpu_torch.materializer import fold, longlog
    from antidote_tpu_torch.materializer.longlog_cases import long_log

    ty, cfg = get_type(name), TYPES_CFG
    state, ops = long_log(name, np.random.default_rng(23), 512, 1024, cfg)
    outs = {}
    for d in ("cpu", dev):
        st = _on(state, d)
        args = [torch.as_tensor(x, device=d) for x in ops]
        outs[d] = [longlog.assoc_fold(ty, cfg, st, *args),
                   longlog.fold_long(ty, cfg, st, *args, chunk=256),
                   fold.fold_batch(ty, cfg, st, *args)]
    assert _same(outs["cpu"], outs[dev])
    for got in outs[dev][:2]:
        assert _same(got, outs[dev][2])


def _serving_script(node):
    """Writes, publishes and epoch reads through a node's store and
    manager; returns what a caller sees."""
    store, txm = node.store, node.txm
    txm.enable_serving_epochs()
    out = []
    keys = [("s%d" % i, "set_aw", "b") for i in range(40)] + [
        ("c%d" % i, "counter_pn", "b") for i in range(10)]
    for r in range(6):
        node.update_objects(
            [(k, t, b, ("add", r) if t == "set_aw" else ("increment", r))
             for k, t, b in keys[r::3]])
        txm.publish_serving_epoch()
        ep = store.pin_serving_epoch()
        try:
            pend, fb = store.epoch_read_launch(keys, ep)
            out.append((store.epoch_read_finish(pend), fb, ep.id))
        finally:
            store.unpin_serving_epoch(ep)
    m = node.metrics
    out.append({k: m.epoch_publish.value(mode=k) for k in ("copy",
                                                           "scatter")})
    out.append(m.snapshot_cache.value(event="hit"))
    out.append(node.read_objects(keys)[0])
    return out


def test_serving_epochs_on_the_card_equal_cpu(dev):
    cfg = AntidoteConfig(n_shards=4, max_dcs=D, keys_per_table=64)
    got = [_serving_script(AntidoteNode(cfg, device=d))
           for d in ("cpu", dev)]
    assert got[0] == got[1]
    assert got[1][-3]["scatter"] > 0


def test_epoch_read_launch_never_syncs_the_card(dev):
    """The launch stage runs with the CUDA sync debug mode at "error": any
    synchronizing call in it (a host copy, ``.item()``, a blocking H2D
    copy) would raise."""
    node = AntidoteNode(AntidoteConfig(n_shards=4, max_dcs=D), device=dev)
    node.update_objects([(i, "set_aw", "b", ("add", i)) for i in range(64)]
                        + [(i, "counter_pn", "b", ("increment", i))
                           for i in range(64, 96)])
    node.txm.publish_serving_epoch()
    store = node.store
    objs = ([(i, "set_aw", "b") for i in range(64)]
            + [(i, "counter_pn", "b") for i in range(64, 96)])
    ep = store.pin_serving_epoch()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pend, fb = store.epoch_read_launch(objs, ep)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    vals = store.epoch_read_finish(pend)
    store.unpin_serving_epoch(ep)
    assert fb == [] and vals == [[i] for i in range(64)] + list(range(64, 96))


# ---------------------------------------------------------------------------
# durability on the card
# ---------------------------------------------------------------------------
def _durable_cfg():
    return AntidoteConfig(n_shards=4, max_dcs=D, ops_per_key=8,
                          snap_versions=2, set_slots=8, keys_per_table=64,
                          wal_segments=2)


def _durable_script(node, rng):
    """Writes, a full image, more writes, a delta link, a tail; returns
    the commit clocks."""
    vcs = []

    def w(ups):
        vcs.append(np.asarray(node.update_objects(ups)).copy())

    for i in range(40):
        w([(int(k), "set_aw", "b", ("add", int(rng.integers(0, 20))))
           for k in rng.integers(0, 48, 3)]
          + [(int(k), "counter_pn", "b", ("increment", int(rng.integers(
              -9, 9)))) for k in rng.integers(100, 140, 2)])
        if i == 15:
            node.start_checkpointer(interval_s=0.0, rebase_every=64)
            node.checkpoint_now(full=True)
        if i == 30:
            assert node.checkpoint_now()["kind"] == "delta"
    return vcs


def _durable_objs():
    return ([(k, "set_aw", "b") for k in range(48)]
            + [(k, "counter_pn", "b") for k in range(100, 140)])


def _reads_at(node, vcs):
    out = []
    for vc in vcs:
        txn = node.start_transaction()
        txn.snapshot_vc = vc
        try:
            out.append(node.read_objects(_durable_objs(), txn))
        except RuntimeError as e:
            assert "compaction horizon" in str(e)
            out.append("horizon")
        node.abort_transaction(txn)
    return out


def test_recovery_onto_the_card_equals_cpu(dev, tmp_path):
    """One directory, recovered on the card and on the CPU: the same
    digest, values at every clock of the script and table arrays."""
    from antidote_tpu_torch.carry import table_arrays

    cfg = _durable_cfg()
    d = str(tmp_path / "wal")
    live = AntidoteNode(cfg, log_dir=d, device="cpu")
    vcs = _durable_script(live, np.random.default_rng(5))
    live.close()
    nodes = [AntidoteNode(cfg, log_dir=d, recover=True, device=x)
             for x in ("cpu", dev)]
    reads = [_reads_at(n, vcs) for n in nodes]
    assert reads[0] == reads[1] and "horizon" in reads[0]
    digests = [(n.store.log.op_ids.tolist(), n.store.log.seqs.tolist(),
                n.txm.commit_counter, sorted(map(repr, n.store.directory)))
               for n in nodes]
    assert digests[0] == digests[1]
    for name, t in nodes[0].store.tables.items():
        a, b = table_arrays(t), table_arrays(nodes[1].store.tables[name])
        for f, x in a.items():
            if isinstance(x, dict):
                assert all(np.array_equal(x[g], b[f][g]) for g in x), f
            else:
                assert np.array_equal(np.asarray(x), np.asarray(b[f])), f
    for n in nodes:
        n.close()


def test_checkpoint_beside_a_committing_thread_equals_replay(dev, tmp_path):
    """A second thread commits while the card's heads are stamped: no
    commit fails, and recovery (image + tail) equals the live node."""
    import threading

    cfg = _durable_cfg()
    d = str(tmp_path / "wal")
    node = AntidoteNode(cfg, log_dir=d, device=dev)
    rng = np.random.default_rng(9)
    _durable_script(node, rng)
    stop, errors = threading.Event(), []

    def writer():
        wr = np.random.default_rng(10)
        try:
            while not stop.is_set():
                node.update_objects(
                    [(int(k), "set_aw", "b", ("add", int(wr.integers(0, 20))))
                     for k in wr.integers(0, 48, 4)]
                    + [(int(wr.integers(100, 140)), "counter_pn", "b",
                        ("increment", 1))])
        except Exception as e:
            errors.append(e)

    th = threading.Thread(target=writer)
    th.start()
    for full in (True, False, False):
        node.checkpoint_now(full=full)
    stop.set()
    th.join(timeout=60)
    assert not th.is_alive() and errors == []
    want = node.read_objects(_durable_objs())[0]
    counter = node.txm.commit_counter
    node.close()
    rec = AntidoteNode(cfg, log_dir=d, recover=True, device=dev)
    assert rec.read_objects(_durable_objs())[0] == want
    assert rec.txm.commit_counter == counter
    rec.close()


def test_checkpoint_stamp_never_syncs_the_card(dev, tmp_path):
    """The stamp's capture (under the commit lock) runs with the CUDA sync
    debug mode at "error", full and delta: the head copies are issued on
    the table's stream and no host copy or ``.item()`` runs there."""
    node = AntidoteNode(_durable_cfg(), log_dir=str(tmp_path / "w"),
                        device=dev)
    _durable_script(node, np.random.default_rng(12))
    cp = node.checkpointer
    for name in ("_capture_locked", "_capture_delta_locked"):
        orig = getattr(cp, name)

        def guarded(orig=orig):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return orig()
            finally:
                torch.cuda.set_sync_debug_mode("default")

        setattr(cp, name, guarded)
    assert node.checkpoint_now(full=True)["kind"] == "full"
    node.update_objects([(1, "set_aw", "b", ("add", 99))])
    assert node.checkpoint_now(full=False)["kind"] == "delta"
    want = node.read_objects(_durable_objs())[0]
    node.close()
    rec = AntidoteNode(_durable_cfg(), log_dir=str(tmp_path / "w"),
                       recover=True, device=dev)
    assert rec.read_objects(_durable_objs())[0] == want
    rec.close()


def _cold_script(node):
    """Counters and sets, a full image, evictions by budget on the commit
    path, fault-ins by reads, a full image carrying the cold rows forward.
    Returns the cold key sets it saw."""
    seen = []
    for i in range(40):
        node.update_objects([(i, "counter_pn", "b", ("increment", i + 1)),
                             (("s", i % 13), "set_aw", "b", ("add", i))])
    node.checkpoint_now(full=True)
    cold = node.store.cold
    cold.budget = 20
    node.update_objects([(3, "counter_pn", "b", ("increment", 7))])
    seen.append(sorted(map(repr, cold.cold_set)))
    node.read_objects([(5, "counter_pn", "b"), (("s", 4), "set_aw", "b")])
    seen.append(sorted(map(repr, cold.cold_set)))
    node.checkpoint_now(full=True)
    return seen


def _cold_objs():
    return ([(i, "counter_pn", "b") for i in range(40)]
            + [(("s", i), "set_aw", "b") for i in range(13)])


def test_evict_and_fault_in_on_the_card_equal_cpu(dev, tmp_path):
    """One script on a CUDA node and its CPU twin: the same keys go cold,
    the evicted rows are zero on the card, and every key faults back in
    to the same value, head and table arrays."""
    from antidote_tpu_torch.carry import table_arrays

    nodes, seen = [], []
    for i, x in enumerate(("cpu", dev)):
        n = AntidoteNode(_durable_cfg(), log_dir=str(tmp_path / f"n{i}"),
                         resident_rows=1 << 30, device=x)
        seen.append(_cold_script(n))
        nodes.append(n)
    assert seen[0] == seen[1] and len(seen[0][-1]) > 20
    gpu = nodes[1].store
    for name, t in gpu.tables.items():
        assert t.head_vc.device.type == "cuda"
        for s, rows in t.free_rows.items():
            idx = torch.as_tensor(rows, device=dev)
            assert int(t.head_vc[s][idx].abs().sum()) == 0, name
    vals = [n.read_objects(_cold_objs())[0] for n in nodes]
    assert vals[0] == vals[1]
    assert nodes[1].store.cold.faults == nodes[0].store.cold.faults > 20
    assert nodes[0].store.cold.cold_set == nodes[1].store.cold.cold_set
    for name, t in nodes[0].store.tables.items():
        a, b = table_arrays(t), table_arrays(gpu.tables[name])
        for f, x in a.items():
            if isinstance(x, dict):
                assert all(np.array_equal(x[g], b[f][g]) for g in x), f
            else:
                assert np.array_equal(np.asarray(x), np.asarray(b[f])), f
    for n in nodes:
        n.close()


def test_stamp_then_evict_then_image_on_the_card(dev, tmp_path):
    """A full stamp's head copy is issued on the table's stream before an
    eviction zeroes the rows in place on the same stream: the image
    written afterwards holds every row's pre-evict bytes."""
    from antidote_tpu_torch.log import checkpoint as ckpt

    node = AntidoteNode(_durable_cfg(), log_dir=str(tmp_path / "w"),
                        resident_rows=1 << 30, device=dev)
    for i in range(64):
        node.update_objects([(i, "counter_pn", "b", ("increment", i + 1))])
    node.checkpoint_now(full=True)
    cp, store = node.checkpointer, node.store
    with node.txm.checkpoint_barrier:
        cap, frozen = cp._capture_locked()
        store.cold.budget = 1
        assert store.cold.evict_now(max_rows=64) == 64
    cp._scan_chains(cap)
    cp._write_atomic(cap, frozen)
    path = f"{cp.root}/ckpt_{cap['id']}"
    image = ckpt._load_verified(path, ckpt.load_manifest(path))
    tb = image["tables"]["counter_pn"]
    for key, _b, _t, shard, row in image["directory"]:
        assert int(tb["head"]["cnt"][shard, row]) == key + 1
    assert int(store.tables["counter_pn"].head["cnt"].abs().sum()) == 0
    node.close()


def test_import_and_reshard_onto_a_cuda_store(dev, tmp_path):
    """A shard exported from a CPU node imports into a CUDA node, and a
    reshard of the CUDA store (4 to 8 shards) keeps every value and moves
    its rows on the card."""
    from antidote_tpu_torch.log import LogManager
    from antidote_tpu_torch.store import handoff

    cfg = _durable_cfg()
    src = AntidoteNode(cfg, log_dir=str(tmp_path / "src"), device="cpu")
    for i in range(48):
        src.update_objects([(i, "counter_pn", "b", ("increment", i + 1)),
                            (("s", i % 7), "set_aw", "b", ("add", i))])
    objs = _cold_objs()[:48] + [(("s", i), "set_aw", "b") for i in range(7)]
    want = src.read_objects(objs)[0]
    dst = AntidoteNode(cfg, log_dir=str(tmp_path / "dst"), device=dev)
    for shard in range(cfg.n_shards):
        dst.receive_handoff(handoff.unpack(handoff.pack(
            handoff.export_shard(src.store, shard))))
    assert dst.read_objects(objs)[0] == want
    import dataclasses

    new_cfg = dataclasses.replace(cfg, n_shards=cfg.n_shards * 2)
    new = handoff.reshard(dst.store, new_cfg, my_dc=0,
                          log=LogManager(new_cfg, str(tmp_path / "n")))
    assert new.device.type == "cuda"
    assert all(t.head_vc.device.type == "cuda" for t in new.tables.values())
    assert AntidoteNode(store=new).read_objects(objs)[0] == want
    src.close()
    dst.close()


# ---------------------------------------------------------------------------
# the wire front end on the card
# ---------------------------------------------------------------------------
def _wire_node(dev):
    node = AntidoteNode(AntidoteConfig(n_shards=4, max_dcs=D,
                                       keys_per_table=256), device=dev)
    node.update_objects([(i, "set_aw", "b", ("add", i)) for i in range(200)]
                        + [(i, "counter_pn", "b", ("increment", i))
                           for i in range(200, 260)])
    node.txm.enable_serving_epochs()
    node.txm.publish_serving_epoch()
    return node


def _objs(rng, n):
    ks = rng.choice(260, n, replace=False)
    return [(int(k), "set_aw" if k < 200 else "counter_pn", "b")
            for k in ks]


def test_epoch_read_across_three_threads_equals_locked_read(dev):
    """An epoch read launched on one thread and finished on another while
    a third commits and publishes equals the locked read at the epoch's
    clock: every thread runs on the legacy default stream, so the
    finish's host copy is ordered after the launch."""
    import queue
    import threading

    node = _wire_node(dev)
    store = node.store
    q, results, errors = queue.Queue(), [], []
    done = threading.Event()

    def launcher():
        rng = np.random.default_rng(3)
        try:
            for _ in range(24):
                objs = _objs(rng, 128)
                ep = store.pin_serving_epoch()
                pend, fb = store.epoch_read_launch(objs, ep)
                assert not fb
                q.put((ep, pend, objs, ep.vc.copy()))
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)
        finally:
            q.put(None)

    def finisher():
        while (item := q.get(timeout=120)) is not None:
            ep, pend, objs, vc = item
            try:
                results.append((objs, vc, store.epoch_read_finish(pend)))
            finally:
                store.unpin_serving_epoch(ep)

    def writer():
        r = 0
        while not done.is_set() and r < 6:
            node.update_objects([(i, "set_aw", "b", ("add", 1000 + r))
                                 for i in range(r, 200, 7)]
                                + [(i, "counter_pn", "b", ("increment", 1))
                                   for i in range(200 + r, 260, 5)])
            node.txm.publish_serving_epoch()
            r += 1

    ts = [threading.Thread(target=f) for f in (launcher, finisher, writer)]
    for t in ts:
        t.start()
    ts[0].join(120)
    ts[1].join(120)
    done.set()
    ts[2].join(120)
    assert not errors and not any(t.is_alive() for t in ts)
    assert len(results) == 24
    for objs, vc, got in results:
        txn = node.start_transaction()
        txn.snapshot_vc = np.asarray(vc, np.int32)
        try:
            want = node.read_objects(objs, txn)
        finally:
            node.abort_transaction(txn)
        assert got == want


def test_server_launch_stage_never_syncs_the_card(dev):
    """The dispatcher's launch stage (pin, classify, chunk, launch,
    hand-off) runs under the CUDA sync debug mode at "error"; the
    writeback of the same batches then equals the locked read."""
    from antidote_tpu_torch.proto.server import ProtocolServer, _StaticWork

    node = _wire_node(dev)
    srv = ProtocolServer(node, port=0, batch_static=False)
    try:
        rng = np.random.default_rng(5)
        works = [_StaticWork("read", objects=_objs(rng, 64))
                 for _ in range(12)]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            left = srv._launch_epoch_reads(works)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert left == []
        n = 0
        while not srv._writeback_q.empty():
            b = srv._writeback_q.get_nowait()
            got = node.store.epoch_read_finish(b.pending)
            node.store.unpin_serving_epoch(b.pending.ep)
            for w, (lo, hi) in zip(b.works, b.spans):
                assert got[lo:hi] == node.read_objects(w.objects)[0]
                n += 1
        assert n == len(works)
    finally:
        srv.close()


def _frames():
    from antidote_tpu_torch.proto import apb
    from antidote_tpu_torch.proto.codec import MessageCode, encode

    def msg(code, body):
        return encode(code, body)[4:]

    rng = np.random.default_rng(9)
    out = []
    for i in range(20):
        k = int(rng.integers(8))
        out.append(msg(MessageCode.STATIC_UPDATE_OBJECTS, {"updates": [
            [k, "counter_pn", "b", ["increment", int(rng.integers(9))]],
            [f"s{k}", "set_aw", "b", ["add", int(rng.integers(99))]],
            [f"m{k}", "register_mv", "b", ["assign", i]]], "clock": None}))
        out.append(msg(MessageCode.STATIC_READ_OBJECTS, {"objects": [
            [k, "counter_pn", "b"], [f"s{k}", "set_aw", "b"],
            [f"m{k}", "register_mv", "b"]], "clock": None}))
        out.append(apb.encode_frame_body("ApbStaticReadObjects", {
            "transaction": {}, "objects": [
                {"key": f"s{k}".encode(), "type": apb.TYPE_IDS["set_aw"],
                 "bucket": b"b"}]}))
    return out


def test_reply_bytes_of_a_cuda_node_equal_a_cpu_node(dev):
    """One script of frames, both dialects, through a server over a CPU
    node and one over a CUDA node: the reply frames are byte-equal (the
    values a card decodes encode as the CPU's)."""
    import socket
    import struct

    from antidote_tpu_torch.proto.codec import read_frame_buffered
    from antidote_tpu_torch.proto.server import ProtocolServer

    replies = []
    for d in ("cpu", dev):
        node = AntidoteNode(AntidoteConfig(n_shards=4, max_dcs=D,
                                           keys_per_table=64), device=d)
        srv = ProtocolServer(node, port=0, epoch_tick_ms=0)
        try:
            s = socket.create_connection((srv.host, srv.port), timeout=60)
            rf = s.makefile("rb")
            got = []
            for f in _frames():
                s.sendall(struct.pack(">I", len(f)) + f)
                got.append(read_frame_buffered(rf))
            rf.close()
            s.close()
            replies.append(got)
        finally:
            srv.close()
    assert replies[0] == replies[1]


def test_console_serve_on_the_card_is_ready_after_the_kernel_build(
        dev, tmp_path):
    """``console serve --device cuda`` prints its ready line only after
    the readiness probe launched the kernel library on the card (built
    by then) and the native front end was built and bound, and a
    ``console ready`` poll answers without a rebuild; its status carries
    the native plane's block."""
    import json
    import os
    import select
    import subprocess
    import sys
    import time
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "antidote_tpu_torch.console", "serve",
         "--port", "0", "--shards", "4", "--max-dcs", "2"],
        cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 900)
        assert ready, "serve printed no ready line"
        info = json.loads(proc.stdout.readline())
        built = sorted((root / "antidote_tpu_torch" / "_build").glob(
            "libmaterializer_*.so"), key=os.path.getmtime)
        assert built and os.path.getmtime(built[-1]) <= time.time()
        from antidote_tpu_torch import native_build
        from antidote_tpu_torch.proto.client import AntidoteClient
        from antidote_tpu_torch.proto.native_frontend import SOURCE

        assert native_build.lib_path(SOURCE, "frontend").exists()
        c = AntidoteClient("127.0.0.1", info["port"], timeout=60)
        nat = c.node_status()["pipeline"]["native"]
        c.close()
        assert nat["accepted"] >= 1
        t0 = time.monotonic()
        res = subprocess.run(
            [sys.executable, "-m", "antidote_tpu_torch.console", "ready",
             "--port", str(info["port"])], cwd=root, env=env,
            capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        assert all(json.loads(res.stdout).values())
        assert time.monotonic() - t0 < 60
        assert sorted(built[-1].parent.glob("libmaterializer_*.so"),
                      key=os.path.getmtime)[-1] == built[-1]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def _native_hits(srv):
    return srv.native.stats()["native_hits"]


def test_native_server_over_a_cuda_node_converges(dev):
    """Clockless reads through the native plane over a CUDA node: never
    beyond the committed total, converged after every write, and served by
    the C++ loop between writes."""
    import time

    from antidote_tpu_torch.proto.client import AntidoteClient
    from antidote_tpu_torch.proto.server import ProtocolServer

    node = AntidoteNode(AntidoteConfig(n_shards=4, max_dcs=D,
                                       keys_per_table=64), device=dev)
    srv = ProtocolServer(node, port=0, native_frontend=True,
                         epoch_tick_ms=25)
    c = AntidoteClient(port=srv.port, timeout=60)
    obj = [("wk", "counter_pn", "b")]
    try:
        for total in range(1, 9):
            c.update_objects([("wk", "counter_pn", "b", ("increment", 1))])
            deadline = time.monotonic() + 30
            while (v := c.read_objects(obj)[0][0]) != total:
                assert v <= total and time.monotonic() < deadline
                time.sleep(0.01)
            for _ in range(4):
                assert c.read_objects(obj)[0] == [total]
        assert _native_hits(srv) > 0
    finally:
        c.close()
        srv.close()


def test_native_hit_bytes_of_a_cuda_node_equal_a_cpu_node(dev):
    """One script through a native server over a CPU node and one over a
    CUDA node: the whole-batch hit the C++ loop serves is byte-equal."""
    import socket
    import struct
    import time

    import msgpack

    from antidote_tpu_torch.proto.client import AntidoteClient
    from antidote_tpu_torch.proto.codec import MessageCode, read_frame
    from antidote_tpu_torch.proto.server import ProtocolServer

    objs = [[f"c{i}", "counter_pn", "b"] for i in range(4)] + [
        [f"s{i}", "set_aw", "b"] for i in range(4)] + [["nil", "set_aw", "b"]]
    body = bytes([MessageCode.STATIC_READ_OBJECTS]) + msgpack.packb(
        {"objects": objs, "clock": None}, use_bin_type=True)
    req = struct.pack(">I", len(body)) + body
    replies = []
    for d in ("cpu", dev):
        node = AntidoteNode(AntidoteConfig(n_shards=4, max_dcs=D,
                                           keys_per_table=64), device=d)
        srv = ProtocolServer(node, port=0, native_frontend=True,
                             epoch_tick_ms=25)
        try:
            c = AntidoteClient(port=srv.port, timeout=60)
            c.update_objects([(f"c{i}", "counter_pn", "b", ("increment", i))
                              for i in range(4)]
                             + [(f"s{i}", "set_aw", "b", ("add_all", [i, 9]))
                                for i in range(4)])
            c.close()
            time.sleep(0.5)
            s = socket.create_connection((srv.host, srv.port), timeout=60)
            h0 = _native_hits(srv)
            deadline = time.monotonic() + 30
            while _native_hits(srv) == h0:
                assert time.monotonic() < deadline
                s.sendall(req)
                read_frame(s)
            s.sendall(req)
            replies.append(read_frame(s))
            assert _native_hits(srv) == h0 + 2
            s.close()
        finally:
            srv.close()
    assert replies[0] == replies[1]
