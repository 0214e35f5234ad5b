"""Live membership on the port against the JAX package.

The counterparts of ``tests/test_live_membership.py`` on the port's members
(``device="cpu"``, the JAX suite's 8-shard ``cfg``): continuous writes
through a live join and a live leave of a middle member with no lost or
duplicated op, the leave planner's zero-shard survivors, departed ids never
reused, the sequencer refusing to leave, the check that ``rpcs`` covers
every live member, the membership records across a prepare-log
compaction, and a two-phase move interrupted by the exporter's crash.

Then the port held to the JAX package (the tolerance is equality): one
seeded run on each package — the same members, join, leave and
writes between the moves — gives equal shard maps and epochs, byte-equal
``own``/``members``/``departed`` records in every ``prepare.wal`` and equal
values; a shard package exported by a JAX member imports into a port member
and the reverse, with equal reads; a coordinator retrying past a ``busy``
owner leaves no prepare lock behind, and a read retried past a move reads
the new owner at its snapshot.  Two repairs of the reference: a joiner
crashing mid-join recovers the layout it was seeded with (the JAX member
recovers a modular guess over the post-join count), and an import from a
compacted source is sealed by a checkpoint link whose directory recovers
in both packages."""

import threading
import time

import msgpack
import numpy as np
import pytest

from antidote_tpu.cluster import ClusterMember as JaxMember
from antidote_tpu.cluster import ClusterNode as JaxNode
from antidote_tpu.cluster import join as jax_join
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu_torch.cluster import ClusterMember, ClusterNode
from antidote_tpu_torch.cluster import join as port_join
from antidote_tpu_torch.cluster.join import (live_join, live_leave,
                                             plan_join_moves,
                                             plan_leave_moves)
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.log.wal import replay

#: the JAX suite's widths
KW = dict(n_shards=8, max_dcs=2, ops_per_key=8, snap_versions=2,
          set_slots=8, keys_per_table=64)


@pytest.fixture
def cfg():
    return AntidoteConfig(**KW)


def _member(cfg, i, n, **kw):
    return ClusterMember(cfg, dc_id=0, member_id=i, n_members=n,
                         device="cpu", **kw)


def _wire(members):
    for i, m in enumerate(members):
        for j, o in enumerate(members):
            if i != j and o.member_id not in m.peers:
                m.connect(o.member_id, *o.address)


def _rpcs(members):
    return {m.member_id: tuple(m.address) for m in members}


def _assert_consistent_layout(members, n_shards):
    """Every member agrees on one complete map; owned sets partition the
    shard space and match the shared map."""
    ref = members[0].shard_map
    for m in members[1:]:
        assert m.shard_map == ref, (m.member_id, m.shard_map, ref)
    owned = {}
    for m in members:
        for s in m.shards:
            assert s not in owned, f"shard {s} owned twice"
            owned[s] = m.member_id
    assert set(owned) == set(range(n_shards))
    assert owned == ref
    return ref


def test_live_join_under_load_then_leave(cfg):
    ms = [_member(cfg, i, 2)
          for i in range(2)]
    _wire(ms)
    live = list(ms)
    try:
        nodes = [ClusterNode(m) for m in ms]
        n_keys = 24
        acked = np.zeros(n_keys, np.int64)
        acked_lock = threading.Lock()
        stop = threading.Event()
        errs = []

        def writer(node, seed):
            rng = np.random.default_rng(seed)
            while not stop.is_set():
                k = int(rng.integers(n_keys))
                try:
                    node.update_objects(
                        [(k, "counter_pn", "b", ("increment", 1))])
                except Exception as e:
                    if "abort" in str(e).lower():
                        continue  # cert conflict: not acked, retryable
                    import traceback
                    errs.append(traceback.format_exc())
                    return
                with acked_lock:
                    acked[k] += 1

        ts = [threading.Thread(target=writer, args=(nodes[i % 2], 40 + i))
              for i in range(3)]
        for t in ts:
            t.start()
        time.sleep(1.0)  # load running against the 2-member cluster

        # ---- live join member 2, WHILE the writers run: the balanced
        # plan streams shards only TO the joiner (2 of 8 here), never
        # reshuffling the survivors — minimal moves, not a modular remap
        joiner = _member(cfg, 2, 3,
                               shards=[])
        live.append(joiner)
        _wire(live)
        moved = live_join(_rpcs(live), new_id=2)
        assert moved == len(plan_join_moves(
            {s: s % 2 for s in range(cfg.n_shards)}, 2)) == 2
        assert joiner.shards == {0, 1}

        time.sleep(1.0)  # load continues on the 3-member cluster
        stop.set()
        for t in ts:
            t.join(timeout=60)
        assert not errs, errs

        # every member agrees on one balanced layout covering all shards
        layout = _assert_consistent_layout(live, cfg.n_shards)
        loads = [sum(1 for o in layout.values() if o == m) for m in range(3)]
        assert max(loads) - min(loads) <= 1, loads

        # zero lost, zero duplicated: every acked increment is readable
        # exactly once, from every member's coordinator
        objs = [(k, "counter_pn", "b") for k in range(n_keys)]
        for node in (ClusterNode(joiner), nodes[0], nodes[1]):
            vals, _ = node.read_objects(objs)
            got = np.asarray(vals, np.int64)
            assert (got == acked).all(), (got.tolist(), acked.tolist())

        # ---- live leave: member 2 drains back out, data survives
        live_leave(_rpcs(live), leaving_id=2)
        assert joiner.shards == set()
        vals, _ = nodes[0].read_objects(objs)
        assert (np.asarray(vals, np.int64) == acked).all()
        _assert_consistent_layout(ms, cfg.n_shards)
        # the shrunk cluster still commits
        nodes[1].update_objects([(0, "counter_pn", "b", ("increment", 5))])
        vals, _ = nodes[0].read_objects([(0, "counter_pn", "b")])
        assert vals[0] == int(acked[0]) + 5
    finally:
        for m in live:
            try:
                m.close()
            except Exception:
                pass


def test_live_leave_middle_member_under_load(cfg):
    """The r5 VERDICT item 3 acceptance shape: member 1 of 3 — a MIDDLE
    id — live-leaves under write load.  Its shards drain to the
    least-loaded survivors, the id space keeps its gap (no renumbering),
    and zero acked ops are lost or duplicated."""
    ms = [_member(cfg, i, 3)
          for i in range(3)]
    _wire(ms)
    try:
        nodes = [ClusterNode(m) for m in ms]
        n_keys = 24
        acked = np.zeros(n_keys, np.int64)
        acked_lock = threading.Lock()
        stop = threading.Event()
        errs = []

        def writer(node, seed):
            rng = np.random.default_rng(seed)
            while not stop.is_set():
                k = int(rng.integers(n_keys))
                try:
                    node.update_objects(
                        [(k, "counter_pn", "b", ("increment", 1))])
                except Exception as e:
                    if "abort" in str(e).lower():
                        continue
                    import traceback
                    errs.append(traceback.format_exc())
                    return
                with acked_lock:
                    acked[k] += 1

        # drive through members 0 and 2 (the survivors): the leaver's
        # clients would need re-pointing at a survivor anyway (its
        # process goes away), exactly like draining a real node
        ts = [threading.Thread(target=writer, args=(nodes[i], 70 + i))
              for i in (0, 2, 0)]
        for t in ts:
            t.start()
        time.sleep(1.0)

        before = {s: int(o) for s, o in ms[0].shard_map.items()}
        moved = live_leave(_rpcs(ms), leaving_id=1)
        assert moved == len(plan_leave_moves(before, 1)) == 3

        time.sleep(1.0)
        stop.set()
        for t in ts:
            t.join(timeout=60)
        assert not errs, errs

        assert ms[1].shards == set()
        survivors = [ms[0], ms[2]]
        layout = _assert_consistent_layout(survivors, cfg.n_shards)
        assert set(layout.values()) == {0, 2}  # the gap stays a gap
        # the departed peer is forgotten everywhere
        for m in survivors:
            assert 1 not in m.peers

        objs = [(k, "counter_pn", "b") for k in range(n_keys)]
        for node in (nodes[0], ClusterNode(ms[2])):
            vals, _ = node.read_objects(objs)
            got = np.asarray(vals, np.int64)
            assert (got == acked).all(), (got.tolist(), acked.tolist())

        # the gapped cluster still serves writes on every shard
        for k in range(cfg.n_shards):
            nodes[0].update_objects(
                [(k, "counter_pn", "b", ("increment", 1))])
        vals, _ = ClusterNode(ms[2]).read_objects(
            [(k, "counter_pn", "b") for k in range(cfg.n_shards)])
        assert vals == [int(acked[k]) + 1 for k in range(cfg.n_shards)]
    finally:
        for m in ms:
            try:
                m.close()
            except Exception:
                pass


def test_leave_plan_includes_zero_shard_survivors():
    """A survivor owning nothing is invisible in the shard map but is
    the least-loaded placement target by definition — the planner must
    see it."""
    shard_map = {0: 0, 1: 1, 2: 0, 3: 1}
    moves = plan_leave_moves(shard_map, 1, members={0, 1, 2})
    assert [dst for _s, _src, dst in moves] == [2, 2]
    # without the member hint the old occupancy-only behavior remains
    moves = plan_leave_moves(shard_map, 1)
    assert all(dst == 0 for _s, _src, dst in moves)


def test_departed_id_is_never_reused(cfg):
    """The id-space bound is monotone EVERYWHERE (m_forget_member,
    m_set_owner broadcasts, recovery replay): after leaves — including
    the highest-then-middle sequence whose second drive recomputes a
    SMALLER bound from its shrunken rpcs map — a join reusing any
    departed id must be refused; its durable state and the routes
    remote DCs learned for its fabric id would alias the new member."""
    ms = [_member(cfg, i, 3)
          for i in range(3)]
    _wire(ms)
    try:
        live_leave(_rpcs(ms), leaving_id=2)   # highest id departs...
        live_leave({0: tuple(ms[0].address),
                    1: tuple(ms[1].address)}, leaving_id=1)  # ...then mid
        assert ms[0].n_members == 3  # bound never shrank
        assert ms[0].departed == {1, 2}  # durable never-reuse set
        for dead in (1, 2):
            with pytest.raises(ValueError, match="never be reused"):
                live_join({0: tuple(ms[0].address),
                           dead: ("127.0.0.1", 1)}, new_id=dead)
        # even a reused id the operator already WIRED back into the peer
        # set (indistinguishable from an interrupted join by liveness
        # alone) is refused — the durable departed set catches it
        imposter = _member(cfg, 2, 3,
                                 shards=[])
        try:
            ms[0].connect(2, *imposter.address)
            with pytest.raises(ValueError, match="never be reused"):
                live_join({0: tuple(ms[0].address),
                           2: tuple(imposter.address)}, new_id=2)
        finally:
            imposter.close()
            ms[0].peers.pop(2).close()
        # a genuinely fresh id is welcome (validation passes the bound
        # check; the dummy address then fails at wiring, which proves
        # the refusal above came from the bound, not the address)
        with pytest.raises(Exception,
                           match="(?i)connect|refused|timed|attempt"):
            live_join({0: tuple(ms[0].address),
                       3: ("127.0.0.1", 1)}, new_id=3)
    finally:
        for m in ms:
            m.close()


def test_sequencer_cannot_live_leave(cfg):
    ms = [_member(cfg, i, 2)
          for i in range(2)]
    _wire(ms)
    try:
        with pytest.raises(ValueError, match="sequencer"):
            live_leave(_rpcs(ms), leaving_id=0)
    finally:
        for m in ms:
            m.close()


def test_rpcs_must_cover_every_live_member(cfg):
    """A caller that forgets a live member would half-commit the change
    (the omitted member never hears the broadcasts); both refuse
    up front, before any durable mutation."""
    ms = [_member(cfg, i, 3)
          for i in range(3)]
    _wire(ms)
    try:
        partial = {0: tuple(ms[0].address), 1: tuple(ms[1].address)}
        with pytest.raises(ValueError, match="cover every live member"):
            live_leave(partial, leaving_id=1)  # member 2 omitted
        # nothing moved, nothing forgotten
        assert 2 in ms[0].peers and ms[1].shards
    finally:
        for m in ms:
            m.close()


def test_membership_state_survives_log_compaction(cfg, tmp_path):
    """Prepare-log compaction rewrites the WAL from live state; it must
    re-emit the membership records (boot_layout + full map/epochs +
    id-space bound + departed set), or a post-move member would recover
    with the modular guess of its recover-time count — silently
    claiming shards it gave away."""
    dirs = [str(tmp_path / f"m{i}") for i in range(3)]
    ms = [_member(cfg, i, 3,
                        log_dir=dirs[i]) for i in range(3)]
    _wire(ms)
    try:
        live_leave(_rpcs(ms), leaving_id=1)
        m0 = ms[0]
        before = (set(m0.shards), dict(m0.shard_map),
                  dict(m0.shard_epoch), set(m0.departed), m0.n_members)
        m0._compact_prepare_log()
        m0.close()
        m0.node.store.log.close()
        rec = _member(cfg, 0, 3,
                            log_dir=dirs[0], recover=True)
        ms[0] = rec
        assert (set(rec.shards), dict(rec.shard_map),
                dict(rec.shard_epoch), set(rec.departed),
                rec.n_members) == before
    finally:
        for m in ms:
            try:
                m.close()
            except Exception:
                pass


def test_join_recovers_from_crash_mid_move(cfg, tmp_path):
    """Two-phase move crash safety: a crash after export (before the
    import is confirmed) destroys NOTHING — the source still owns the
    only durable copy (ownership flips only at relinquish), the volatile
    mid-move mark clears on restart, and a re-run of the moves completes the
    move with a fresh export."""
    dirs = [str(tmp_path / f"m{i}") for i in range(2)]
    ms = [_member(cfg, i, 2,
                        log_dir=dirs[i]) for i in range(2)]
    _wire(ms)
    joiner_dir = str(tmp_path / "m2")
    try:
        node = ClusterNode(ms[0])
        for k in range(12):
            node.update_objects([(k, "counter_pn", "b", ("increment", k + 1))])
        joiner = _member(cfg, 2, 3,
                               shards=[], log_dir=joiner_dir)
        ms.append(joiner)
        _wire(ms)
        for m in ms:
            m.m_join_begin(2, list(joiner.address), 3)
        # move ONE shard by hand, crashing the exporter before the
        # import lands: two-phase export copied WITHOUT dropping, so the
        # crash destroys nothing
        moves = plan_join_moves({s: int(o[0]) for s, o in
                                 ms[0].m_shard_map().items()}, 2)
        shard, src, dst = moves[0]
        data = ms[src].m_export_shard(shard, dst)
        assert shard in ms[src].shards      # still the owner (phase 1)
        assert shard in ms[src].moving      # but refusing new work
        del data  # the mover "crashes"; its package dies with it
        ms[src].close()
        ms[src].node.store.log.close()
        ms[src]._prep_wal.close()
        rec = _member(cfg, src, 3,
                            log_dir=dirs[src], recover=True)
        ms[src] = rec
        # rejoin re-wiring: peers must learn the recovered member's NEW
        # address (the takeover rejoin flow's re-ctl_wire step)
        for m in ms:
            if m is not rec:
                m.connect(src, *rec.address)
        _wire(ms)
        # the recovered source still owns the shard (no durable own
        # event until relinquish) and the volatile mid-move mark cleared
        assert shard in rec.shards
        assert shard not in rec.moving
        assert rec.shard_map[shard] == src
        # a re-run completes the whole plan with fresh exports
        for shard2, src2, dst2 in moves:
            d2 = ms[src2].m_export_shard(shard2, dst2)
            ms[dst2].m_import_shard(d2)
            ms[src2].m_relinquish_shard(shard2, dst2)
            for m in ms:
                if m.member_id not in (src2, dst2):
                    m.m_set_owner(shard2, dst2, 3)
        vals, _ = ClusterNode(ms[1]).read_objects(
            [(k, "counter_pn", "b") for k in range(12)])
        assert vals == [k + 1 for k in range(12)]
    finally:
        for m in ms:
            try:
                m.close()
            except Exception:
                pass


# ---------------------------------------------------------------------------
# the port held to the JAX package
# ---------------------------------------------------------------------------
C, S, B = "counter_pn", "set_aw", "b"
#: the membership records of a prepare log
MEMBERSHIP = ("boot_layout", "own", "members", "departed")


class _Jax:
    Node = JaxNode
    join = jax_join

    @staticmethod
    def member(i, n, **kw):
        cfg = JaxConfig(**KW, batch_buckets=(8, 64))
        return JaxMember(cfg, dc_id=0, member_id=i, n_members=n, **kw)


class _Port:
    Node = ClusterNode
    join = port_join

    @staticmethod
    def member(i, n, **kw):
        return _member(AntidoteConfig(**KW), i, n, **kw)


def _close(ms):
    for m in ms:
        try:
            m.close()
        except (OSError, RuntimeError):
            pass


def _crash(m):
    m.rpc.close()
    m.node.store.log.close()
    m._prep_wal.close()


def _membership_records(log_dir):
    return [msgpack.packb(r, use_bin_type=True)
            for r in replay(f"{log_dir}/prepare.wal")
            if r.get("ev") in MEMBERSHIP]


def _seeded_run(pkg, root):
    """Three members with logs and writes; member 3 joins, member 1 (a
    middle id) leaves; member 0's coordinator commits one seeded
    transaction after every move and a few around them."""
    dirs = [str(root / pkg.__name__ / f"m{i}") for i in range(4)]
    ms = [pkg.member(i, 3, log_dir=dirs[i]) for i in range(3)]
    _wire(ms)
    rng = np.random.default_rng(11)
    try:
        coord = pkg.Node(ms[0])

        def write(*_):
            k = int(rng.integers(24))
            coord.update_objects([(k, C, B, ("increment", int(k) + 1)),
                                  (100 + k, S, B,
                                   ("add", int(rng.integers(1000))))])

        for _ in range(10):
            write()
        ms.append(pkg.member(3, 4, log_dir=dirs[3], shards=[]))
        _wire(ms)
        moved = [pkg.join.live_join(_rpcs(ms), 3, progress=write)]
        write()
        moved.append(pkg.join.live_leave(_rpcs(ms), 1, progress=write))
        for _ in range(4):
            write()
        survivors = [ms[0], ms[2], ms[3]]
        objs = ([(k, C, B) for k in range(24)]
                + [(100 + k, S, B) for k in range(24)])
        out = {"moved": moved,
               "maps": [m.m_shard_map() for m in ms],
               "shards": [sorted(m.shards) for m in ms],
               "membership": [m.m_membership() for m in survivors],
               "values": [sorted(v) if isinstance(v, list) else v
                          for v in coord.read_objects(objs)[0]]}
    finally:
        _close(ms)
    out["records"] = [_membership_records(d) for d in dirs]
    return out


def test_seeded_join_and_leave_equal_the_jax_package(tmp_path):
    """The same seeded run on both packages: equal moves, maps with their
    epochs, owned sets, membership views, values — and byte-equal
    membership records in every member's ``prepare.wal``."""
    port = _seeded_run(_Port, tmp_path)
    jax = _seeded_run(_Jax, tmp_path)
    assert port["moved"] == jax["moved"] == [2, 2]
    for key in ("maps", "shards", "membership", "values"):
        assert port[key] == jax[key], key
    assert port["records"] == jax["records"]
    # the leaver's own records hand each of its shards away
    assert sum(1 for r in port["records"][1]
               if msgpack.unpackb(r)["ev"] == "own") >= 2


def _seed_duo(pkg):
    ms = [pkg.member(i, 2) for i in range(2)]
    _wire(ms)
    coord = pkg.Node(ms[0])
    for k in range(16):
        coord.update_objects([(k, C, B, ("increment", k + 1)),
                              (100 + k, S, B, ("add_all", [k, k + 50]))])
    coord.update_objects([(101, S, B, ("remove", 1))])
    return ms


def test_shard_packages_move_across_the_packages():
    """A shard exported by a JAX member imports into a port member, and a
    port member's into a JAX member: the importers read what the exporters
    read, and take the same certification table."""
    jax_duo, port_duo = _seed_duo(_Jax), _seed_duo(_Port)
    importers = [_Port.member(2, 3, shards=[]), _Jax.member(2, 3, shards=[])]
    try:
        shard = 1
        owned = [o for o in ([(k, C, B) for k in range(16)]
                             + [(100 + k, S, B) for k in range(16)])
                 if _shard_of(o) == shard]
        assert len(owned) >= 4
        vc = [int(x) for x in jax_duo[1].node.store.applied_vc[shard]]
        want = jax_duo[1].m_read_values(owned, vc)
        assert port_duo[1].m_read_values(owned, vc) == want
        port_imp, jax_imp = importers
        port_imp.m_import_shard(jax_duo[1].m_export_shard(shard, 2))
        jax_imp.m_import_shard(port_duo[1].m_export_shard(shard, 2))
        assert port_imp.shards == jax_imp.shards == {shard}
        assert port_imp.m_read_values(owned, vc) == want
        assert jax_imp.m_read_values(owned, vc) == want
        assert port_imp.last_commit == jax_imp.last_commit
        assert port_imp.shard_epoch[shard] == jax_imp.shard_epoch[shard] == 1
    finally:
        _close(jax_duo + port_duo + importers)


def _shard_of(obj):
    from antidote_tpu_torch.store.kv import key_to_shard

    return key_to_shard(obj[0], obj[2], KW["n_shards"])


@pytest.mark.parametrize("pkg", [_Port, _Jax], ids=["port", "jax"])
def test_prepare_retried_past_busy_leaves_no_lock(pkg):
    """A commit whose second owner answers ``busy`` (its shard exported,
    mid-move) aborts the first owner's prepare before every retry: once
    the move is cancelled the commit lands once, and no prepare lock or
    staged write-set is left at either owner."""
    ms = [pkg.member(i, 2) for i in range(2)]
    _wire(ms)
    try:
        c0, c1 = pkg.Node(ms[0]), pkg.Node(ms[1])
        # int key k lives on shard k % 8: shard 0 at member 0, 1 at 1
        t = c0.start_transaction()
        c0.update_objects([(0, C, B, ("increment", 5)),
                           (1, C, B, ("increment", 7))], txn=t)
        ms[1].m_export_shard(1, 0)
        done = []
        th = threading.Thread(target=lambda: done.append(
            c0.commit_transaction(t)))
        th.start()
        time.sleep(0.3)
        assert not done  # riding out the move window
        ms[1].m_cancel_export(1)
        th.join(timeout=30)
        assert done
        for m in ms:
            assert m.prepared == {} and m.staged == {}
        c1.update_objects([(0, C, B, ("increment", 1))])
        vals, _ = c1.read_objects([(0, C, B), (1, C, B)])
        assert vals == [6, 7]
        if pkg is _Port:
            assert c0.move_retries["busy"] >= 2
    finally:
        _close(ms)


def test_read_retried_past_a_move_reads_the_new_owner_at_its_snapshot():
    """A coordinator whose map still names the old owner gets
    ``not_owner``, refreshes from a peer and reads the moved shard at the
    new owner, at the transaction's snapshot (the ring ops after it are
    folded out)."""
    ms = [_Port.member(i, 2) for i in range(2)]
    _wire(ms)
    try:
        c0 = ClusterNode(ms[0])
        c0.update_objects([(1, C, B, ("increment", 3)),
                           (9, S, B, ("add", "a"))])
        t = c0.start_transaction()
        c0.update_objects([(1, C, B, ("increment", 4)),
                           (9, S, B, ("add", "b"))])
        joiner = _Port.member(2, 3, shards=[])
        ms.append(joiner)
        _wire(ms)
        for m in ms:
            m.m_join_begin(2, list(joiner.address), 3)
        # the move without its broadcast: member 0's map goes stale
        joiner.m_import_shard(ms[1].m_export_shard(1, 2))
        ms[1].m_relinquish_shard(1, 2)
        assert ms[0].shard_map[1] == 1
        assert c0.read_objects([(1, C, B), (9, S, B)], txn=t) == [3, ["a"]]
        assert c0.move_retries["not_owner"] >= 1
        assert ms[0].shard_map[1] == 2 and ms[0].shard_epoch[1] == 1
        assert c0.read_objects([(1, C, B)])[0] == [7]
    finally:
        _close(ms)


def test_joiner_crashed_mid_join_recovers_its_seeded_layout(tmp_path):
    """A joiner with a log crashes after its first import: it recovers the
    moved shard and every other entry of the map it was seeded with.  The
    JAX member recovers its unmoved entries modular over the post-join
    count, which names owners the shards never had."""
    recovered = {}
    for pkg in (_Port, _Jax):
        root = tmp_path / pkg.__name__
        ms = [pkg.member(i, 2, log_dir=str(root / f"m{i}"))
              for i in range(2)]
        joiner = pkg.member(2, 3, shards=[], log_dir=str(root / "j"))
        ms.append(joiner)
        _wire(ms)
        try:
            pkg.Node(ms[0]).update_objects(
                [(k, C, B, ("increment", k + 1)) for k in range(16)])
            for m in ms:
                m.m_join_begin(2, list(joiner.address), 3)
            joiner.m_seed_map(ms[0].m_shard_map(), 3)
            shard, src, dst = plan_join_moves(
                {s: e[0] for s, e in ms[0].m_shard_map().items()}, 2)[0]
            joiner.m_import_shard(ms[src].m_export_shard(shard, dst))
            ms[src].m_relinquish_shard(shard, dst)
            ms[1 - src].m_set_owner(shard, dst, 3, 1)
            want = ms[0].shard_map
            _crash(joiner)
            rec = pkg.member(2, 3, shards=[], log_dir=str(root / "j"),
                             recover=True)
            ms[2] = rec
            recovered[pkg.__name__] = (rec.shards, rec.shard_map, want,
                                       shard)
        finally:
            _close(ms)
    shards, got, want, shard = recovered["_Port"]
    assert shards == {shard} and got == want
    shards, got, want, shard = recovered["_Jax"]
    assert shards == {shard} and got != want


def test_compacted_import_sealed_by_a_link_recovers_in_both(tmp_path):
    """Members that checkpointed export compacted shards: each import at
    the joiner returns only once a local checkpoint covers the rows — a
    full image first, then delta links without a WAL rotation — and the
    joiner's directory, crashed after the join, recovers the moved values
    in the port and in the JAX package."""
    dirs = [str(tmp_path / f"m{i}") for i in range(3)]
    ms = [_Port.member(i, 2, log_dir=dirs[i]) for i in range(2)]
    _wire(ms)
    try:
        coord = ClusterNode(ms[0])
        for k in range(16):
            coord.update_objects([(k, C, B, ("increment", k + 1)),
                                  (100 + k, S, B, ("add", k))])
        for m in ms:
            m.node.checkpoint_now()
        joiner = _Port.member(2, 3, shards=[], log_dir=dirs[2])
        ms.append(joiner)
        _wire(ms)
        gens = joiner.node.store.log.gen
        assert live_join(_rpcs(ms), 2) == 2
        kinds = [m["kind"] for m in _manifests(dirs[2])]
        assert kinds == ["full", "delta"]
        assert joiner.node.store.log.gen == gens  # no WAL rotation
        objs = [(k, C, B) for k in range(16)] + [(100 + k, S, B)
                                                 for k in range(16)]
        mine = [o for o in objs if _shard_of(o) in joiner.shards]
        vc = [int(x) for x in joiner.node.store.dc_max_vc()]
        want = joiner.m_read_values(mine, vc)
        assert want
        _crash(joiner)
        rec = _Port.member(2, 3, shards=[], log_dir=dirs[2], recover=True)
        ms[2] = rec
        assert rec.m_read_values(mine, vc) == want
        rec.close()
        jrec = _Jax.member(2, 3, shards=[], log_dir=dirs[2], recover=True)
        try:
            assert jrec.shards == rec.shards
            assert jrec.m_read_values(mine, vc) == want
        finally:
            jrec.close()
    finally:
        _close(ms)


def _manifests(log_dir):
    from antidote_tpu_torch.log.checkpoint import (checkpoint_root,
                                                   list_checkpoints,
                                                   load_manifest)

    return [load_manifest(p) for _i, p in
            list_checkpoints(checkpoint_root(log_dir))]


def test_a_shard_mid_move_pings_no_frontier_past_its_applied_clock():
    """Between the importer taking a shard and the source relinquishing
    it, both members hold it; a commit at the importer gets a ts above
    the source's applied frontier.  The source's inter-DC endpoint must
    keep the moved chain's safe time at that frontier: a ping claiming the
    sequencer's counter would make a remote DC drop the importer's commit
    as a duplicate (the JAX endpoint claims the counter)."""
    from antidote_tpu.cluster import attach_interdc as jax_attach
    from antidote_tpu.interdc.transport import LoopbackHub as JaxHub
    from antidote_tpu_torch.cluster import attach_interdc
    from antidote_tpu_torch.interdc.transport import LoopbackHub

    safe = {}
    for pkg, attach, hub in ((_Port, attach_interdc, LoopbackHub()),
                             (_Jax, jax_attach, JaxHub())):
        ms = [pkg.member(i, 2) for i in range(2)]
        _wire(ms)
        try:
            reps = [attach(m, hub) for m in ms]
            coord = pkg.Node(ms[0])
            coord.update_objects([(1, C, B, ("increment", 1))])
            frontier = ms[1].applied_ts[1]
            ms[1].m_export_shard(1, 0)
            # the sequencer moves on (commits on member 0's shards)
            for _ in range(3):
                coord.update_objects([(0, C, B, ("increment", 1))])
            ms[1].invalidate_seq_cache()
            safe[pkg.__name__] = (int(reps[1].safe_time(1)), frontier,
                                  int(ms[0].seq.counter))
        finally:
            _close(ms)
    got, frontier, counter = safe["_Port"]
    assert got == frontier < counter
    got, frontier, counter = safe["_Jax"]
    assert got == counter > frontier


def test_a_ping_never_claims_a_ts_sequenced_during_its_checks():
    """A member's safe time for a shard must not cover a transaction that
    is prepared there and sequenced while the safe time is being decided:
    the ping would reach the remote DC before the transaction, and the
    remote DC would drop the transaction as a duplicate.  The window is
    planted between the prepared-check and what follows it.  The port
    reads the sequencer's frontier before its checks and stays below the
    planted ts; the JAX endpoint reads it after them and claims it."""
    from antidote_tpu.cluster import attach_interdc as jax_attach
    from antidote_tpu.interdc.transport import LoopbackHub as JaxHub
    from antidote_tpu_torch.cluster import attach_interdc
    from antidote_tpu_torch.interdc.transport import LoopbackHub

    got = {}
    for pkg, attach, hub in ((_Port, attach_interdc, LoopbackHub()),
                             (_Jax, jax_attach, JaxHub())):
        m = pkg.member(0, 1)
        try:
            rep = attach(m, hub)
            pkg.Node(m).update_objects([(0, C, B, ("increment", 1))])
            shard = _shard_of((0, C, B))
            read_vc = [int(x) for x in m.stable_vc()]
            checks = m.prepared_on_shard
            planted = []

            def racing(s, checks=checks, m=m, read_vc=read_vc,
                       shard=shard, planted=planted):
                held = checks(s)
                if not planted:
                    # a coordinator's prepare and its ts land here
                    planted.append(0)
                    effs = m.m_downstream(0, C, B, ("increment", 1),
                                          read_vc)
                    m.m_prepare(77, effs, read_vc[0])
                    planted[0] = int(m.seq_ts([shard], 77)[0])
                return held

            m.prepared_on_shard = racing
            got[pkg.__name__] = (int(rep.safe_time(shard)), planted[0])
        finally:
            _close([m])
    safe, ts = got["_Port"]
    assert safe < ts
    safe, ts = got["_Jax"]
    assert safe == ts


def test_remote_commits_during_a_move_reach_the_importer_whole():
    """Between a move's export and its relinquish the remote DC commits on
    the moving shard.  The source leaves them to the importer, whose chain
    state starts at the export's cut: they reach the importer through its
    catch-up, after a transaction the source's coordinator started from
    its own view of the clocks has committed there.  Had the source
    applied them to its copy (as the JAX endpoint does), its clock row
    would run ahead of the importer's, that transaction's snapshot would
    carry the ahead row into the importer's clock, and the importer would
    drop the remote commits as duplicates."""
    from antidote_tpu_torch.api.node import AntidoteNode
    from antidote_tpu_torch.cluster import (attach_interdc,
                                            cluster_query_router)
    from antidote_tpu_torch.interdc import DCReplica, LoopbackHub

    hub = LoopbackHub()
    ms = [_Port.member(i, 2) for i in range(2)]
    _wire(ms)
    node1 = AntidoteNode(AntidoteConfig(**KW), dc_id=1, device="cpu")
    try:
        reps = [attach_interdc(m, hub) for m in ms]
        r1 = DCReplica(node1, hub)
        r1.route_query = cluster_query_router({0: 2}, KW["n_shards"])
        for r in reps:
            r.observe_dc(r1)
            r1.observe_dc(r)
        obj = (0, C, B)  # shard 0, member 0's: the coordinator's member
        shard, chain = _shard_of(obj), (1, 0)
        node1.update_objects([(0, C, B, ("increment", 1))])
        hub.pump()
        cut = reps[0].last_seen[chain]
        data = ms[0].m_export_shard(shard, 1)
        row = ms[0].node.store.applied_vc[shard].copy()
        for _ in range(3):
            node1.update_objects([(0, C, B, ("increment", 10))])
        r1.heartbeat()
        hub.pump()
        # the source left the window's commits to the importer
        assert reps[0].last_seen[chain] == cut
        assert (ms[0].node.store.applied_vc[shard] == row).all()
        ms[1].m_import_shard(data)
        ms[0].m_relinquish_shard(shard, 1)
        ms[0].refresh_peer_clocks()
        vc0 = ClusterNode(ms[0]).update_objects(
            [(0, C, B, ("increment", 100))])
        last = node1.update_objects([(0, C, B, ("increment", 1000))])
        hub.pump()
        assert reps[1].catchups >= 1
        vc = [int(x) for x in np.maximum(vc0, last)]
        assert ms[1].m_read_values([obj], vc)[0] == 1131
    finally:
        _close(ms)
        node1.close()


def test_a_failed_import_leaves_nothing_for_the_move_run_again(tmp_path):
    """The joiner's seal of a compacted import fails on every try: each
    failed try drops what it installed, and the mover cancels the export,
    so the source serves and commits on.  The move run again installs the
    new package whole: the commits made between the two exports are at
    the new owner."""
    dirs = [str(tmp_path / f"m{i}") for i in range(3)]
    ms = [_Port.member(i, 2, log_dir=dirs[i]) for i in range(2)]
    _wire(ms)
    clients = {}
    try:
        coord = ClusterNode(ms[0])
        coord.update_objects([(1, C, B, ("increment", 1)),
                              (9, S, B, ("add", "a"))])
        for m in ms:
            m.node.checkpoint_now()  # compacted sources: imports seal
        joiner = _Port.member(2, 3, shards=[], log_dir=dirs[2])
        ms.append(joiner)
        _wire(ms)
        for m in ms:
            m.m_join_begin(2, list(joiner.address), 3)
        seal = joiner.node.seal_import

        def broken():
            raise OSError("no space left on device")

        joiner.node.seal_import = broken
        from antidote_tpu_torch.cluster.rpc import RpcClient

        clients = {m.member_id: RpcClient(*m.address) for m in ms}
        with pytest.raises(RuntimeError, match="kept failing"):
            port_join._move_shard(clients, 1, 1, 2, 3)
        store = joiner.node.store
        assert not list(store.directory.shard_keys(1))
        assert all(int(t.used_rows[1]) == 0 for t in store.tables.values())
        assert 1 in ms[1].shards and 1 not in ms[1].moving
        coord.update_objects([(1, C, B, ("increment", 10)),
                              (9, S, B, ("add", "b"))])
        joiner.node.seal_import = seal
        port_join._move_shard(clients, 1, 1, 2, 3)
        assert joiner.shards == {1} and ms[0].shard_map[1] == 2
        assert coord.read_objects([(1, C, B), (9, S, B)])[0] == [
            11, ["a", "b"]]
    finally:
        for c in clients.values():
            c.close()
        _close(ms)


def test_a_call_dying_with_a_departed_member_is_its_not_owner():
    """A coordinator whose map still names a member that has just left:
    the leave's ``m_forget_member`` dropped that member's client (or
    closed it under a call in flight), and the failed call is read as the
    departed member's ``not_owner`` — the commit refreshes its map and
    lands at the new owner instead of failing the client."""
    ms = [_Port.member(i, 3) for i in range(3)]
    _wire(ms)
    try:
        c0 = ClusterNode(ms[0])
        c0.update_objects([(1, C, B, ("increment", 2))])
        # member 1 hands shard 1 to member 2; member 0 misses the
        # broadcast, then forgets the departed member
        ms[2].m_import_shard(ms[1].m_export_shard(1, 2))
        ms[1].m_relinquish_shard(1, 2)
        ms[0].m_forget_member(1, 3)
        assert ms[0].shard_map[1] == 1 and 1 not in ms[0].peers
        c0.update_objects([(1, C, B, ("increment", 3))])
        assert c0.move_retries["not_owner"] >= 1
        assert ms[0].shard_map[1] == 2
        assert c0.read_objects([(1, C, B)])[0] == [5]
    finally:
        _close(ms)
