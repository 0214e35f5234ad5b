"""Offline membership resize (``cluster/resize.py``) against the JAX package.

The three resize cases of ``tests/test_cluster_features.py`` run on each
package (the port's members and resize on ``device="cpu"``) with equal
results: a 2 -> 3 -> 1 resize reading every value back and committing on
the grown and shrunk DCs; a commit logged but never applied surviving the
resize (recovery through the full member machinery); the layout-epoch
stamps and the refusal to boot a retired directory.  Then directories
written by the JAX package are resized by the port's ``resize_dc`` and read
back by members of both packages, equal to the JAX package's own resize;
the quiescence gate refuses an undecided prepare; and a DC whose members
checkpointed (their WALs hold only the tail above the images) keeps every
value across the port's resize.  Exact: the tolerance is equality."""

import shutil

import pytest

from antidote_tpu.cluster import ClusterMember as JaxMember
from antidote_tpu.cluster import ClusterNode as JaxNode
from antidote_tpu.cluster.resize import resize_dc as jax_resize
from antidote_tpu.cluster.rpc import eff_to_wire as jax_eff_to_wire
from antidote_tpu.config import AntidoteConfig as JaxConfig
from antidote_tpu.log import LogDirMismatch as JaxDirMismatch
from antidote_tpu.log import load_dir_meta as jax_dir_meta
from antidote_tpu_torch.cluster import ClusterMember, ClusterNode
from antidote_tpu_torch.cluster.resize import main as resize_main
from antidote_tpu_torch.cluster.resize import resize_dc
from antidote_tpu_torch.cluster.rpc import eff_to_wire
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.log import LogDirMismatch, load_dir_meta
from antidote_tpu_torch.store.kv import key_to_shard

KW = dict(n_shards=4, max_dcs=3, ops_per_key=8, keys_per_table=64)
C, S, B = "counter_pn", "set_aw", "b"


class _Jax:
    Node = JaxNode
    wire = staticmethod(jax_eff_to_wire)
    resize = staticmethod(jax_resize)
    DirMismatch = JaxDirMismatch
    dir_meta = staticmethod(jax_dir_meta)

    @staticmethod
    def member(i, n, log_dir, recover=False, **kw):
        cfg = JaxConfig(**{**KW, **kw}, batch_buckets=(16, 64))
        return JaxMember(cfg, dc_id=0, member_id=i, n_members=n,
                         log_dir=log_dir, recover=recover)


class _Port:
    Node = ClusterNode
    wire = staticmethod(eff_to_wire)
    resize = staticmethod(lambda old, new, dc_id=0:
                          resize_dc(old, new, dc_id, device="cpu"))
    DirMismatch = LogDirMismatch
    dir_meta = staticmethod(load_dir_meta)

    @staticmethod
    def member(i, n, log_dir, recover=False, **kw):
        return ClusterMember(AntidoteConfig(**{**KW, **kw}), dc_id=0,
                             member_id=i, n_members=n, log_dir=log_dir,
                             recover=recover, device="cpu")


def _dc(pkg, dirs, recover=False, **kw):
    ms = [pkg.member(i, len(dirs), d, recover, **kw)
          for i, d in enumerate(dirs)]
    for m in ms:
        for o in ms:
            if o is not m:
                m.connect(o.member_id, *o.address)
    return ms


def _shutdown(ms):
    """Stop members the way the resize tool expects them: quiesced, logs
    closed (a clean stop)."""
    for m in ms:
        m.rpc.close()
        if m.node.store.log is not None:
            m.node.store.log.close()
        m._prep_wal.close()


def _sorted(vals):
    return [sorted(v) if isinstance(v, list) else v for v in vals]


def _populate(pkg, ms, n=12):
    c = pkg.Node(ms[-1])
    expect = {}
    for i in range(n):
        c.update_objects([(f"k{i}", C, B, ("increment", i + 1)),
                          (f"s{i}", S, B, ("add", f"e{i}"))])
        expect[(f"k{i}", C, B)] = i + 1
        expect[(f"s{i}", S, B)] = [f"e{i}"]
    return expect


def _key_on(member, tag):
    for i in range(10_000):
        k = f"{tag}{i}"
        if key_to_shard(k, B, KW["n_shards"]) in member.shards:
            return k
    raise AssertionError


# ---------------------------------------------------------------------------
# the three resize cases, on each package
# ---------------------------------------------------------------------------
def case_grow_then_shrink(pkg, tmp):
    out = []
    old = [str(tmp / f"m{i}") for i in range(2)]
    ms = _dc(pkg, old)
    expect = _populate(pkg, ms)
    _shutdown(ms)
    new = [str(tmp / f"n{i}") for i in range(3)]
    pkg.resize(old, new, dc_id=0)
    ms = _dc(pkg, new, recover=True)
    try:
        vals, _ = pkg.Node(ms[1]).read_objects(list(expect))
        out.append(_sorted(vals))
        vc = pkg.Node(ms[1]).update_objects([("k0", C, B,
                                              ("increment", 100))])
        out.append([int(x) for x in vc])
        out.append(pkg.Node(ms[0]).read_objects([("k0", C, B)])[0])
        expect[("k0", C, B)] = 101
    finally:
        _shutdown(ms)
    solo = [str(tmp / "solo")]
    pkg.resize(new, solo, dc_id=0)
    (m,) = _dc(pkg, solo, recover=True)
    try:
        c = pkg.Node(m)
        out.append(_sorted(c.read_objects(list(expect))[0]))
        c.update_objects([("k1", C, B, ("increment", 1))])
        out.append(c.read_objects([("k1", C, B)])[0])
    finally:
        m.close()
    return out


def case_torn_commit_survives(pkg, tmp):
    old = [str(tmp / f"m{i}") for i in range(2)]
    m0, m1 = _dc(pkg, old)
    c1 = pkg.Node(m1)
    k1 = _key_on(m1, "t")
    m1.invalidate_seq_cache()
    txn = c1.start_transaction()
    c1._update([(k1, C, B, ("increment", 77))], txn)
    snap = int(txn.snapshot_vc[0])
    m1.m_prepare(txn.txid, [pkg.wire(e) for e in txn.writeset], snap)
    shard = key_to_shard(k1, B, KW["n_shards"])
    ts, prev = c1._seq([shard], txn.txid)
    # the torn window: a durable commit record, no store apply
    m1._prep_append({"ev": "commit", "txid": int(txn.txid),
                     "vc": [int(ts), 0, 0],
                     "prev": {int(k): int(v) for k, v in prev.items()}})
    _shutdown([m0, m1])
    new = [str(tmp / "n0")]
    pkg.resize(old, new, dc_id=0)
    (m,) = _dc(pkg, new, recover=True)
    try:
        c = pkg.Node(m)
        out = [c.read_objects([(k1, C, B)])[0]]
        c.update_objects([(k1, C, B, ("increment", 1))])
        out.append(c.read_objects([(k1, C, B)])[0])
    finally:
        m.close()
    return out


def case_retires_old_dirs(pkg, tmp):
    kw = dict(max_dcs=2, snap_versions=2)
    old = [str(tmp / "o0")]
    (m0,) = _dc(pkg, old, **kw)
    pkg.Node(m0).update_objects([("k", C, B, ("increment", 3))])
    _shutdown([m0])
    new = [str(tmp / "n0"), str(tmp / "n1")]
    pkg.resize(old, new, dc_id=0)
    out = [pkg.dir_meta(new[0])["layout_epoch"],
           pkg.dir_meta(old[0])["retired_by_layout_epoch"]]
    with pytest.raises(pkg.DirMismatch, match="retired"):
        pkg.member(0, 1, old[0], recover=True, **kw)
    ms = _dc(pkg, new, recover=True, **kw)
    try:
        out.append(pkg.Node(ms[0]).read_objects([("k", C, B)])[0])
    finally:
        for m in ms:
            m.close()
    return out


CASES = [case_grow_then_shrink, case_torn_commit_survives,
         case_retires_old_dirs]
WANT = {"grow_then_shrink": None,
        "torn_commit_survives": [[77], [78]],
        "retires_old_dirs": [1, 1, [3]]}


@pytest.mark.parametrize("pkg", [_Jax, _Port], ids=["jax", "port"])
@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_resize_case(case, pkg, tmp_path):
    got = case(pkg, tmp_path)
    want = WANT[case.__name__[5:]]
    if want is not None:
        assert got == want
    else:
        expect = [i + 1 for i in range(12)]
        vals = got[0]
        assert vals[0::2] == expect
        assert vals[1::2] == [[f"e{i}"] for i in range(12)]
        assert got[2] == [101]
        assert got[3][0] == 101 and got[3][1:] == vals[1:]
        assert got[4] == [3]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_resize_case_matches_jax(case, tmp_path):
    assert (case(_Port, tmp_path / "port")
            == case(_Jax, tmp_path / "jax"))


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------
def test_jax_dirs_resized_by_port_read_back_equal(tmp_path):
    """A JAX 2-member DC's directories, resized 2 -> 3 by the JAX tool and
    by the port's: port members on the port's result, JAX members on a
    copy of it and JAX members on the JAX result all read the same
    values, and commit on."""
    old = [str(tmp_path / f"m{i}") for i in range(2)]
    ms = _dc(_Jax, old)
    expect = _populate(_Jax, ms, n=16)
    c = _Jax.Node(ms[0])
    c.update_objects([("s3", S, B, ("remove", "e3"))])
    expect[("s3", S, B)] = []
    _shutdown(ms)
    jax_old = [str(tmp_path / f"jm{i}") for i in range(2)]
    for a, b in zip(old, jax_old):
        shutil.copytree(a, b)
    jax_new = [str(tmp_path / f"jn{i}") for i in range(3)]
    jax_resize(jax_old, jax_new, dc_id=0)
    port_new = [str(tmp_path / f"pn{i}") for i in range(3)]
    resize_dc(old, port_new, dc_id=0, device="cpu")
    port_copy = [str(tmp_path / f"pc{i}") for i in range(3)]
    for a, b in zip(port_new, port_copy):
        shutil.copytree(a, b)
    got = {}
    for name, pkg, dirs in (("jax", _Jax, jax_new), ("port", _Port, port_new),
                            ("jax_on_port", _Jax, port_copy)):
        ms = _dc(pkg, dirs, recover=True)
        try:
            vals, _ = pkg.Node(ms[2]).read_objects(list(expect))
            vc = pkg.Node(ms[1]).update_objects([("k2", C, B,
                                                  ("increment", 5))])
            after = pkg.Node(ms[0]).read_objects([("k2", C, B)],
                                                 clock=vc)[0]
            got[name] = [_sorted(vals), [int(x) for x in vc], after]
        finally:
            for m in ms:
                m.close()
    assert got["port"] == got["jax"]
    assert got["jax_on_port"] == got["jax"]
    assert got["port"][0] == _sorted(list(expect.values()))
    assert got["port"][2] == [3 + 5]


def test_resize_refuses_undecided_prepare(tmp_path):
    """The quiescence gate: a staged-but-undecided txn in any old
    directory refuses the resize (exit 2 from the CLI), and nothing is
    written to the new directories."""
    old = [str(tmp_path / f"m{i}") for i in range(2)]
    m0, m1 = _dc(_Port, old)
    c1 = ClusterNode(m1)
    txn = c1.start_transaction()
    c1._update([("w", C, B, ("increment", 1))], txn)
    owner = m0 if key_to_shard("w", B, KW["n_shards"]) in m0.shards else m1
    owner.m_prepare(txn.txid, [eff_to_wire(e) for e in txn.writeset],
                    int(txn.snapshot_vc[0]))
    _shutdown([m0, m1])
    new = [str(tmp_path / "n0")]
    with pytest.raises(RuntimeError, match="undecided"):
        resize_dc(old, new, device="cpu")
    assert resize_main(["--old-dirs", ",".join(old), "--new-dirs", new[0],
                        "--device", "cpu"]) == 2
    assert not (tmp_path / "n0").exists()


def test_resize_after_checkpoint_keeps_values(tmp_path):
    """Members that published checkpoints hold only their WAL tails above
    the images; the resize gives each new directory a full image, so
    every value (below and above the images) survives."""
    old = [str(tmp_path / f"m{i}") for i in range(2)]
    ms = _dc(_Port, old)
    expect = _populate(_Port, ms, n=10)
    for m in ms:
        manifest = m.coordinator().checkpoint_now()
        assert manifest["id"] == 1
    c = ClusterNode(ms[0])
    c.update_objects([("k1", C, B, ("increment", 40)),
                      ("tail", S, B, ("add", "t"))])
    expect[("k1", C, B)] += 40
    expect[("tail", S, B)] = ["t"]
    _shutdown(ms)
    new = [str(tmp_path / f"n{i}") for i in range(3)]
    parts = resize_dc(old, new, device="cpu")
    assert set(parts) == {"recover", "export", "import", "seal"}
    ms = _dc(_Port, new, recover=True)
    try:
        vals, _ = ClusterNode(ms[2]).read_objects(list(expect))
        assert _sorted(vals) == _sorted(list(expect.values()))
    finally:
        for m in ms:
            m.close()


def test_resize_of_checkpointed_members_fits_in_two_generations(tmp_path):
    """The new directories' images rotate each new node onto a second
    generation of WAL files, so the resize closes the old members before
    them: the open files stay within one log a member of either layout
    plus one generation a new member (4 -> 3 at 64 shards under a limit
    a resize that kept the old logs open through the images overran),
    and every value survives."""
    import os
    import resource

    kw = dict(n_shards=64)
    old = [str(tmp_path / f"m{i}") for i in range(4)]
    ms = _dc(_Port, old, **kw)
    expect = _populate(_Port, ms, n=10)
    for m in ms:
        m.coordinator().checkpoint_now()
    _shutdown(ms)
    new = [str(tmp_path / f"n{i}") for i in range(3)]
    fds = [int(f) for f in os.listdir("/proc/self/fd")]
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    # one file a shard for each of the 7 logs, and 64 to spare; keeping
    # the old logs open through the images needs 64 x (4 + 2 x 3)
    limit = max(max(fds) + 1, len(fds) + 64 * 7 + 64)
    resource.setrlimit(resource.RLIMIT_NOFILE, (min(limit, hard), hard))
    try:
        resize_dc(old, new, cfg=AntidoteConfig(**{**KW, **kw}),
                  device="cpu")
    finally:
        resource.setrlimit(resource.RLIMIT_NOFILE, (soft, hard))
    ms = _dc(_Port, new, recover=True, **kw)
    try:
        vals, _ = ClusterNode(ms[0]).read_objects(list(expect))
        assert _sorted(vals) == _sorted(list(expect.values()))
    finally:
        for m in ms:
            m.close()
