"""The port's cluster members as OS processes over real sockets.

``python -m antidote_tpu_torch.cluster.boot --device cpu`` processes in the
JAX suite's topology (``tests/test_cluster_processes.py``: a 2-member DC0
and two single-member DCs): replication across the four processes, a
causal chain through three DCs, atomic visibility of a transaction spanning
both DC0 members, and concurrent writers on both members converging.  Then
the crash story: a coordinator member killed by its failpoint (exit 137)
after the first owner's commit, the survivor's takeover completing the
commit, the member rejoining from its logs with ``--recover`` and
converging; and a kill between sequencing and the fan-out, which the
survivor's takeover aborts.  The operator console's cluster commands
(``ringready``, ``cluster-status``, ``cluster-resolve``, ``cluster-sweep``)
run against the processes, and ``cluster-join``/``cluster-leave`` move
shards to a ``--joining`` process and off a leaving one.  Last, the
whole story with a remote DC watching (``kill9_story``, which the card
test runs with ``--device cuda``): DC1 reads the completed transaction
whole from the rejoined member's clock.  Every spawn, ``readline`` and
wait runs under a deadline."""

import json
import os
import select
import subprocess
import sys
import time

import pytest

from antidote_tpu_torch import console
from antidote_tpu_torch.cluster.rpc import RpcClient
from antidote_tpu_torch.proto.client import AntidoteClient, RemoteAbort

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOPOLOGY = [(0, 0, 2), (0, 1, 2), (1, 0, 1), (2, 0, 1)]
#: seconds a member process may take to print its ports line
BOOT_S = 120.0


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _spawn(dc, member, members, log_dir=None, recover=False, shards=4,
           max_dcs=3, extra=(), device="cpu"):
    cmd = [sys.executable, "-m", "antidote_tpu_torch.cluster.boot",
           "--dc-id", str(dc), "--member", str(member),
           "--members", str(members), "--shards", str(shards),
           "--max-dcs", str(max_dcs), "--device", device, *extra]
    if log_dir is not None:
        cmd += ["--log-dir", str(log_dir)]
    if recover:
        cmd.append("--recover")
    return subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, cwd=REPO)


def _announce(p, timeout=BOOT_S) -> dict:
    """The process's ports line, read under a deadline."""
    ready, _, _ = select.select([p.stdout], [], [], timeout)
    assert ready, "member process did not announce within the deadline"
    line = p.stdout.readline().decode()
    assert line, f"member process died before announcing (rc {p.poll()})"
    return json.loads(line)


def _stop(ps):
    for p in ps:
        if p.poll() is None:
            p.terminate()
    for p in ps:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)


def _wire(topology, infos, members_by_dc):
    remotes = {i["fabric_id"]: i["fabric"] for i in infos}
    for (dc, _m, _n), info in zip(topology, infos):
        peers = {m: i["rpc"] for (d2, m, _), i in zip(topology, infos)
                 if d2 == dc}
        ctl = RpcClient(*info["rpc"])
        try:
            assert ctl.call("ctl_wire", peers, remotes, members_by_dc)
        finally:
            ctl.close()


def _client(info):
    return AntidoteClient(*info["client"])


def _read_at(client, objects, clock, deadline_s=30.0):
    """A clock-pinned read, retried until replication delivers the clock
    (or the deadline passes)."""
    end = time.monotonic() + deadline_s
    while True:
        try:
            return client.read_objects(objects, clock=clock)
        except Exception:  # noqa: BLE001 — retried until the deadline
            if time.monotonic() > end:
                raise
            time.sleep(0.05)


@pytest.fixture(scope="module")
def procs():
    spawned = [_spawn(dc, m, n) for dc, m, n in TOPOLOGY]
    try:
        infos = [_announce(p) for p in spawned]
        _wire(TOPOLOGY, infos, {0: 2, 1: 1, 2: 1})
        yield infos
    finally:
        _stop(spawned)


def test_replication_across_four_processes(procs):
    n1, n2, dc1, dc2 = procs
    c1 = _client(n1)
    # int key k -> shard k % 4; member 0 owns {0, 2}, member 1 {1, 3}
    vc = c1.update_objects([(0, "counter_pn", "b", ("increment", 11)),
                            (1, "set_aw", "b", ("add", "spread"))])
    for info in (dc1, dc2, n2):
        c = _client(info)
        vals, _ = _read_at(c, [(0, "counter_pn", "b"), (1, "set_aw", "b")],
                           vc)
        assert vals == [11, ["spread"]]
        c.close()
    c1.close()


def test_causality_chain_across_dcs(procs):
    n1, n2, dc1, dc2 = procs
    c2 = _client(n2)
    vcx = c2.update_objects([("x", "counter_pn", "cb", ("increment", 1))])
    c_dc1 = _client(dc1)
    vals, vc_read = _read_at(c_dc1, [("x", "counter_pn", "cb")], vcx)
    assert vals == [1]
    vcy = c_dc1.update_objects([("y", "counter_pn", "cb", ("increment", 2))],
                               clock=vc_read)
    c_dc2 = _client(dc2)
    vals, _ = _read_at(c_dc2, [("y", "counter_pn", "cb"),
                               ("x", "counter_pn", "cb")], vcy)
    assert vals == [2, 1], "causality violated: y visible without x"
    c2.close(), c_dc1.close(), c_dc2.close()


def test_atomic_multi_member_txn_visibility(procs):
    n1, n2, dc1, _ = procs
    c1 = _client(n1)
    txn = c1.start_transaction()
    txn.update_objects([(4, "counter_pn", "ab", ("increment", 1)),
                        (5, "counter_pn", "ab", ("increment", 1))])
    vc = txn.commit()
    c_dc1 = _client(dc1)
    objs = [(4, "counter_pn", "ab"), (5, "counter_pn", "ab")]
    vals, _ = _read_at(c_dc1, objs, vc)
    assert vals == [1, 1]
    for _ in range(10):
        vals, _ = c_dc1.read_objects(objs)
        assert vals in ([0, 0], [1, 1]), f"partial txn visible: {vals}"
    c1.close(), c_dc1.close()


def _update_retrying(client, updates, deadline_s=30.0):
    """Certification aborts are first-committer-wins doing its job:
    clients retry."""
    end = time.monotonic() + deadline_s
    while True:
        try:
            return client.update_objects(updates)
        except RemoteAbort:
            if time.monotonic() > end:
                raise
            time.sleep(0.02)


def test_concurrent_writes_from_both_members_converge(procs):
    n1, n2, _, _ = procs
    c1, c2 = _client(n1), _client(n2)
    vc1 = _update_retrying(c1, [("cs", "set_aw", "vb", ("add", "from-n1"))])
    vc2 = _update_retrying(c2, [("cs", "set_aw", "vb", ("add", "from-n2"))])
    top = [max(a, b) for a, b in zip(vc1, vc2)]
    for info in procs:
        c = _client(info)
        vals, _ = _read_at(c, [("cs", "set_aw", "vb")], top)
        assert sorted(vals[0]) == ["from-n1", "from-n2"]
        c.close()
    c1.close(), c2.close()


def _rpc_spec(info) -> str:
    return f"{info['rpc'][0]}:{info['rpc'][1]}"


def test_console_cluster_commands(procs, capsys):
    n1, n2, _, _ = procs
    assert console.main(["ringready", "--rpc", _rpc_spec(n1)]) == 0
    assert json.loads(capsys.readouterr().out) == {"local": True,
                                                   "member1": True}
    assert console.main(["cluster-status", "--rpc", _rpc_spec(n2)]) == 0
    st = json.loads(capsys.readouterr().out)
    assert st["member"] == 1 and st["owned_shards"] == [1, 3]
    assert st["ready"] == {"local": True, "member0": True}
    assert console.main(["cluster-resolve", "--rpc", _rpc_spec(n2)]) == 0
    assert json.loads(capsys.readouterr().out) == {"resolved": 0}
    assert console.main(["cluster-sweep", "--rpc", _rpc_spec(n1),
                         "--grace", "0"]) == 0
    assert json.loads(capsys.readouterr().out) == {"swept": 0}


def test_joining_member_process_announces_owning_nothing(procs):
    """``cluster.boot --joining`` boots a member owning no shard: its ports
    line, then its status over the control RPC."""
    p = _spawn(0, 2, 3, extra=("--joining",))
    try:
        info = _announce(p)
        assert set(info) == {"rpc", "client", "fabric", "fabric_id"}
        assert info["fabric_id"] == (2 << 16) | 0
        ctl = RpcClient(*info["rpc"])
        try:
            st = ctl.call("ctl_status")
        finally:
            ctl.close()
        assert st["member"] == 2 and st["owned_shards"] == []
        assert st["members"] == 3
    finally:
        _stop([p])


def test_membership_commands_move_shards_between_processes(tmp_path,
                                                           capsys):
    """The console's ``cluster-join`` streams shards to a ``--joining``
    process and ``cluster-leave`` drains a member out, each printing the
    JAX console's line (the moves the JAX planner makes); the values stay
    exact and the sequencer may not leave."""
    from antidote_tpu.cluster.join import plan_join_moves, plan_leave_moves

    spawned, infos = _spawn_duo(tmp_path)
    try:
        p = _spawn(0, 2, 3, log_dir=tmp_path / "m2", max_dcs=2,
                   extra=("--joining",))
        spawned.append(p)
        infos.append(_announce(p))
        trio = DUO + [(0, 2, 3)]
        _wire(trio, infos, {0: 3})
        c0 = _client(infos[0])
        objs = [(k, "counter_pn", "b") for k in range(8)]
        c0.update_objects([(k, "counter_pn", "b", ("increment", k + 1))
                           for k in range(8)])
        spec = ",".join(f"{m}={_rpc_spec(i)}"
                        for (_d, m, _n), i in zip(trio, infos))
        capsys.readouterr()
        assert console.main(["cluster-join", "--rpcs", spec,
                             "--joiner", "2"]) == 0
        moves = plan_join_moves({s: s % 2 for s in range(4)}, 2)
        assert json.loads(capsys.readouterr().out) == {
            "joined": 2, "moved": len(moves)}
        after = {s: s % 2 for s in range(4)}
        for s, _src, dst in moves:
            after[s] = dst
        ctl = RpcClient(*infos[2]["rpc"])
        try:
            assert ctl.call("ctl_status")["owned_shards"] == sorted(
                s for s, o in after.items() if o == 2)
        finally:
            ctl.close()
        with pytest.raises(ValueError, match="sequencer"):
            console.main(["cluster-leave", "--rpcs", spec, "--leaver", "0"])
        capsys.readouterr()
        assert console.main(["cluster-leave", "--rpcs", spec,
                             "--leaver", "1"]) == 0
        assert json.loads(capsys.readouterr().out) == {
            "left": 1, "moved": len(plan_leave_moves(after, 1))}
        spawned[1].kill()
        spawned[1].wait(timeout=30)
        c0.update_objects([(1, "counter_pn", "b", ("increment", 10))])
        c2 = _client(infos[2])
        for c in (c0, c2):
            vals, _ = c.read_objects(objs)
            assert vals == [k + 1 + (10 if k == 1 else 0) for k in range(8)]
        c0.close(), c2.close()
    finally:
        _stop(spawned)


# ---------------------------------------------------------------------------
# coordinator-crash takeover + rejoin across processes
# ---------------------------------------------------------------------------
DUO = [(0, 0, 2), (0, 1, 2)]


def _spawn_duo(tmp_path):
    spawned = [_spawn(0, m, 2, log_dir=tmp_path / f"m{m}", max_dcs=2)
               for m in (0, 1)]
    try:
        infos = [_announce(p) for p in spawned]
        _wire(DUO, infos, {0: 2})
    except BaseException:
        _stop(spawned)
        raise
    return spawned, infos


def test_kill9_mid_commit_fanout_then_takeover_and_rejoin(tmp_path):
    spawned, infos = _spawn_duo(tmp_path)
    try:
        ctl1 = RpcClient(*infos[1]["rpc"])
        assert ctl1.call("ctl_failpoint", "after_first_commit")
        c1 = _client(infos[1])
        # key 0 on member 0's shard (first in the fan-out), key 1 on
        # member 1's (never gets the commit)
        with pytest.raises(Exception):
            c1.update_objects([(0, "counter_pn", "b", ("increment", 7)),
                               (1, "counter_pn", "b", ("increment", 7))])
        assert spawned[1].wait(timeout=60) == 137
        ctl0 = RpcClient(*infos[0]["rpc"])
        ctl0.call("ctl_resolve", 0.0)
        c0 = _client(infos[0])
        vals, _ = c0.read_objects([(0, "counter_pn", "b")])
        assert vals == [7]
        p1b = _spawn(0, 1, 2, log_dir=tmp_path / "m1", recover=True,
                     max_dcs=2)
        spawned[1] = p1b
        infos[1] = _announce(p1b)
        _wire(DUO, infos, {0: 2})
        ctl1b = RpcClient(*infos[1]["rpc"])
        assert ctl1b.call("ctl_resolve", 0.0) >= 1
        c1b = _client(infos[1])
        vals, _ = c1b.read_objects([(0, "counter_pn", "b"),
                                    (1, "counter_pn", "b")])
        assert vals == [7, 7], "the rejoined member must converge"
        c1b.update_objects([(1, "counter_pn", "b", ("increment", 1))])
        vals, _ = c0.read_objects([(1, "counter_pn", "b")])
        assert vals == [8]
        for c in (c0, c1b):
            c.close()
        for ctl in (ctl0, ctl1, ctl1b):
            ctl.close()
    finally:
        _stop(spawned)


def test_kill9_after_seq_wedge_aborted_by_survivor(tmp_path):
    spawned, infos = _spawn_duo(tmp_path)
    try:
        ctl1 = RpcClient(*infos[1]["rpc"])
        assert ctl1.call("ctl_failpoint", "after_seq")
        c1 = _client(infos[1])
        with pytest.raises(Exception):
            c1.update_objects([(0, "counter_pn", "b", ("increment", 100))])
        assert spawned[1].wait(timeout=60) == 137
        ctl0 = RpcClient(*infos[0]["rpc"])
        assert ctl0.call("ctl_resolve", 0.0) >= 1
        c0 = _client(infos[0])
        c0.update_objects([(0, "counter_pn", "b", ("increment", 1))])
        vals, _ = c0.read_objects([(0, "counter_pn", "b")])
        assert vals == [1]
        c0.close(), ctl0.close(), ctl1.close()
    finally:
        _stop(spawned)


# ---------------------------------------------------------------------------
# the whole crash story with a remote DC watching (the card test runs it
# with --device cuda)
# ---------------------------------------------------------------------------
STORY = [(0, 0, 2), (0, 1, 2), (1, 0, 1)]


def kill9_story(device: str, tmp_path) -> None:
    """A 2-member DC0 and a 1-member DC1 as member processes on
    ``device``, every member with a log directory.  Member 1 coordinates a
    transaction over both DC0 members and dies (exit 137) after the first
    owner's commit; the survivor's takeover completes it; member 1 rejoins
    with ``--recover``; DC1 reads the transaction whole at the rejoined
    member's clock; then an ``after_seq`` kill on the rejoined member is
    aborted by the survivor, and the DC takes writes again."""
    spawned = [_spawn(dc, m, n, log_dir=tmp_path / f"d{dc}m{m}", max_dcs=2,
                      device=device)
               for dc, m, n in STORY]
    clients = []
    try:
        infos = [_announce(p, 900) for p in spawned]
        _wire(STORY, infos, {0: 2, 1: 1})
        ctl1 = RpcClient(*infos[1]["rpc"])
        assert ctl1.call("ctl_failpoint", "after_first_commit")
        c1 = _client(infos[1])
        clients.append(c1)
        with pytest.raises(Exception):
            c1.update_objects([(0, "counter_pn", "b", ("increment", 7)),
                               (1, "counter_pn", "b", ("increment", 7))])
        assert spawned[1].wait(timeout=120) == 137
        ctl1.close()
        ctl0 = RpcClient(*infos[0]["rpc"])
        ctl0.call("ctl_resolve", 0.0)
        c0 = _client(infos[0])
        clients.append(c0)
        assert c0.read_objects([(0, "counter_pn", "b")])[0] == [7]
        spawned[1] = _spawn(0, 1, 2, log_dir=tmp_path / "d0m1",
                            recover=True, max_dcs=2, device=device)
        infos[1] = _announce(spawned[1], 900)
        _wire(STORY, infos, {0: 2, 1: 1})
        ctl1 = RpcClient(*infos[1]["rpc"])
        assert ctl1.call("ctl_resolve", 0.0) >= 1
        c1 = _client(infos[1])
        clients.append(c1)
        objs = [(0, "counter_pn", "b"), (1, "counter_pn", "b")]
        vals, vc = c1.read_objects(objs)
        assert vals == [7, 7], "the rejoined member must converge"
        dc1 = _client(infos[2])
        clients.append(dc1)
        vals, _ = _read_at(dc1, objs, vc, deadline_s=120.0)
        assert vals == [7, 7], "DC1 must read the transaction whole"
        # an after_seq kill of the rejoined coordinator: the survivor aborts
        assert ctl1.call("ctl_failpoint", "after_seq")
        with pytest.raises(Exception):
            c1.update_objects([(0, "counter_pn", "b", ("increment", 100))])
        assert spawned[1].wait(timeout=120) == 137
        ctl1.close()
        assert ctl0.call("ctl_resolve", 0.0) >= 1
        c0.update_objects([(0, "counter_pn", "b", ("increment", 1))])
        assert c0.read_objects([(0, "counter_pn", "b")])[0] == [8]
        ctl0.close()
    finally:
        for c in clients:
            c.close()
        _stop(spawned)


def test_kill9_story_with_a_remote_dc(tmp_path):
    kill9_story("cpu", tmp_path)
