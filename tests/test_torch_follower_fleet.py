"""A hash-routed fleet of port followers shadowing a clustered port owner
under fire: ``tests/test_chaos.py::
test_hashed_fleet_clustered_owner_sigkill_and_shard_move`` on the port.

Two ``ClusterMember``s (``device="cpu"``) with their inter-DC endpoints
and wire servers; four followers as ``python -m antidote_tpu_torch.console
serve --follower-of a,b`` processes, each under a seeded drop/delay plan
on its subscription streams (``ANTIDOTE_FAULT_PLAN``).  Every session read
through a ``SessionClient`` over the fleet must read its own writes while
one follower is SIGKILLed and a shard moves live between the members; the
killed follower rejoins from its own directory and the fleet's images and
converges digest-clean.  Every wait has its own deadline, so a hang fails
the test instead of eating the run's clock.  Tolerance: exact values.
"""

import json
import os
import select
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from antidote_tpu_torch.cluster import ClusterNode, attach_interdc
from antidote_tpu_torch.cluster.join import _move_shard
from antidote_tpu_torch.cluster.member import ClusterMember
from antidote_tpu_torch.cluster.rpc import RpcClient
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.interdc.tcp import TcpFabric
from antidote_tpu_torch.proto.client import (AntidoteClient, RemoteLagging,
                                             SessionClient)
from antidote_tpu_torch.proto.server import ProtocolServer

ROOT = Path(__file__).resolve().parent.parent


def _ready_line(proc, timeout):
    """The first stdout line of a serve child, parsed, within ``timeout``
    seconds (else the test fails)."""
    deadline = time.monotonic() + timeout
    while True:
        left = deadline - time.monotonic()
        if left <= 0 or proc.poll() is not None:
            pytest.fail(f"follower printed no ready line "
                        f"(rc {proc.poll()})")
        ready, _, _ = select.select([proc.stdout], [], [], min(left, 1.0))
        if ready:
            line = proc.stdout.readline()
            if line.strip():
                return json.loads(line)


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        pass


def test_hashed_fleet_clustered_owner_sigkill_and_shard_move(tmp_path):
    ccfg = AntidoteConfig(n_shards=4, max_dcs=2)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    # a seeded drop/delay storm on every follower's subscription streams:
    # chain gaps open all the time and heal through the per-member routed
    # catch-up
    env["ANTIDOTE_FAULT_PLAN"] = json.dumps({"seed": 16, "rules": [
        {"site": "interdc.deliver", "action": "drop", "p": 0.08,
         "times": 300},
        {"site": "interdc.deliver", "action": "delay", "p": 0.08,
         "times": 300},
    ]})
    fab = TcpFabric(backoff_base=0.05, backoff_max=0.5)
    ms = [ClusterMember(ccfg, dc_id=0, member_id=i, n_members=2,
                        log_dir=str(tmp_path / f"m{i}"), device="cpu")
          for i in range(2)]
    for a in ms:
        for b in ms:
            if a is not b:
                a.connect(b.member_id, *b.address)
    reps = [attach_interdc(m, fab) for m in ms]
    # one wire server a member (``interdc=``: it answers the member's
    # descriptor and replica registry); the console learns the fleet
    # endpoint by endpoint from these
    srvs = [ProtocolServer(ClusterNode(m), port=0, interdc=r)
            for m, r in zip(ms, reps)]
    owner_list = ",".join(f"{s.host}:{s.port}" for s in srvs)
    coord = ClusterNode(ms[0])
    stop = threading.Event()

    def pumper():
        while not stop.is_set():
            fab.pump(timeout=0.05)
            for m in ms:
                try:
                    m.refresh_peer_clocks()
                except (ConnectionError, OSError, RuntimeError):
                    pass

    pump_t = threading.Thread(target=pumper, daemon=True)
    pump_t.start()

    def spawn_follower(name):
        return subprocess.Popen(
            [sys.executable, "-m", "antidote_tpu_torch.console", "serve",
             "--device", "cpu", "--port", "0",
             "--log-dir", str(tmp_path / name),
             "--follower-of", owner_list, "--replica-name", name,
             "--follower-park-ms", "400", "--divergence-check-s", "0.5"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=open(str(tmp_path / (name + ".log")), "a"), text=True)

    procs = []
    sc = None
    try:
        keys = [f"k{i}" for i in range(8)]  # spread over all 4 shards
        totals = {k: 0 for k in keys}
        for _ in range(3):
            for k in keys:
                coord.update_objects([(k, "counter_pn", "b",
                                       ("increment", 1))])
                totals[k] += 1
        # one image a member: every follower composes the fleet's images
        for m in ms:
            m.node.checkpoint_now()
        followers = {f"f{i}": spawn_follower(f"f{i}") for i in range(4)}
        procs.extend(followers.values())
        infos = {}
        for name, p in followers.items():
            infos[name] = _ready_line(p, timeout=120)
            assert infos[name]["ready"] and infos[name]["role"] == "follower"
            assert infos[name]["bootstrap"] == "image"
            assert infos[name]["fleet"]["owner_members"] == 2
        sc = SessionClient((srvs[0].host, srvs[0].port),
                           [(infos[f"f{i}"]["host"], infos[f"f{i}"]["port"])
                            for i in range(4)], seed=1616)

        def session_round(r):
            k = keys[r % len(keys)]
            sc.update_objects([(k, "counter_pn", "b", ("increment", 1))])
            totals[k] += 1
            vals, _ = sc.read_objects([(k, "counter_pn", "b")])
            assert vals == [totals[k]], (k, vals, totals[k])

        # phase 1: the storm alone — read-your-writes on every read
        for r in range(8):
            session_round(r)
        # phase 2: a write burst, then SIGKILL f3 mid-storm — the ring
        # sheds only f3's arcs, sessions keep reading their writes
        for k in keys:
            for _ in range(3):
                coord.update_objects([(k, "counter_pn", "b",
                                       ("increment", 1))])
                totals[k] += 1
        f3 = followers["f3"]
        f3.send_signal(signal.SIGKILL)
        f3.wait(timeout=10)
        f3_addr = (infos["f3"]["host"], infos["f3"]["port"])
        served_dead_before = sc.served_by.get(f3_addr, 0)
        for r in range(8):
            session_round(r)
        assert sc.served_by.get(f3_addr, 0) == served_dead_before
        # phase 3: a live shard move between the members mid-storm — the
        # ownership gossip re-points every follower's catch-up with no
        # reconnect; sessions keep reading their writes through it
        moved = next(s for s in range(ccfg.n_shards) if s in ms[1].shards)
        clients = {m.member_id: RpcClient(*m.address) for m in ms}
        try:
            _move_shard(clients, moved, 1, 0, 2)
        finally:
            for c in clients.values():
                c.close()
        assert moved in ms[0].shards
        for r in range(12):
            session_round(r)
        # phase 4: f3 rejoins from its local state and the fleet's images
        # and converges digest-clean with the totals at the session token
        f3b = spawn_follower("f3")
        procs.append(f3b)
        i3b = _ready_line(f3b, timeout=120)
        assert i3b["ready"] and i3b["bootstrap"] in ("image", "delta",
                                                     "tail")
        fc = AntidoteClient(i3b["host"], i3b["port"], timeout=30)
        objs = [(k, "counter_pn", "b") for k in keys]
        token = sc.token
        deadline = time.monotonic() + 90
        while True:
            try:
                vals, _ = fc.read_objects(objs, clock=token)
            except RemoteLagging:
                vals = None
            if vals == [totals[k] for k in keys]:
                st = fc.node_status()["replicas"]
                if (st["state"] == "serving"
                        and st["divergence"].get("ok", 0) >= 1
                        and st["divergence"].get("mismatch", 0) == 0):
                    break
            assert time.monotonic() < deadline, (
                f"rejoined follower never converged digest-clean: "
                f"{vals} != {totals}")
            time.sleep(0.2)
        fc.close()
        # both members' registries see the fleet
        for r in reps:
            reg = r.replica_status()["followers"]
            for name in ("f0", "f1", "f2", "f3"):
                assert reg[name]["state"] in ("ok", "lagging"), reg
    finally:
        if sc is not None:
            sc.close()
        stop.set()
        pump_t.join(timeout=10)
        for p in procs:
            _stop(p)
        for s in srvs:
            s.close()
        for m in ms:
            m.close()
        fab.close()
