"""Geo-replication across live membership change, over the port's member
processes (the counterpart of ``tests/test_geo_membership.py``).

A 2-member DC0 and a 1-member DC1 (``python -m
antidote_tpu_torch.cluster.boot``) under cross-DC write load: DC0
live-joins a member through the console (``cluster-join``), then a MIDDLE
member live-leaves (``cluster-leave``) and its process is killed — a
publisher dies for good.  DC1 learns the joiner's endpoint only after the
moves, so the moved chains carry a gap that only the catch-up routed by the
gossiped (owner, epoch) stamps can heal (the boot-time modular router
points at the dead or relinquished owners).  Both DCs converge to the exact
acknowledged totals: no lost and no duplicated op.  ``geo_story`` runs the
same with ``--device cuda`` in ``tests/test_torch_cuda.py``."""

import threading
import time

import numpy as np

from antidote_tpu_torch import console
from antidote_tpu_torch.cluster.rpc import RpcClient
from antidote_tpu_torch.proto.client import AntidoteClient
from test_torch_cluster_processes import _announce, _spawn, _stop

N_KEYS = 16  # int key k -> shard k % 8
#: seconds the two DCs get to converge on the acknowledged totals
CONVERGE_S = 90.0


def _wire(info, peers, remotes, members_by_dc):
    ctl = RpcClient(*info["rpc"])
    try:
        assert ctl.call("ctl_wire", peers, remotes, members_by_dc)
    finally:
        ctl.close()


def _writer(info, seed, amount, acked, lock, stop, errs):
    rng = np.random.default_rng(seed)
    c = AntidoteClient(*info["client"])
    try:
        while not stop.is_set():
            k = int(rng.integers(N_KEYS))
            try:
                c.update_objects(
                    [(k, "counter_pn", "b", ("increment", amount))])
            except Exception as e:  # noqa: BLE001 — sorted below
                msg = str(e).lower()
                # certification conflicts and an exhausted move window are
                # both client-retryable non-acks: the coordinator aborted
                # every prepared leg before surfacing either
                if "abort" in msg or "unstable" in msg:
                    continue
                errs.append(repr(e))
                return
            with lock:
                acked[k] += amount
    finally:
        c.close()


def _status(info, what="ctl_status"):
    ctl = RpcClient(*info["rpc"])
    try:
        return ctl.call(what)
    finally:
        ctl.close()


def geo_story(device, tmp_path):
    """The join, leave and kill under cross-DC load; returns the last
    reads and the repl status of DC1."""
    spawned = []

    def boot(dc, member, members, joining=False):
        p = _spawn(dc, member, members, log_dir=tmp_path / f"d{dc}m{member}",
                   shards=8, max_dcs=2, device=device,
                   extra=("--joining",) if joining else ())
        spawned.append(p)
        return _announce(p)

    try:
        m0, m1, dc1 = boot(0, 0, 2), boot(0, 1, 2), boot(1, 0, 1)
        peers0 = {0: m0["rpc"], 1: m1["rpc"]}
        remotes = {i["fabric_id"]: i["fabric"] for i in (m0, m1, dc1)}
        for i in (m0, m1):
            _wire(i, peers0, remotes, {0: 2, 1: 1})
        _wire(dc1, {0: dc1["rpc"]}, remotes, {0: 2, 1: 1})

        acked = [0] * N_KEYS
        lock = threading.Lock()
        stop = threading.Event()
        errs = []
        ts = [threading.Thread(target=_writer,
                               args=(m0, 21, 1, acked, lock, stop, errs)),
              threading.Thread(target=_writer,
                               args=(dc1, 22, 2, acked, lock, stop, errs))]
        for t in ts:
            t.start()
        time.sleep(0.8)  # cross-DC load flowing both ways

        # live-join member 2 at DC0 through the console, under load; DC1
        # is not wired to the joiner yet, so what it publishes on its
        # moved chains is missed — the catch-up gap
        m2 = boot(0, 2, 3, joining=True)
        peers3 = {0: m0["rpc"], 1: m1["rpc"], 2: m2["rpc"]}
        remotes3 = dict(remotes)
        remotes3[m2["fabric_id"]] = m2["fabric"]
        for i in (m0, m1, m2):
            _wire(i, peers3, remotes3, {0: 3, 1: 1})
        spec = ",".join(f"{m}={i['rpc'][0]}:{i['rpc'][1]}"
                        for m, i in ((0, m0), (1, m1), (2, m2)))
        assert console.main(["cluster-join", "--rpcs", spec,
                             "--joiner", "2"]) == 0
        time.sleep(0.8)  # commits land on the joiner's chains, unseen

        # live-leave member 1 (a middle id) under the same load, then kill
        # its process: its chains moved to the survivors with their state
        assert console.main(["cluster-leave", "--rpcs", spec,
                             "--leaver", "1"]) == 0
        spawned[1].kill()
        assert spawned[1].wait(timeout=30) is not None

        # only now does DC1 learn the joiner's endpoint (new wiring, not a
        # reconnect); its modular router ({0: 3}) points moved chains at
        # the dead member or the old owners — only the gossiped stamps
        # land the catch-up on the real owners
        live = {i["fabric_id"]: i["fabric"] for i in (m0, m2, dc1)}
        _wire(dc1, {0: dc1["rpc"]}, live, {0: 3, 1: 1})

        time.sleep(0.8)  # load continues on the gapped cluster
        stop.set()
        for t in ts:
            t.join(timeout=60)
        assert not errs, errs
        with lock:
            want = list(acked)
        assert sum(want) > 0
        objs = [(k, "counter_pn", "b") for k in range(N_KEYS)]

        deadline = time.monotonic() + CONVERGE_S
        while True:
            reads = {}
            for name, info in (("dc1", dc1), ("m0", m0), ("m2", m2)):
                c = AntidoteClient(*info["client"])
                try:
                    reads[name] = c.read_objects(objs)[0]
                finally:
                    c.close()
            if all(v == want for v in reads.values()):
                break
            if time.monotonic() > deadline:
                # the chain positions and clocks say where an op was lost
                chains = {name: _status(info, "ctl_repl_status")
                          for name, info in (("dc1", dc1), ("m0", m0),
                                             ("m2", m2))}
                raise AssertionError(
                    f"DCs failed to converge: {reads} expected {want}; "
                    f"chain state {chains}")
            time.sleep(0.25)

        # the survivors cover every shard; the leaver's id stays a gap
        owned = (_status(m0)["owned_shards"] + _status(m2)["owned_shards"])
        assert sorted(owned) == list(range(8))
        return reads, _status(dc1, "ctl_repl_status")
    finally:
        _stop(spawned)


def test_join_leave_kill_publisher_catchup_reroutes(tmp_path):
    _reads, repl = geo_story("cpu", tmp_path)
    # DC1 learned where the moved DC0 chains live now: no route names the
    # departed member 1's fabric id
    routes = repl["shard_route"]
    assert routes
    for chain, (owner, epoch) in routes.items():
        shard = int(chain.split(":")[1])
        # no route names the departed member, and an owner other than the
        # boot layout's came with a move's epoch
        assert owner != 1
        assert epoch >= 1 or owner == shard % 2
