"""Where the CPU goes in ``chip_smoke.py``'s takeover phase and its live
segment: each thread's CPU seconds (``/proc/self/task``) by thread kind,
and the calls, thread-CPU seconds and wall seconds (inclusive) of the
endpoints', the follower's, the members' and the checkpointer's methods,
each split by the segment's part (join, attach, leave, check).  Writes
``chiprun_out/prof/profile.txt`` and ``result.json``.

    python3 live_profile.py          # on the card, at the phase's size
    PN_SHARDS=256 PN_CTR=256 PN_SET=3000 python3 live_profile.py cpu

Only the methods of this process are timed: a follower that runs in a
process of its own is seen through its effect on the members."""
import collections
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.getcwd())
import torch
import chip_smoke

part = ["pre"]
cpu = collections.defaultdict(collections.Counter)     # part -> thread-kind -> ticks
TICK = os.sysconf("SC_CLK_TCK")

def ticks(tid):
    try:
        with open(f"/proc/self/task/{tid}/stat") as f:
            s = f.read()
        fs = s[s.rindex(")") + 2:].split()
        return int(fs[11]) + int(fs[12])
    except OSError:
        return None

def kind(name):
    return name.split(" (")[-1].rstrip(")").rstrip("0123456789-_")

acc = collections.defaultdict(lambda: collections.defaultdict(lambda: [0, 0.0, 0.0]))
tls = threading.local()
def wrap(cls, name):
    fn = cls.__dict__.get(name)
    if fn is None:
        return
    def w(self, *a, **k):
        depth = getattr(tls, "d", None)
        if depth is None:
            depth = tls.d = set()
        key = f"{type(self).__name__}.{name}"
        if key in depth:
            return fn(self, *a, **k)
        depth.add(key)
        c0, w0 = time.thread_time(), time.perf_counter()
        try:
            return fn(self, *a, **k)
        finally:
            depth.discard(key)
            e = acc[part[0]][key]
            e[0] += 1; e[1] += time.thread_time() - c0; e[2] += time.perf_counter() - w0
    setattr(cls, name, w)
from antidote_tpu_torch.interdc.replica import DCReplica
from antidote_tpu_torch.interdc.follower import FollowerReplica
from antidote_tpu_torch.interdc.tcp import TcpFabric
from antidote_tpu_torch.cluster.member import ClusterMember
from antidote_tpu_torch.cluster.coordinator import ClusterNode as Coordinator
from antidote_tpu_torch.log.checkpoint import Checkpointer
for cls in (DCReplica, FollowerReplica):
    for n in list(cls.__dict__):
        if callable(cls.__dict__[n]) and not n.startswith("__") and not isinstance(cls.__dict__[n], (staticmethod, classmethod)):
            wrap(cls, n)
for n in ("pump", "_rpc", "publish", "query_log", "request", "_reader_loop", "_flush"):
    wrap(TcpFabric, n)
for n in list(ClusterMember.__dict__):
    if (n.startswith("m_") or n in ("advance_idle_shards", "_apply_now", "_chain_apply", "refresh_peer_clocks", "clock_matrix", "seq_ts")) and callable(ClusterMember.__dict__[n]):
        wrap(ClusterMember, n)
for n in ("commit_transaction", "start_transaction", "read_objects", "update_objects", "_seq", "_snapshot"):
    wrap(Coordinator, n)
for n in ("seal", "checkpoint_now"):
    wrap(Checkpointer, n)

from antidote_tpu_torch.store.kv import KVStore
for n in ("apply_effects", "apply_effect_groups"):
    wrap(KVStore, n)
from antidote_tpu_torch.api.node import AntidoteNode
for n in ("seal_import", "install_handoff", "read_objects"):
    wrap(AntidoteNode, n)

tcpu = {}
def thread_cpu():
    out = {}
    for t in threading.enumerate():
        if t.native_id is None:
            continue
        c = ticks(t.native_id)
        if c is not None:
            out[(t.native_id, t.name)] = c
    return out
def boundary(new):
    now = thread_cpu()
    p = part[0]
    for k, c in now.items():
        cpu[p][kind(k[1])] += c - tcpu.get(k, 0 if p != "pre" else c)
    tcpu.clear(); tcpu.update(now)
    part[0] = new
import antidote_tpu_torch.cluster.join as J
pj, pl = J.live_join, J.live_leave
def lj(*a, **k):
    boundary("join")
    try:
        return pj(*a, **k)
    finally:
        boundary("attach")
def ll(*a, **k):
    boundary("leave")
    try:
        return pl(*a, **k)
    finally:
        boundary("check")
J.live_join, J.live_leave = lj, ll
t0 = time.perf_counter()
if len(sys.argv) < 2:
    from antidote_tpu_torch.materializer import cuda_kernels as ck
    from antidote_tpu_torch import native_build
    for src, stem, _g in native_build.MODULES:
        native_build.ensure(src, stem)
    ck.build()
dev = torch.device(sys.argv[1]) if len(sys.argv) > 1 else torch.device("cuda", 0)
res = chip_smoke.takeover_phase(torch, dev, n_set=int(os.environ.get("PN_SET", 12500)), n_ctr=int(os.environ.get("PN_CTR", 2048)), n_shards=int(os.environ.get("PN_SHARDS", 2048)))
boundary("end")
live = res["live"]
out = {"seconds": time.perf_counter() - t0,
       "live": {k: live.get(k) for k in ("join_s", "leave_s", "seconds", "move_ms", "seal_ms", "move_rpc_ms", "retries", "acked_during_moves")},
       "follower": live["follower"]}
os.makedirs("chiprun_out/prof", exist_ok=True)
with open("chiprun_out/prof/result.json", "w") as f:
    json.dump(out, f, default=str, indent=1)
with open("chiprun_out/prof/profile.txt", "w") as f:
    for p in ("join", "attach", "leave", "check"):
        f.write(f"=== {p}: cpu seconds by thread kind\n")
        for k, v in cpu[p].most_common(30):
            f.write(f"{v / TICK:9.2f} {k}\n")
        f.write(f"=== {p}: calls, thread cpu s, wall s (inclusive)\n")
        for k, (n, c, w) in sorted(acc[p].items(), key=lambda kv: -kv[1][1])[:70]:
            f.write(f"{n:8d} {c:9.3f} {w:9.3f} {k}\n")
print(json.dumps({k: out["live"][k] for k in ("join_s", "leave_s", "seconds")}))
