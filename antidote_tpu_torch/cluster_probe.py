"""Two measurements of the multi-member DC on one card.

    python3 -m antidote_tpu_torch.cluster_probe

Runs from the root of a checkout on a machine with a CUDA card.  The DC is
the one ``chip_smoke.py`` drives: 4 members in one process over localhost
RPC, ``AntidoteConfig(n_shards=2048, max_dcs=4, ops_per_key=16,
snap_versions=2, set_slots=16, keys_per_table=128)``, every member's tables
on the card, clock gossip every 0.1 s as a member process does.

1. **Grouped against per-shard apply.**  Populate transactions of 1024
   ``set_aw`` adds on fresh keys, in four blocks of ``AB_TXNS``: the
   member's chained apply as it is (the ready links of all shards of a
   commit as one grouped store append), then twice with one store append
   per shard (the JAX package's form), then grouped again.  Reports the
   mean ms per transaction of each block.
2. **The repo benchmark's traffic** (``bench_wire.py --cluster``, config
   ``set_aw_zipf_north_star``): after every one of 200,000 keys holds one
   element, 16 client threads (coordinators in turn) run clockless
   single-key static transactions for ``TRAFFIC_S`` seconds: 90% reads,
   else an add (80%) or a remove (20%) of a random element, keys
   Zipf(1.0).  Reports ops/s, per-class p50/p99, certification aborts,
   ``stable_min`` launches per op, the mean time per op in the start, in
   ``stable_vc`` and in each RPC method, and, over a further profiled
   window, the device's busy share.

Prints one JSON line; progress goes to stderr.
"""

from __future__ import annotations

import json
import sys
import threading
import time

import numpy as np

MEMBERS, SHARDS, KEYS, TXN = 4, 2048, 200_000, 1024
AB_TXNS = 16                        # populate txns per A/B block
WORKERS, TRAFFIC_S, PROFILE_S = 16, 10.0, 3.0
READ_FRACTION, ADD_SHARE = 0.9, 0.8
GOSSIP_S = 0.1
S, BK = "set_aw", "b"


def log(msg: str) -> None:
    print(f"[cluster_probe] {msg}", file=sys.stderr, flush=True)


def per_shard_apply(member, links) -> None:
    """The JAX package's chained apply: one store append per shard link."""
    for shard, ts, effs, vc in links:
        if effs:
            member.node.store.apply_effects(effs, [vc] * len(effs),
                                            [member.dc_id] * len(effs))
        member.applied_ts[shard] = ts


class Timers:
    """Per-name total seconds and counts, summed over threads."""

    def __init__(self):
        self.lock = threading.Lock()
        self.total: dict = {}

    def wrap(self, name, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                key = name(a) if callable(name) else name
                with self.lock:
                    s, n = self.total.get(key, (0.0, 0))
                    self.total[key] = (s + dt, n + 1)
        return timed


def make_cluster(dev, n_shards):
    from antidote_tpu_torch.cluster import ClusterMember
    from antidote_tpu_torch.config import AntidoteConfig

    cfg = AntidoteConfig(n_shards=n_shards, max_dcs=4, ops_per_key=16,
                         snap_versions=2, set_slots=16, keys_per_table=128)
    members = [ClusterMember(cfg, 0, i, MEMBERS, device=dev)
               for i in range(MEMBERS)]
    for m in members:
        for p in members:
            if p is not m:
                m.connect(p.member_id, *p.address)
    return members


def populate(coords, keys, rng, first) -> list:
    """One add per key in txns of TXN updates; ms per txn."""
    ms = []
    for j, lo in enumerate(range(0, len(keys), TXN)):
        ops = [(int(k), S, BK, ("add", int(e))) for k, e in
               zip(keys[lo:lo + TXN], rng.integers(0, 1000, TXN))]
        t0 = time.perf_counter()
        coords[(first + j) % MEMBERS].update_objects(ops)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def ab_apply(members, coords, rng, ab_txns) -> dict:
    """Blocks grouped, per-shard, per-shard, grouped on fresh keys."""
    out = {"grouped_ms_per_txn": [], "per_shard_ms_per_txn": []}
    block = ab_txns * TXN
    for b, mode in enumerate(("grouped", "per_shard", "per_shard",
                              "grouped")):
        for m in members:
            if mode == "per_shard":
                m._apply_now = per_shard_apply.__get__(m)
            else:
                m.__dict__.pop("_apply_now", None)
        keys = rng.permutation(np.arange(b * block, (b + 1) * block))
        ms = populate(coords, keys, rng, b)
        out[f"{mode}_ms_per_txn"].append(float(np.mean(ms)))
        log(f"A/B block {b} ({mode}): {np.mean(ms):.2f} ms per txn")
    for m in members:
        m.__dict__.pop("_apply_now", None)
    out["keys"] = 4 * block
    return out


def traffic(torch, members, coords, n_keys, seconds, profile_s) -> dict:
    """The repo benchmark's traffic; see the module docstring."""
    from antidote_tpu_torch.api import AbortError
    from antidote_tpu_torch.cluster.rpc import RpcClient
    from antidote_tpu_torch.materializer import cuda_kernels as ck

    w = 1.0 / np.arange(1, n_keys + 1)
    cdf = np.cumsum(w / w.sum())
    timers = Timers()
    call = RpcClient.call
    RpcClient.call = timers.wrap(lambda a: f"rpc:{a[1]}", call)
    for m in members:
        m.stable_vc = timers.wrap("stable_vc", m.stable_vc)
    for c in coords:
        c.start_transaction = timers.wrap("start", c.start_transaction)
    lat = {"read": [], "write": []}
    counts = {"aborts": 0, "errors": []}

    def drive(stop, record):
        def worker(i):
            rng = np.random.default_rng(100 + i)
            coord = coords[i % MEMBERS]
            while time.perf_counter() < stop:
                k = int(np.searchsorted(cdf, rng.random()))
                t0 = time.perf_counter()
                try:
                    if rng.random() < READ_FRACTION:
                        kind = "read"
                        coord.read_objects([(k, S, BK)])
                    else:
                        kind = "write"
                        op = "add" if rng.random() < ADD_SHARE else "remove"
                        coord.update_objects(
                            [(k, S, BK, (op, int(rng.integers(1 << 30))))])
                except AbortError:
                    counts["aborts"] += 1
                    continue
                except Exception as e:  # noqa: BLE001 — re-raised below
                    counts["errors"].append(repr(e))
                    return
                if record:
                    lat[kind].append((time.perf_counter() - t0) * 1e3)
        ts = [threading.Thread(target=worker, args=(i,))
              for i in range(WORKERS)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if counts["errors"]:
            raise RuntimeError(counts["errors"][0])

    try:
        ck.reset_launches()
        t0 = time.perf_counter()
        drive(t0 + seconds, True)
        wall = time.perf_counter() - t0
        launches = ck.LAUNCHES["stable_min"]
        tot = dict(timers.total)
        busy = None
        if torch.device(members[0].node.store.device).type == "cuda":
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            t1 = time.perf_counter()
            drive(t1 + profile_s, False)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t1
            prof.stop()
            dev_us = sum(e.self_device_time_total
                         for e in prof.key_averages()
                         if str(e.device_type).endswith("CUDA"))
            busy = {"wall_ms": pwall * 1e3, "device_ms": dev_us / 1e3,
                    "device_busy_share": dev_us / 1e6 / pwall}
    finally:
        RpcClient.call = call
    n_ops = len(lat["read"]) + len(lat["write"])
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else None  # noqa
    return {
        "workers": WORKERS, "seconds": wall, "ops": n_ops,
        "ops_per_s": n_ops / wall, "aborts": counts["aborts"],
        **{f"{k}_{q}_ms": pct(v, n) for k, v in lat.items()
           for q, n in (("p50", 50), ("p99", 99))},
        "all_p50_ms": pct(lat["read"] + lat["write"], 50),
        "all_p99_ms": pct(lat["read"] + lat["write"], 99),
        "stable_min_launches_per_op": launches / max(n_ops, 1),
        # mean ms per op spent in each wrapped call (calls nest: start
        # holds stable_vc and, at times, rpc:m_seq_counter)
        "ms_per_op": {k: s * 1e3 / max(n_ops, 1) for k, (s, n) in
                      sorted(tot.items())},
        "calls_per_op": {k: n / max(n_ops, 1) for k, (s, n) in
                         sorted(tot.items())},
        "profile": busy,
    }


def run(torch, dev, n_shards=SHARDS, n_keys=KEYS, ab_txns=AB_TXNS,
        seconds=TRAFFIC_S, profile_s=PROFILE_S) -> dict:
    members = make_cluster(dev, n_shards)
    stop = threading.Event()

    def gossip():
        while not stop.wait(GOSSIP_S):
            for m in members:
                m.refresh_peer_clocks()

    g = threading.Thread(target=gossip, daemon=True, name="clock-gossip")
    g.start()
    try:
        coords = [m.coordinator() for m in members]
        rng = np.random.default_rng(23)
        ab = ab_apply(members, coords, rng, ab_txns)
        t0 = time.perf_counter()
        populate(coords, np.arange(ab["keys"], n_keys), rng, 0)
        log(f"filled keys {ab['keys']}..{n_keys - 1} in "
            f"{time.perf_counter() - t0:.1f} s")
        tr = traffic(torch, members, coords, n_keys, seconds, profile_s)
        log(f"traffic: {tr['ops_per_s']:.1f} ops/s")
        return {"apply_ab": ab, "traffic": tr}
    finally:
        stop.set()
        g.join()
        for m in members:
            m.close()


def main() -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: this probe runs on the card only")
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    from antidote_tpu_torch.materializer import cuda_kernels as ck
    ck.build()  # outside the timed blocks: nvcc runs on a cold checkout
    res = run(torch, torch.device("cuda", 0))
    print(json.dumps({"card": card, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
