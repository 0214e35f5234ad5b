"""Offline DC membership resize: N member log-dirs -> M member log-dirs.

The reference changes membership live through riak_core's staged join and
leave with ownership handoff.  Here ownership at boot is the modular layout
(shard s owned by member s % n_members), so this tool is a RING-WIDE remap
performed OFFLINE on quiesced logs:

    python -m antidote_tpu_torch.cluster.resize \
        --old-dirs /data/m0,/data/m1 --new-dirs /data/n0,/data/n1,/data/n2

1. the prepare logs are checked for staged-but-undecided txns (resize
   refuses until takeover settles them — run ``console cluster-resolve`` /
   ``cluster-sweep`` on the live cluster first);
2. every old member recovers through the full member machinery on
   ``--device`` (``cuda`` by default), so a commit logged but not applied
   is re-applied first;
3. each shard's table slice + WAL chain moves to its new owner through the
   handoff package (``store/handoff.py``);
4. the sequencer floor goes into the new member 0's ``prepare.wal``
   (per-shard last-ts chains + a counter floor at the max applied ts);
5. the new directories are stamped with the next layout epoch and the old
   ones retired (a member booted on one refuses);
6. members then boot with ``cluster.boot --members M --recover``.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional


def _check_quiescent(old_dirs: List[str]) -> None:
    """Refuse while any old directory holds a staged-but-undecided txn."""
    from antidote_tpu_torch.log.wal import replay

    for d in old_dirs:
        prep = os.path.join(d, "prepare.wal")
        if not os.path.exists(prep):
            continue
        staged = {}
        for rec in replay(prep):
            ev = rec.get("ev")
            txid = int(rec.get("txid", 0))
            if ev == "prep":
                staged[txid] = True
            elif ev in ("commit", "abort"):
                staged.pop(txid, None)
        if staged:
            raise RuntimeError(
                f"{d!r} holds staged-but-undecided txns {sorted(staged)}; "
                "settle them first (console cluster-resolve / "
                "cluster-sweep on the live cluster)")


def _at_once(calls: List[Callable]) -> list:
    """Run ``calls`` in threads, one each (a member's recovery or image is
    host work around file and device I/O, which drop the interpreter
    lock), and return their results in order.  When one fails, the
    others still end first; what they built is closed, then the first
    failure is raised."""
    with ThreadPoolExecutor(max_workers=max(1, len(calls))) as ex:
        futs = [ex.submit(c) for c in calls]
    errs = [f.exception() for f in futs]
    if any(e is not None for e in errs):
        for f, e in zip(futs, errs):
            if e is None and hasattr(f.result(), "close"):
                f.result().close()
        raise next(e for e in errs if e is not None)
    return [f.result() for f in futs]


def resize_dc(old_dirs: List[str], new_dirs: List[str], dc_id: int = 0,
              cfg=None, device="cuda") -> Dict[str, float]:
    """Move a quiesced DC's data from ``old_dirs`` (member i's directory
    at index i) into ``new_dirs``.  ``cfg`` defaults to the recorded shape
    with the default widths.  Returns the seconds of each part: ``recover``
    (the old members), ``export`` and ``import`` (the handoff packages),
    ``seal`` (the images of a checkpointed source, the sequencer floor,
    closing and stamping)."""
    from antidote_tpu_torch.api.node import AntidoteNode
    from antidote_tpu_torch.cluster.member import ClusterMember
    from antidote_tpu_torch.config import AntidoteConfig, resolve_device
    from antidote_tpu_torch.log import (load_dir_meta, mark_dir_retired,
                                        segment_index, stamp_layout_epoch)
    from antidote_tpu_torch.log.wal import ShardWAL
    from antidote_tpu_torch.store import handoff

    device = resolve_device(device)
    n_old, n_new = len(old_dirs), len(new_dirs)
    if set(old_dirs) & set(new_dirs):
        raise ValueError("new dirs must be disjoint from old dirs")
    for d in new_dirs:
        if os.path.isdir(d) and os.listdir(d):
            raise ValueError(f"new dir {d!r} is not empty")
    meta = load_dir_meta(old_dirs[0])
    if meta is None:
        raise RuntimeError(f"{old_dirs[0]!r} has no log-dir metadata")
    if cfg is None:
        cfg = AntidoteConfig(n_shards=meta["n_shards"],
                             max_dcs=meta["max_dcs"])
    _check_quiescent(old_dirs)
    parts = {"recover": 0.0, "export": 0.0, "import": 0.0, "seal": 0.0}
    t0 = time.perf_counter()
    # recover the old members through the FULL member machinery: a crash
    # between the durable commit record and the store apply leaves the
    # effects only in prepare.wal, and _replay_recovered_commits is what
    # re-applies them — a bare store-WAL replay would drop an
    # acknowledged commit.  The members recover, and the new directories
    # open, all at once.
    built = _at_once(
        [functools.partial(ClusterMember, cfg, dc_id=dc_id, member_id=i,
                           n_members=n_old, log_dir=d, recover=True,
                           device=device)
         for i, d in enumerate(old_dirs)]
        + [functools.partial(AntidoteNode, cfg, dc_id=dc_id, log_dir=d,
                             device=device) for d in new_dirs])
    old_members, new_nodes = built[:n_old], built[n_old:]
    parts["recover"] = time.perf_counter() - t0
    compacted = False
    try:
        try:
            # one listing of each old log directory serves all its exports
            segments = [segment_index(m.node.store.log.dir)
                        for m in old_members]
            for s in range(cfg.n_shards):
                t1 = time.perf_counter()
                pkg = handoff.export_shard(old_members[s % n_old].node.store,
                                           s, segments=segments[s % n_old])
                t2 = time.perf_counter()
                handoff.import_shard(new_nodes[s % n_new].store, pkg)
                compacted |= bool(pkg.get("compacted"))
                parts["export"] += t2 - t1
                parts["import"] += time.perf_counter() - t2
            # the sequencer floor for the new member 0: per-shard last-ts
            # = the old OWNER's applied frontier (NOT the old ledger's
            # last issued ts: a takeover-aborted hole is closed only by an
            # in-memory no-op link, so carrying the issued ts would wedge
            # the first commit after the resize behind a prev no one can
            # reach)
            floor = [int(old_members[s % n_old].applied_ts.get(s, 0))
                     for s in range(cfg.n_shards)]
            t1 = time.perf_counter()
        finally:
            # the old members close before the images: an image rotates
            # its node onto a new generation of WAL files, so each new
            # node holds two files a shard until it publishes
            for m in old_members:
                m.close()
        if compacted:
            # a checkpointed source ships only its WAL tail: the rows below
            # its image exist in the new nodes' tables alone, so each new
            # directory gets a full image of them before it closes (the
            # images at once)
            _at_once([functools.partial(n.checkpoint_now, full=True)
                      for n in new_nodes])
        w = ShardWAL(os.path.join(new_dirs[0], "prepare.wal"))
        for s, ts_s in enumerate(floor):
            if ts_s > 0:
                w.append({"ev": "seq", "ts": ts_s, "txid": 0,
                          "shards": [int(s)], "prev": {}})
        # the counter floor covers lanes with no per-shard record
        w.append({"ev": "seq", "ts": max(floor, default=0), "txid": 0,
                  "shards": [], "prev": {}})
        w.commit()
        w.sync()
        w.close()
    finally:
        for n in new_nodes:
            n.close()
    # layout-epoch guard: stamp the new layout's epoch into the new dirs
    # and RETIRE the old ones — an old-dir member booted after the resize
    # would serve (and extend) a stale copy of shards that live elsewhere
    new_epoch = int(meta.get("layout_epoch", 0)) + 1
    for d in new_dirs:
        stamp_layout_epoch(d, new_epoch)
    for d in old_dirs:
        mark_dir_retired(d, new_epoch)
    parts["seal"] += time.perf_counter() - t1
    return parts


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="antidote_tpu_torch.cluster.resize")
    ap.add_argument("--old-dirs", required=True,
                    help="comma-separated member log dirs (current layout)")
    ap.add_argument("--new-dirs", required=True,
                    help="comma-separated member log dirs (new layout; "
                         "must be empty)")
    ap.add_argument("--dc-id", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the members recover onto (default "
                         "cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    new_dirs = args.new_dirs.split(",")
    try:
        resize_dc(args.old_dirs.split(","), new_dirs, args.dc_id,
                  device=args.device)
    except RuntimeError as e:
        print(f"resize: {e}", file=sys.stderr, flush=True)
        return 2
    print("resized; boot the new members with "
          "`python -m antidote_tpu_torch.cluster.boot --members "
          f"{len(new_dirs)} --recover ...`")
    return 0


if __name__ == "__main__":
    sys.exit(main())
