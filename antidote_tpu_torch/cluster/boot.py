"""Cluster member process entrypoint.

    python -m antidote_tpu_torch.cluster.boot --dc-id 0 --member 1 \
        --members 2 --shards 4 --max-dcs 3 [--log-dir DIR] [--recover] \
        [--joining] [--device cuda]

The member's tables live on ``--device`` (``cuda`` by default; the process
exits 2 without a card unless given ``--device cpu``).  Prints one JSON
line with the process' ports:

    {"rpc": [h, p], "client": [h, p], "fabric": [h, p], "fabric_id": N}

then serves until killed.  A controller (a test harness, or an operator
script) wires the topology afterwards through the control RPC:

    ctl_wire(peers, remotes, members_by_dc)
        peers          {member_id: [host, port]}      intra-DC RPC
        remotes        {fabric_id: [host, port]}      inter-DC endpoints
        members_by_dc  {dc_id: n_members}             catch-up routing

— the two-phase bring-up of the reference's test utilities (boot nodes,
then exchange descriptors and observe the DCs).  The other controls:
``ctl_failpoint`` (arm a coordinator failpoint: the process exits 137
there), ``ctl_resolve`` (takeover of wedged chains), ``ctl_sweep`` (stale
prepared locks), ``ctl_ready_all``, ``ctl_status`` and
``ctl_repl_status``.

``--joining`` boots the member owning nothing, for a live join: wire it
(``ctl_wire`` on every member, the joiner included), then run ``console
cluster-join``, which streams its share of the shards over while the DC
serves.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _build(args, device):
    """The member, its inter-DC endpoint, its coordinator and its wire
    server (the member's tables on ``device``)."""
    from antidote_tpu_torch.cluster import (ClusterMember, ClusterNode,
                                            attach_interdc)
    from antidote_tpu_torch.config import AntidoteConfig
    from antidote_tpu_torch.interdc.tcp import TcpFabric
    from antidote_tpu_torch.proto.server import ProtocolServer

    cfg = AntidoteConfig(n_shards=args.shards, max_dcs=args.max_dcs)
    member = ClusterMember(cfg, dc_id=args.dc_id, member_id=args.member,
                           n_members=args.members, log_dir=args.log_dir,
                           recover=args.recover,
                           shards=[] if args.joining else None,
                           device=device)
    fabric = TcpFabric()
    replica = attach_interdc(member, fabric)
    if args.recover:
        # chain positions from the recovered WAL: a rejoined member's
        # egress continues its chains instead of restarting them at 0
        replica.restore_from_log()
    node = ClusterNode(member)
    # interdc=replica: this member's wire server answers
    # GET_CONNECTION_DESCRIPTOR and replica-status
    server = ProtocolServer(node, port=0, interdc=replica)
    return member, fabric, replica, node, server


def _register_controls(member, fabric, replica, node) -> None:
    from antidote_tpu_torch.cluster import cluster_query_router
    from antidote_tpu_torch.supervise import Supervisor, ThreadLoop

    subscribed = set()

    def ctl_wire(peers, remotes, members_by_dc) -> bool:
        for mid, (h, p) in peers.items():
            mid = int(mid)
            if mid != member.member_id:
                member.connect(mid, h, int(p))
        for fid, (h, p) in remotes.items():
            fabric.connect_remote(int(fid), h, int(p))
        replica.route_query = cluster_query_router(
            {int(k): int(v) for k, v in members_by_dc.items()},
            member.cfg.n_shards)
        for fid in remotes:
            fid = int(fid)
            if (fid != replica.fabric_id and (fid & 0xFFFF) != member.dc_id
                    and fid not in subscribed):
                # a re-wire (a member rejoining at a new address) must not
                # stack duplicate subscription streams: the existing ones
                # redial the address just learned
                fabric.subscribe(replica.fabric_id, fid, replica._on_message)
                subscribed.add(fid)
        # supervised loops: the inter-DC drain (deliveries + heartbeat
        # flushes) and the members' stable-time gossip (100 ms; without
        # it unpinned reads never pull a peer's newer rows)
        old = getattr(fabric, "_pump_sup", None)
        if old is not None:  # re-wire: replace, don't stack the loops
            old.shutdown()
        sup = Supervisor()
        sup.add("interdc-pump", start=lambda: fabric.start_pump_loop(),
                alive=lambda lp: lp.is_alive(), stop=lambda lp: lp.stop())
        sup.add("clock-gossip",
                start=lambda: ThreadLoop(member.refresh_peer_clocks,
                                         interval_s=0.1,
                                         name="clock-gossip").start(),
                alive=lambda lp: lp.is_alive(), stop=lambda lp: lp.stop())
        sup.start()
        fabric._pump_sup = sup
        return True

    def ctl_repl_status():
        """Geo-replication introspection: per-chain positions, learned
        ownership routes and the raw shard clock matrix."""
        vc = member.node.store.applied_vc
        with member.node.txm.commit_lock:
            last_seen = dict(replica.last_seen)
            shard_route = dict(replica.shard_route)
        return {
            "owned": sorted(int(s) for s in member.shards),
            "pub_opid": [int(x) for x in replica.pub_opid],
            "last_seen": {f"{o}:{s}": int(v)
                          for (o, s), v in last_seen.items()},
            "shard_route": {f"{o}:{s}": [int(mm), int(e)]
                            for (o, s), (mm, e) in shard_route.items()},
            "applied_vc": [[int(x) for x in row] for row in vc],
            "stable_vc": [int(x) for x in member.stable_vc()],
        }

    rpc = member.rpc
    rpc.register("ctl_wire", ctl_wire)
    rpc.register("ctl_failpoint",
                 lambda name: setattr(node, "failpoint", name) or True)
    rpc.register("ctl_resolve",
                 lambda grace=0.0: member.resolve_wedged(grace))
    rpc.register("ctl_sweep",
                 lambda grace=30.0: member.sweep_stale_prepared(grace))
    rpc.register("ctl_ready_all",
                 lambda: {str(k): bool(v)
                          for k, v in node.check_ready().items()})
    rpc.register("ctl_status", lambda: node.status(include_ready=True))
    rpc.register("ctl_repl_status", ctl_repl_status)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="antidote_tpu_torch.cluster.boot")
    ap.add_argument("--dc-id", type=int, required=True)
    ap.add_argument("--member", type=int, default=0)
    ap.add_argument("--members", type=int, default=1)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--max-dcs", type=int, default=4)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--recover", action="store_true",
                    help="rejoin: replay the WAL + prepare log")
    ap.add_argument("--joining", action="store_true",
                    help="boot OWNING NOTHING: the live-join protocol "
                         "(cluster.join.live_join, console cluster-join) "
                         "streams this member's shard share over while the "
                         "cluster serves")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the member's tables (default "
                         "cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    from antidote_tpu_torch.config import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"--device {args.device}: {e}", file=sys.stderr, flush=True)
        return 2
    member, fabric, replica, node, server = _build(args, device)
    _register_controls(member, fabric, replica, node)
    print(json.dumps({
        "rpc": list(member.address),
        "client": [server.host, server.port],
        "fabric": list(fabric.address_of(replica.fabric_id)),
        "fabric_id": replica.fabric_id,
    }), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
