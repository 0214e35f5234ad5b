"""Operator console — the release entrypoint and admin CLI.

The analogue of the reference's release script + ``antidote_console`` and
its riak-admin commands: ``serve`` boots a single-node DC the way the OTP
release does (WAL, recovery, wire protocol, metrics endpoint, readiness
gate, supervision), and the other commands operate a running node over
the client protocol.

    python -m antidote_tpu_torch.console serve --log-dir /data/dc0 --port 8087
    python -m antidote_tpu_torch.console status --port 8087
    python -m antidote_tpu_torch.console ready --port 8087
    python -m antidote_tpu_torch.console read  --port 8087 KEY TYPE BUCKET
    python -m antidote_tpu_torch.console update --port 8087 KEY TYPE BUCKET OP ARG
    python -m antidote_tpu_torch.console checkpoint-now --port 8087
    python -m antidote_tpu_torch.console serve --log-dir /data/f1 \
        --follower-of owner-host:8087 --replica-name f1 --port 8088
    python -m antidote_tpu_torch.console replica-status --port 8087
    python -m antidote_tpu_torch.console replica-add --port 8087 --name f2
    python -m antidote_tpu_torch.console replica-remove --port 8087 --name f2
    python -m antidote_tpu_torch.console inspect --log-dir /data/dc0
    python -m antidote_tpu_torch.console inspect-checkpoint --log-dir /data/dc0
    python -m antidote_tpu_torch.console ringready --rpc host:port
    python -m antidote_tpu_torch.console cluster-status --rpc host:port
    python -m antidote_tpu_torch.console cluster-resolve --rpc host:port
    python -m antidote_tpu_torch.console cluster-sweep --rpc host:port
    python -m antidote_tpu_torch.console cluster-join \
        --rpcs 0=host:port,1=host:port,2=host:port --joiner 2
    python -m antidote_tpu_torch.console cluster-leave \
        --rpcs 0=host:port,1=host:port,2=host:port --leaver 1

``serve`` puts the node's tables on ``--device`` (``cuda`` by default; a
machine without a card must ask for ``cpu``), or with ``--mesh-devices N``
over the first N visible cards in shard blocks (``parallel.
MeshServingPlane``; an N that does not divide the shards, or more cards
than are visible, exits 2, and the ready line gains ``mesh_devices``), and
prints its ready line —
one JSON object on stdout — only after the readiness probe ran a
transaction on that device (on a card, after the kernels were built) and
the protocol server bound its port.  The client port belongs to the native
C++ front end unless ``--no-native-frontend`` (or
``ANTIDOTE_NATIVE_FRONTEND=off``) asks for the Python socketserver plane;
a native plane that cannot be built or bound stops the boot (exit 2).
``--interdc`` adds inter-DC replication: a TCP fabric endpoint (on
``--interdc-port``, advertised under ``--public-host``) with the native
receive pump, a ``DCReplica`` (its chains restored from the log on
recovery), and the replication and escrow loops as supervised children;
other DCs bootstrap a mesh through ``get_connection_descriptor`` and
``connect_to_dcs``.  A pump that cannot be built stops the boot (exit 2).
``--follower-of HOST:PORT`` boots a follower read replica of that owner
instead (a clustered owner: every member's endpoint, comma-separated, the
first named in redirects): it adopts the owner's shape and dc id, needs
``--log-dir``, ships and installs the owner's image — a composition of
the members' images — (or catches its tail up), and only then prints its
ready line, with ``role: follower``, the bootstrap mode and the owner's
member count; ``--follower-peers`` names a geo owner's peer DCs, whose
chains the follower subscribes to itself.  ``replica-status``, ``replica-add`` and
``replica-remove`` operate an owner's follower registry.
``inspect`` and ``inspect-checkpoint`` read a log directory offline, with
no node.  ``ringready``, ``cluster-status``, ``cluster-resolve`` (the
takeover of wedged commit chains) and ``cluster-sweep`` (stale prepared
locks) operate a multi-member DC through a member's control RPC
(``python -m antidote_tpu_torch.cluster.boot``); ``cluster-join`` streams
a booted-empty member's (``cluster.boot --joining``) share of the shards
over while the DC serves, and ``cluster-leave`` drains any member but the
sequencer (member 0) out of it, each with per-shard progress on stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _parse_arg(raw: str):
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


def resolve_serve_shape(log_dir, shards, max_dcs):
    """Deployment shape for ``serve``: an explicit flag wins; otherwise an
    existing log dir's recorded {n_shards, max_dcs}; otherwise the
    defaults (16, 8).  An explicit flag CONFLICTING with the recorded
    shape is passed through — LogManager fails loudly on it rather than
    silently stranding committed shards."""
    if log_dir is not None and (shards is None or max_dcs is None):
        from antidote_tpu_torch.log import load_dir_meta

        meta = load_dir_meta(log_dir) if os.path.isdir(log_dir) else None
        if meta is not None:
            if shards is None:
                shards = meta["n_shards"]
            if max_dcs is None:
                max_dcs = meta["max_dcs"]
    return shards or 16, max_dcs or 8


def _parse_endpoints(csv: str):
    """``host:port[,host:port...]`` -> [(host, port)] (the --follower-of
    and --follower-peers lists)."""
    out = []
    for part in (csv or "").split(","):
        part = part.strip()
        if not part:
            continue
        host, port = part.rsplit(":", 1)
        out.append((host, int(port)))
    return out


def _owner_shape(args):
    """A follower adopts its owner's shape and dc lane (set on ``args``).
    Returns the owner's endpoints from --follower-of — a clustered owner's
    members as a comma-separated list, the first the write endpoint named
    in typed redirects — or an exit code when they are unusable (the
    caller returns it)."""
    from antidote_tpu_torch.proto.client import AntidoteClient

    if args.log_dir is None:
        log("--follower-of requires --log-dir (followers install "
            "checkpoint images into a durable WAL)")
        return 2
    try:
        owner_addrs = _parse_endpoints(args.follower_of)
    except ValueError:
        owner_addrs = []
    if not owner_addrs:
        log("--follower-of needs at least one HOST:PORT endpoint")
        return 2
    try:
        oc = AntidoteClient(*owner_addrs[0], timeout=30)
        ost = oc.node_status()
        oc.close()
    except (ConnectionError, OSError) as e:
        log(f"cannot reach the owner at {args.follower_of}: {e!r}")
        return 2
    for flag, key in (("shards", "n_shards"), ("max_dcs", "max_dcs")):
        mine = getattr(args, flag)
        if mine is None:
            setattr(args, flag, int(ost[key]))
        elif mine != int(ost[key]):
            log(f"--{flag.replace('_', '-')} {mine} conflicts with the "
                f"owner's {key}={ost[key]}: a follower replicates that "
                "exact store (drop the flag to adopt the shape)")
            return 2
    args.dc_id = int(ost["dc_id"])
    return owner_addrs


def cmd_serve(args) -> int:
    from antidote_tpu_torch import faults as _faults
    from antidote_tpu_torch.api import AntidoteNode
    from antidote_tpu_torch.config import AntidoteConfig, resolve_device
    from antidote_tpu_torch.log.checkpoint import has_checkpoints
    from antidote_tpu_torch.proto.native_frontend import (
        NativeFrontendUnavailable, count_python_plane)
    from antidote_tpu_torch.interdc.native_pump import NativePumpUnavailable
    from antidote_tpu_torch.proto.server import ProtocolServer
    from antidote_tpu_torch.supervise import Supervisor
    from antidote_tpu_torch.tenancy import TenantRegistry

    # subprocess chaos hook: a chaos driver SIGKILLs serve children and
    # cannot install a plan in-process, so one may ride in the env
    _faults.install_from_env()
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        log(f"--device {args.device}: {e}")
        return 2
    owner_addrs = []
    if args.follower_of:
        owner_addrs = _owner_shape(args)
        if isinstance(owner_addrs, int):
            return owner_addrs
    shards, max_dcs = resolve_serve_shape(args.log_dir, args.shards,
                                          args.max_dcs)
    cfg = AntidoteConfig(n_shards=shards, max_dcs=max_dcs,
                         keys_per_table=args.keys_per_table,
                         wal_segments=args.wal_segments,
                         sync_log=args.sync_log,
                         fold_chunk=args.fold_chunk)
    has_wal_data = args.log_dir is not None and os.path.isdir(args.log_dir) and (
        any(
            f.endswith(".wal")
            and os.path.getsize(os.path.join(args.log_dir, f)) > 0
            for f in os.listdir(args.log_dir)
        )
        # a published checkpoint is committed data even when every WAL
        # file below its floor was reclaimed
        or has_checkpoints(args.log_dir)
    )
    mesh_plane = None
    if args.mesh_devices:
        # the mesh serving plane: built BEFORE the node so that recovery's
        # tables are placed at creation, attached after it so that stable
        # time and per-shard publishes route through it
        from antidote_tpu_torch.parallel import MeshServingPlane

        try:
            mesh_plane = MeshServingPlane(
                cfg, args.mesh_devices,
                devices=None if device.type == "cuda" else [device])
        except ValueError as e:
            log(f"--mesh-devices {args.mesh_devices}: {e}")
            return 2
    if args.resident_rows > 0 and args.log_dir is None:
        log("--resident-rows requires --log-dir (cold rows live in "
            "checkpoint sidecars)")
        return 2
    recover = args.recover or has_wal_data
    node = AntidoteNode(cfg, dc_id=args.dc_id, log_dir=args.log_dir,
                        recover=recover,
                        resident_rows=args.resident_rows,
                        cold_fault_rate_cap=args.cold_fault_rate_cap,
                        device=device,
                        sharding=(mesh_plane.sharding
                                  if mesh_plane is not None else None))
    if mesh_plane is not None:
        mesh_plane.metrics = node.metrics
        mesh_plane.attach(node.store)
    if args.log_dir is not None and args.checkpoint_interval_s > 0:
        node.start_checkpointer(interval_s=args.checkpoint_interval_s,
                                retain=args.checkpoint_retain,
                                rebase_every=args.checkpoint_rebase_every,
                                scrub_every_s=args.checkpoint_scrub_s)
    probes = node.check_ready()
    if not all(probes.values()):
        log(f"NOT READY: {probes}")
        return 1
    interdc = fabric = follower = None
    if args.interdc or args.follower_of:
        # geo-replication / the follower plane: a TCP fabric endpoint +
        # replica, so protocol clients can bootstrap a DC mesh
        # (GetConnectionDescriptor / ConnectToDCs on either dialect) and
        # followers can subscribe and ship images
        from antidote_tpu_torch.interdc import DCReplica, FollowerReplica
        from antidote_tpu_torch.interdc.tcp import TcpFabric

        public = args.public_host
        if public is None and args.host not in ("0.0.0.0", "::"):
            public = args.host
        try:
            fabric = TcpFabric(host=args.host, port=args.interdc_port,
                               public_host=public)
        except NativePumpUnavailable as e:
            log(f"--interdc: {e}")
            if node.checkpointer is not None:
                node.checkpointer.stop()
            return 2
        if public is None:
            log("WARNING: binding inter-DC on a wildcard address with no "
                "--public-host: connection descriptors will advertise the "
                "bind address, which remote DCs cannot reach")
        if args.follower_of:
            follower = FollowerReplica(
                node, fabric,
                name=(args.replica_name
                      or f"follower-{args.dc_id}-{os.getpid()}"),
                owner_client_addr=owner_addrs[0],
                park_s=max(0.0, args.follower_park_ms) / 1e3,
                digest_every_s=args.divergence_check_s)
        else:
            interdc = DCReplica(node, fabric, name=f"dc{args.dc_id}")
            if recover:
                interdc.restore_from_log()
    # the OTP supervision tree (antidote_sup one_for_one, 5-in-10s):
    # listener, metrics and the replication loops run as supervised
    # children; a flapping child takes the node down
    sup = Supervisor(on_giveup=lambda name: os._exit(70))
    if fabric is not None:
        # a pump crash (bad frame, handler bug) restarts the loop instead
        # of silently freezing replication while the node keeps serving
        sup.add("interdc-pump",
                start=lambda: fabric.start_pump_loop(),
                alive=lambda lp: lp.is_alive(),
                stop=lambda lp: lp.stop())
    if interdc is not None:
        # the escrow loop keeps bounded-counter grants moving
        sup.add("escrow-pump",
                start=lambda: interdc.start_escrow_loop(),
                alive=lambda lp: lp.is_alive(),
                stop=lambda lp: lp.stop())
    server_box = {}
    tenants = TenantRegistry.from_flags(args.tenant)

    def start_proto():
        port = server_box["srv"].port if "srv" in server_box else args.port
        server_box["srv"] = ProtocolServer(
            node, host=args.host, port=port, interdc=interdc,
            tenants=tenants,
            max_connections=args.max_connections,
            max_in_flight=args.max_in_flight,
            max_in_flight_per_client=args.max_in_flight_per_client,
            default_deadline_ms=args.default_deadline_ms,
            epoch_tick_ms=args.epoch_tick_ms,
            snapshot_cache_size=args.snapshot_cache_size,
            group_commit_window_us=args.group_commit_window_us,
            native_frontend=args.native_frontend,
            follower=follower, server_proxy=not args.no_server_proxy,
        )
        return server_box["srv"]

    sup.add("proto", start_proto, alive=lambda s: s.is_alive(),
            stop=lambda s: s.close())
    if args.metrics_port is not None:
        def stop_metrics(m):
            # clear the cached handle FIRST: a close() failure must not
            # leave serve_metrics returning the dead server forever (the
            # flap would reach restart intensity and kill the node)
            node._metrics_server = None
            m.close()

        sup.add("metrics",
                lambda: node.serve_metrics(args.metrics_port),
                alive=lambda m: m._thread.is_alive(),
                stop=stop_metrics)
    if not args.native_frontend:
        count_python_plane("--no-native-frontend")
    try:
        sup.start()
    except NativeFrontendUnavailable as e:
        log(f"{e} (--no-native-frontend serves from the Python plane)")
        sup.shutdown()
        if fabric is not None:
            fabric.close()
        if node.checkpointer is not None:
            node.checkpointer.stop()
        return 2
    server = server_box["srv"]
    ready: dict = {"host": server.host, "port": server.port, "ready": True}
    if tenants.multi:
        ready["tenants"] = list(tenants.names)
    if follower is not None:
        # attach AFTER the pump and the server are supervised: the
        # bootstrap ships the owner fleet's images and catches the tails
        # up, then subscribes — only then is the ready line printed, so
        # whoever waits for it meets a SERVING follower.  Every owner-DC
        # member's descriptor is fetched (a clustered owner), plus any
        # --follower-peers (a geo owner's peer DCs)
        from antidote_tpu_torch.proto.client import AntidoteClient

        peer_addrs = (_parse_endpoints(args.follower_peers)
                      if args.follower_peers else [])
        descs = []
        for addr in owner_addrs + peer_addrs:
            oc = AntidoteClient(*addr, timeout=30)
            descs.append(oc.get_connection_descriptor())
            oc.close()
        follower.client_addr = (args.public_host or server.host,
                                server.port)
        try:
            mode = follower.attach(descs)
        except (ConnectionError, OSError, RuntimeError, ValueError) as e:
            log(f"follower bootstrap from {args.follower_of} failed: {e!r}")
            sup.shutdown()
            fabric.close()
            if node.checkpointer is not None:
                node.checkpointer.stop()
            return 2
        ready.update({"role": "follower", "bootstrap": mode,
                      "name": follower.name,
                      "fleet": {"owner_members": len(owner_addrs),
                                "peer_dcs": len(peer_addrs)}})
        log(f"follower {follower.name} of {args.follower_of} serving "
            f"(bootstrap mode={mode}, owner members={len(owner_addrs)})")
    if mesh_plane is not None:
        ready["mesh_devices"] = mesh_plane.n_devices
    if interdc is not None:
        # the escrow plane armed at boot: the rights-transfer loop runs
        ready["escrow"] = dict(node.txm.bcounters.status(), loop=True)
    log(f"antidote_tpu_torch dc{args.dc_id} serving on "
        f"{server.host}:{server.port} (device={device}, "
        f"recovered={recover}, keys={len(node.store.directory)}"
        + (f", mesh={mesh_plane.n_devices}dev"
           if mesh_plane is not None else "") + ")")
    print(json.dumps(ready), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        log("shutting down")
        if node.checkpointer is not None:
            node.checkpointer.stop()
        sup.shutdown()
        if fabric is not None:
            fabric.close()
    return 0


def _client(args):
    from antidote_tpu_torch.proto.client import AntidoteClient

    return AntidoteClient(args.host, args.port)


def cmd_status(args) -> int:
    c = _client(args)
    print(json.dumps(c.node_status(), indent=2))
    c.close()
    return 0


def cmd_ready(args) -> int:
    c = _client(args)
    ready = c.node_status(include_ready=True)["ready"]
    print(json.dumps(ready))
    c.close()
    return 0 if all(ready.values()) else 1


def cmd_read(args) -> int:
    c = _client(args)
    vals, vc = c.read_objects([(args.key, args.type, args.bucket)])
    print(json.dumps({"value": vals[0], "clock": list(vc)}, default=str))
    c.close()
    return 0


def cmd_update(args) -> int:
    c = _client(args)
    vc = c.update_objects(
        [(args.key, args.type, args.bucket, (args.op, _parse_arg(args.arg)))]
    )
    print(json.dumps({"commit_clock": list(vc)}))
    c.close()
    return 0


def cmd_checkpoint_now(args) -> int:
    """Run one synchronous checkpoint cycle on a serving node and print
    the published manifest (stamp, image bytes, WAL bytes reclaimed)."""
    c = _client(args)
    print(json.dumps(c.checkpoint_now(), indent=2))
    c.close()
    return 0


def cmd_replica_status(args) -> int:
    """Replica-plane view: against an owner, every known follower with
    its typed state (ok | lagging | down | bootstrapping | healing) and
    applied-VC lag, plus the hash ring a session client builds over the
    serving fleet (size and arc shares); against a follower, its own
    state, bootstrap and divergence view.  Exit 1 when any follower is
    not ok."""
    from antidote_tpu_torch.proto.client import HashRing

    c = _client(args)
    out = c.replica_admin("status")
    c.close()
    serving = [(f["addr"][0], int(f["addr"][1]))
               for f in (out.get("followers") or {}).values()
               if f.get("addr") and f.get("state") in ("ok", "lagging")]
    if serving:
        ring = HashRing(serving)
        out["ring"] = {"size": len(ring),
                       "arc_share": ring.arc_share_by_name()}
    print(json.dumps(out, indent=2))
    bad = [n for n, f in (out.get("followers") or {}).items()
           if f.get("state") != "ok"]
    if out.get("role") == "follower" and out.get("state") != "serving":
        bad.append(out.get("name"))
    return 1 if bad else 0


def cmd_replica_add(args) -> int:
    """Pre-register an expected follower with the owner (``down`` until
    its first liveness report; clears a remove's tombstone)."""
    c = _client(args)
    addr = None
    if args.addr:
        h, p = args.addr.rsplit(":", 1)
        addr = (h, int(p))
    out = c.replica_admin("add", name=args.name, addr=addr)
    c.close()
    print(json.dumps(out, indent=2))
    return 0


def cmd_replica_remove(args) -> int:
    """Decommission a follower at the owner: dropped from the registry,
    its future reports refused (stop the follower process separately)."""
    c = _client(args)
    out = c.replica_admin("remove", name=args.name)
    c.close()
    print(json.dumps(out, indent=2))
    return 0


def cmd_inspect(args) -> int:
    """Offline WAL inspection: per shard, records, op-id chain maxima by
    origin DC, records by type, segments and bytes.  Segment files
    (``shard_P.sN.wal``) merge into their shard's summary in replay
    order, as recovery reads them."""
    import glob
    import re

    from antidote_tpu_torch.log import segment_index, shard_segment_paths
    from antidote_tpu_torch.log.wal import replay_segments

    shards = sorted({
        int(m.group(1))
        for p in glob.glob(os.path.join(args.log_dir, "shard_*.wal"))
        if (m := re.match(r"shard_(\d+)\.(?:s\d+\.)?(?:g\d+\.)?wal$",
                          os.path.basename(p)))
    })
    out = {}
    segments = segment_index(args.log_dir)
    for shard in shards:
        paths = [p for p in shard_segment_paths(args.log_dir, shard, 1,
                                                segments)
                 if os.path.exists(p)]
        recs = 0
        chains: dict = {}
        types: dict = {}
        for rec in replay_segments(paths):
            recs += 1
            o = int(rec["o"])
            chains[o] = max(chains.get(o, 0), int(rec["id"]))
            types[rec["t"]] = types.get(rec["t"], 0) + 1
        out[f"shard_{shard}"] = {
            "records": recs, "opid_chains": chains,
            "records_by_type": types,
            "segments": len(paths),
            "bytes": sum(os.path.getsize(p) for p in paths),
        }
    print(json.dumps(out, indent=2))
    return 0


def cmd_inspect_checkpoint(args) -> int:
    """Offline checkpoint inspection: every published image's manifest
    (newest last), and the decoded summary of the newest one — stamp VC,
    per-shard floors, replication chain floors, tables, extras."""
    from antidote_tpu_torch.log import checkpoint as _ckpt

    root = _ckpt.checkpoint_root(args.log_dir)
    out = {"root": root,
           "published": [m for _id, p in _ckpt.list_checkpoints(root)
                         if (m := _ckpt.load_manifest(p)) is not None]}
    latest = _ckpt.load_latest(args.log_dir)
    if latest is not None:
        image, manifest = latest
        out["latest"] = {
            "id": int(image["id"]),
            "verified": True,
            "keys": len(image["directory"]),
            "tables": {
                t: int(sum(int(x) for x in tb["used_rows"]))
                for t, tb in image["tables"].items()
            },
            "stamp_vc_max": manifest.get("stamp_vc_max"),
            "commit_counter": int(image["commit_counter"]),
            "floor_seqs": [int(x) for x in image["floor_seqs"]],
            "chain_floor": [[int(x) for x in row]
                            for row in image["chain_floor"]],
            "blobs": len(image.get("blobs", [])),
            "shard_resets": image.get("shard_resets", {}),
            "extras": sorted((image.get("extras") or {}).keys()),
        }
        membership = (image.get("extras") or {}).get("membership")
        if membership:
            out["latest"]["membership"] = membership
    print(json.dumps(out, indent=2))
    return 0


def _member_rpc(args):
    from antidote_tpu_torch.cluster.rpc import RpcClient

    host, port = args.rpc.rsplit(":", 1)
    return RpcClient(host, int(port))


def _member_call(args, method: str, *a):
    cli = _member_rpc(args)
    try:
        return cli.call(method, *a)
    finally:
        cli.close()


def cmd_ringready(args) -> int:
    """All members of the DC up and answering (the riak_core ringready
    probe)."""
    probes = _member_call(args, "ctl_ready_all")
    print(json.dumps(probes))
    return 0 if all(probes.values()) else 1


def cmd_cluster_status(args) -> int:
    print(json.dumps(_member_call(args, "ctl_status")))
    return 0


def cmd_cluster_resolve(args) -> int:
    print(json.dumps({"resolved": _member_call(args, "ctl_resolve",
                                               args.grace)}))
    return 0


def cmd_cluster_sweep(args) -> int:
    print(json.dumps({"swept": _member_call(args, "ctl_sweep", args.grace)}))
    return 0


def _parse_member_rpcs(spec: str):
    """``0=host:port,1=host:port,...`` -> {member_id: (host, port)}."""
    out = {}
    for part in spec.split(","):
        mid, addr = part.split("=", 1)
        host, port = addr.rsplit(":", 1)
        out[int(mid)] = (host, int(port))
    return out


def _move_progress(shard, src, dst, done, total):
    log(f"[{done}/{total}] shard {shard}: member {src} -> member {dst}")


def cmd_cluster_join(args) -> int:
    """Live-join a booted-empty member into a serving DC (the staged join
    and ownership handoff), with per-shard progress on stderr.  The joiner
    must already run (``cluster.boot --joining``) and be wired
    (``ctl_wire``)."""
    from antidote_tpu_torch.cluster.join import live_join

    rpcs = _parse_member_rpcs(args.rpcs)
    moved = live_join(rpcs, new_id=args.joiner, progress=_move_progress)
    print(json.dumps({"joined": args.joiner, "moved": moved}))
    return 0


def cmd_cluster_leave(args) -> int:
    """Live-drain any member but member 0 (the sequencer) out of a serving
    DC: its shards stream to the least-loaded survivors, then every
    survivor forgets it.  Shut the leaver down afterwards."""
    from antidote_tpu_torch.cluster.join import live_leave

    rpcs = _parse_member_rpcs(args.rpcs)
    moved = live_leave(rpcs, leaving_id=args.leaver,
                       progress=_move_progress)
    print(json.dumps({"left": args.leaver, "moved": moved}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="antidote_tpu_torch.console")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sv = sub.add_parser("serve", help="boot a node and serve the protocol")
    sv.add_argument("--device", default="cuda",
                    help="device of the node's tables: cuda (default; "
                         "fails without a card) or cpu")
    sv.add_argument("--mesh-devices", type=int, default=0,
                    help="place the node's tables over this many devices "
                         "(the visible cards; on --device cpu the CPU is "
                         "the one device), n_shards divisible by it; 0 = "
                         "one device.  Stable time runs stable_min per "
                         "shard block and epoch publishes go per-shard "
                         "incremental")
    sv.add_argument("--log-dir", default=None)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8087)
    sv.add_argument("--metrics-port", type=int, default=None)
    sv.add_argument("--interdc", action="store_true",
                    help="serve inter-DC replication (a TCP fabric endpoint "
                         "+ replica; bootstrap with connect_to_dcs)")
    sv.add_argument("--interdc-port", type=int, default=0,
                    help="fixed inter-DC fabric port (0 = ephemeral)")
    sv.add_argument("--public-host", default=None,
                    help="host advertised in connection descriptors "
                         "(defaults to --host unless it is a wildcard)")
    sv.add_argument("--follower-of", default=None,
                    metavar="HOST:PORT[,HOST:PORT...]",
                    help="boot a follower read replica of the owner at "
                         "HOST:PORT (its client endpoint): adopts the "
                         "owner's shape and dc id, ships its image; a "
                         "clustered owner is the comma-separated list of "
                         "all its members' client endpoints (their images "
                         "compose the store; the first is named in "
                         "redirects); requires --log-dir")
    sv.add_argument("--follower-peers", default=None,
                    help="with --follower-of against a geo-replicated "
                         "owner: the peer DCs' client endpoints "
                         "(HOST:PORT,...), whose chains the follower "
                         "subscribes to itself (without them those lanes' "
                         "divergence checks report 'unsubscribed')")
    sv.add_argument("--replica-name", default=None,
                    help="follower name in the owner's replica registry "
                         "(default: follower-<dc>-<pid>)")
    sv.add_argument("--follower-park-ms", type=float, default=100.0,
                    help="how long a session read parks for the "
                         "follower's applied clock to cover its token "
                         "before the typed lagging redirect")
    sv.add_argument("--no-server-proxy", action="store_true",
                    help="on a follower: out-of-arc reads and writes "
                         "answer typed redirects instead of being proxied "
                         "or forwarded to the owner")
    sv.add_argument("--divergence-check-s", type=float, default=5.0,
                    help="cadence of the follower's round-robin per-shard "
                         "Merkle comparison against the owner (<= 0 "
                         "disables it)")
    sv.add_argument("--dc-id", type=int, default=0)
    sv.add_argument("--shards", type=int, default=None,
                    help="default: the log dir's recorded shape, else 16")
    sv.add_argument("--max-dcs", type=int, default=None,
                    help="default: the log dir's recorded shape, else 8")
    sv.add_argument("--recover", action="store_true")
    sv.add_argument("--keys-per-table", type=int, default=4096,
                    help="initial rows per (type, shard); size near the "
                         "expected keyspace — every growth doubling "
                         "reallocates the device tables")
    sv.add_argument("--native-frontend", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="own the client port from the C++ epoll front "
                         "end: accept, framing, admission and whole-batch "
                         "cache hits run off the interpreter lock "
                         "(--no-native-frontend: the Python socketserver "
                         "plane).  A native plane that cannot be built or "
                         "bound stops the boot")
    sv.add_argument("--max-connections", type=int, default=1024,
                    help="connection cap for the accept loop (native and "
                         "Python planes alike); excess connections queue "
                         "in the kernel listen backlog")
    sv.add_argument("--max-in-flight", type=int, default=256,
                    help="global admitted-request cap; past it the server "
                         "answers a typed busy error with a retry-after "
                         "hint instead of queueing")
    sv.add_argument("--max-in-flight-per-client", type=int, default=64,
                    help="per-client (peer host) admitted-request cap "
                         "(keeps one client machine's connection fleet "
                         "from monopolizing the global budget)")
    sv.add_argument("--default-deadline-ms", type=float, default=None,
                    help="server-side deadline for requests that carry no "
                         "deadline_ms field; work that outlives it is "
                         "aborted at dequeue (default: no deadline)")
    sv.add_argument("--epoch-tick-ms", type=float, default=100.0,
                    help="serving-epoch publication cadence for the "
                         "dedicated ticker (<= 0 disables the lock-split "
                         "epoch read plane entirely)")
    sv.add_argument("--snapshot-cache-size", type=int, default=None,
                    help="hot-key snapshot cache capacity in entries "
                         "(default: the store's built-in 65536)")
    sv.add_argument("--wal-segments", type=int, default=4,
                    help="parallel WAL append segments per shard: the "
                         "group-fsync coordinator syncs one segment "
                         "while the next commit group appends to its "
                         "neighbor (1 = classic single-file layout; "
                         "recovery merges either way)")
    sv.add_argument("--sync-log", action="store_true",
                    help="fsync before every commit ack (group fsync: "
                         "one fdatasync covers the whole merged batch)."
                         "  Default off, like the reference's "
                         "sync_log=false — an ack then means 'reached "
                         "the OS', durable within the WAL's background "
                         "sync interval")
    sv.add_argument("--fold-chunk", type=int, default=4096,
                    help="over-ring fold routing threshold: a replayed "
                         "key whose op log exceeds this many ops folds "
                         "with the chunked strategy instead of one "
                         "serial scan")
    sv.add_argument("--checkpoint-interval-s", type=float, default=300.0,
                    help="background checkpoint cadence: each cycle "
                         "publishes a VC-stamped store image and reclaims "
                         "WAL files below its floor, so restart = load "
                         "image + replay tail.  <= 0 disables (restart "
                         "then replays the whole WAL)")
    sv.add_argument("--checkpoint-rebase-every", type=int, default=8,
                    help="full-image rebase cadence of the incremental "
                         "checkpoint chain: between rebases, a stamp "
                         "writes only the rows dirtied since its parent "
                         "link; 1 = always full")
    sv.add_argument("--checkpoint-scrub-s", type=float, default=900.0,
                    help="background bit-rot scrub cadence: CRC-verify "
                         "retained images/links off the commit lock; a "
                         "corrupt delta link is retired and a rebase "
                         "forced (0 disables)")
    sv.add_argument("--resident-rows", type=int, default=0,
                    help="cold-tier device residency budget: past this "
                         "many resident table rows, the coldest "
                         "image-covered keys are evicted to the "
                         "checkpoint sidecar and faulted back on read "
                         "(typed cold_miss past the fault-rate cap).  "
                         "0 = unbounded")
    sv.add_argument("--cold-fault-rate-cap", type=float, default=0.0,
                    help="cold fault-ins admitted per second before "
                         "reads are refused with a typed cold_miss "
                         "retry hint (0 = unlimited)")
    sv.add_argument("--checkpoint-retain", type=int, default=2,
                    help="published checkpoint images kept on disk; "
                         "older ones (and WAL files wholly below the "
                         "newest floor) are reclaimed after each publish")
    sv.add_argument("--tenant", action="append", default=None,
                    metavar="NAME:WEIGHT[,max_in_flight=N][,max_backlog=N]",
                    help="declare a tenant lane for weighted-fair "
                         "admission (repeatable).  Requests map to the "
                         "lane whose name prefixes their bucket as "
                         "'tenant/bucket' (or carry an explicit "
                         "per-request tag); everything else rides the "
                         "built-in 'default' lane.  WEIGHT sets the "
                         "lane's deficit-round-robin share; "
                         "max_in_flight caps the tenant's admitted "
                         "requests, max_backlog its queued depth.  "
                         "Over-quota requests get a typed tenant_busy "
                         "refusal while other lanes keep serving")
    sv.add_argument("--group-commit-window-us", type=float, default=0.0,
                    help="merge-point gather window in µs: the locked "
                         "worker keeps draining late-arriving commits "
                         "this long before taking the commit lock "
                         "(0 = natural batching only)")
    sv.set_defaults(fn=cmd_serve)

    for name, fn in (("status", cmd_status), ("ready", cmd_ready)):
        p = sub.add_parser(name)
        p.add_argument("--host", default="127.0.0.1")
        p.add_argument("--port", type=int, default=8087)
        p.set_defaults(fn=fn)

    rd = sub.add_parser("read")
    rd.add_argument("--host", default="127.0.0.1")
    rd.add_argument("--port", type=int, default=8087)
    rd.add_argument("key"), rd.add_argument("type"), rd.add_argument("bucket")
    rd.set_defaults(fn=cmd_read)

    up = sub.add_parser("update")
    up.add_argument("--host", default="127.0.0.1")
    up.add_argument("--port", type=int, default=8087)
    up.add_argument("key"), up.add_argument("type"), up.add_argument("bucket")
    up.add_argument("op"), up.add_argument("arg")
    up.set_defaults(fn=cmd_update)

    cn = sub.add_parser("checkpoint-now",
                        help="run one synchronous checkpoint cycle on a "
                             "serving node (stamp, stream, publish, "
                             "reclaim) and print the manifest")
    cn.add_argument("--host", default="127.0.0.1")
    cn.add_argument("--port", type=int, default=8087)
    cn.set_defaults(fn=cmd_checkpoint_now)

    rs = sub.add_parser("replica-status",
                        help="follower fleet health: typed ok/lagging/"
                             "down states, lag and the session ring (exit "
                             "1 when any follower is not ok)")
    rs.add_argument("--host", default="127.0.0.1")
    rs.add_argument("--port", type=int, default=8087)
    rs.set_defaults(fn=cmd_replica_status)

    ra = sub.add_parser("replica-add",
                        help="pre-register an expected follower with the "
                             "owner's registry")
    ra.add_argument("--host", default="127.0.0.1")
    ra.add_argument("--port", type=int, default=8087)
    ra.add_argument("--name", required=True)
    ra.add_argument("--addr", default=None,
                    help="the follower's client endpoint host:port")
    ra.set_defaults(fn=cmd_replica_add)

    rr = sub.add_parser("replica-remove",
                        help="decommission a follower at the owner (its "
                             "reports are refused from then on)")
    rr.add_argument("--host", default="127.0.0.1")
    rr.add_argument("--port", type=int, default=8087)
    rr.add_argument("--name", required=True)
    rr.set_defaults(fn=cmd_replica_remove)

    ins = sub.add_parser("inspect", help="offline WAL inspection")
    ins.add_argument("--log-dir", required=True)
    ins.set_defaults(fn=cmd_inspect)

    ic = sub.add_parser("inspect-checkpoint",
                        help="offline checkpoint inspection: published "
                             "manifests + the newest image's decoded "
                             "summary (stamp VC, floors, chain floors, "
                             "membership extras)")
    ic.add_argument("--log-dir", required=True)
    ic.set_defaults(fn=cmd_inspect_checkpoint)

    # a multi-member DC through a member's control RPC (antidote_console's
    # ringready; rejoin a crashed member with `python -m
    # antidote_tpu_torch.cluster.boot ... --recover`)
    for name, fn, hlp in (
        ("ringready", cmd_ringready,
         "all cluster members up and answering (riak_core ringready)"),
        ("cluster-status", cmd_cluster_status,
         "member topology, owned shards, stable VC"),
        ("cluster-resolve", cmd_cluster_resolve,
         "takeover: settle wedged commit chains (dead coordinator)"),
        ("cluster-sweep", cmd_cluster_sweep,
         "release prepared locks of never-sequenced dead txns"),
    ):
        p = sub.add_parser(name, help=hlp)
        p.add_argument("--rpc", required=True,
                       help="member control RPC as host:port")
        if name == "cluster-resolve":
            p.add_argument("--grace", type=float, default=0.0)
        if name == "cluster-sweep":
            p.add_argument("--grace", type=float, default=30.0)
        p.set_defaults(fn=fn)

    # live membership change (staged join/leave while the DC serves)
    cj = sub.add_parser(
        "cluster-join",
        help="live-join a booted-empty member (shards stream over while "
             "the cluster serves; per-shard progress on stderr)")
    cj.add_argument("--rpcs", required=True,
                    help="member control RPCs incl. the joiner, as "
                         "id=host:port,id=host:port,...")
    cj.add_argument("--joiner", type=int, required=True,
                    help="joining member id (fresh, highest)")
    cj.set_defaults(fn=cmd_cluster_join)

    cl = sub.add_parser(
        "cluster-leave",
        help="live-drain any member but the sequencer (member 0) out of "
             "a serving DC, then forget it everywhere")
    cl.add_argument("--rpcs", required=True,
                    help="member control RPCs incl. the leaver, as "
                         "id=host:port,...")
    cl.add_argument("--leaver", type=int, required=True,
                    help="departing member id (any id except 0)")
    cl.set_defaults(fn=cmd_cluster_leave)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
