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
    python -m antidote_tpu_torch.console inspect --log-dir /data/dc0
    python -m antidote_tpu_torch.console inspect-checkpoint --log-dir /data/dc0

``serve`` puts the node's tables on ``--device`` (``cuda`` by default; a
machine without a card must ask for ``cpu``) and prints its ready line —
one JSON object on stdout — only after the readiness probe ran a
transaction on that device (on a card, after the kernels were built) and
the protocol server bound its port.  The client port belongs to the native
C++ front end unless ``--no-native-frontend`` (or
``ANTIDOTE_NATIVE_FRONTEND=off``) asks for the Python socketserver plane;
a native plane that cannot be built or bound stops the boot (exit 2).
``inspect`` and ``inspect-checkpoint`` read a log directory offline, with
no node.
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


def cmd_serve(args) -> int:
    from antidote_tpu_torch import faults as _faults
    from antidote_tpu_torch.api import AntidoteNode
    from antidote_tpu_torch.config import AntidoteConfig, resolve_device
    from antidote_tpu_torch.log.checkpoint import has_checkpoints
    from antidote_tpu_torch.proto.native_frontend import (
        NativeFrontendUnavailable, count_python_plane)
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
    if args.resident_rows > 0 and args.log_dir is None:
        log("--resident-rows requires --log-dir (cold rows live in "
            "checkpoint sidecars)")
        return 2
    recover = args.recover or has_wal_data
    node = AntidoteNode(cfg, dc_id=args.dc_id, log_dir=args.log_dir,
                        recover=recover,
                        resident_rows=args.resident_rows,
                        cold_fault_rate_cap=args.cold_fault_rate_cap,
                        device=device)
    if args.log_dir is not None and args.checkpoint_interval_s > 0:
        node.start_checkpointer(interval_s=args.checkpoint_interval_s,
                                retain=args.checkpoint_retain,
                                rebase_every=args.checkpoint_rebase_every,
                                scrub_every_s=args.checkpoint_scrub_s)
    probes = node.check_ready()
    if not all(probes.values()):
        log(f"NOT READY: {probes}")
        return 1
    # the OTP supervision tree (antidote_sup one_for_one, 5-in-10s):
    # listener + metrics run as supervised children; a flapping child
    # takes the node down
    sup = Supervisor(on_giveup=lambda name: os._exit(70))
    server_box = {}
    tenants = TenantRegistry.from_flags(args.tenant)

    def start_proto():
        port = server_box["srv"].port if "srv" in server_box else args.port
        server_box["srv"] = ProtocolServer(
            node, host=args.host, port=port, tenants=tenants,
            max_connections=args.max_connections,
            max_in_flight=args.max_in_flight,
            max_in_flight_per_client=args.max_in_flight_per_client,
            default_deadline_ms=args.default_deadline_ms,
            epoch_tick_ms=args.epoch_tick_ms,
            snapshot_cache_size=args.snapshot_cache_size,
            group_commit_window_us=args.group_commit_window_us,
            native_frontend=args.native_frontend,
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
        if node.checkpointer is not None:
            node.checkpointer.stop()
        return 2
    server = server_box["srv"]
    ready: dict = {"host": server.host, "port": server.port, "ready": True}
    if tenants.multi:
        ready["tenants"] = list(tenants.names)
    log(f"antidote_tpu_torch dc{args.dc_id} serving on "
        f"{server.host}:{server.port} (device={device}, "
        f"recovered={recover}, keys={len(node.store.directory)})")
    print(json.dumps(ready), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        log("shutting down")
        if node.checkpointer is not None:
            node.checkpointer.stop()
        sup.shutdown()
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


def cmd_inspect(args) -> int:
    """Offline WAL inspection: per shard, records, op-id chain maxima by
    origin DC, records by type, segments and bytes.  Segment files
    (``shard_P.sN.wal``) merge into their shard's summary in replay
    order, as recovery reads them."""
    import glob
    import re

    from antidote_tpu_torch.log import shard_segment_paths
    from antidote_tpu_torch.log.wal import replay_segments

    shards = sorted({
        int(m.group(1))
        for p in glob.glob(os.path.join(args.log_dir, "shard_*.wal"))
        if (m := re.match(r"shard_(\d+)\.(?:s\d+\.)?(?:g\d+\.)?wal$",
                          os.path.basename(p)))
    })
    out = {}
    for shard in shards:
        paths = [p for p in shard_segment_paths(args.log_dir, shard)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="antidote_tpu_torch.console")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sv = sub.add_parser("serve", help="boot a node and serve the protocol")
    sv.add_argument("--device", default="cuda",
                    help="device of the node's tables: cuda (default; "
                         "fails without a card) or cpu")
    sv.add_argument("--log-dir", default=None)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8087)
    sv.add_argument("--metrics-port", type=int, default=None)
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

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
