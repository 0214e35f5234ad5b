"""FollowerReplica — a fault-first read replica of one owner node.

A follower is a full store replica of ONE single-node owner (same
``dc_id``, same deployment shape) that subscribes to the owner's
transaction stream, applies effects through the same chain and causal-gate
machinery a geo peer uses — including the owner's OWN-origin chain, which
a peer DC skips — and serves snapshot reads from its own wire server with
no owner load.  Its tables live on its node's device; a CUDA follower's
reads and applies launch the kernels there and never carry on on the CPU.

  * **bootstrap from nothing** — a fresh follower ships the owner's newest
    checkpoint image over the request channel (``ckpt_meta`` /
    ``ckpt_fetch``, fault site ``ckpt.ship``), installs it into a fresh
    store, checkpoints it LOCALLY (its own crash recovery is then
    self-sufficient), and catches the WAL tail up through the ordinary
    opid-gap machinery (mode ``image``);
  * **fall below the compaction floor and repair** — a catch-up refused
    below the owner's compaction floor re-bootstraps from the current
    image (mode ``delta``) instead of retrying forever;
  * **crash and rejoin fast** — a restarted follower recovers from its own
    WAL and local images, re-derives its chain positions and replays only
    the missed suffix (mode ``tail``);
  * **diverge and self-heal** — per-shard Merkle roots are compared
    against the owner at EQUAL applied clocks; a mismatch walks the tree
    to the diverged leaves and re-installs only their keys from the
    owner's leaf fetch (a full image re-bootstrap is the escalation);
  * **never lie to a session** — reads carrying a session token are gated
    on the PER-SHARD applied clocks of the shards they touch: the follower
    parks briefly, then answers a typed ``ReplicaLagging`` redirect.

A follower can shadow a clustered (multi-member) owner and a
geo-replicated one.  ``attach`` takes a list of descriptors: every member
of the owner DC, plus, for a geo owner, the peer DCs' endpoints, and opens
one subscription an endpoint.  Requests about a shard (catch-up,
divergence roots, Merkle walks) go to the member that owns it: the
ownership gossip every member stamps on its frames
(``DCReplica.shard_route``) takes precedence over the modular layout, so
a live shard move re-points them with no reconnect.  A bootstrap or an
image repair composes the members' images: each installs restricted to
the shards its member owns (``install_image(shards=)``).  A geo owner's
peer chains replicate through the follower's own subscriptions to the
peer DCs.

Every serving-epoch publish on a follower goes through
:meth:`FollowerReplica.publish_applied_epoch_locked`, which slaves the
commit counter to the applied own lane first, so no epoch claims a clock
the follower has not applied.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import zlib
from typing import Dict, List, Optional

import numpy as np

from antidote_tpu_torch.interdc.messages import Descriptor
from antidote_tpu_torch.interdc.replica import DCReplica
from antidote_tpu_torch.overload import (ColdMiss, ReplicaLagging,
                                         retry_hint_ms)
from antidote_tpu_torch.store.kv import KVStore, freeze_key, key_to_shard

log = logging.getLogger(__name__)


class FollowerReplica(DCReplica):
    """Read-only follower of one owner node (see the module docstring)."""

    #: default fabric-id base for followers — far above any dc id, so a
    #: follower's endpoint never shadows a DC's on a shared fabric
    FID_BASE = 1 << 14
    #: session reads park at most this long for the applied clock to
    #: catch the token before the typed redirect
    PARK_S = 0.10
    #: liveness-report cadence to the owner (the owner marks a silent
    #: follower DOWN after DCReplica.REPLICA_DOWN_S)
    REPORT_EVERY_S = 1.0
    #: backoff between retries of a FAILED quarantine repair
    HEAL_RETRY_S = 2.0
    #: drain-path epoch publishes are rate-limited to one a window (each
    #: is a device re-freeze); the server's ticker and the session gate's
    #: on-demand publish keep freshness
    EPOCH_PUBLISH_MIN_S = 0.025
    #: range-heal attempts before escalating to a full image re-bootstrap
    MERKLE_HEAL_ATTEMPTS = 8

    def __init__(self, node, hub, name: str = "", owner_client_addr=None,
                 fabric_id: Optional[int] = None,
                 park_s: Optional[float] = None,
                 digest_every_s: float = 0.0):
        if fabric_id is None:
            fabric_id = self.FID_BASE + (os.getpid() % self.FID_BASE)
        super().__init__(node, hub, name or f"follower-{fabric_id}",
                         fabric_id=fabric_id)
        #: the owner's client endpoint (host, port), carried in every
        #: typed redirect so session clients can re-route
        self.owner_client_addr = (tuple(owner_client_addr)
                                  if owner_client_addr else None)
        #: this follower's own client endpoint, reported to the owner
        #: (the serving fleet's ring is built from these)
        self.client_addr = None
        self.park_s = self.PARK_S if park_s is None else float(park_s)
        #: <= 0 disables the periodic divergence sweep
        self.digest_every_s = float(digest_every_s)
        #: the owner's fabric id (set by attach; for a clustered owner
        #: the lowest member id's, the sequencer's)
        self.owner_fid: Optional[int] = None
        #: the subscribed fleet: fabric id -> Descriptor (the owner DC's
        #: members and, for a geo owner, its peer DCs)
        self.fleet: Dict[int, Descriptor] = {}
        #: dc id -> sorted fabric ids of that DC's endpoints (the modular
        #: catch-up route before any ownership gossip arrives)
        self.fleet_by_dc: Dict[int, List[int]] = {}
        #: the owner DC's member fabric ids (image sources and report
        #: targets)
        self.member_fids: List[int] = []
        #: session-gate refusals since the last admitted read: the
        #: pressure signal behind the redirect's retry hint
        self._gate_streak = 0
        #: bootstrapping -> serving -> (healing -> serving)*; anything but
        #: "serving" redirects every session read
        self.state = "bootstrapping"
        #: completed bootstrap/repair cycles and the last cycle's mode
        self.boots = 0
        self.last_bootstrap_mode: Optional[str] = None
        self.divergence_counts: Dict[str, int] = {
            "ok": 0, "skipped": 0, "mismatch": 0}
        #: leaves fetched by range heals (the heal's cost in leaves)
        self.healed_leaves = 0
        #: the last bootstrap's stages: ship_bytes and ship_s (the image
        #: over the request channel), install_s (the wipe through the
        #: install), local_checkpoint_s, catch_up_s (the WAL tail)
        self.boot_stats: Dict[str, float] = {}
        self._boot_lock = threading.RLock()
        self._in_heal = False
        #: a failed quarantine repair parks its mode here; the tick
        #: retries it on HEAL_RETRY_S backoff
        self._heal_pending: Optional[str] = None
        self._heal_retry_at = 0.0
        self._last_report = 0.0
        self._last_digest = time.monotonic()
        self._last_epoch_pub = 0.0
        self._digest_rr = 0
        #: serving-fleet snapshot learned from follower_report replies:
        #: name -> {addr, state}; the version lets the proxy plane rebuild
        #: its ring only when a new snapshot landed
        self.fleet_table: Dict[str, dict] = {}
        self.fleet_table_v = 0

    # -- identity overrides -----------------------------------------------
    def _ingest_own_origin(self) -> bool:
        return True  # the owner's own chain IS the follower's data plane

    def _on_local_commit(self, effects, commit_vc, origin) -> None:
        # a follower is read-only (its wire server forwards writes): a
        # local commit here means an embedder bypassed that, and the state
        # WILL diverge until a digest check heals it
        log.error("follower %s observed a LOCAL commit (%d effect(s)) — "
                  "followers are read-only; this state WILL diverge from "
                  "the owner until the next divergence check heals it",
                  self.name, len(effects))

    def heartbeat(self, exclude=frozenset()) -> None:
        return  # followers never publish safe times — they consume them

    def maybe_heartbeat(self) -> None:
        """The follower's tick (runs at every fabric pump): the liveness
        report to the owner, a parked repair's retry and — when armed —
        the round-robin divergence sweep, one shard a window."""
        now = time.monotonic()
        if now - self._last_report >= self.REPORT_EVERY_S:
            self._last_report = now
            self._send_report()
        if (self._heal_pending is not None and not self._in_heal
                and now >= self._heal_retry_at):
            mode, self._heal_pending = self._heal_pending, None
            self._heal(mode)  # re-parks itself on failure
        if (self.digest_every_s > 0 and self.state == "serving"
                and now - self._last_digest >= self.digest_every_s):
            self._last_digest = now
            shard = self._digest_rr % self.node.cfg.n_shards
            self._digest_rr += 1
            self.check_divergence([shard])

    # -- attach / bootstrap -----------------------------------------------
    def attach(self, desc) -> str:
        """Wire this follower to its owner fleet from connection
        descriptor(s) (``GET_CONNECTION_DESCRIPTOR`` replies): one for a
        single-member owner, or every member's of a clustered owner DC,
        plus, for a geo-replicated owner, the peer DCs'.  Bootstraps (a
        composition of the members' images / delta / tail), subscribes to
        every stream and closes the bootstrap-to-subscribe window with one
        more catch-up.  Returns the bootstrap mode."""
        descs = list(desc) if isinstance(desc, (list, tuple)) else [desc]
        descs = [Descriptor.from_wire(d) if isinstance(d, dict) else d
                 for d in descs]
        fleet: Dict[int, Descriptor] = {}
        for d in descs:
            fid = d.fabric_id if d.fabric_id is not None else d.dc_id
            if fid == self.fabric_id:
                raise ValueError("follower fabric id collides with a fleet "
                                 "endpoint's")
            fleet[fid] = d
        by_dc: Dict[int, List[int]] = {}
        for fid, d in fleet.items():
            by_dc.setdefault(int(d.dc_id), []).append(fid)
        for fids in by_dc.values():
            # a member's fabric id grows with its member id (member 0
            # keeps the bare dc id): sorted ids are member-id order
            fids.sort()
        if self.dc_id not in by_dc:
            raise ValueError(
                f"no descriptor for the owner DC (dc_id={self.dc_id}) in "
                "the fleet — a follower shadows that exact store")
        self.fleet = fleet
        self.fleet_by_dc = by_dc
        self.member_fids = list(by_dc[self.dc_id])
        self.owner_fid = self.member_fids[0]

        def route(origin: int, shard: int) -> int:
            # the modular layout over the origin's known members; a
            # gossip-learned shard_route (newer epochs win) takes
            # precedence in DCReplica._route
            fids = by_dc.get(origin)
            if not fids:
                return origin
            return fids[shard % len(fids)]

        self.route_query = route
        connect = getattr(self.hub, "connect_remote", None)
        for fid, d in fleet.items():
            if d.address is not None and connect is not None:
                connect(fid, d.address[0], int(d.address[1]))
        mode = self.bootstrap()
        for fid in fleet:
            self.hub.subscribe(self.fabric_id, fid, self._on_message)
        with self._boot_lock:
            self._in_heal = True
            t0 = time.monotonic()
            try:
                # the owner may checkpoint inside the bootstrap-to-
                # subscribe window: this catch-up repairs by image too
                if self._catch_up_all_repairing():
                    self._finish_cycle("delta")
                    mode = "delta"
            finally:
                self._in_heal = False
                self.boot_stats["catch_up_s"] = (
                    self.boot_stats.get("catch_up_s", 0.0)
                    + time.monotonic() - t0)
        self._post_apply_publish(force=True)
        self._send_report()
        try:
            known = self.hub.request(self.owner_fid, "peer_origins", {})
            missing = sorted({int(o) for o in known["origins"]}
                             - set(self.fleet_by_dc))
            if missing:
                log.warning(
                    "follower %s: the owner replicates origin lane(s) %s "
                    "but no descriptor for them was given — pass their "
                    "endpoints via --follower-peers, or divergence checks "
                    "on those lanes will report 'unsubscribed' forever",
                    self.name, missing)
        except (ConnectionError, OSError, RuntimeError, KeyError) as e:
            log.warning("follower %s: peer_origins query failed (%r)",
                        self.name, e)
        return mode

    def bootstrap(self) -> str:
        """One bootstrap cycle: an image install for a blank follower
        (when the owner has one), a WAL catch-up otherwise; a catch-up
        refused below the owner's compaction floor repairs by image
        re-install (mode ``delta``).  Leaves the replica ``serving``."""
        with self._boot_lock:
            self._in_heal = True
            self.boot_stats = {}
            try:
                self.restore_from_log()
                have_local = (bool(self.node.store.directory)
                              or bool(self.last_seen))
                mode = "tail"
                if not have_local:
                    metas = {fid: self._owner_image_meta(fid=fid)
                             for fid in self._image_fids()}
                    if any(m is not None for m in metas.values()):
                        self._reinstall(metas)
                        mode = "image"
                t0 = time.monotonic()
                if self._catch_up_all_repairing() and mode != "image":
                    mode = "delta"
                self.boot_stats["catch_up_s"] = time.monotonic() - t0
                self._finish_cycle(mode)
                return mode
            finally:
                self._in_heal = False

    def _finish_cycle(self, mode: str) -> None:
        self._post_apply_publish(force=True)
        self.boots += 1
        self.last_bootstrap_mode = mode
        self.node.metrics.follower_bootstrap.inc(mode=mode)
        self.state = "serving"
        log.info("follower %s: bootstrap cycle complete (mode=%s, "
                 "applied=%s)", self.name, mode,
                 [int(x) for x in self.node.store.dc_max_vc()])

    def _heal(self, mode: str) -> None:
        """Quarantine and repair: stop serving sessions, re-install the
        owner's current image, catch the tail up, resume.  A FAILED repair
        (owner unreachable mid-fetch, image retired mid-ship) leaves the
        replica ``healing`` — sessions keep redirecting — and the tick
        retries it on a short backoff; the delivery pump never crashes on
        it."""
        with self._boot_lock:
            self.state = "healing"
            self._in_heal = True
            try:
                self._reinstall()
                self._catch_up_all_repairing()
                self._finish_cycle(mode)
                self._heal_pending = None
            except Exception:
                self._heal_pending = mode
                self._heal_retry_at = time.monotonic() + self.HEAL_RETRY_S
                log.exception("follower %s: repair (mode=%s) failed; "
                              "staying quarantined and retrying from the "
                              "tick", self.name, mode)
            finally:
                self._in_heal = False

    def _catch_up_all_repairing(self, attempts: int = 3) -> bool:
        """Catch every chain up, re-installing the owner's image whenever
        the position is below the compaction floor (which can happen again
        mid-repair).  Returns True if any (re)install happened.  Caller
        holds ``_boot_lock`` with ``_in_heal`` set."""
        reinstalled = False
        last: Optional[BaseException] = None
        for _attempt in range(attempts):
            try:
                self._catch_up_all()
                return reinstalled
            except RuntimeError as e:
                if "compaction floor" not in str(e):
                    raise
                log.warning("follower %s below the owner's compaction "
                            "floor; repairing from the checkpoint image",
                            self.name)
                last = e
                self._reinstall()
                reinstalled = True
        raise last  # type: ignore[misc]

    def restore_from_log(self) -> None:
        """Reseed the CONSUMED chain positions from the local WAL and the
        installed chain floors (a follower consumes the owner's own-origin
        chain too, and never rebuilds an egress window)."""
        from antidote_tpu_torch.log import segment_index

        store = self.node.store
        if store.log is None:
            return
        segments = segment_index(store.log.dir)  # one listing a pass
        for shard in sorted(self.shards):
            counts: Dict[int, int] = {}
            for origin in range(self.node.cfg.max_dcs):
                base = store.log.chain_base(shard, origin)
                if base:
                    counts[origin] = base
            for origin, _vc, _effs in self._wal_txn_groups(
                    shard, my_effects_after=1 << 62, segments=segments):
                counts[origin] = counts.get(origin, 0) + 1
            for origin, n in counts.items():
                key = (origin, shard)
                if n > self.last_seen.get(key, 0):
                    self.last_seen[key] = n

    # -- image shipping ---------------------------------------------------
    def _image_fids(self) -> List[int]:
        """Fabric ids to ship images from: every member of the owner DC
        (their images compose the whole store); a single-member owner is
        ``[owner_fid]``."""
        return list(self.member_fids) or [self.owner_fid]

    def _owner_image_meta(self, before_id: Optional[int] = None,
                          fid: Optional[int] = None):
        body = {} if before_id is None else {"before_id": int(before_id)}
        return self.hub.request(self.owner_fid if fid is None else fid,
                                "ckpt_meta", body)

    def _fetch_file(self, meta: dict, fid: int, file: str, size: int,
                    crc: int) -> bytes:
        """Ship one published checkpoint file of endpoint ``fid`` in
        chunks over the request channel and verify its size and CRC: a
        truncated or bit-rotted ship fails loudly and never installs."""
        buf = bytearray()
        while len(buf) < size:
            req = {"id": int(meta["id"]), "off": len(buf),
                   "n": DCReplica.CKPT_SHIP_CHUNK}
            if file != "image":
                req["file"] = file
            r = self.hub.request(fid, "ckpt_fetch", req)
            data = bytes(r["data"])
            if not data:
                break
            buf.extend(data)
            if r.get("eof"):
                break
        data = bytes(buf)
        if len(data) != size or (zlib.crc32(data) & 0xFFFFFFFF) != crc:
            raise RuntimeError(
                f"shipped checkpoint {file} ckpt_{meta['id']} failed "
                f"verification ({len(data)}/{size} bytes)")
        return data

    def _fetch_image(self, meta: dict, fid: Optional[int] = None) -> dict:
        """Ship and decode one member's image (and, when the image holds
        cold keys, its cold sidecar, carried back under ``_cold_bytes``
        for the reinstall to stage)."""
        from antidote_tpu_torch.store.handoff import unpack

        fid = self.owner_fid if fid is None else fid
        data = self._fetch_file(meta, fid, "image",
                                int(meta["image_bytes"]),
                                int(meta["image_crc32"]))
        image = unpack(data)
        if meta.get("cold_bytes") and meta.get("cold_keys"):
            image["_cold_bytes"] = self._fetch_file(
                meta, fid, "cold", int(meta["cold_bytes"]),
                int(meta["cold_crc32"]))
            image["_cold_manifest"] = meta.get("cold_manifest")
        return image

    def _fetch_member_image(self, fid: int, meta: Optional[dict] = None):
        """Resolve and fetch member ``fid``'s newest verifiable image,
        falling back to the next OLDER retained image on a failed fetch
        (else re-resolving the newest).  Returns ``(image, meta)``, or
        ``(None, None)`` when the member has published nothing (a member
        that never checkpointed never compacted: the catch-up replays its
        shards' whole chains)."""
        last: Optional[BaseException] = None
        for _attempt in range(3):
            if meta is None:
                meta = self._owner_image_meta(fid=fid)
            if meta is None:
                return None, None
            try:
                return self._fetch_image(meta, fid=fid), meta
            except (RuntimeError, OSError) as e:
                log.warning("follower %s: image ckpt_%s fetch from endpoint "
                            "%d failed (%s); falling back to an older "
                            "retained image (else re-resolving the newest)",
                            self.name, meta.get("id"), fid, e)
                last = e
                try:
                    meta = self._owner_image_meta(before_id=meta.get("id"),
                                                  fid=fid)
                except (ConnectionError, OSError, RuntimeError):
                    meta = None
        raise RuntimeError(
            "checkpoint image shipping failed repeatedly") from last

    def _reinstall(self, metas: Optional[Dict[int, dict]] = None) -> None:
        """Discard the local state and install the owner fleet's newest
        images: one a member, each restricted to the shards that member
        owns (``install_image(shards=)``), which compose the whole DC
        store; a single-member owner installs one unrestricted image.

        The store is REPLACED by a fresh one on the same device and log:
        the old tables may be arbitrarily wrong (that is why we are here)
        and a reader may still pin one of their serving epochs, so nothing
        is written into them; local WAL records and local images derived
        from them must not resurrect; the epoch-id sequence continues so
        snapshot-cache stamps never repeat.  Every image is fetched BEFORE
        the wipe (a failed fetch leaves the local state untouched), and
        the install ends with a LOCAL checkpoint so the follower's own
        recovery covers the installed prefix.  ``metas``: the
        ``ckpt_meta`` replies already resolved, by fabric id."""
        from antidote_tpu_torch.log import checkpoint as ckpt

        fids = self._image_fids()
        multi = len(fids) > 1
        # (fabric id, image, restricted shards or None); per member: the
        # image's id and bytes, its ship and install seconds
        images: List[tuple] = []
        members: Dict[int, dict] = {}
        for fid in fids:
            t0 = time.monotonic()
            image, meta = self._fetch_member_image(fid,
                                                   (metas or {}).get(fid))
            if image is None:
                continue
            images.append((fid, image, meta.get("shards") if multi else None))
            members[fid] = {"id": int(meta["id"]),
                            "bytes": int(meta["image_bytes"]),
                            "ship_s": time.monotonic() - t0}
        self.boot_stats.update(
            members=members,
            ship_bytes=sum(m["bytes"] for m in members.values()),
            ship_s=sum(m["ship_s"] for m in members.values()))
        if not images:
            raise RuntimeError(
                "owner has no published checkpoint image to bootstrap from "
                "(run checkpoint-now on the owner, or size its "
                "--checkpoint-interval-s below the follower's outage)")
        node, txm = self.node, self.node.txm
        cfg = node.cfg
        staged: List[str] = []
        t0 = time.monotonic()
        with txm.commit_lock:
            old = node.store
            logm = old.log
            if logm is None:
                raise RuntimeError("a follower needs a durable log "
                                   "(log_dir) to bootstrap")
            ckpt.discard_all(logm.dir)
            logm.truncate_shards(range(cfg.n_shards))
            # adopt the OWNER's truncation epochs: ours were just bumped
            # by the truncations, and the install would drop every shard
            # as stale against them.  A member's image gives the epochs
            # of the shards it installs only
            resets: Dict[int, int] = {}
            for _fid, image, restrict in images:
                allowed = (None if restrict is None
                           else {int(s) for s in restrict})
                for k, v in (image.get("shard_resets") or {}).items():
                    if allowed is None or int(k) in allowed:
                        resets[int(k)] = int(v)
            logm.adopt_shard_resets(resets)
            store = KVStore(cfg, device=old.device, log=logm,
                            sharding=old.sharding)
            store.metrics = node.metrics
            if old.mesh is not None:
                # a placed follower stays placed across every reinstall:
                # the plane re-attaches to the fresh store, so its stable
                # time keeps running per block
                old.mesh.attach(store)
            store.snapshot_cache_cap = old.snapshot_cache_cap
            store._serving_seq = old._serving_seq
            old.drop_serving_epoch()
            node.store = store
            txm.store = store
            txm.committed_keys = {}
            txm.commit_counter = 0
            txm.epoch_lag_counter = 0
            old_cold = old.cold
            for idx, (fid, image, restrict) in enumerate(images):
                t1 = time.monotonic()
                summary = ckpt.install_image(store, txm, image,
                                             shards=restrict)
                members[fid]["install_s"] = time.monotonic() - t1
                cold_entries = summary.get("cold_directory") or []
                if not cold_entries:
                    continue
                # the member's cold keys: stage its sidecar so they stay
                # fault-able; the local rebase below re-emits them into
                # our own image, after which the staging file goes
                if store.cold is None:
                    node.enable_cold_tier(
                        old_cold.budget if old_cold else 0,
                        old_cold.fault_rate_cap if old_cold else 0.0)
                root = ckpt.checkpoint_root(logm.dir)
                os.makedirs(root, exist_ok=True)
                token = f"import.{idx}.{image['id']}"
                path = os.path.join(root, f"tmp.{os.getpid()}.{token}.bin")
                with open(path, "wb") as f:
                    f.write(image.pop("_cold_bytes"))
                staged.append(path)
                store.cold.add_source(token, path,
                                      image.pop("_cold_manifest"))
                store.cold.seed(cold_entries, token)
            if store.cold is None and old_cold is not None:
                node.enable_cold_tier(old_cold.budget,
                                      old_cold.fault_rate_cap)
            # the install stamped the OWNER's WAL floors and sequences,
            # but this WAL was just truncated: local appends mint q from 1
            # and local replay skips nothing (the LOCAL checkpoint below
            # covers the image prefix; chain_floor stays — it numbers the
            # chains and keeps the compaction-horizon guard honest)
            logm.floor_seqs[:] = 0
            logm.seqs[:] = 0
            # chain positions restart at the image's floors; anything
            # gated or pending against the old store is garbage now
            self.last_seen.clear()
            self.pending.clear()
            self.gate.clear()
            for shard in range(cfg.n_shards):
                for origin in range(cfg.max_dcs):
                    base = logm.chain_base(shard, origin)
                    if base:
                        self.last_seen[(origin, shard)] = base
            self._sync_counter_locked()
        t1 = time.monotonic()
        self.boot_stats["install_s"] = t1 - t0
        self._local_checkpoint()
        self.boot_stats["local_checkpoint_s"] = time.monotonic() - t1
        for path in staged:
            try:
                os.remove(path)  # reclaim-ok: staged import sidecar — the
                # local rebase re-emitted its rows into our own image
            except OSError:
                pass

    def _local_checkpoint(self) -> None:
        """Checkpoint the freshly installed state locally.  A running
        checkpointer captured the PRE-swap store: rebuild it against the
        new one, keeping its cadence."""
        node = self.node
        cp = node.checkpointer
        interval, retain, rebase, scrub = 0.0, 2, 8, 0.0
        if cp is not None:
            interval, retain = cp.interval_s, cp.retain
            rebase, scrub = cp.rebase_every, cp.scrub_every_s
            cp.stop()
            node.checkpointer = None
        node.start_checkpointer(interval_s=interval, retain=retain,
                                rebase_every=rebase, scrub_every_s=scrub)
        node.checkpointer.checkpoint_now(full=True)

    # -- chain catch-up -----------------------------------------------------
    def _catch_up_all(self) -> None:
        """Pull every subscribed chain's suffix — the owner's own-origin
        chains and, for a geo owner, every subscribed peer's — then drain
        the gate now (the steady-state drain runs on stream deliveries,
        which a replica mid-bootstrap has none of)."""
        origins = (sorted(self.fleet_by_dc) if self.fleet_by_dc
                   else [self.dc_id])
        for shard in sorted(self.shards):
            for origin in origins:
                key = (origin, shard)
                super()._catch_up(key, self.last_seen.get(key, 0))
        self._drain_gates()

    def _catch_up(self, key, from_opid) -> None:
        """The runtime repair hook: a catch-up refused below the owner's
        compaction floor re-bootstraps from the image (mode ``delta``)
        instead of failing on every later ping."""
        try:
            super()._catch_up(key, from_opid)
        except RuntimeError as e:
            if "compaction floor" not in str(e) or self._in_heal:
                raise
            log.warning("follower %s: catch-up for chain %s fell below the "
                        "owner's compaction floor; re-bootstrapping from "
                        "the image (%s)", self.name, key, e)
            self._heal("delta")

    # -- applied-clock-stamped serving epochs --------------------------------
    def _drain_gates(self) -> None:
        super()._drain_gates()
        self._post_apply_publish()

    def _post_apply_publish(self, force: bool = False) -> None:
        with self.node.txm.commit_lock:
            self._sync_counter_locked()
            now = time.monotonic()
            if force or now - self._last_epoch_pub >= self.EPOCH_PUBLISH_MIN_S:
                self._last_epoch_pub = now
                self.publish_applied_epoch_locked()

    def _sync_counter_locked(self) -> None:
        """Slave the (otherwise unused) commit counter to the applied own
        lane: the locked read path and the epoch clock derive the own-lane
        snapshot from it, and a follower's truth is exactly what it has
        applied."""
        self.node.txm.commit_counter = int(
            self.node.store.dc_max_vc()[self.dc_id])

    def publish_applied_epoch_locked(self) -> str:
        """The ONLY sanctioned epoch publish on a follower (the server's
        ticker routes here too): the commit counter is slaved to the
        applied clock first, so the published epoch's clock claims exactly
        what this replica has applied — an epoch stamped ahead of the
        applied clock would serve a session token it does not cover.
        Caller holds the commit lock."""
        txm = self.node.txm
        if not txm.serving_epochs:
            return "disabled"
        self._sync_counter_locked()
        return txm._publish_serving_epoch_locked()

    # -- session gate ---------------------------------------------------------
    def _gate_refused(self, msg: str, dialect: str,
                      floor_ms: int = 0) -> ReplicaLagging:
        """One typed lagging redirect: counts the refusal, bumps the
        streak and scales the retry hint with it (25..500 ms), so a parked
        fleet backs off harder the longer this replica refuses."""
        self._gate_streak += 1
        self.node.metrics.session_redirects.inc(kind="lagging",
                                                dialect=dialect)
        return ReplicaLagging(
            msg, retry_after_ms=max(floor_ms,
                                    retry_hint_ms(self._gate_streak)),
            redirect=self.owner_client_addr)

    def gate_read(self, objects, clock, deadline: Optional[float] = None,
                  dialect: str = "native") -> None:
        """Admission gate for session reads on this follower: park until
        the PER-SHARD applied clocks of every shard the read touches cover
        the token, then make sure the serving epoch cannot claim coverage
        it lacks; past the park window (or while not serving) answer a
        typed redirect — never a stale read."""
        if self.state != "serving":
            raise self._gate_refused(
                f"follower {self.name} is {self.state}", dialect,
                floor_ms=250)
        if clock is None:
            self._gate_streak = 0
            return
        cfg = self.node.cfg
        vec = np.zeros(cfg.max_dcs, np.int64)
        cl = np.asarray(clock, np.int64)[:cfg.max_dcs]
        vec[:len(cl)] = cl
        shards = sorted({key_to_shard(freeze_key(k), b, cfg.n_shards)
                         for (k, _t, b) in objects})
        end = time.monotonic() + self.park_s
        if deadline is not None:
            end = min(end, deadline)
        while True:
            store = self.node.store  # a heal may swap it mid-park
            if self.state != "serving":
                break
            if all((store.applied_vc[s] >= vec).all() for s in shards):
                self._ensure_epoch_covers(store, shards, vec, dialect)
                self._gate_streak = 0
                return
            if time.monotonic() >= end:
                break
            time.sleep(0.002)
        raise self._gate_refused(
            f"follower {self.name} applied clock is behind the session "
            f"token after a {int(self.park_s * 1e3)} ms park", dialect)

    def _ensure_epoch_covers(self, store, shards: List[int],
                             vec: np.ndarray,
                             dialect: str = "native") -> None:
        """The epoch half of the gate: the live applied clocks cover the
        token, but the FROZEN serving epoch may predate the covering
        applies while its cross-shard max clock still claims the token.
        Each epoch records the per-shard cut it was captured at; when the
        current one would claim the token without covering it on the
        target shards, publish a fresh one."""
        for _attempt in range(2):
            ep = store.serving_epoch
            if ep is None:
                return  # no epoch: reads take the (live) locked path
            if not (vec[:len(ep.vc)] <= np.asarray(ep.vc, np.int64)).all():
                return  # the epoch won't claim the token: locked path
            app = ep.applied
            if app is None or all((app[s] >= vec).all() for s in shards):
                return
            with self.node.txm.commit_lock:
                self.publish_applied_epoch_locked()
        raise self._gate_refused(
            f"follower {self.name} could not refresh its serving epoch to "
            "cover the session token (publish deferred)", dialect)

    # -- divergence detection ---------------------------------------------
    def _lag_result(self, mine_vc, owner_vc, origins) -> str:
        """Type a clock mismatch: ``unsubscribed`` when every lane this
        replica trails on is a peer lane it holds no descriptor for, else
        ``skipped`` (replication in flight, retried next sweep)."""
        behind = [lane for lane in range(self.node.cfg.max_dcs)
                  if mine_vc[lane] < owner_vc[lane]]
        if not behind:
            return "skipped"  # ahead of the owner's cut: in flight too
        origins = {int(o) for o in (origins or [])}
        unsub = [lane for lane in behind
                 if lane in origins and lane not in self.fleet_by_dc]
        if unsub and len(unsub) == len(behind):
            return "unsubscribed"
        return "skipped"

    def check_divergence(self, shards=None) -> Dict[int, str]:
        """Compare per-shard Merkle roots against the owner at EQUAL
        applied clocks.  ``skipped`` = clocks unequal (retried next
        sweep); ``unsubscribed`` = the lag is on a peer lane this follower
        has no descriptor for; ``ok`` = roots match; ``mismatch`` = silent
        corruption: the follower quarantines, walks the tree to the
        diverged leaves and heals by fetching only them, escalating to a
        full image re-bootstrap when the range heal cannot converge."""
        from antidote_tpu_torch.store.merkle import get_merkle

        m = self.node.metrics
        out: Dict[int, str] = {}
        for shard in (range(self.node.cfg.n_shards) if shards is None
                      else shards):
            shard = int(shard)
            try:
                reply = self.hub.request(self._route(self.dc_id, shard),
                                         "merkle_root", {"shard": shard})
            except (ConnectionError, OSError, RuntimeError, KeyError) as e:
                log.warning("follower %s: divergence check for shard %d "
                            "unreachable (%r)", self.name, shard, e)
                out[shard] = "unreachable"
                continue
            store = self.node.store
            with self.node.txm.commit_lock:
                mine_vc = [int(x) for x in store.applied_vc[shard]]
                if mine_vc != [int(x) for x in reply["vc"]]:
                    result = self._lag_result(mine_vc, reply["vc"],
                                              reply.get("origins"))
                    mine = None
                else:
                    mk = get_merkle(store)
                    # detection re-reads the data (corruption bypasses the
                    # incremental marks); the walk reuses these hashes
                    mk.rescan(shard)
                    mine = mk.root(shard)
                    result = "ok" if mine == reply["root"] else "mismatch"
            self.divergence_counts[result] = (
                self.divergence_counts.get(result, 0) + 1)
            m.divergence_checks.inc(result=result)
            out[shard] = result
            if result == "mismatch":
                log.error("follower %s DIVERGED from the owner on shard %d "
                          "at applied clock %s (root %s != %s): "
                          "quarantining and healing the localized range",
                          self.name, shard, mine_vc, mine, reply["root"])
                if not self._merkle_heal(shard):
                    log.error("follower %s: range heal for shard %d could "
                              "not converge; escalating to a full image "
                              "re-bootstrap", self.name, shard)
                    m.divergence_heals.inc(mode="image")
                    self._heal("image")
                    break
        return out

    def _merkle_heal(self, shard: int) -> bool:
        """Localize and repair one shard's divergence: walk the owner's
        tree against ours, fetch ONLY the diverged leaves' key states and
        install them at equal applied clocks.  Quarantines for the
        duration (sessions get typed redirects), never wipes the store.
        Returns True once the roots agree again."""
        from antidote_tpu_torch.store.merkle import get_merkle

        m = self.node.metrics
        prev_state, self.state = self.state, "healing"
        try:
            for _attempt in range(self.MERKLE_HEAL_ATTEMPTS):
                target = self._route(self.dc_id, shard)
                store = self.node.store
                mk = get_merkle(store)
                try:
                    root = self.hub.request(target, "merkle_root",
                                            {"shard": shard})
                except (ConnectionError, OSError, RuntimeError, KeyError):
                    self._on_clock_wait()
                    continue
                try:
                    with self.node.txm.commit_lock:
                        mine_vc = [int(x) for x in store.applied_vc[shard]]
                        if mine_vc != [int(x) for x in root["vc"]]:
                            pass  # clocks moved: drain and retry below
                        elif mk.root(shard) == root["root"]:
                            m.divergence_heals.inc(mode="range")
                            self._seal_heal()
                            return True
                        else:
                            leaves = self._walk_diverged(mk, shard, target,
                                                         mine_vc)
                            if leaves is not None:
                                healed = all(
                                    self._heal_leaf(mk, shard, target, leaf,
                                                    mine_vc)
                                    for leaf in leaves)
                                if healed and mk.root(shard) == root["root"]:
                                    m.divergence_heals.inc(mode="range")
                                    self._seal_heal()
                                    return True
                except (ConnectionError, OSError, RuntimeError, KeyError,
                        ColdMiss):
                    # a mid-walk owner restart or a refused cold fault-in
                    # must not crash the pump tick this check runs on:
                    # count the attempt, retry
                    log.warning("follower %s: merkle heal attempt for shard "
                                "%d failed mid-walk; retrying", self.name,
                                shard, exc_info=True)
                self._on_clock_wait()
            return False
        finally:
            if self.state == "healing":
                self.state = prev_state

    def _seal_heal(self) -> None:
        """Make a range heal durable: the corrupt bytes may sit in a
        published local image, and a delta link cannot carry the phantom
        drops — force the next stamp to be a full rebase."""
        cp = self.node.checkpointer
        if cp is not None:
            cp.force_rebase = True
            cp.request()

    def _walk_diverged(self, mk, shard: int, target: int, pin_vc):
        """Descend the tree from the root following mismatching children
        only.  Returns the diverged leaf indices, or None when the owner's
        clock moved mid-walk.  Runs under the commit lock."""
        m = self.node.metrics
        frontier = [0]
        for level in range(mk.depth()):
            nxt = []
            for idx in frontier:
                reply = self.hub.request(target, "merkle_node", {
                    "shard": shard, "level": level, "index": idx})
                if [int(x) for x in reply["vc"]] != pin_vc:
                    return None
                mine = mk.children(shard, level, idx)
                m.merkle_probe_hashes.inc(len(mine))
                for child, (a, b) in enumerate(zip(mine, reply["hashes"])):
                    if a != b:
                        nxt.append(idx * mk.fanout + child)
            frontier = nxt
            if not frontier:
                return []
        return frontier

    def _heal_leaf(self, mk, shard: int, target: int, leaf: int,
                   pin_vc) -> bool:
        """Replace one leaf's keys with the owner's states (the
        range-restricted fetch), verifying the owner served the SAME
        applied cut.  Keys held here that the owner's leaf lacks are
        phantom rows of the corruption: dropped.  Runs under the commit
        lock."""
        reply = self.hub.request(target, "merkle_leaf",
                                 {"shard": shard, "leaf": leaf})
        if [int(x) for x in reply["vc"]] != pin_vc:
            return False
        self.healed_leaves += 1
        store = self.node.store
        shipped = set()
        for key, bucket, tname, slots_ub, head_vc, heads in reply["keys"]:
            dk = (freeze_key(key), bucket)
            shipped.add(dk)
            self._install_healed_row(store, dk, tname, slots_ub, head_vc,
                                     heads)
            mk.mark(shard, dk)
        for dk in mk.leaf_keys(shard, leaf) - shipped:
            ent = store.directory.get(dk)
            if ent is not None:
                store.table(ent[0]).evict_rows(  # evict-ok: Merkle range
                    np.asarray([ent[1]]),  # heal drops a phantom row the
                    np.asarray([ent[2]]))  # owner's leaf does not hold
                store.directory.pop(dk, None)
            self._forget_cold(store, dk)
            store.drop_cached_value(dk)
            store.mark_epoch_fallback(dk)
            mk.mark(shard, dk)
        return True

    @staticmethod
    def _forget_cold(store, dk) -> None:
        cold = store.cold
        if cold is None:
            return
        ref = cold.refs.pop(dk, None)
        cold.cold_set.discard(dk)
        if ref is not None:
            s = cold.by_shard.get(ref.shard)
            if s is not None:
                s.discard(dk)

    def _install_healed_row(self, store, dk, tname: str, slots_ub: int,
                            head_vc, heads) -> None:
        """Install one shipped key state: clear any existing row (at any
        slot tier — promotion timing legitimately differs between
        replicas), then a fresh row with the head installed and one
        snapshot version seeded (a cold fault-in's discipline).  The key
        is marked for the locked path on every live serving epoch and its
        cached values dropped: the frozen epoch slots are copies that
        still hold the row's old bytes, and a pinned epoch must never
        serve them."""
        ent = store.directory.get(dk)
        if ent is None:
            self._forget_cold(store, dk)
        else:
            store.table(ent[0]).evict_rows(  # evict-ok: Merkle range heal
                np.asarray([ent[1]]),  # replaces the (possibly corrupt)
                np.asarray([ent[2]]))  # row with the owner's state
            store.directory.pop(dk, None)
        t = store.table(tname)
        shard = (int(ent[1]) if ent is not None
                 else key_to_shard(dk[0], dk[1], store.cfg.n_shards))
        store.mark_epoch_fallback(dk)
        row = t.alloc_row(shard)
        head_rows = {f: np.frombuffer(spec["b"], np.dtype(spec["dt"]))
                     .reshape(spec["sh"])[None]
                     for f, spec in heads.items()}
        t.install_rows(np.asarray([shard]), np.asarray([row]), head_rows,
                       np.asarray(head_vc, np.int32)[None])
        t.slots_ub[shard, row] = int(slots_ub)
        store.directory[dk] = (tname, shard, row)
        store.note_ckpt_dirty(dk)  # delta links must carry the heal
        store.drop_cached_value(dk)

    # -- liveness / status -------------------------------------------------
    def _send_report(self) -> None:
        if self.owner_fid is None:
            return
        body = {"name": self.name,
                "applied": [int(x) for x in self.node.store.dc_max_vc()],
                "addr": list(self.client_addr) if self.client_addr else None,
                "state": self.state, "boots": self.boots}
        # every member of the owner DC keeps a registry, so replica-status
        # answers against any of them
        fids = self.member_fids or [self.owner_fid]
        failed = 0
        for fid in fids:
            try:
                reply = self.hub.request(fid, "follower_report", body)
            except (ConnectionError, OSError, RuntimeError, KeyError):
                failed += 1
                continue
            # the member piggybacks its registry's serving-fleet snapshot
            # on the ACK: the proxy plane's health table learns membership
            # with no extra round trip
            fleet = (reply or {}).get("fleet")
            if fleet is not None and fleet != self.fleet_table:
                self.fleet_table = fleet
                self.fleet_table_v += 1
        if failed == len(fids):
            now = time.monotonic()
            if now - getattr(self, "_last_report_warn", 0.0) > 5.0:
                self._last_report_warn = now
                log.warning("follower %s: liveness report to the owner "
                            "failed; will keep retrying", self.name)

    def replica_status(self) -> dict:
        return {
            "role": "follower",
            "name": self.name,
            "state": self.state,
            "owner": (list(self.owner_client_addr)
                      if self.owner_client_addr else None),
            "applied": [int(x) for x in self.node.store.dc_max_vc()],
            "boots": self.boots,
            "last_bootstrap_mode": self.last_bootstrap_mode,
            "divergence": dict(self.divergence_counts),
            "fleet": {"owner_members": max(1, len(self.member_fids)),
                      "peer_dcs": sorted(d for d in self.fleet_by_dc
                                         if d != self.dc_id)},
        }

    def replica_admin(self, body: dict) -> dict:
        if body.get("op", "status") == "status":
            return self.replica_status()
        raise RuntimeError("replica add/remove are owner operations; this "
                           "node is a follower")


__all__ = ["FollowerReplica"]
