"""DCReplica — the inter-DC replication endpoint of a DC, or of one
member of a multi-member DC (``cluster.attach_interdc``).

  egress:  local commit → per-shard TxnMessage with (shard, origin) opid
           chaining → transport publish; a bounded window of recent
           messages serves catch-up, the WAL serves what lies below it
  ingress: message → per-(origin, shard) chain check: eq → deliver,
           gt → buffer + log catch-up query, lt → drop the duplicate
           → causal dependency gate: apply once the shard clock dominates
           the transaction's snapshot VC with the origin lane zeroed
  heartbeats: empty messages carrying the origin's safe time, so remote
           stable snapshots advance while a DC is idle

The gate drains under the transaction manager's commit lock: a remote
apply and a local commit never write the tables at once (two appliers can
lose a whole batch, and the chain-clock duplicate suppression would make
the loss permanent).  Remote effects reach the serving plane only through
the serving-epoch ticker; the replica never publishes an epoch itself.

The request channel also carries the follower and anti-entropy plane:
image shipping (``ckpt_meta``/``ckpt_fetch``, fault site ``ckpt.ship``),
shard digests and Merkle walks (``shard_digest``, ``merkle_root``,
``merkle_node``, ``merkle_leaf``), the origin lanes this endpoint carries
(``peer_origins``) and the followers' liveness reports
(``follower_report``), which feed the registry behind ``replica_status``
and ``replica_admin``.  ``adopt_shard``, ``export_shard_state`` and
``release_shard`` move a shard's chain state with the shard;
``ingress_barrier`` excludes the fabric's request handlers for a reshard.
"""

from __future__ import annotations

import collections
import contextlib
import errno
import itertools
import logging
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from antidote_tpu_torch import faults
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.interdc.messages import Descriptor, TxnMessage
from antidote_tpu_torch.obs.metrics import net_metrics
from antidote_tpu_torch.store.kv import effect_from_rec
from antidote_tpu_torch.supervise import ThreadLoop
from antidote_tpu_torch.txn.bcounter import TRANSFER_FREQ

log = logging.getLogger(__name__)


class DCReplica:
    #: recent egress messages kept in memory per shard; catch-up below the
    #: window is served from the WAL
    SENT_WINDOW = 256
    #: heartbeat cadence: at most one flush per interval on the commit
    #: path (a 1 s heartbeat timer), or every N commits, whichever first;
    #: pumps flush lazily whenever commits are pending
    HEARTBEAT_INTERVAL_S = 1.0
    HEARTBEAT_EVERY_COMMITS = 64
    #: ingress high-water marks.  GATE_HWM caps one (origin,
    #: shard) chain's causal-gate queue: past it, delivery is SHED
    #: without advancing ``last_seen`` — the chain gap that opens is
    #: exactly what the opid catch-up repairs, so pressure converts into
    #: repair traffic instead of memory.  PENDING_HWM caps the
    #: out-of-order buffer the same way (anything dropped is above
    #: ``last_seen`` and gets refetched).
    GATE_HWM = 1024
    PENDING_HWM = 256
    #: follower liveness: a follower whose last report is older than this
    #: is DOWN; one whose applied own-lane clock trails the owner's commit
    #: counter by more than REPLICA_LAG_OPS is LAGGING (both surface typed
    #: in node status and the console)
    REPLICA_DOWN_S = 5.0
    REPLICA_LAG_OPS = 1024
    #: image-shipping chunk of ckpt_fetch (one request a chunk; the
    #: ckpt.ship fault site is consulted a chunk)
    CKPT_SHIP_CHUNK = 4 << 20

    def __init__(self, node, hub, name: str = "",
                 fabric_id: Optional[int] = None, shards=None):
        self.node = node
        self.hub = hub
        self.name = name or f"dc{node.dc_id}"
        self.dc_id = node.dc_id
        #: shards this endpoint publishes and ingests: every shard for a
        #: single-node DC, a member's own for a multi-member DC (one
        #: publisher per (origin, shard)).  Any container with membership
        #: works: a cluster member passes a LIVE view of its owned set
        self.shards = (set(range(node.cfg.n_shards)) if shards is None
                       else shards)
        #: the id this endpoint registers under on the fabric: the DC id
        #: for a DC (a peer's catch-up queries go to the origin DC's own
        #: endpoint), its own id for a follower of that DC
        self.fabric_id = self.dc_id if fabric_id is None else int(fabric_id)
        #: (origin dc, shard) -> fabric id serving that chain's catch-up
        #: and anti-entropy queries (the origin DC's endpoint)
        self.route_query = lambda origin, shard: origin
        #: (origin dc, shard) -> (owner member id, ownership epoch) learned
        #: from a clustered publisher's stamps (TxnMessage.owner/oepoch):
        #: which member of the origin serves each chain.  Strictly newer
        #: epochs win, so a stale router or a replayed frame never points
        #: catch-up back at a previous owner; it takes precedence over
        #: ``route_query``
        self.shard_route: Dict[Tuple[int, int], Tuple[int, int]] = {}
        #: shard -> (member id, ownership epoch) stamped into egress
        #: messages; ``attach_interdc`` installs the member's.  None = a
        #: single-member origin, nothing to stamp
        self.owner_info = None
        #: held (AFTER the commit lock) around the gate drain's store
        #: apply: ``attach_interdc`` points it at the cluster member's
        #: lock, the one its owner reads take, so an ingress apply never
        #: writes the tables under a member's reader
        self.store_lock = threading.RLock()
        #: a clustered DC's route for a counter_b rights request to the
        #: key's owner member (``attach_interdc``); None grants locally
        self.transfer_handler = None
        p = node.cfg.n_shards
        #: egress opid chain per shard (my origin)
        self.pub_opid = np.zeros(p, np.int64)
        #: bounded recent-message window per shard (fast catch-up path);
        #: guarded by _sent_lock — the TCP fabric serves catch-up queries
        #: on server threads while the control thread appends, and deque
        #: iteration under concurrent append raises
        self.sent: List[collections.deque] = [
            collections.deque(maxlen=self.SENT_WINDOW) for _ in range(p)
        ]
        self._sent_lock = threading.Lock()
        self._commits_since_hb = 0
        self._last_hb = time.monotonic()
        #: per-shard safe time last pinged (drives the tick-path flush)
        self._published_safe: Dict[int, int] = {}
        #: ingress: last delivered opid per (origin, shard)
        self.last_seen: Dict[Tuple[int, int], int] = {}
        #: ingress: out-of-order buffer per (origin, shard)
        # bounded-by: PENDING_HWM (checked at every insert in _on_message)
        self.pending: Dict[Tuple[int, int], List[TxnMessage]] = (
            collections.defaultdict(list)
        )
        #: causal gate FIFO per (origin, shard)
        # bounded-by: GATE_HWM (shed-at-accept in _accept/_flush_pending)
        self.gate: Dict[Tuple[int, int], collections.deque] = (
            collections.defaultdict(collections.deque)
        )
        hub.register(self.fabric_id, self._on_message, self._serve_log_query)
        hub.register_request(self.fabric_id, self._serve_request)
        hub.register_tick(self.fabric_id, self.maybe_heartbeat)
        #: a drain owed by deliveries of a pump batch that is not over
        #: yet (see _drain_after_delivery); the fabric's flush settles it.
        #: The in-process hub delivers one message at a time and drains
        #: after each
        self._drain_due = False
        if hasattr(hub, "register_flush"):
            hub.register_flush(self.fabric_id, self.flush_deliveries)
        node.txm.commit_listeners.append(self._on_local_commit)
        node.txm.on_clock_wait = self._on_clock_wait
        node.txm.remote_ingest = True
        # bounded-counter rights requests ride the query channel; the
        # batched twin sends one tick's asks to one granter in one trip
        node.txm.bcounters.request_transfer = self._request_transfer
        node.txm.bcounters.request_transfer_many = self._request_transfer_many
        #: ingress odometers: catch-up queries sent and the deepest the
        #: causal gate has been
        self.catchups = 0
        self.max_gate_depth = 0
        #: follower registry: name -> {addr, applied, state, at (monotonic
        #: of the last report), boots}; reports arrive on the request
        #: channel (follower_report), operators pre-register and
        #: decommission through the wire's REPLICA_ADMIN
        self.followers: Dict[str, dict] = {}
        #: decommissioned follower names whose reports are refused
        self._removed_followers: set = set()
        self._followers_lock = threading.Lock()

    # ------------------------------------------------------------------
    # restart: chain positions from the WAL
    # ------------------------------------------------------------------
    def _wal_txn_groups(self, shard: int, my_effects_after: int = 0,
                        snap: "Tuple[int, int] | None" = None,
                        segments: "Dict[int, List[str]] | None" = None):
        """One shard's WAL records grouped into transactions, in apply
        order.  Grouping key is the (origin, commit VC) IDENTITY over the
        whole replay — commit VCs are unique per origin — never record
        adjacency: handoff/reshard re-chaining interleaves a multi-shard
        txn's records, and adjacency grouping would split such a txn and
        desync the opid chain.

        Returns [[origin, vc_tuple, effects]].  Effects are materialized
        only for my own chain and only for groups whose chain opid
        exceeds ``my_effects_after`` — a catch-up query slightly below
        the window must not pay effect decoding for the whole chain
        prefix it will discard.  My-chain opids are numbered from the
        log's CHAIN FLOOR: a checkpoint-truncated WAL holds
        only the tail groups, and the floor records how many own-origin
        groups the image covers, so numbering stays continuous across
        compaction.  ``segments``: one listing of the log directory
        (``log.segment_index``) for a pass over many shards."""
        store = self.node.store
        index: Dict[Tuple[int, tuple], int] = {}
        out: List[list] = []
        my_opid: Dict[int, int] = {}
        # (base, floor) snapshot under the commit lock: a checkpoint
        # publish updates both together there, and a torn read would
        # shift this response's opid numbering against the chain.
        # Callers that ALSO number against the base (catch-up serving)
        # pass their own snapshot so both sides agree.
        if snap is None:
            with self.node.txm.commit_lock:
                snap = (store.log.chain_base(shard, self.dc_id),
                        int(store.log.floor_seqs[shard]))
        my_count, floor = snap
        for rec in store.log.replay_shard(shard, floor=floor,
                                          index=segments):
            ident = (int(rec["o"]), tuple(int(x) for x in rec["vc"]))
            at = index.get(ident)
            if at is None:
                index[ident] = at = len(out)
                out.append([ident[0], ident[1], []])
                if ident[0] == self.dc_id:
                    my_count += 1
                    my_opid[at] = my_count
            if ident[0] == self.dc_id and my_opid[at] > my_effects_after:
                out[at][2].append(effect_from_rec(rec))
        return out

    def _chain_message(self, shard: int, opid: int, vc: tuple,
                       effects: list) -> TxnMessage:
        """My-origin chain message #opid (1-based) for a shard."""
        cvc = np.asarray(vc, np.int32)
        svc = cvc.copy()
        svc[self.dc_id] = 0
        ow, oe = self._owner_stamp(shard)
        return TxnMessage(
            origin=self.dc_id, shard=shard, prev_opid=opid - 1,
            last_opid=opid, commit_vc=cvc, snapshot_vc=svc,
            effects=effects, timestamp=int(cvc[self.dc_id]),
            owner=ow, oepoch=oe,
        )

    def _owner_stamp(self, shard: int) -> tuple:
        """(owner member id, ownership epoch) for egress gossip, or (None,
        None) for a single-member origin."""
        if self.owner_info is None:
            return (None, None)
        ow, oe = self.owner_info(shard)
        return (int(ow), int(oe))

    def restore_from_log(self) -> None:
        """Rebuild replication chains after a node restart from its WAL.

        Egress: my own-origin records regroup into per-shard TxnMessages
        with fresh sequential opids, so peers' catch-up queries keep
        working.  Ingress: each remote (origin, shard) chain's
        delivered-txn count IS the publisher's opid (one opid per txn per
        shard, delivered exactly once in order), so ``last_seen`` reseeds
        from the log.  Both resume at ``LogManager.chain_base`` (the
        checkpoint's chain floor), and catch-up below it is refused.
        """
        from antidote_tpu_torch.log import segment_index

        store = self.node.store
        if store.log is None:
            raise RuntimeError("restore_from_log needs a node with a WAL")
        segments = segment_index(store.log.dir)  # one listing a pass
        for shard in sorted(self.shards):
            # chain positions resume at the checkpoint's chain floor
            # (groups the image covers but the truncated WAL no longer
            # holds) + whatever the tail replays on top; with no
            # checkpoint the floors are zero and this is the classic
            # whole-log reseed
            counts: Dict[int, int] = collections.defaultdict(int)
            for origin in range(self.node.cfg.max_dcs):
                base = store.log.chain_base(shard, origin)
                if base:
                    counts[origin] = base
            self.pub_opid[shard] = store.log.chain_base(shard, self.dc_id)
            for origin, vc, effs in self._wal_txn_groups(
                    shard, segments=segments):
                counts[origin] += 1
                if origin != self.dc_id:
                    continue
                self.pub_opid[shard] += 1
                with self._sent_lock:
                    self.sent[shard].append(self._chain_message(
                        shard, int(self.pub_opid[shard]), vc, effs
                    ))
            for origin, n in counts.items():
                if origin != self.dc_id:
                    self.last_seen[(origin, shard)] = n

    # ------------------------------------------------------------------
    # live shard moves: a shard's replication chain state travels WITH
    # the shard, so the new owner continues the (origin, shard) opid chain
    # where the old one stopped — subscribers never see a chain restart
    # ------------------------------------------------------------------
    def adopt_shard(self, shard: int, extras=None) -> None:
        """Install a moved-in shard's chain state from the handoff
        package's extras: the egress opid and the recent sent window
        (catch-up keeps serving through the move) and the remote chains'
        ingress positions (gap detection resumes where the old owner
        stood).  Without extras, the egress opid is recounted from the
        imported WAL as :meth:`restore_from_log` does — resuming at 0
        would make every subscriber drop the new owner's first commits as
        chain duplicates — and the ingress positions restart at 0, which
        costs only an idempotent catch-up replay.  Monotone: a duplicate
        delivery never rewinds a chain that advanced since."""
        shard = int(shard)
        extras = (extras or {}).get("interdc", {})
        if "pub_opid" in extras:
            opid = int(extras["pub_opid"])
        elif self.node.store.log is not None:
            opid = self.node.store.log.chain_base(shard, self.dc_id) + sum(
                1 for origin, _vc, _effs in self._wal_txn_groups(
                    shard, my_effects_after=1 << 62)
                if origin == self.dc_id)
        else:
            opid = 0
        if opid > int(self.pub_opid[shard]):
            self.pub_opid[shard] = opid
            with self._sent_lock:
                self.sent[shard].clear()
                for data in extras.get("sent", ()):
                    self.sent[shard].append(
                        TxnMessage.from_bytes(bytes(data)))
        for o, v in extras.get("last_seen", ()):
            key = (int(o), shard)
            if int(v) > self.last_seen.get(key, 0):
                self.last_seen[key] = int(v)
        self._published_safe.pop(shard, None)

    def export_shard_state(self, shard: int) -> dict:
        """The extras counterpart of :meth:`adopt_shard`, taken under the
        commit lock so it is one cut with the handoff package.  The
        exported ingress position is the APPLIED-safe one: a dep-blocked
        transaction can sit in the causal gate without its effects in the
        package's table slice, so each chain's position is clamped below
        its earliest queued transaction (the new owner's catch-up
        refetches and re-gates the suffix; ``pending`` sits above a gap
        and is refetched anyway)."""
        shard = int(shard)
        with self.node.txm.commit_lock:
            with self._sent_lock:
                sent = [m.to_bytes() for m in self.sent[shard]]
            last_seen = []
            for (o, s), v in self.last_seen.items():
                if s != shard:
                    continue
                safe = int(v)
                for m in self.gate.get((o, s), ()):
                    if not m.is_ping:
                        safe = min(safe, int(m.prev_opid))
                        break  # the gate is FIFO in chain order
                last_seen.append([int(o), safe])
            return {"interdc": {"pub_opid": int(self.pub_opid[shard]),
                                "sent": sent, "last_seen": last_seen}}

    def release_shard(self, shard: int) -> None:
        """Clear a relinquished shard's chain state at the OLD owner: its
        egress chain now lives at the importer, and queued remote
        transactions must never apply to the dropped slice (the new owner
        replays them through catch-up)."""
        shard = int(shard)
        with self.node.txm.commit_lock:
            self.pub_opid[shard] = 0
            with self._sent_lock:
                self.sent[shard].clear()
            self._published_safe.pop(shard, None)
            for table in (self.last_seen, self.pending, self.gate):
                for key in [k for k in table if k[1] == shard]:
                    del table[key]

    def ingress_barrier(self):
        """A lock excluding the fabric's request handlers (a bounded-
        counter grant commits on one) for the duration of a reshard; the
        in-process hub delivers on the caller's thread and needs none."""
        eps = getattr(self.hub, "endpoints", None)
        if eps and self.fabric_id in eps:
            return eps[self.fabric_id].lock
        return contextlib.nullcontext()

    def descriptor(self) -> Descriptor:
        """Shareable connection descriptor.  Carries the
        transport endpoint when the hub has one (TcpFabric), so another
        process/deployment can subscribe from the descriptor alone."""
        addr = None
        # exported descriptors carry the ADVERTISED address (public_host
        # substituted); local dialing keeps using the bind address
        address_of = getattr(self.hub, "advertised_of",
                             getattr(self.hub, "address_of", None))
        if address_of is not None:
            try:
                addr = tuple(address_of(self.fabric_id))
            except KeyError:
                addr = None
        return Descriptor(self.dc_id, self.name, self.node.cfg.n_shards,
                          addr, self.fabric_id)

    def observe_dc(self, remote: "DCReplica") -> None:
        """Subscribe to a remote DC's txn stream (in-process peers)."""
        self.hub.subscribe(self.fabric_id, remote.fabric_id, self._on_message)

    def observe_descriptor(self, desc) -> None:
        """Subscribe from a wire descriptor (dict or Descriptor) — the
        cross-process form of :meth:`observe_dc`.  Learns the
        remote endpoint, opens the stream subscription; the opid-gap
        catch-up machinery fetches anything missed before connecting."""
        if isinstance(desc, dict):
            desc = Descriptor.from_wire(desc)
        remote_fid = desc.fabric_id if desc.fabric_id is not None else desc.dc_id
        if remote_fid == self.fabric_id:
            return  # self-descriptor: nothing to subscribe to
        if desc.address is not None:
            connect = getattr(self.hub, "connect_remote", None)
            if connect is not None:
                connect(remote_fid, desc.address[0], int(desc.address[1]))
        self.hub.subscribe(self.fabric_id, remote_fid, self._on_message)

    @staticmethod
    def connect_all(replicas: List["DCReplica"]) -> None:
        for a in replicas:
            for b in replicas:
                if a is not b:
                    a.observe_dc(b)

    # ------------------------------------------------------------------
    # egress
    # ------------------------------------------------------------------
    def _on_local_commit(self, effects, commit_vc, origin) -> None:
        by_shard: Dict[int, list] = {}
        for eff in effects:
            _, shard, _ = self.node.store.locate(eff.key, eff.type_name,
                                                 eff.bucket)
            by_shard.setdefault(shard, []).append(eff)
        snapshot_vc = np.asarray(commit_vc, np.int32).copy()
        snapshot_vc[origin] = 0
        for shard, effs in by_shard.items():
            prev = int(self.pub_opid[shard])
            self.pub_opid[shard] += 1
            ow, oe = self._owner_stamp(shard)
            msg = TxnMessage(
                origin=origin, shard=shard, prev_opid=prev,
                last_opid=prev + 1,
                commit_vc=np.asarray(commit_vc, np.int32),
                snapshot_vc=snapshot_vc, effects=effs,
                timestamp=int(commit_vc[origin]),
                owner=ow, oepoch=oe,
            )
            with self._sent_lock:
                self.sent[shard].append(msg)
            self.hub.publish(self.fabric_id, msg.to_bytes())
        # idle-shard safe times are NOT broadcast per commit — that would
        # be O(n_shards) fabric messages per txn.  They flush on the
        # interval/commit-count thresholds below and at every fabric pump
        # (maybe_heartbeat via the tick)
        self._drain_if_gated()
        self._commits_since_hb += 1
        if self.node.txm._publishing_group:
            # mid-group publish: later group members' counters are
            # already minted but their messages are not on the stream
            # yet, so a safe-time ping here would make subscribers skip
            # them as duplicates (lost effects).  The tick-path flush
            # (maybe_heartbeat at every pump) or the next commit sends
            # the deferred ping instead.
            return
        if (self._commits_since_hb >= self.HEARTBEAT_EVERY_COMMITS
                or time.monotonic() - self._last_hb
                >= self.HEARTBEAT_INTERVAL_S):
            self.heartbeat()

    def maybe_heartbeat(self) -> None:
        """Flush deferred safe-time pings iff something new is worth
        publishing: commits since the last flush, or a shard's safe time
        advancing past what was last pinged.  Tick path: called at every
        fabric pump, so a peer blocked on my
        lane is unblocked promptly without any per-commit broadcast."""
        if self._commits_since_hb > 0:
            self.heartbeat()
            return
        if self.owner_info is None:
            safe = self.safe_time(0)
            if any(safe > self._published_safe.get(s, 0)
                   for s in self.shards):
                self.heartbeat()
                return
        elif any(int(self.safe_time(s)) > self._published_safe.get(s, 0)
                 for s in list(self.shards)):
            # a cluster member's safe times move with the DC sequencer
            # even when this member saw no commit
            self.heartbeat()
            return
        # LIVENESS: re-ping on the wall-clock interval even with nothing
        # new — a LOST final ping (or txn) is only ever detected by a
        # later message on the same chain, and this re-send provides it
        if time.monotonic() - self._last_hb >= self.HEARTBEAT_INTERVAL_S:
            self.heartbeat()

    def safe_time(self, shard: int) -> int:
        """Largest own-lane ts such that no future local commit on
        ``shard`` can carry a smaller one — AND every commit at or below
        it has already been published to the stream (taken under the
        manager's commit lock: a counter read mid-commit would mint a
        ping that outruns its own txn on the wire, and the subscriber's
        chain-clock duplicate suppression would drop the txn as
        already-applied).  A single-node DC mints commits from one
        monotone counter applied synchronously, so the counter itself is
        safe for every shard.  A cluster member's endpoint replaces this
        with its shard's own (``cluster.attach_interdc``)."""
        txm = self.node.txm
        with txm.commit_lock:
            return txm.commit_counter

    def heartbeat(self, exclude=frozenset()) -> None:
        """Broadcast per-shard safe times.  Also
        advances MY lane on idle local shards: without it, a remote txn
        whose snapshot depends on my lane would gate forever on shards I
        never wrote to."""
        self._commits_since_hb = 0
        self._last_hb = time.monotonic()
        vc = self.node.store.applied_vc
        # stamp under the commit lock, once for every shard: the safe time
        # and the chain positions must belong to one cut (and a busy
        # commit plane is waited for once, not once a shard).  A cluster
        # member's safe time is its shard's own (the sequencer frontier,
        # or the chain frontier while a txn is prepared there)
        with self.node.txm.commit_lock:
            one = (int(self.safe_time(0)) if self.owner_info is None
                   else None)
            pings = {}
            for shard in sorted(self.shards):
                safe = one if one is not None else int(self.safe_time(shard))
                vc[shard, self.dc_id] = max(vc[shard, self.dc_id], safe)
                self._published_safe[shard] = safe
                pings[shard] = (int(self.pub_opid[shard]), safe,
                                self._owner_stamp(shard))
        for shard, (prev, safe, (ow, oe)) in pings.items():
            if shard in exclude:
                continue
            msg = TxnMessage(
                origin=self.dc_id, shard=shard, prev_opid=prev,
                last_opid=prev,  # pings do not advance the chain
                commit_vc=np.zeros(self.node.cfg.max_dcs, np.int32),
                snapshot_vc=np.zeros(self.node.cfg.max_dcs, np.int32),
                effects=[], timestamp=safe, owner=ow, oepoch=oe,
            )
            self.hub.publish(self.fabric_id, msg.to_bytes())
        self._drain_if_gated()

    def _drain_after_delivery(self) -> None:
        """Drain the gate after a delivery — or, while the fabric's pump
        holds more frames of the same batch, owe it to the batch's end
        (``flush_deliveries``): one device apply then covers every
        transaction the batch made ready, where a drain a message paid
        one apply a message.  Caller holds the commit lock."""
        if getattr(self.hub, "batching", lambda: False)():
            self._drain_due = True
            return
        self._drain_due = False
        self._drain_gates()

    def flush_deliveries(self) -> None:
        """The fabric's pump batch ended: settle an owed drain."""
        with self.node.txm.commit_lock:
            if self._drain_due:
                self._drain_due = False
                self._drain_gates()

    def _drain_if_gated(self) -> None:
        """My own lane just rose (a local commit on its shards, a
        heartbeat on the others): a remote transaction gated on it — its
        snapshot saw my commits — can apply now, not only when the next
        message of some chain arrives."""
        with self.node.txm.commit_lock:
            if any(self.gate.values()):
                self._drain_gates()

    def _serve_request(self, kind: str, payload) -> object:
        """Generic query-channel dispatch."""
        if kind == "bcounter":
            return self._grant_one(payload)
        if kind == "bcounter_many":
            # batched rights requests: each entry keeps the single-key
            # grant discipline — the SAME fault site keyed per key (a
            # plan can starve one key of the batch), the same granter
            # counter.  Per-
            # entry faults fail THAT entry (grant 0), not the frame:
            # the requester's at-most-once throttle already covers each
            # (key, target) independently, so a half-served batch must
            # not un-serve the grants that committed.
            out = []
            for key, bucket, amount in payload["entries"]:
                try:
                    out.append(self._grant_one({
                        "key": key, "bucket": bucket, "amount": amount,
                        "to_dc": payload["to_dc"],
                    }))
                except (ConnectionError, OSError):
                    out.append(0)
            return out
        if kind == "check_up":
            return True
        handler = self._FOLLOWER_PLANE.get(kind)
        if handler is not None:
            return handler(self, payload)
        raise ValueError(f"unknown request kind {kind!r}")

    def _grant_one(self, payload) -> int:
        """Serve ONE rights request at granter entry: consult the
        ``bcounter.transfer`` fault site (keyed per key, so chaos plans
        can starve/stretch grant traffic — wide enough to SIGKILL a
        granter mid-transfer), then commit the grant locally."""
        d = faults.hit("bcounter.transfer",
                        key=(payload.get("key"), self.dc_id))
        if d is not None:
            if d.action == "delay" and d.arg:
                time.sleep(float(d.arg))
            elif d.action == "drop":
                raise ConnectionError(
                    "injected fault: bcounter.transfer dropped")
            elif d.action in ("error", "io_error", "enospc"):
                raise OSError(
                    errno.EIO,
                    f"injected fault: bcounter.transfer "
                    f"{payload.get('key')!r}")
        if self.transfer_handler is not None:
            # clustered DC: route to the key's owner member, whose
            # coordinator commits the grant through the sequencer
            grant = self.transfer_handler(payload)
        else:
            grant = self.node.txm.bcounters.process_transfer(
                self.node.txm, payload["key"], payload["bucket"],
                payload["amount"], payload["to_dc"])
        m = self.node.metrics
        if grant and m is not None:
            m.escrow_grants.inc(role="granter")
        return grant

    def _request_transfer_many(self, dc: int, entries) -> None:
        """Batched rights requests: every shortfall key asking the same
        granter DC this tick rides ONE query-channel round trip
        (``bcounter_many``) instead of one RPC per key — a flash-sale
        tick with hundreds of starved keys was paying hundreds of
        sequential cross-DC round trips before any grant landed.

        The at-most-once discipline is unchanged and PER ENTRY: the
        requester's grace throttle was set before the send for each
        (key, target) pair, so a reply-phase failure of the batch holds
        every member's throttle — no blind resend of any entry inside
        the grace window, exactly as if each had been its own RPC."""
        m = self.node.metrics
        t0 = time.monotonic()
        try:
            grants = self.hub.request(
                dc, "bcounter_many",
                {"entries": [[k, b, a] for k, b, a in entries],
                 "to_dc": self.dc_id},
            )
        except Exception as e:
            log.warning(
                "bcounter batched transfer request to dc%d (%d keys) "
                "failed typed (%s); grace throttle holds — no blind "
                "resend", dc, len(entries), e)
            if m is not None:
                m.escrow_grants.inc(role="failed")
            return
        if m is not None:
            m.escrow_transfer_seconds.observe(time.monotonic() - t0)
            for g in (grants or ()):
                if g:
                    m.escrow_grants.inc(role="requester")

    def _request_transfer(self, dc: int, key, bucket: str,
                          amount: int) -> None:
        """One rights request over the AT-MOST-ONCE query channel.

        Grants are non-idempotent commits on the granter, so a reply-
        phase failure (timeout after the request left the socket,
        connection lost before the reply) means the grant MAY have
        committed remotely — this surfaces typed in the log + metrics
        and relies on the grace throttle (set BEFORE the send in
        transfer_periodic) instead of blind-resending; the next tick
        past the grace window re-reads state, so an arrived grant
        retires the shortfall instead of being asked for twice."""
        m = self.node.metrics
        t0 = time.monotonic()
        try:
            grant = self.hub.request(
                dc, "bcounter", {"key": key, "bucket": bucket,
                                 "amount": amount, "to_dc": self.dc_id},
            )
        except Exception as e:
            log.warning(
                "bcounter transfer request to dc%d for %r failed typed "
                "(%s); grace throttle holds — no blind resend",
                dc, key, e)
            if m is not None:
                m.escrow_grants.inc(role="failed")
            return
        if m is not None:
            m.escrow_transfer_seconds.observe(time.monotonic() - t0)
            if grant:
                m.escrow_grants.inc(role="requester")

    def bcounter_tick(self) -> int:
        """Run one round of the rights-transfer loop."""
        ty = get_type("counter_b")
        txm = self.node.txm

        def read_state(key, bucket):
            # under the commit lock: the write plane grows the device
            # tables in place while committing
            with txm.commit_lock:
                return txm.store.read_states(
                    [(key, "counter_b", bucket)], txm.store.dc_max_vc()
                )[0]

        sent = txm.bcounters.transfer_periodic(read_state, ty)
        m = self.node.metrics
        if m is not None:
            m.escrow_shortfall.set(txm.bcounters.shortfall())
        return sent

    def start_escrow_loop(self, base_s: float = None,
                          seed: int = None) -> ThreadLoop:
        """The supervised background rights-transfer loop — the same
        ThreadLoop discipline as the pump loop: crashes end the
        thread loudly and the supervisor restarts it.  The interval is
        JITTERED around the base while demand is queued (two DCs'
        loops must not phase-lock their grant traffic) and backs off
        up to 5x base when the queue is empty, snapping back on the
        first refusal."""
        base = float(base_s) if base_s is not None else TRANSFER_FREQ
        rng = random.Random(seed if seed is not None else self.dc_id)
        loop = ThreadLoop(lambda: None, interval_s=base,
                          name=f"escrow-pump-{self.name}")

        def tick():
            self.bcounter_tick()
            if self.node.txm.bcounters.pending:
                loop.interval_s = base * (0.5 + rng.random())
            else:
                loop.interval_s = min(loop.interval_s * 1.5 + 1e-3,
                                      base * 5.0)

        loop.fn = tick
        return loop.start()

    def _serve_log_query(self, shard: int, origin: int,
                         from_opid: int) -> List[bytes]:
        """Serve a catch-up read of my own chain.

        The bounded in-memory window serves recent requests; anything
        below it is regrouped from the durable log, so catch-up
        correctness survives both long uptimes (the window caps memory)
        and restarts.  A request below the log's chain base (a prefix a
        checkpoint truncated) is refused."""
        if origin != self.dc_id:
            raise ValueError(f"dc{self.dc_id} serves only its own chain, "
                             f"not origin {origin}")
        with self._sent_lock:
            window = self.sent[shard]
            covered = not window or window[0].prev_opid <= from_opid
            if covered:
                return [
                    m.to_bytes() for m in window if m.last_opid > from_opid
                ]
            window_start = window[0].prev_opid
        if self.node.store.log is not None:
            wlog = self.node.store.log
            with self.node.txm.commit_lock:
                base = wlog.chain_base(shard, self.dc_id)
                floor_snap = (base, int(wlog.floor_seqs[shard]))
            if from_opid < base:
                # the requested prefix was checkpoint-compacted away:
                # serving from base would leave an unfillable gap at the
                # subscriber (its chain check only accepts contiguous
                # opids), so refuse loudly — the operator remedy is a
                # fresh subscription / state transfer, and the
                # prevention is retention sized above the slowest peer
                raise RuntimeError(
                    f"catch-up from opid {from_opid} on shard {shard} is "
                    f"below the compaction floor ({base}): that chain "
                    "prefix was checkpoint-truncated and only lives in "
                    "the checkpoint image"
                )
            out = []
            opid = base
            for origin_g, vc, effs in self._wal_txn_groups(
                shard, my_effects_after=from_opid, snap=floor_snap
            ):
                if origin_g != self.dc_id:
                    continue
                opid += 1
                if opid > from_opid:
                    out.append(
                        self._chain_message(shard, opid, vc, effs).to_bytes()
                    )
            return out
        raise RuntimeError(
            f"catch-up from opid {from_opid} on shard {shard} is below the "
            f"in-memory window (starts at {window_start}) and no WAL "
            "is attached to serve it"
        )

    def _ingest_own_origin(self) -> bool:
        """Whether this endpoint applies messages of its OWN dc lane:
        False for a DC (it minted that chain), True for a follower, whose
        whole data plane is the owner's own-origin chain."""
        return False

    def _route(self, origin: int, shard: int) -> int:
        """Fabric id serving a chain's catch-up and anti-entropy queries:
        the newest gossiped owner when one is known, else the configured
        fallback router."""
        ent = self.shard_route.get((origin, shard))
        if ent is not None:
            return (int(ent[0]) << 16) | int(origin)  # cluster.fabric_id_of
        return self.route_query(origin, shard)

    def _learn_route(self, msg: TxnMessage) -> None:
        """Adopt a clustered publisher's shard-ownership gossip: a strictly
        newer epoch re-points this chain's catch-up at the new owner
        (replayed or stale frames never resurrect a previous one)."""
        if msg.owner is None:
            return
        rk = (msg.origin, msg.shard)
        oe = int(msg.oepoch or 0)
        cur = self.shard_route.get(rk)
        if cur is not None and oe <= cur[1]:
            return
        self.shard_route[rk] = (int(msg.owner), oe)
        if cur is not None and cur[0] != int(msg.owner):
            net_metrics().route_updates.inc()
            log.info("chain %s: catch-up re-routed to member %d (epoch %d, "
                     "was member %d)", rk, msg.owner, oe, cur[0])

    # ------------------------------------------------------------------
    # follower plane: image shipping, digests, the liveness registry —
    # all on the request channel
    # ------------------------------------------------------------------
    def _serve_ckpt_meta(self, payload=None) -> "dict | None":
        """The newest published image's shippable metadata, or None (no
        durable log, or nothing published: the follower catches the whole
        chain up from the WAL).  ``before_id`` restricts to strictly older
        retained images.  The reply carries the shards this endpoint owns
        (a follower composing several owners' images installs each
        restricted to them).

        A shard import sealed by a delta link is in no full image yet, so
        no image this endpoint could ship covers every shard it owns: a
        request for the newest publishes a full image first (without a WAL
        rotation).  The JAX member's imports are full images already."""
        from antidote_tpu_torch.log import checkpoint as ckpt

        wlog = self.node.store.log
        if wlog is None:
            return None
        before = (payload or {}).get("before_id")
        cp = self.node.checkpointer
        if before is None and cp is not None and cp.sealed_links:
            cp.checkpoint_now(full=True, rotate=False)
        meta = ckpt.latest_image_meta(wlog.dir, before_id=before)
        if meta is not None:
            meta["shards"] = sorted(int(s) for s in self.shards)
        return meta

    def _serve_ckpt_fetch(self, payload) -> dict:
        """One chunk of a published image (``{id, off, n[, file]}`` ->
        ``{data, eof}``; ``file="cold"`` ships the cold sidecar).  The
        ``ckpt.ship`` fault site is consulted a chunk: delay holds the
        shipper mid-image, error/io_error/enospc fail the fetch typed."""
        from antidote_tpu_torch.log import checkpoint as ckpt

        wlog = self.node.store.log
        if wlog is None:
            raise RuntimeError("ckpt_fetch on a node without a durable log")
        ckpt_id = int(payload["id"])
        d = faults.hit("ckpt.ship", key=f"ckpt_{ckpt_id}")
        if d is not None:
            if d.action == "delay" and d.arg:
                time.sleep(float(d.arg))
            elif d.action in ("error", "io_error", "enospc"):
                raise OSError(errno.EIO,
                              f"injected fault: ckpt.ship ckpt_{ckpt_id}")
        path = (ckpt.cold_path(wlog.dir, ckpt_id)
                if payload.get("file") == "cold"
                else ckpt.image_path(wlog.dir, ckpt_id))
        off = int(payload.get("off", 0))
        n = int(payload.get("n", self.CKPT_SHIP_CHUNK))
        with open(path, "rb") as f:
            size = f.seek(0, 2)
            f.seek(off)
            data = f.read(max(0, n))
        return {"data": data, "eof": off + len(data) >= size}

    def _serve_shard_digest(self, payload) -> dict:
        """One shard's (applied clock, content digest), one cut under the
        commit lock: the comparison a follower checks its own against."""
        from antidote_tpu_torch.store.kv import shard_digest

        shard = int(payload["shard"])
        store = self.node.store
        with self.node.txm.commit_lock:
            return {"vc": [int(x) for x in store.applied_vc[shard]],
                    "digest": shard_digest(store, shard),
                    "origins": self._known_origins()}

    def _known_origins(self) -> List[int]:
        """Origin lanes this endpoint carries chains for: a follower's
        evidence for typing a lag ``unsubscribed`` (it was never given
        that peer's descriptor) instead of ``skipped``."""
        return sorted({o for (o, _s) in self.last_seen} | {self.dc_id})

    def _serve_peer_origins(self, _payload=None) -> dict:
        return {"origins": self._known_origins()}

    def _serve_merkle_root(self, payload) -> dict:
        """One shard's Merkle root at its applied clock (re-read from the
        data: corruption bypasses the incremental marks)."""
        from antidote_tpu_torch.store.merkle import get_merkle

        shard = int(payload["shard"])
        store = self.node.store
        with self.node.txm.commit_lock:
            mk = get_merkle(store)
            mk.rescan(shard)
            return {"vc": [int(x) for x in store.applied_vc[shard]],
                    "root": mk.root(shard), "leaves": mk.n_leaves,
                    "fanout": mk.fanout, "depth": mk.depth(),
                    "origins": self._known_origins()}

    def _serve_merkle_node(self, payload) -> dict:
        """Child hashes of one tree node — a walk step."""
        from antidote_tpu_torch.store.merkle import get_merkle

        shard = int(payload["shard"])
        store = self.node.store
        with self.node.txm.commit_lock:
            mk = get_merkle(store)
            return {"vc": [int(x) for x in store.applied_vc[shard]],
                    "hashes": mk.children(shard, int(payload["level"]),
                                          int(payload["index"]))}

    def _serve_merkle_leaf(self, payload) -> dict:
        """One leaf's raw key states (head fields, head clock, slot
        bound), one cut with the returned clock: the range-restricted
        heal fetch.  A cold key faults in without admission."""
        from antidote_tpu_torch.store.merkle import get_merkle

        shard = int(payload["shard"])
        leaf = int(payload["leaf"])
        store = self.node.store
        with self.node.txm.commit_lock:
            mk = get_merkle(store)
            rows = []
            for key, bucket in sorted(mk.leaf_keys(shard, leaf), key=repr):
                ent = store.directory.get((key, bucket))
                if (ent is None and store.cold is not None
                        and store.cold.is_cold((key, bucket))):
                    ent = store.cold.fault_in((key, bucket), admit=False)
                if ent is None:
                    continue
                tname, _s, row = ent
                t = store.table(tname)
                heads = {}
                a = t.shard_arrays(shard)
                for f, x in a["head"].items():
                    arr = x[row].cpu().numpy()
                    heads[f] = {"b": arr.tobytes(), "dt": str(arr.dtype),
                                "sh": list(arr.shape)}
                rows.append([
                    key, bucket, tname, int(t.slots_ub[shard, row]),
                    [int(v) for v in a["head_vc"][row].cpu().numpy()],
                    heads,
                ])
            return {"vc": [int(x) for x in store.applied_vc[shard]],
                    "keys": rows}

    def _serve_follower_report(self, payload) -> dict:
        """A follower's periodic liveness and lag report.  Decommissioned
        names are refused (``accepted: False``).  The ACK carries the
        registry's serving-fleet snapshot, which feeds the followers'
        proxy planes."""
        name = str(payload.get("name", ""))
        with self._followers_lock:
            if name in self._removed_followers:
                return {"accepted": False}
            ent = self.followers.setdefault(name, {"boots": 0})
            ent["applied"] = [int(x) for x in payload.get("applied") or []]
            ent["addr"] = payload.get("addr")
            ent["state"] = payload.get("state", "serving")
            ent["boots"] = int(payload.get("boots", ent.get("boots", 0)))
            ent["at"] = time.monotonic()
            n_followers = len(self.followers)
        m = self.node.metrics
        if m is not None:
            m.fleet_followers.set(n_followers)
            if len(ent["applied"]) > self.dc_id:
                m.follower_lag.set(
                    max(0, int(self.node.txm.commit_counter)
                        - int(ent["applied"][self.dc_id])), follower=name)
        fleet = {fname: {"addr": fent.get("addr"), "state": fent["state"]}
                 for fname, fent in self.replica_status()["followers"].items()}
        return {"accepted": True,
                "commit_counter": int(self.node.txm.commit_counter),
                "fleet": fleet}

    _FOLLOWER_PLANE = {
        "ckpt_meta": _serve_ckpt_meta,
        "ckpt_fetch": _serve_ckpt_fetch,
        "shard_digest": _serve_shard_digest,
        "merkle_root": _serve_merkle_root,
        "merkle_node": _serve_merkle_node,
        "merkle_leaf": _serve_merkle_leaf,
        "peer_origins": _serve_peer_origins,
        "follower_report": _serve_follower_report,
    }

    def replica_status(self) -> dict:
        """The node-status / console ``replica-status`` block of an owner:
        every known follower with its typed liveness (ok | lagging | down
        | its self-reported bootstrapping/healing) and applied-VC lag."""
        now = time.monotonic()
        counter = int(self.node.txm.commit_counter)
        out: Dict[str, dict] = {}
        with self._followers_lock:
            snap = {k: dict(v) for k, v in self.followers.items()}
        for name, ent in sorted(snap.items()):
            at = ent.get("at", 0.0)
            applied = ent.get("applied") or []
            lag = (max(0, counter - int(applied[self.dc_id]))
                   if len(applied) > self.dc_id else None)
            if not at or now - at > self.REPLICA_DOWN_S:
                state = "down"
            elif ent.get("state") not in (None, "serving"):
                state = str(ent["state"])
            elif lag is not None and lag > self.REPLICA_LAG_OPS:
                state = "lagging"
            else:
                state = "ok"
            out[name] = {"state": state, "lag": lag,
                         "age_s": round(now - at, 2) if at else None,
                         "addr": ent.get("addr"),
                         "boots": ent.get("boots", 0)}
        return {"role": "owner", "followers": out}

    def replica_admin(self, body: dict) -> dict:
        """The wire's REPLICA_ADMIN op: ``add`` pre-registers an expected
        follower (``down`` until its first report; clears a remove's
        tombstone), ``remove`` decommissions a name (its reports are
        refused from then on), ``status`` is :meth:`replica_status`."""
        op = body.get("op", "status")
        if op == "status":
            return self.replica_status()
        name = str(body["name"])
        if op == "add":
            with self._followers_lock:
                self._removed_followers.discard(name)
                ent = self.followers.setdefault(name, {"boots": 0})
                if body.get("addr"):
                    ent["addr"] = list(body["addr"])
            return self.replica_status()
        if op == "remove":
            with self._followers_lock:
                self.followers.pop(name, None)
                self._removed_followers.add(name)
            m = self.node.metrics
            if m is not None:
                m.follower_lag.set(0, follower=name)
            return self.replica_status()
        raise ValueError(f"unknown replica admin op {op!r}")

    # ------------------------------------------------------------------
    # ingress
    # ------------------------------------------------------------------
    def _on_message(self, data: bytes) -> None:
        try:
            msg = TxnMessage.from_bytes(data)
        except Exception:
            # a frame corrupted in transit (truncation, bit rot) must not
            # kill the pump: discard it — if it carried a txn, the chain
            # gap surfaces on the next message and catch-up replays it
            # from the publisher's log
            net_metrics().corrupt_frames.inc()
            log.warning("discarding undecodable inter-DC frame (%d bytes)",
                        len(data))
            return
        if msg.origin == self.dc_id and not self._ingest_own_origin():
            return  # a DC never applies its own origin's chain
        # INGRESS STATE DISCIPLINE: last_seen/pending/gate mutate only
        # under the node's commit lock — the same lock the gate drain
        # holds.  The catch-up NETWORK call stays outside the lock (a
        # dead endpoint's 30 s timeout must not freeze local commits)
        lock = self.node.txm.commit_lock
        key = (msg.origin, msg.shard)
        catchup_from = None
        with lock:
            self._learn_route(msg)
            if msg.shard not in self.shards:
                return  # another member's chain, or another shard count
            last = self.last_seen.get(key, 0)
            if msg.is_ping:
                if msg.last_opid <= last:
                    self._queue(msg)
                    self._drain_after_delivery()
                    return
                # the ping reveals lost txns: catch up before trusting it
                catchup_from = last
            elif msg.prev_opid == last:
                self._accept(key, msg)
                self._drain_after_delivery()
                return
            elif msg.prev_opid > last:
                # gap: buffer and query the origin's log reader (the
                # catch-up's pending flush integrates this message).
                # BOUNDED: past the high-water mark the message is shed —
                # it sits above last_seen, so the still-open gap makes
                # catch-up refetch it once the buffer drains
                if len(self.pending[key]) >= self.PENDING_HWM:
                    self._shed_ingress(key, "pending")
                else:
                    self.pending[key].append(msg)
                catchup_from = last
            else:
                return  # duplicate — drop
        self._catch_up(key, catchup_from)
        with lock:
            # a ping the catch-up could NOT cover (severed query channel)
            # is dropped: trusting it would advance the chain clock past
            # the undelivered txns, and the duplicate suppression would
            # then drop their eventual replay forever — a permanently lost
            # effect.  The publisher re-sends on its 1 s cadence and the
            # next ping retries the catch-up.  What the catch-up did
            # deliver drains either way
            if msg.is_ping and msg.last_opid <= self.last_seen.get(key, 0):
                self._queue(msg)
            self._drain_after_delivery()

    def _catch_up(self, key, from_opid) -> None:
        origin, shard = key
        target = self._route(origin, shard)
        self.catchups += 1
        try:
            msgs = self.hub.query_log(target, shard, origin, from_opid)
        except (ConnectionError, OSError, KeyError) as e:
            # the query channel is down (partition, endpoint restart) or
            # the origin's address is not known yet (KeyError): keep the
            # out-of-order buffer and return — every later ping on this
            # chain re-reveals the gap and retries the catch-up, so
            # healing the link heals the chain with no operator action
            net_metrics().catchup_failures.inc()
            log.warning("catch-up query to dc%s for chain %s failed (%r); "
                        "will retry on the next chain message", target, key, e)
            return
        # the replayed suffix lands under the commit lock (same ingress
        # discipline as _on_message)
        with self.node.txm.commit_lock:
            for data in msgs:
                m = TxnMessage.from_bytes(data)
                if not m.is_ping and m.prev_opid == self.last_seen.get(key, 0):
                    self._accept(key, m)
            self._flush_pending(key)

    def _shed_ingress(self, key, where: str) -> None:
        """Count + (throttled) log one shed ingress message.  The shed
        NEVER advances ``last_seen``, so it is indistinguishable from a
        lossy link: the publisher's next chain message re-reveals the
        gap and catch-up replays the loss once pressure drains — shed is
        deferral into the repair path, not data loss.  The publisher
        sees the pressure as catch-up queries against its log (plus the
        antidote_interdc_ingress_shed_total counter here)."""
        net_metrics().ingress_shed.inc()
        now = time.monotonic()
        if now - getattr(self, "_last_shed_log", 0.0) > 5.0:
            self._last_shed_log = now
            log.warning("ingress gate for chain %s past its %s high-water "
                        "mark; shedding (catch-up will refill)", key, where)

    def _gate_full(self, key) -> bool:
        q = self.gate.get(key)
        return q is not None and len(q) >= self.GATE_HWM

    def _accept(self, key, msg: TxnMessage) -> None:
        # BOUNDED gate: a chain at its high-water mark (dep-blocked head
        # under a delivery storm) sheds instead of queueing — last_seen
        # stays put, so the skipped suffix returns through catch-up
        if self._gate_full(key):
            self._shed_ingress(key, "gate")
            return
        self.last_seen[key] = msg.last_opid
        self._queue(msg)
        self._flush_pending(key)

    def _flush_pending(self, key) -> None:
        """Drain the out-of-order buffer: one pass over the buffer sorted
        by chain position.  Stops flushing (keeps the tail buffered) once the gate
        hits its high-water mark — same bound as _accept."""
        buf = self.pending.get(key)
        if not buf:
            return
        buf.sort(key=lambda m: m.prev_opid)
        keep: List[TxnMessage] = []
        for m in buf:
            last = self.last_seen.get(key, 0)
            if m.prev_opid == last and not self._gate_full(key):
                self.last_seen[key] = m.last_opid
                self._queue(m)
            elif m.last_opid > last:
                keep.append(m)  # still a gap ahead of it (or gate full)
            # else: duplicate — drop
        self.pending[key] = keep

    # ------------------------------------------------------------------
    # causal dependency gate
    # ------------------------------------------------------------------
    def _queue(self, msg: TxnMessage) -> None:
        q = self.gate[(msg.origin, msg.shard)]
        if msg.is_ping and q and q[-1].is_ping:
            # coalesce trailing pings: per-chain ping timestamps are
            # monotone and the drain only reads the LAST one, so a
            # blocked head accumulates at most one parked ping instead
            # of one per heartbeat interval
            q[-1] = msg
            return
        q.append(msg)
        # gate-depth gauge refresh is the drain path's job (_drain_gates
        # runs on every delivery pump): an O(#chains) sum per enqueued
        # message would tax the hot ingress path for a gauge

    def _drain_gates(self) -> None:
        """Apply every gated txn whose dependencies are satisfied; loop
        until no queue makes progress.

        Ready txns are BATCHED into one ``apply_effects`` device launch
        per drain round: readiness cascades are evaluated against a
        simulated clock copy, and the real partition clocks only advance
        after the whole batch applied (the stable snapshot must never
        dominate unapplied ops — including ping advances, which are
        deferred the same way so a ping queued behind a txn cannot claim
        its ts early).

        SERIALIZATION: the whole drain runs under the transaction
        manager's commit lock.  A server-thread commit writes the same
        device tables in place through ``KVStore.apply_effect_groups``;
        two concurrent appliers can silently drop a whole batch, and the
        chain-clock duplicate suppression then makes the loss permanent.
        The lock is reentrant and taken in the same order everywhere
        (endpoint handler lock → commit lock), so the remote-ingress
        plane and the local-commit plane are mutually exclusive
        writers."""
        with self.node.txm.commit_lock:
            depth = sum(map(len, self.gate.values()))
            self.max_gate_depth = max(self.max_gate_depth, depth)
            self._drain_gates_locked()
            if self.node.metrics is not None:
                self.node.metrics.interdc_gate_depth.set(
                    sum(map(len, self.gate.values())))

    def _drain_gates_locked(self) -> None:
        store = self.node.store
        while True:
            sim = store.applied_vc.copy()
            batch: list = []  # ready txns, dependency-respecting order
            advances: list = []  # (shard, origin, ts) after apply
            taken: Dict[tuple, int] = {}  # gate key -> msgs consumed
            progressed = True
            while progressed:
                progressed = False
                for gk, q in self.gate.items():
                    if not q:
                        # an idle chain (a subscriber of thousands of
                        # shards keeps one a shard): nothing to examine
                        continue
                    origin, shard = gk
                    if shard not in self.shards:
                        # a cluster member's shard mid-move: it stays at
                        # the export's cut (cluster._LiveShards)
                        continue
                    i = taken.get(gk, 0)
                    for msg in itertools.islice(q, i, None):
                        if msg.is_ping:
                            ts = msg.timestamp
                            if sim[shard, origin] < ts:
                                sim[shard, origin] = ts
                                advances.append((shard, origin, ts))
                            i += 1
                            progressed = True
                            continue
                        # duplicate suppression: per-chain origin
                        # timestamps are strictly monotone, and the chain
                        # clock only advances past ts once the txn
                        # carrying ts was applied (or a catch-up replayed
                        # it) — so ts ≤ clock ⟺ already applied.  Makes
                        # re-delivery (restart catch-up from a
                        # conservative opid) idempotent.
                        ts = int(msg.commit_vc[origin])
                        if ts <= int(sim[shard, origin]):
                            i += 1
                            progressed = True
                            continue
                        local = sim[shard].copy()
                        local[origin] = 0
                        if not (local >= msg.snapshot_vc).all():
                            # dep-blocked head.  Pings QUEUED BEHIND it
                            # may still advance this lane up to ts-1:
                            # everything below the head's ts is applied
                            # (chain order), so duplicate suppression
                            # survives — and without this, two chains
                            # can deadlock after message loss (each
                            # head's unblocking ping trapped behind the
                            # other's blocked head)
                            # per-chain ping timestamps are monotone:
                            # the LAST ping in the queue carries the max
                            best = 0
                            for m2 in reversed(q):
                                if m2.is_ping:
                                    best = m2.timestamp
                                    break
                            adv = min(best, ts - 1)
                            if adv > sim[shard, origin]:
                                sim[shard, origin] = adv
                                advances.append((shard, origin, adv))
                                progressed = True
                            break
                        batch.append((msg, origin))
                        sim[shard, origin] = ts
                        advances.append((shard, origin, ts))
                        i += 1
                        progressed = True
                    taken[gk] = i
            if not batch and not advances:
                # still consume the examined prefix (duplicates, stale
                # pings): leaving it queued forever is a leak AND makes
                # every later drain rescan it
                for gk, n in taken.items():
                    q = self.gate[gk]
                    for _ in range(n):
                        q.popleft()
                return
            if batch:
                effects, vcs, origins = [], [], []
                for msg, origin in batch:
                    vc = np.asarray(msg.commit_vc, np.int32)
                    for eff in msg.effects:
                        effects.append(eff)
                        vcs.append(vc)
                        origins.append(origin)
                # messages are consumed from the queues only AFTER the
                # apply succeeds — an exception leaves everything queued
                # for the next drain instead of silently dropping txns
                with self.store_lock:
                    store.apply_effects(effects, vcs, origins)
            for gk, n in taken.items():
                q = self.gate[gk]
                for _ in range(n):
                    q.popleft()
            for shard, origin, ts in advances:
                self._advance_clock(shard, origin, ts)

    def _advance_clock(self, shard: int, origin: int, ts: int) -> None:
        vc = self.node.store.applied_vc
        if vc[shard, origin] < ts:
            vc[shard, origin] = ts

    # ------------------------------------------------------------------
    def _on_clock_wait(self) -> None:
        """Called by the txn manager while waiting for the stable snapshot
        to catch up to a client clock.  An idle pump sleeps a moment so
        the spin paces real time: peers' safe times advance on their
        heartbeat timers, not on our loop iterations.  The pump is bounded
        (a few hundred frames, a 2 ms wait) so the waiting reader
        re-checks its clock often while a busy fabric keeps delivering."""
        if self.hub.pump(max_rounds=256, timeout=0.002) == 0:
            time.sleep(0.002)
