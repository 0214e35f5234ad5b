"""ClusterMember — one node of a multi-member DC, in memory.

A DC's shards spread over N members joined by the intra-DC RPC:

  * shard ownership: member ``i`` of ``n`` owns shards {s : s % n == i};
    the explicit ``shard_map`` (shard -> owner) is the routing truth;
  * member 0 is the DC's commit SEQUENCER: it mints the DC-wide own-lane
    commit timestamps, returning per-shard previous-ts chains so owners
    apply own-DC commits gap-free in ts order;
  * owners certify at prepare (first-committer-wins per key + a prepared
    lock) and apply at commit;
  * stable time: each member gossips its owned shards' applied clock rows;
    the DC stable snapshot is the entry-wise min over the assembled
    (shards x D) matrix via ``stable_min_of`` — with the cluster's shard
    count at or past its threshold, the ``stable_min`` kernel on the
    member's device.

Coordinators (``cluster/coordinator.py``) run on any member and drive these
handlers over the RPC.

Not in this slice: the durable prepare log and recovery (with the
durability slice), coordinator-crash takeover, live join/leave and shard
handoff, the escrow-counter transfer handler, and metrics.
"""

from __future__ import annotations

import threading
import time
import zlib
from collections import OrderedDict
from typing import Any, Dict, Tuple

import numpy as np

from antidote_tpu_torch.api.node import AntidoteNode
from antidote_tpu_torch.cluster.rpc import RpcClient, RpcServer, eff_from_wire
from antidote_tpu_torch.config import AntidoteConfig
from antidote_tpu_torch.crdt import get_type
from antidote_tpu_torch.store.kv import (Effect, freeze_key, key_to_shard,
                                         stable_min_of)
from antidote_tpu_torch.txn.bcounter import NoPermissionsError
from antidote_tpu_torch.txn.manager import host_state, overlay_effects

#: the RPC surface of a member in this slice
HANDLERS = ("m_read_values", "m_downstream", "m_prepare", "m_commit",
            "m_abort", "m_clocks", "m_seq", "m_seq_counter", "m_ready",
            "m_shard_map", "m_membership")

#: how long a read or downstream waits for its shard's own lane to reach
#: the requested timestamp before it gives up (s)
READ_SAFE_TIMEOUT_S = 30.0


def owned_shards(cfg: AntidoteConfig, member_id: int, n_members: int):
    """The modular layout: member ``i`` owns the shards ``s % n == i``."""
    return [s for s in range(cfg.n_shards) if s % n_members == member_id]


def overlay_digest(seed: int, wires) -> int:
    """Rolling, process-independent fingerprint of an effect-wire
    sequence (incremental overlay shipping)."""
    d = seed
    for w in wires:
        d = zlib.crc32(w["eb"], zlib.crc32(w["a"], d)) & 0xFFFFFFFF
    return d


class Sequencer:
    """DC-wide commit-timestamp authority (member 0).

    ``next_ts(shards)`` -> (ts, {shard: previous ts issued for it}) — the
    per-shard chain lets owners apply own-DC commits contiguously."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counter = 0
        self.last_ts: Dict[int, int] = {}

    def next_ts(self, shards) -> Tuple[int, Dict[int, int]]:
        with self._lock:
            self.counter += 1
            ts = self.counter
            prev = {}
            for s in shards:
                s = int(s)
                prev[s] = self.last_ts.get(s, 0)
                self.last_ts[s] = ts
            return ts, prev


class ClusterMember:
    """One member of a DC.  Its node's tables live on ``device`` ("cuda"
    by default; "cpu" only when asked)."""

    def __init__(self, cfg: AntidoteConfig, dc_id: int, member_id: int,
                 n_members: int, log_dir=None, host: str = "127.0.0.1",
                 recover: bool = False, device="cuda"):
        if log_dir is not None or recover:
            raise NotImplementedError(
                "log_dir/recover: the prepare log and recovery are not "
                "ported yet (in-memory only)")
        self.cfg = cfg
        self.dc_id = dc_id
        self.member_id = member_id
        self.n_members = n_members
        self.shards = set(owned_shards(cfg, member_id, n_members))
        #: shard -> owning member id (the riak_core ring analogue)
        self.shard_map: Dict[int, int] = {
            s: s % n_members for s in range(cfg.n_shards)}
        self._owned = np.zeros(cfg.n_shards, bool)
        self._owned[sorted(self.shards)] = True
        self.node = AntidoteNode(cfg, dc_id=dc_id, device=device)
        self._coordinator = None
        #: sequencer lives on member 0 only
        self.seq = Sequencer() if member_id == 0 else None
        #: peer member_id -> RpcClient
        self.peers: Dict[int, RpcClient] = {}
        #: peer member_id -> last gossiped [n_shards, D] clock rows (only
        #: the peer's owned rows are meaningful)
        self.peer_clocks: Dict[int, np.ndarray] = {}
        self._lock = threading.RLock()
        #: (key, bucket) -> txid holding the prepare lock
        self.prepared: Dict[Tuple[Any, str], int] = {}
        #: txid -> (effects, [keys], snapshot own lane) between prepare
        #: and commit
        self.staged: Dict[int, Tuple[list, list, int]] = {}
        #: (key, bucket) -> own-lane ts of its last commit (cert table)
        self.last_commit: Dict[Tuple[Any, str], int] = {}
        #: per owned shard: last own-DC ts applied (chain frontier)
        self.applied_ts: Dict[int, int] = {s: 0 for s in self.shards}
        #: per shard: {prev_ts: (ts, effects, commit_vc)} awaiting chain
        self.chain_wait: Dict[int, Dict[int, tuple]] = {
            s: {} for s in self.shards}
        #: (key, bucket, tentative VC bytes, txid) -> (folded state
        #: tensors, n, prefix digest) — incremental overlay folds
        self._overlay_fold_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._seq_cache = 0
        self._seq_cache_at = 0.0
        self.rpc = RpcServer(host=host)
        for name in HANDLERS:
            self.rpc.register(name, getattr(self, name))

    @property
    def _xlock(self):
        """Cross-plane writer lock (the node's reentrant commit lock),
        taken before ``self._lock`` by every path that mutates the store:
        the store tolerates exactly one writer at a time."""
        return self.node.txm.commit_lock

    def coordinator(self):
        """This member's own transaction coordinator (lazily built to
        avoid an import cycle)."""
        if self._coordinator is None:
            from antidote_tpu_torch.cluster.coordinator import ClusterNode

            self._coordinator = ClusterNode(self)
        return self._coordinator

    # ------------------------------------------------------------------
    def connect(self, member_id: int, host: str, port: int) -> None:
        self.peers[member_id] = RpcClient(host, port)

    @property
    def address(self) -> Tuple[str, int]:
        return (self.rpc.host, self.rpc.port)

    # ------------------------------------------------------------------
    # owner-side handlers (RPC server threads; the member lock serializes
    # them against each other)
    # ------------------------------------------------------------------
    def m_ready(self) -> bool:
        return True

    def m_seq(self, shards) -> Tuple[int, Dict[int, int]]:
        return self.seq_ts(shards)

    def seq_ts(self, shards) -> Tuple[int, Dict[int, int]]:
        """Issue a commit ts + per-shard prev chain (sequencer only)."""
        assert self.seq is not None, "not the sequencer"
        ts, prev = self.seq.next_ts(shards)
        return ts, {int(k): int(v) for k, v in prev.items()}

    def m_seq_counter(self) -> int:
        assert self.seq is not None, "not the sequencer"
        return self.seq.counter

    def m_clocks(self) -> list:
        """My owned shards' applied clock rows: [(shard, [D])]."""
        self.advance_idle_shards()
        vc = self.node.store.applied_vc
        return [(s, [int(x) for x in vc[s]]) for s in sorted(self.shards)]

    def invalidate_seq_cache(self) -> None:
        """Force the next ``_seq_counter`` to refresh from the sequencer
        (after a certification abort: the conflict proves the frontier
        moved past our cached view)."""
        self._seq_cache_at = 0.0

    def _seq_counter(self) -> int:
        """The DC timestamp frontier (locally for the sequencer, a cached
        RPC otherwise)."""
        if self.seq is not None:
            return self.seq.counter
        now = time.monotonic()
        if now - self._seq_cache_at > 0.2 and 0 in self.peers:
            try:
                self._seq_cache = int(self.peers[0].call("m_seq_counter"))
                self._seq_cache_at = now
            except (OSError, RuntimeError):
                pass  # stale is safe: the frontier only lags
        return self._seq_cache

    def advance_idle_shards(self) -> None:
        """Own-lane safe-time advance for idle owned shards: with no
        prepared or chain-buffered txn touching a shard, every issued ts
        is already applied there (prepare precedes sequencing), so its
        own-lane clock may claim the sequencer frontier — what lets the
        aggregated stable snapshot progress past untouched shards."""
        ctr = self._seq_counter()
        if ctr == 0:
            return
        with self._lock:
            idle = self._owned.copy()
            idle[[s for s, w in self.chain_wait.items() if w]] = False
            idle[[key_to_shard(k, b, self.cfg.n_shards)
                  for k, b in self.prepared]] = False
            col = self.node.store.applied_vc[:, self.dc_id]
            np.maximum(col, ctr, out=col, where=idle)

    def m_read_values(self, objects, read_vc, overlays=None) -> list:
        """Owner read: values at ``read_vc`` for my keys.

        ``overlays`` (aligned with ``objects``; None entries = plain)
        carries a coordinator txn's own pending effects for each object —
        read-your-writes in open cluster transactions: the owner reads the
        base state at the snapshot, folds the txn's effects eagerly and
        returns the overlaid value.

        Before reading, each involved shard waits until its own-lane clock
        can safely claim ``read_vc[own]`` — an in-flight commit below that
        ts would otherwise make the snapshot observe a txn partially."""
        objs = [(freeze_key(k), t, b) for k, t, b in objects]
        read_vc = np.asarray(read_vc, np.int32)
        want = int(read_vc[self.dc_id])
        shards = {key_to_shard(k, b, self.cfg.n_shards) for k, _, b in objs}
        for s in shards:
            self._check_owner(s)
            self._wait_read_safe(s, want)
        with self._lock:
            if not overlays or not any(overlays):
                vals = self.node.store.read_values(objs, read_vc)
            else:
                vals = self._read_values_overlaid(objs, read_vc, overlays)
        return [_wire_value(v) for v in vals]

    def _overlay_state(self, key, type_name, bucket, state, read_vc,
                       overlay) -> dict:
        """Fold a txn's pending effect wires onto a host state (the
        overlay at the owner: ``overlay_effects``, on the store's device
        through the type's batched apply, or on the host for a type with
        a host twin).  The tentative own-lane stamp is read_vc[own]+1 =
        snapshot+1 — the value m_commit's restamp rewrites to the real
        commit ts.

        ``overlay`` is the incremental form ``{"n": prefix_len, "d":
        prefix_digest, "effs": [new wires], "nd": digest after, "txid"}``
        — the coordinator ships only the effects the owner has not folded
        yet.  An owner without the cached prefix raises
        ``overlay-resync`` and the coordinator re-sends in full."""
        store = self.node.store
        ent = store.locate(key, type_name, bucket, create=False)
        cfg_k = store.table(ent[0]).cfg if ent else self.cfg
        tvc = np.asarray(read_vc, np.int32).copy()
        tvc[self.dc_id] += 1
        if not isinstance(overlay, dict):
            raise TypeError("overlay must be the incremental dict form "
                            "{'n', 'd', 'effs', 'nd'}")
        ck = (key, bucket, tvc.tobytes(), int(overlay.get("txid", 0)))
        cached = self._overlay_fold_cache.get(ck)
        n0, d0 = int(overlay["n"]), int(overlay["d"])
        wires, nd = overlay["effs"], int(overlay["nd"])
        n_total = n0 + len(wires)
        if cached is not None and cached[1] == n_total and cached[2] == nd:
            # idempotent re-send (the same object twice in one batch)
            return host_state(cached[0])
        if n0 != 0:
            if cached is None or cached[1:3] != (n0, d0):
                raise RuntimeError(
                    "overlay-resync: owner has no matching overlay prefix "
                    f"for {key!r} (have "
                    f"{None if cached is None else cached[1:3]}, want "
                    f"({n0}, {d0}))")
            state = cached[0]
        effs = [eff_from_wire(w) for w in wires]
        for eff in effs:
            # the txn's blob payloads travel with its effects; the owner
            # interns them before value decode resolves
            for h, data in eff.blob_refs:
                store.blobs.intern_bytes(h, data)
        state = overlay_effects(get_type(type_name), cfg_k, state, effs, tvc,
                                self.dc_id, store.device, fresh=n0 == 0)
        self._overlay_fold_cache[ck] = (state, n_total, nd)
        while len(self._overlay_fold_cache) > 512:
            self._overlay_fold_cache.popitem(last=False)
        return host_state(state)

    def _read_values_overlaid(self, objs, read_vc, overlays) -> list:
        store = self.node.store
        plain = [i for i, ov in enumerate(overlays) if not ov]
        laid = [i for i, ov in enumerate(overlays) if ov]
        vals: list = [None] * len(objs)
        if plain:
            pv = store.read_values([objs[i] for i in plain], read_vc)
            for i, v in zip(plain, pv):
                vals[i] = v
        states = store.read_states([objs[i] for i in laid], read_vc)
        for i, state in zip(laid, states):
            key, type_name, bucket = objs[i]
            state = self._overlay_state(key, type_name, bucket, state,
                                        read_vc, overlays[i])
            ent = store.locate(key, type_name, bucket, create=False)
            cfg_k = store.table(ent[0]).cfg if ent else self.cfg
            vals[i] = get_type(type_name).value(state, store.blobs, cfg_k)
        return vals

    def _wait_read_safe(self, shard: int, want_ts: int) -> None:
        # the requested own-lane ts was derived from the sequencer
        # (stable/session/frontier), so it IS a frontier lower bound:
        # adopt it instead of waiting out the cache-refresh window
        if self.seq is None and want_ts > self._seq_cache:
            self._seq_cache = want_ts
        deadline = time.monotonic() + READ_SAFE_TIMEOUT_S
        while True:
            self.advance_idle_shards()
            if int(self.node.store.applied_vc[shard, self.dc_id]) >= want_ts:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"shard {shard} own-lane stuck below {want_ts} "
                    "(in-flight commit never arrived?)")
            time.sleep(0.001)

    def m_downstream(self, key, type_name, bucket, op, read_vc,
                     overlay=None) -> list:
        """Generate downstream effects for a state-dependent op at my
        replica of the key, with the coordinator txn's pending effects for
        it overlaid (observed-remove must see same-txn adds).  A
        counter_b decrement or transfer runs its escrow guard here, against
        the owner's replica: the lane must be this DC's and hold the
        rights; first-committer-wins certification closes the race
        between the check and the commit."""
        from antidote_tpu_torch.cluster.rpc import eff_to_wire

        key = freeze_key(key)
        op = _freeze_op(op)
        ty = get_type(type_name)
        read_vc = np.asarray(read_vc, np.int32)
        # same in-flight-commit gate as m_read_values: a downstream
        # generated from a snapshot missing a committed-but-unapplied op
        # would break observed-remove semantics
        shard = key_to_shard(key, bucket, self.cfg.n_shards)
        self._check_owner(shard)
        self._wait_read_safe(shard, int(read_vc[self.dc_id]))
        with self._lock:
            store = self.node.store
            state = store.read_states([(key, type_name, bucket)], read_vc)[0]
            if overlay:
                state = self._overlay_state(key, type_name, bucket, state,
                                            read_vc, overlay)
            if type_name == "counter_b" and op[0] in ("decrement",
                                                      "transfer"):
                self._escrow_guard(ty, state, key, bucket, op)
            ent = store.locate(key, type_name, bucket, create=False)
            cfg_k = store.table(ent[0]).cfg if ent else self.cfg
            effs = ty.downstream(op, state, store.blobs, cfg_k)
        return [eff_to_wire(Effect(key, type_name, bucket, a, b, refs))
                for a, b, refs in effs]

    def _escrow_guard(self, ty, state, key, bucket, op) -> None:
        """Refuse (as an ``abort:`` error) a counter_b spend on another
        DC's lane or past the rights this lane holds."""
        amount, src_lane = op[1][0], op[1][-1]
        if src_lane != self.dc_id:
            raise RuntimeError(
                f"abort: counter_b {op[0]} must spend this DC's lane "
                f"{self.dc_id}, not {src_lane}")
        bcm = self.node.txm.bcounters
        try:
            bcm.check_decrement(ty, state, key, bucket, amount)
        except NoPermissionsError as e:
            if op[0] == "transfer":
                bcm.satisfied(key, bucket)
            raise RuntimeError(f"abort: {e}") from e
        bcm.satisfied(key, bucket)

    def _check_owner(self, shard: int) -> None:
        if shard not in self.shards:
            raise RuntimeError(
                f"not_owner: shard {shard} owner "
                f"{self.shard_map.get(shard, -1)} "
                f"(asked member {self.member_id})")

    def m_shard_map(self) -> dict:
        """{shard: [owner, epoch]} — the JAX package's form, whose epochs
        count completed moves; ownership never moves in this slice, so
        every epoch is 0."""
        return {int(s): [int(m), 0] for s, m in self.shard_map.items()}

    def m_membership(self) -> dict:
        """The member-id bound and the live member ids this member knows
        (self + wired peers)."""
        with self._lock:
            return {"n_members": int(self.n_members),
                    "members": sorted({self.member_id, *self.peers})}

    def m_prepare(self, txid: int, effs_wire: list, snap_own: int) -> bool:
        """Certify + lock this txn's keys on my shards (first-committer-
        wins against ``snap_own``).  Raises on conflict (the RPC surfaces
        it as an error reply)."""
        effects = [eff_from_wire(w) for w in effs_wire]
        with self._lock:
            for eff in effects:
                self._check_owner(
                    key_to_shard(eff.key, eff.bucket, self.cfg.n_shards))
                dk = (eff.key, eff.bucket)
                holder = self.prepared.get(dk)
                if holder is not None and holder != txid:
                    raise RuntimeError(
                        f"abort: key {eff.key!r} prepared by txn {holder}")
                if self.last_commit.get(dk, 0) > snap_own:
                    raise RuntimeError(
                        f"abort: certification conflict on {eff.key!r}")
                # type-binding check HERE, not at apply: a key bound to a
                # different CRDT type must fail as a clean prepare abort
                try:
                    self.node.store.locate(eff.key, eff.type_name,
                                           eff.bucket, create=False)
                except TypeError as e:
                    raise RuntimeError(f"abort: {e}") from e
            keys = []
            for eff in effects:
                dk = (eff.key, eff.bucket)
                self.prepared[dk] = txid
                keys.append(dk)
            self.staged[txid] = (effects, keys, int(snap_own))
        return True

    def m_abort(self, txid: int) -> bool:
        with self._lock:
            staged = self.staged.pop(txid, None)
            if staged is not None:
                for dk in staged[1]:
                    if self.prepared.get(dk) == txid:
                        del self.prepared[dk]
        return True

    def m_commit(self, txid: int, commit_vc, prev_by_shard) -> bool:
        """Apply a staged txn at ts = commit_vc[own]; my shards' slices
        apply in ts order via the sequencer's per-shard chain."""
        commit_vc = np.asarray(commit_vc, np.int32)
        ts = int(commit_vc[self.dc_id])
        # an applied commit proves the sequencer reached ts: advance the
        # cached frontier so idle-shard advance need not wait for it
        if self.seq is None and ts > self._seq_cache:
            self._seq_cache = ts
        with self._xlock, self._lock:
            effects, keys, snap_own = self.staged.pop(txid, (None, None, 0))
            if effects is None:
                return True  # duplicate commit
            # rewrite tentative own dots (overlay stamp = snapshot+1) to
            # the real commit ts
            if snap_own + 1 != ts:
                for eff in effects:
                    eff.eff_a, eff.eff_b = get_type(
                        eff.type_name).restamp_own_dots(
                            self.cfg, eff.eff_a, eff.eff_b, self.dc_id,
                            snap_own + 1, ts)
            by_shard: Dict[int, list] = {}
            for eff in effects:
                _, shard, _ = self.node.store.locate(eff.key, eff.type_name,
                                                     eff.bucket)
                by_shard.setdefault(shard, []).append(eff)
            self._chain_apply([
                (shard, int(prev_by_shard.get(shard, 0)), ts, effs,
                 commit_vc)
                for shard, effs in by_shard.items()])
            for dk in keys:
                if self.prepared.get(dk) == txid:
                    del self.prepared[dk]
                self.last_commit[dk] = ts
        return True

    def _chain_apply(self, links) -> None:
        """``links``: [(shard, prev, ts, effects, commit_vc)], at most one
        per shard.  A link applies once its shard's own-lane chain reaches
        ``prev`` and is buffered until then (commits arrive out of ts
        order from concurrent coordinators).  The ready links of different
        shards apply as ONE grouped store append, then the buffered
        successors they unblock, round by round: per shard the order is
        the chain's, and shards share no keys."""
        ready = []
        for shard, prev, ts, effects, commit_vc in links:
            if shard not in self.chain_wait:
                raise RuntimeError(
                    f"commit ts {ts} for unowned shard {shard} at member "
                    f"{self.member_id} (owned {sorted(self.shards)}, map "
                    f"{self.shard_map.get(shard)}) — protocol violation")
            if self.applied_ts[shard] < prev:
                self.chain_wait[shard][prev] = (ts, effects, commit_vc)
            else:
                ready.append((shard, ts, effects, commit_vc))
        while ready:
            self._apply_now(ready)
            ready = [(s,) + self.chain_wait[s].pop(self.applied_ts[s])
                     for s, *_ in ready
                     if self.applied_ts[s] in self.chain_wait[s]]

    def _apply_now(self, links) -> None:
        groups = [(effs, [vc] * len(effs), [self.dc_id] * len(effs))
                  for _, _, effs, vc in links if effs]
        if groups:
            self.node.store.apply_effect_groups(groups)
        for shard, ts, _, _ in links:
            self.applied_ts[shard] = ts

    # ------------------------------------------------------------------
    # stable-time aggregation (stable-time gossip between members)
    # ------------------------------------------------------------------
    def refresh_peer_clocks(self) -> None:
        for mid, cli in list(self.peers.items()):
            try:
                rows = cli.call("m_clocks")
            except (OSError, RuntimeError):
                # unreachable peer: keep its last gossiped rows; staleness
                # is safe (mins only lag)
                continue
            if not rows:
                continue
            idx = np.asarray([s for s, _ in rows], np.int64)
            vals = np.asarray([r for _, r in rows], np.int32)
            with self._lock:
                mat = self.peer_clocks.get(mid)
                if mat is None:
                    mat = np.zeros((self.cfg.n_shards, self.cfg.max_dcs),
                                   np.int32)
                    self.peer_clocks[mid] = mat
                mat[idx] = np.maximum(mat[idx], vals)

    def clock_matrix(self) -> np.ndarray:
        """The DC's full (shards x D) applied matrix: my owned rows live,
        the other rows from gossip (one masked max per peer)."""
        mat = self.node.store.applied_vc.copy()
        foreign = ~self._owned[:, None]
        with self._lock:
            for peer in self.peer_clocks.values():
                np.maximum(mat, peer, out=mat, where=foreign)
        return mat

    def stable_vc(self) -> np.ndarray:
        """DC stable snapshot = entry-wise min over every member's shard
        rows, through ``stable_min_of`` on the member's device."""
        self.advance_idle_shards()
        return stable_min_of(self.clock_matrix(), self.node.store.device)

    def close(self) -> None:
        self.rpc.close()
        for cli in list(self.peers.values()):
            cli.close()


def _wire_value(v):
    """Client values over msgpack: map dicts have tuple keys."""
    if isinstance(v, dict):
        return {"__map__": [[list(k), _wire_value(x)] for k, x in v.items()]}
    if isinstance(v, (list, tuple)):
        return [_wire_value(x) for x in v]
    return v


def unwire_value(v):
    if isinstance(v, dict) and "__map__" in v:
        return {(freeze_key(k[0]), k[1]): unwire_value(x)
                for k, x in v["__map__"]}
    if isinstance(v, list):
        return [unwire_value(x) for x in v]
    return v


def _freeze_op(op):
    """Ops over msgpack come back as lists; freeze to the tuple shapes the
    type layer expects."""
    if isinstance(op, list):
        return tuple(_freeze_op(x) for x in op)
    return op
