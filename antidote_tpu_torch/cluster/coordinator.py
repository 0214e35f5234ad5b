"""ClusterNode — transaction coordination over a multi-member DC.

The AntidoteNode-shaped facade a member serves clients from: any member
coordinates any transaction, routing per-key work to shard owners over the
intra-DC RPC by the member's shard map.  A live join or leave moves shards
under it: an owner answers a retryable ``not_owner:`` or ``busy:``, and the
coordinator refreshes its map from a peer (strictly newer epochs only) and
retries, for up to ``MOVE_WAIT_S``:

  reads      -> owner's read at the snapshot VC; maps assemble from one
                membership read per batch and one field read per nesting
                level
  downstream -> stateless ops generate locally; state-dependent ops
                (observed-remove sets) and escrow spends (counter_b
                decrements, transfers) generate at the owner against its
                replica; map ops expand into membership and field
                updates first
  commit     -> prepare at every involved owner (certify + key lock),
                then one sequencer timestamp (member 0), then commit
                fan-out; a failed prepare releases the prepared keys

Snapshot clocks come from the aggregated member clock matrix (stale is
safe: aggregated mins only ever lag the true applied clocks, so a snapshot
never claims unapplied state).  Only the ClockSI protocol exists here: the
members' transaction managers refuse GentleRain, as the node's does.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from antidote_tpu_torch.cluster.member import (ClusterMember, _freeze_op,
                                               overlay_digest, unwire_value)
from antidote_tpu_torch.cluster.rpc import eff_from_wire, eff_to_wire
from antidote_tpu_torch.crdt import COMPOSITE_NAMES, get_type, is_type
from antidote_tpu_torch.crdt import maps as maps_mod
from antidote_tpu_torch.store.kv import Effect, freeze_key, key_to_shard
from antidote_tpu_torch.txn.manager import AbortError


class ClusterTxn:
    # Seeded with the boot time in microseconds (48 bits) so txids stay
    # unique across coordinators and process restarts; the coordinator's
    # member id tags the top byte.
    _ids = itertools.count(time.time_ns() // 1000 & ((1 << 48) - 1))

    def __init__(self, snapshot_vc: np.ndarray, coord_tag: int):
        self.txid = (coord_tag << 56) | next(ClusterTxn._ids)
        self.snapshot_vc = np.asarray(snapshot_vc, np.int32)
        self.writeset: List[Effect] = []
        self.active = True
        #: (key, bucket) -> (effects shipped to the owner, digest) for
        #: incremental overlay shipping (only NEW effects go over RPC)
        self.overlay_sent: Dict[tuple, tuple] = {}
        #: (key, bucket) -> [Effect] — per-key view of the writeset
        self.pend_idx: Dict[tuple, list] = {}

    def add_effect(self, eff: Effect) -> None:
        self.writeset.append(eff)
        self.pend_idx.setdefault((eff.key, eff.bucket), []).append(eff)


class ClusterNode:
    """Coordinator facade with the AntidoteNode client surface."""

    def __init__(self, member: ClusterMember):
        self.member = member
        self.cfg = member.cfg
        self.dc_id = member.dc_id
        #: fault-injection seam for the takeover tests (the reference's
        #: brutal_kill_nodes mid-stream): "after_seq" = die between
        #: sequencing and the commit fan-out (wedges the chain),
        #: "after_first_commit" = die mid-fan-out (a partial commit the
        #: takeover must finish).  Both end the PROCESS with exit code
        #: 137: arm them only in a member process of its own
        self.failpoint: Optional[str] = None
        #: session floor: my own commits are in my snapshots even before
        #: the aggregated stable catches up (owner reads wait out in-flight
        #: commits below the requested own-lane ts, so the floor is safe)
        self.session_vc = np.zeros(self.cfg.max_dcs, np.int32)
        #: retries after an owner's ``busy``/``not_owner`` reply (a live
        #: shard move under this coordinator), by kind
        self.move_retries = {"busy": 0, "not_owner": 0}

    #: how long a coordinator rides out one shard's move window before
    #: giving up.  Time-based, not attempt-based: an import can sit in a
    #: checkpoint seal, and a fixed retry count shrinks with RPC latency
    MOVE_WAIT_S = 30.0

    # ------------------------------------------------------------------
    def _owner_of_shard(self, shard: int) -> Optional[int]:
        """Peer member id owning a shard; None when it is mine."""
        if shard in self.member.shards:
            return None
        owner = self.member.shard_map.get(shard,
                                          shard % self.member.n_members)
        # a live import updates the shard set and the map in two steps;
        # "the map says me" is the local member either way
        return None if owner == self.member.member_id else owner

    def _refresh_shard_map(self) -> None:
        """Pull the ownership map from a peer (after a not_owner or busy
        reply: a live join or leave moved a shard under us).  Only
        STRICTLY NEWER epochs are adopted — a peer whose map predates a
        move must never clobber what the move's broadcast taught us."""
        for cli in list(self.member.peers.values()):
            try:
                m = cli.call("m_shard_map")
            except (OSError, RuntimeError):
                continue
            with self.member._lock:
                for s, ent in m.items():
                    s = int(s)
                    owner, epoch = int(ent[0]), int(ent[1])
                    if (s not in self.member.shards
                            and epoch > self.member.shard_epoch.get(s, 0)):
                        self.member.shard_map[s] = owner
                        self.member.shard_epoch[s] = epoch
            return

    def _call(self, owner: int, method: str, *args):
        """An owner's RPC.  A call that fails because its member left the
        DC (the leave's ``m_forget_member`` closed the client mid-call, or
        the process is gone) is that member's ``not_owner``: a departed
        member owns no shard, so it holds nothing of this transaction."""
        try:
            return self.member.peers[owner].call(method, *args)
        except (KeyError, OSError, RuntimeError) as e:
            if owner in self.member.departed:
                raise RuntimeError(
                    f"not_owner: member {owner} left the DC") from e
            raise

    def _moved(self, e: BaseException) -> bool:
        """Is ``e`` an owner's retryable move refusal?  Counts it."""
        text = str(e)
        for kind in ("not_owner", "busy"):
            if kind in text:
                self.move_retries[kind] += 1
                return True
        return False

    def _reroute(self, e: BaseException, t0: float, what: str) -> None:
        """After a move refusal: give up ``MOVE_WAIT_S`` after ``t0``, else
        refresh the map and pause briefly before the caller retries."""
        if time.monotonic() > t0 + self.MOVE_WAIT_S:
            raise RuntimeError(
                f"shard ownership unstable: {what} retries exhausted after "
                f"{time.monotonic() - t0:.2f}s (last: {e})") from e
        self._refresh_shard_map()
        time.sleep(0.02)

    def _owner_of(self, key, bucket) -> Optional[int]:
        return self._owner_of_shard(key_to_shard(key, bucket,
                                                 self.cfg.n_shards))

    # ------------------------------------------------------------------
    def _snapshot(self) -> np.ndarray:
        snap = np.maximum(self.member.stable_vc(), self.session_vc)
        # freshest own-lane view (cached sequencer frontier): blind writes
        # certify against recent commits instead of spuriously aborting,
        # and reads wait out in-flight commits at the owners
        snap[self.dc_id] = max(int(snap[self.dc_id]),
                               self.member._seq_counter())
        return snap

    def start_transaction(self, clock=None, props=None) -> ClusterTxn:
        snap = self._snapshot()
        if clock is not None:
            clock = np.asarray(clock, np.int32)
            for _ in range(10_000):
                if (clock <= snap).all():
                    break
                # gossip advances on wall-clock cadences: pace the spin
                time.sleep(0.002)
                self.member.refresh_peer_clocks()
                snap = self._snapshot()
            else:
                raise TimeoutError(f"stable snapshot {snap} never reached "
                                   f"client clock {clock}")
            snap = np.maximum(snap, clock)
        return ClusterTxn(snap, self.member.member_id)

    # ------------------------------------------------------------------
    def read_objects(self, objects: Sequence, txn=None, clock=None):
        if txn is None:
            t = self.start_transaction(clock)
            try:
                return self._read(objects, t), t.snapshot_vc
            finally:
                t.active = False
        return self._read(objects, txn)

    def _read(self, objects, txn: ClusterTxn) -> list:
        # a live move lands between routing and the owner call as a
        # retryable not_owner/busy reply: refresh the map and re-read the
        # batch at the same snapshot, for up to MOVE_WAIT_S
        t0 = time.monotonic()
        while True:
            try:
                return self._read_routed(objects, txn)
            except RuntimeError as e:
                if not self._moved(e):
                    raise
                self._reroute(e, t0, "read")

    def _read_routed(self, objects, txn: ClusterTxn) -> list:
        assert txn.active
        out: List[Any] = [None] * len(objects)
        comp = [(i, (freeze_key(k), t, b))
                for i, (k, t, b) in enumerate(objects)
                if t in COMPOSITE_NAMES]
        if comp:
            vals = maps_mod.assemble([o for _, o in comp],
                                     lambda objs: self._read(objs, txn))
            for (i, _), v in zip(comp, vals):
                out[i] = v
        by_owner: Dict[Optional[int], list] = {}
        for i, (key, t, bucket) in enumerate(objects):
            if t in COMPOSITE_NAMES:
                continue
            key = freeze_key(key)
            by_owner.setdefault(self._owner_of(key, bucket), []).append(
                (i, (key, t, bucket)))
        # read-your-writes: ship the txn's own pending effects per object
        # to the owners, who overlay them on the snapshot state.
        # Incremental: only effects the owner has not folded yet travel.
        for owner, items in by_owner.items():
            objs = [o for _, o in items]
            for full in (False, True):
                overlays = None
                if txn.writeset:
                    overlays = [self._overlay_payload(txn, k, b, full=full)
                                for (k, _t, b) in objs]
                    if not any(overlays):
                        overlays = None
                try:
                    if owner is None:
                        wvals = self.member.m_read_values(
                            objs, txn.snapshot_vc, overlays)
                    else:
                        wvals = self._call(
                            owner, "m_read_values", objs,
                            [int(x) for x in txn.snapshot_vc], overlays)
                except RuntimeError as e:
                    if not full and "overlay-resync" in str(e):
                        continue  # owner lost the prefix: resend in full
                    raise
                if overlays:
                    self._overlay_mark_sent(txn, objs, overlays)
                break
            for (i, _), v in zip(items, wvals):
                out[i] = unwire_value(v)
        return out

    # -- incremental overlay shipping ----------------------------------
    @staticmethod
    def _overlay_payload(txn: ClusterTxn, key, bucket, full: bool = False):
        pend = txn.pend_idx.get((key, bucket))
        if not pend:
            return None
        n0, d0 = ((0, 0) if full
                  else txn.overlay_sent.get((key, bucket), (0, 0)))
        wires = [eff_to_wire(e) for e in pend[n0:]]
        return {"n": n0, "d": d0, "effs": wires,
                "nd": overlay_digest(d0, wires), "txid": txn.txid,
                "_total": len(pend)}

    @staticmethod
    def _overlay_mark_sent(txn: ClusterTxn, objs, overlays) -> None:
        for (k, _t, b), ov in zip(objs, overlays):
            if ov is not None:
                txn.overlay_sent[(k, b)] = (ov["_total"], ov["nd"])

    # ------------------------------------------------------------------
    def update_objects(self, updates: Sequence, txn=None, clock=None):
        if txn is None:
            t = self.start_transaction(clock)
            try:
                self._update(updates, t)
            except BaseException:
                self.abort_transaction(t)
                raise
            return self.commit_transaction(t)
        self._update(updates, txn)

    def _update(self, updates, txn: ClusterTxn) -> None:
        assert txn.active
        for key, type_name, bucket, op in updates:
            key = freeze_key(key)
            op = _freeze_op(op)
            if not is_type(type_name):
                raise TypeError(f"unknown CRDT type {type_name!r}")
            ty = get_type(type_name)
            if not ty.is_operation(op):
                raise TypeError(f"invalid operation {op!r} for {type_name}")
            if type_name in COMPOSITE_NAMES:
                def read_field_value(fk, ft, bucket=bucket):
                    return self._read([(fk, ft, bucket)], txn)[0]

                self._update(maps_mod.expand_update(
                    key, type_name, bucket, op, read_field_value), txn)
                continue
            seq = len(txn.pend_idx.get((key, bucket), ()))
            # counter_b decrements and transfers are escrow-guarded at the
            # key's owner although their downstream needs no state
            guarded_b = (type_name == "counter_b"
                         and op[0] in ("decrement", "transfer"))
            if not (ty.require_state_downstream(op) or guarded_b):
                blobs = self.member.node.store.blobs
                for a, b, refs in ty.downstream(op, None, blobs, self.cfg):
                    a, b = ty.stamp_op_seq(a, b, seq)
                    seq += 1
                    txn.add_effect(Effect(key, type_name, bucket, a, b,
                                          refs))
                continue
            # the owner generates against its replica's state, with the
            # txn's own pending effects for the key overlaid; incremental
            # shipping with a full resend on overlay-resync
            full = False
            t0 = time.monotonic()
            while True:
                owner = self._owner_of(key, bucket)
                overlay = self._overlay_payload(txn, key, bucket, full=full)
                try:
                    if owner is None:
                        wires = self.member.m_downstream(
                            key, type_name, bucket, op, txn.snapshot_vc,
                            overlay)
                    else:
                        wires = self._call(
                            owner, "m_downstream", key, type_name, bucket, op,
                            [int(x) for x in txn.snapshot_vc], overlay)
                except RuntimeError as e:
                    if (not full and overlay is not None
                            and "overlay-resync" in str(e)):
                        full = True
                        continue
                    if self._moved(e):
                        # the new owner has no overlay prefix: resend in
                        # full
                        self._reroute(e, t0, "downstream")
                        full = True
                        continue
                    if "abort" in str(e):
                        self.abort_transaction(txn)
                        raise AbortError(str(e)) from e
                    raise
                if overlay is not None:
                    self._overlay_mark_sent(txn, [(key, type_name, bucket)],
                                            [overlay])
                break
            for w in wires:
                eff = eff_from_wire(w)
                eff.eff_a, eff.eff_b = ty.stamp_op_seq(eff.eff_a, eff.eff_b,
                                                       seq)
                seq += 1
                txn.add_effect(eff)

    # ------------------------------------------------------------------
    def commit_transaction(self, txn: ClusterTxn) -> np.ndarray:
        assert txn.active
        txn.active = False
        if not txn.writeset:
            return txn.snapshot_vc.copy()
        snap_own = int(txn.snapshot_vc[self.dc_id])
        t0 = time.monotonic()
        while True:
            by_owner: Dict[Optional[int], list] = {}
            shards = set()
            for eff in txn.writeset:
                shard = key_to_shard(eff.key, eff.bucket, self.cfg.n_shards)
                shards.add(shard)
                by_owner.setdefault(self._owner_of_shard(shard),
                                    []).append(eff)
            prepared: List[Optional[int]] = []
            try:
                for owner, effs in by_owner.items():
                    wires = [eff_to_wire(e) for e in effs]
                    if owner is None:
                        self.member.m_prepare(txn.txid, wires, snap_own)
                    else:
                        self._call(owner, "m_prepare", txn.txid, wires,
                                   snap_own)
                    prepared.append(owner)
                break
            except BaseException as e:
                # the owners already prepared release their locks first,
                # whatever comes next: a move's retry re-prepares them all
                self._abort_prepared(txn.txid, prepared)
                if isinstance(e, RuntimeError) and self._moved(e):
                    self._reroute(e, t0, "prepare")
                    continue
                # cert conflicts raise "abort: ..." — locally as
                # RuntimeError, remotely through RpcError (a subclass)
                if isinstance(e, RuntimeError) and "abort" in str(e):
                    # another coordinator committed past our snapshot:
                    # refresh the cached frontier so the client's retry
                    # starts from a snapshot that can pass certification
                    self.member.invalidate_seq_cache()
                    raise AbortError(str(e)) from e
                raise
        # one DC-wide timestamp + per-shard chains from the sequencer
        # (ledgered under the txid so takeover can find this txn)
        ts, prev = self._seq(sorted(shards), txn.txid)
        if self.failpoint == "after_seq":
            os._exit(137)
        commit_vc = txn.snapshot_vc.copy()
        commit_vc[self.dc_id] = ts
        vc_wire = [int(x) for x in commit_vc]
        for i, owner in enumerate(by_owner):
            if owner is None:
                self.member.m_commit(txn.txid, vc_wire, prev)
            else:
                self.member.peers[owner].call("m_commit", txn.txid, vc_wire,
                                              prev)
            if i == 0 and self.failpoint == "after_first_commit":
                os._exit(137)
        np.maximum(self.session_vc, commit_vc, out=self.session_vc)
        return commit_vc

    def _seq(self, shards, txid: int):
        if self.member.seq is not None:
            return self.member.seq_ts(shards, txid)
        ts, prev = self.member.peers[0].call("m_seq", list(shards), txid)
        # we just observed the sequencer at ts: refresh the cached
        # frontier so our next snapshot/idle-advance need not wait for it
        if ts > self.member._seq_cache:
            self.member._seq_cache = ts
        return ts, {int(k): int(v) for k, v in prev.items()}

    def _abort_prepared(self, txid: int, owners) -> None:
        for owner in owners:
            try:
                if owner is None:
                    self.member.m_abort(txid)
                else:
                    self.member.peers[owner].call("m_abort", txid)
            except (OSError, RuntimeError):
                pass  # the owner is gone: its prepare lock went with it

    def abort_transaction(self, txn: ClusterTxn) -> None:
        txn.active = False
        txn.writeset.clear()
        txn.pend_idx.clear()

    # ------------------------------------------------------------------
    def checkpoint_now(self) -> dict:
        """One synchronous checkpoint cycle on THIS member's store: each
        member of a clustered DC publishes its own image (its membership
        rides in the image's extras), so the operator checkpoints members
        one by one, as single-node owners."""
        return self.member.node.checkpoint_now()

    def check_ready(self) -> Dict[str, bool]:
        probes = {"local": True}
        for mid, cli in self.member.peers.items():
            try:
                probes[f"member{mid}"] = bool(cli.call("m_ready"))
            except (OSError, RuntimeError):
                probes[f"member{mid}"] = False
        return probes

    def status(self, include_ready: bool = False) -> Dict[str, Any]:
        out = {
            "dc_id": self.dc_id,
            "member": self.member.member_id,
            "members": self.member.n_members,
            "n_shards": self.cfg.n_shards,
            "max_dcs": self.cfg.max_dcs,
            "owned_shards": sorted(self.member.shards),
            "stable_vc": [int(x) for x in self.member.stable_vc()],
        }
        if include_ready:
            out["ready"] = self.check_ready()
        return out
