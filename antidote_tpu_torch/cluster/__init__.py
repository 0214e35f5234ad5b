"""Multi-member DCs: a DC's shards spread over N members joined by an
intra-DC RPC.  Member 0 sequences the DC's commit timestamps, owners
certify and apply their shards, stable time aggregates every member's
clock rows (the ``stable_min`` kernel's path), and each member runs its
own inter-DC endpoint for exactly its shards' chains (``attach_interdc``).

Members log to a durable prepare log beside their shard WALs, recover from
it (``recover=True``), and settle a dead coordinator's transactions through
the takeover protocol (``ClusterMember.resolve_wedged``).  ``join`` adds
and removes members while the DC serves (``live_join``/``live_leave``: one
two-phase shard move at a time); ``resize`` changes the member count
offline; ``boot`` runs a member as a process of its own.
"""

from __future__ import annotations

from typing import Dict

from antidote_tpu_torch.cluster.coordinator import ClusterNode
from antidote_tpu_torch.cluster.member import ClusterMember, owned_shards
from antidote_tpu_torch.cluster.rpc import RpcClient, RpcServer
from antidote_tpu_torch.store.kv import freeze_key, key_to_shard

__all__ = ["ClusterMember", "ClusterNode", "owned_shards", "fabric_id_of",
           "cluster_query_router", "attach_interdc", "RpcClient",
           "RpcServer"]


def fabric_id_of(dc_id: int, member_id: int) -> int:
    """Fabric endpoint id for a cluster member.  Member 0 keeps the bare
    dc_id, so single-node DCs and the default DCReplica wiring are
    unchanged; higher members shift into a disjoint id space."""
    return (member_id << 16) | dc_id


def cluster_query_router(members_by_dc: Dict[int, int], n_shards: int):
    """(origin_dc, shard) -> fabric id of the publisher owning that chain
    under the INITIAL modular layout — the fallback a subscriber uses
    before any ownership gossip arrives for a chain.  Once a publisher's
    (owner, epoch) stamps have been seen, the learned
    ``DCReplica.shard_route`` entry takes precedence."""

    def route(origin: int, shard: int) -> int:
        n = members_by_dc.get(origin, 1)
        return fabric_id_of(origin, shard % n)

    return route


class _LiveShards:
    """A live view of the shards a member's inter-DC endpoint ingests and
    pings: the member's owned set (recovery and live moves reassign it, so
    a frozen copy would keep heartbeating shards that moved away) less the
    shards mid-move.  A shard mid-move stays at the export's cut: remote
    transactions applied to the source's copy would raise its clock row
    past the importer's, a transaction started from that row and committed
    at the importer would raise the importer's row past them, and the
    importer's catch-up would then drop them as duplicates.  The importer
    replays them from the cut (the JAX endpoint keeps applying)."""

    def __init__(self, member: ClusterMember):
        self._member = member

    def __contains__(self, s) -> bool:
        m = self._member
        return s in m.shards and s not in m.moving

    def __iter__(self):
        m = self._member
        return iter([s for s in m.shards if s not in m.moving])

    def __len__(self) -> int:
        return sum(1 for _ in self)


def attach_interdc(member: ClusterMember, fabric, name: str = ""):
    """Run a cluster member's inter-DC endpoint: a DCReplica restricted to
    the member's owned shards, publishing under the member's fabric id
    with its (owner, epoch) stamps, with safe times derived from the DC
    sequencer frontier.

    The safe time for shard s is the sequencer counter when the member
    holds no prepared or chain-buffered txn touching s (any future
    commit's ts will exceed the counter), else the shard's applied chain
    frontier (an outstanding prepared txn may already hold a smaller
    issued ts, and a shard mid-move may already take commits at its
    importer).

    Lock order: the pump's gate drain holds the node's commit lock, then
    ``replica.store_lock`` — the member lock — around its apply, the same
    order ``m_commit`` takes (commit lock, member lock); member readers
    take the member lock alone."""
    from antidote_tpu_torch.interdc.replica import DCReplica

    replica = DCReplica(
        member.node, fabric,
        name=name or f"dc{member.dc_id}m{member.member_id}",
        shards=_LiveShards(member),
        fabric_id=fabric_id_of(member.dc_id, member.member_id))
    replica.owner_info = lambda shard: (
        member.member_id, int(member.shard_epoch.get(int(shard), 0)))
    replica.store_lock = member._lock
    member.export_extras.append(replica.export_shard_state)
    member.on_shard_import.append(
        lambda shard, extras: replica.adopt_shard(shard, extras))
    member.on_shard_relinquish.append(replica.release_shard)

    def safe_time(shard: int) -> int:
        # the frontier is read BEFORE the checks: every ts at or below it
        # was issued to a transaction already prepared, so the checks
        # below see it (or it is applied and published).  Read after them,
        # a transaction prepared and sequenced in between would be claimed
        # unpublished, and remote DCs would drop it as a duplicate (the
        # JAX endpoint reads it after them)
        frontier = member._seq_counter()
        # a shard mid-move (exported, not yet relinquished) is frozen at
        # its applied frontier: the importer may already commit on it, and
        # a ping claiming the sequencer frontier on the moved chain would
        # make remote DCs drop the importer's commits below it as
        # duplicates (the JAX endpoint still claims the frontier)
        if (shard not in member.shards or shard in member.moving
                or member.prepared_on_shard(shard)
                or member.chain_wait.get(shard)):
            return member.applied_ts.get(shard, 0)
        return max(frontier, member.applied_ts.get(shard, 0))

    replica.safe_time = safe_time
    member.on_commit.append(replica._on_local_commit)

    def transfer(payload):
        """Inter-DC counter_b rights requests land on member 0's endpoint
        (the bare-dc fabric id): route them to the key's owner, whose
        coordinator commits the grant through the DC sequencer."""
        key = freeze_key(payload["key"])
        bucket = payload["bucket"]
        shard = key_to_shard(key, bucket, member.cfg.n_shards)
        owner = member.shard_map.get(shard, shard % member.n_members)
        if owner == member.member_id:
            return member.m_process_transfer(key, bucket, payload["amount"],
                                             payload["to_dc"])
        return member.peers[owner].call(
            "m_process_transfer", key, bucket, payload["amount"],
            payload["to_dc"])

    replica.transfer_handler = transfer
    return replica
