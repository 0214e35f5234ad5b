"""Multi-member DCs: a DC's shards spread over N members joined by an
intra-DC RPC.  Member 0 sequences the DC's commit timestamps, owners
certify and apply their shards, and stable time aggregates every member's
clock rows (the ``stable_min`` kernel's path).

This slice runs in memory.  The inter-DC endpoint of a member
(``attach_interdc``) and the catch-up router come with the inter-DC slice;
live join/leave, resize and booting members as processes come with the
durability and console slices.
"""

from __future__ import annotations

from antidote_tpu_torch.cluster.coordinator import ClusterNode
from antidote_tpu_torch.cluster.member import ClusterMember, owned_shards
from antidote_tpu_torch.cluster.rpc import RpcClient, RpcServer

__all__ = ["ClusterMember", "ClusterNode", "owned_shards", "fabric_id_of",
           "RpcClient", "RpcServer"]


def fabric_id_of(dc_id: int, member_id: int) -> int:
    """Fabric endpoint id for a cluster member.  Member 0 keeps the bare
    dc_id; higher members shift into a disjoint id space."""
    return (member_id << 16) | dc_id
