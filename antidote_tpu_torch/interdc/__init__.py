"""Inter-DC replication between single-node DCs and their read replicas:
the wire format (``messages``), the in-process hub (``transport``), the TCP
fabric with its native receive pump (``tcp``, ``native_pump``), the replica
endpoint (``replica``) and the follower read replica (``follower``)."""

from antidote_tpu_torch.interdc.follower import FollowerReplica
from antidote_tpu_torch.interdc.messages import Descriptor, TxnMessage
from antidote_tpu_torch.interdc.replica import DCReplica
from antidote_tpu_torch.interdc.transport import LoopbackHub

__all__ = ["Descriptor", "TxnMessage", "DCReplica", "FollowerReplica",
           "LoopbackHub"]
