"""Inter-DC replication between single-node DCs: the wire format
(``messages``), the in-process hub (``transport``), the TCP fabric with
its native receive pump (``tcp``, ``native_pump``) and the replica
endpoint (``replica``)."""

from antidote_tpu_torch.interdc.messages import Descriptor, TxnMessage
from antidote_tpu_torch.interdc.replica import DCReplica
from antidote_tpu_torch.interdc.transport import LoopbackHub

__all__ = ["Descriptor", "TxnMessage", "DCReplica", "LoopbackHub"]
