"""Cluster & DC metadata.

The reference's ``stable_meta_data_server`` and
``dc_meta_data_utilities`` re-provided: durable node-local KV with
DC-wide broadcast and merge-broadcast, env mirroring, and replicated
runtime flags.
"""

from antidote_tpu_torch.meta.stable_meta import MetaDataStore, MetaCluster

__all__ = ["MetaDataStore", "MetaCluster"]
