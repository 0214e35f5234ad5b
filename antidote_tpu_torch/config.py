"""Global configuration for an antidote_tpu_torch deployment.

The sizing knobs of the JAX package's ``AntidoteConfig`` that this
package reads; the others come with the modules that read them.  There
is no kernel switch: a table whose tensors live on a CUDA device always
runs the hand-written kernels, and a table on the CPU runs their plain
PyTorch versions (``materializer/cuda_kernels.py``).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AntidoteConfig:
    """Deployment-wide sizing knobs (static tensor shapes)."""

    # --- cluster shape -------------------------------------------------
    #: number of shards ("partitions")
    n_shards: int = 8
    #: dense vector-clock width: max number of DCs (replicas)
    max_dcs: int = 4

    # --- per-type table sizing ----------------------------------------
    #: op-ring slots per key before a GC fold is forced
    ops_per_key: int = 16
    #: materialized snapshot versions retained per key
    snap_versions: int = 2
    #: element slots per set key (set_aw, set_rw, set_go)
    set_slots: int = 16
    #: concurrent-value slots per multi-value register key (register_mv)
    mv_slots: int = 4
    #: element slots per sequence key (rga), tombstones included
    rga_slots: int = 64
    #: number of key slots per (shard, type) table; grows by doubling
    keys_per_table: int = 1024

    # --- durability (reference: antidote.app.src:44-48) ---------------
    enable_logging: bool = True
    sync_log: bool = False
    #: parallel append segments per shard WAL: a commit group's records
    #: land on one segment while the group-fsync coordinator syncs the
    #: previous one in the background, so the serial append+fsync floor
    #: splits across segments.  1 = the classic single-file-per-shard
    #: layout (and byte-identical file contents); recovery merges
    #: segments by the per-shard append sequence either way.
    wal_segments: int = 1

    # --- replay folds ---------------------------------------------------
    #: over-ring fold routing threshold (``KVStore._replay_read_many``):
    #: a replayed key whose op-log extent exceeds this folds with the
    #: chunked ``fold_long`` instead of one serial scan
    fold_chunk: int = 4096

    def __post_init__(self):
        assert self.n_shards >= 1
        assert self.max_dcs >= 1
        assert self.snap_versions >= 1
        assert self.ops_per_key >= 2


DEFAULT_CONFIG = AntidoteConfig()


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point was asked for.  ``"cuda"`` is the
    default everywhere and never silently becomes the CPU: without a card
    the caller must ask for ``device="cpu"`` explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
