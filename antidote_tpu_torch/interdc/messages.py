"""Inter-DC wire format.

Per-shard transaction messages with ``prev_opid`` chaining for loss
detection, serialized with msgpack.  Blob payloads referenced by the
effects ride along so the receiving DC can resolve value handles.

The layout is the JAX package's byte for byte (same keys, same order, the
effect lanes as little-endian int64 / int32 buffers), so a port DC and a
JAX DC replicate to each other.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import msgpack
import numpy as np

from antidote_tpu_torch.store.kv import Effect, freeze_key


@dataclasses.dataclass
class TxnMessage:
    """One origin-DC transaction's effects for ONE shard (or a heartbeat
    when ``effects`` is empty)."""

    origin: int                    # origin DC lane
    shard: int                     # target shard
    prev_opid: int                 # last opid of this (shard, origin) chain
    last_opid: int                 # opid of this message's final effect
    commit_vc: np.ndarray          # i32[D]
    snapshot_vc: np.ndarray        # i32[D] — causal deps (origin lane = 0)
    effects: List[Effect]
    #: heartbeat safe time: no future txn from origin will commit below this
    timestamp: int = 0
    #: shard-ownership gossip of clustered origins (member id and
    #: ownership epoch); None, and absent on the wire, for single-member
    #: origins.  Decoded and re-encoded as received
    owner: Optional[int] = None
    oepoch: Optional[int] = None

    @property
    def is_ping(self) -> bool:
        return not self.effects

    def to_bytes(self) -> bytes:
        extra = {}
        if self.owner is not None:
            extra["ow"] = int(self.owner)
            extra["oe"] = int(self.oepoch or 0)
        return msgpack.packb({
            "o": self.origin,
            "p": self.shard,
            "prev": self.prev_opid,
            "last": self.last_opid,
            "cvc": [int(x) for x in np.asarray(self.commit_vc)],
            "svc": [int(x) for x in np.asarray(self.snapshot_vc)],
            "ts": self.timestamp,
            **extra,
            "effs": [
                {
                    "k": e.key, "t": e.type_name, "b": e.bucket,
                    "a": np.asarray(e.eff_a, np.int64).tobytes(),
                    "eb": np.asarray(e.eff_b, np.int32).tobytes(),
                    "bl": [(int(h), bytes(d)) for h, d in e.blob_refs],
                }
                for e in self.effects
            ],
        }, use_bin_type=True)

    @staticmethod
    def from_bytes(data: bytes) -> "TxnMessage":
        m = msgpack.unpackb(data, raw=False, strict_map_key=False)
        return TxnMessage(
            origin=m["o"], shard=m["p"], prev_opid=m["prev"],
            last_opid=m["last"],
            commit_vc=np.asarray(m["cvc"], np.int32),
            snapshot_vc=np.asarray(m["svc"], np.int32),
            timestamp=m["ts"],
            owner=m.get("ow"), oepoch=m.get("oe"),
            effects=[
                Effect(
                    freeze_key(e["k"]), e["t"], e["b"],
                    np.frombuffer(e["a"], np.int64),
                    np.frombuffer(e["eb"], np.int32),
                    [(h, d) for h, d in e["bl"]],
                )
                for e in m["effs"]
            ],
        )


@dataclasses.dataclass
class Descriptor:
    """DC membership descriptor: what another DC needs to subscribe."""

    dc_id: int
    name: str
    n_shards: int
    address: Optional[Tuple[str, int]] = None  # TCP transport endpoint
    #: fabric endpoint identity (equals dc_id for single-member DCs)
    fabric_id: Optional[int] = None

    def to_wire(self) -> dict:
        return {"dc_id": self.dc_id, "name": self.name,
                "n_shards": self.n_shards,
                "address": list(self.address) if self.address else None,
                "fabric_id": self.fabric_id}

    @staticmethod
    def from_wire(d: dict) -> "Descriptor":
        addr = d.get("address")
        return Descriptor(
            int(d["dc_id"]), d.get("name", ""), int(d["n_shards"]),
            (addr[0], int(addr[1])) if addr else None,
            None if d.get("fabric_id") is None else int(d["fabric_id"]),
        )
