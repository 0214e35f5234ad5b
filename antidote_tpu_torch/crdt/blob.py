"""Host-side value interning: arbitrary payloads <-> fixed-width i64 handles.

Device tables hold only fixed-width integers; CRDT payloads (register values,
set elements, map field names) are arbitrary terms.  Each distinct payload is
interned to a stable 64-bit handle and its bytes stay on the host.  Handles
are content hashes (the same scheme as the JAX package), so the same value
interned in two DCs, or in either package, gets the same handle.

Handle 0 is reserved as "empty slot".
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict

import msgpack

EMPTY_HANDLE = 0


def encode_value(value: Any) -> bytes:
    """Canonical bytes for a payload (msgpack, deterministic)."""
    return msgpack.packb(value, use_bin_type=True)


def decode_value(data: bytes) -> Any:
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


def handle_of(data: bytes) -> int:
    """Stable 63-bit content hash (positive i64, never 0)."""
    h = int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(), "little")
    h &= (1 << 63) - 1
    return h or 1


class BlobStore:
    """handle -> payload bytes table for one store instance.

    Replication ships (handle, bytes) pairs alongside effects so the remote
    blob store can resolve handles.
    """

    def __init__(self):
        self._by_handle: Dict[int, bytes] = {}

    def intern(self, value: Any) -> int:
        data = encode_value(value)
        h = handle_of(data)
        self._by_handle.setdefault(h, data)
        return h

    def intern_bytes(self, h: int, data: bytes) -> None:
        self._by_handle.setdefault(h, data)

    def resolve(self, h: int) -> Any:
        if h == EMPTY_HANDLE:
            return None
        return decode_value(self._by_handle[h])

    def bytes_of(self, h: int) -> bytes:
        return self._by_handle[h]

    def __contains__(self, h: int) -> bool:
        return h in self._by_handle

    def __len__(self) -> int:
        return len(self._by_handle)
