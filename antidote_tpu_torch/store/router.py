"""Key→shard router: a pure-Python XXH64, bit-exact with the JAX package's
native ``router.cc`` and its Python fallback, so both packages place every
key on the same shard.

Integer keys map directly (``key % n_shards``); other keys hash the
canonical msgpack serialization of ``(key, bucket)``.  A native batched
router is later work.
"""

from __future__ import annotations

from typing import Any, Sequence

import msgpack
import numpy as np

_M = (1 << 64) - 1
_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5


def _rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & _M


def _round(acc, inp):
    acc = (acc + inp * _P2) & _M
    return (_rotl(acc, 31) * _P1) & _M


def _merge(acc, val):
    acc ^= _round(0, val)
    return (acc * _P1 + _P4) & _M


def xxh64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    p = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M
        v2 = (seed + _P2) & _M
        v3 = seed & _M
        v4 = (seed - _P1) & _M
        while p + 32 <= n:
            v1 = _round(v1, int.from_bytes(data[p:p + 8], "little")); p += 8
            v2 = _round(v2, int.from_bytes(data[p:p + 8], "little")); p += 8
            v3 = _round(v3, int.from_bytes(data[p:p + 8], "little")); p += 8
            v4 = _round(v4, int.from_bytes(data[p:p + 8], "little")); p += 8
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M
        h = _merge(h, v1)
        h = _merge(h, v2)
        h = _merge(h, v3)
        h = _merge(h, v4)
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * _P1) & _M
        h = (_rotl(h, 23) * _P2 + _P3) & _M
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M
        h = (_rotl(h, 11) * _P1) & _M
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M
    h ^= h >> 29
    h = (h * _P3) & _M
    h ^= h >> 32
    return h


def key_bytes(key: Any, bucket: str) -> bytes:
    """Canonical serialization of a bound key for hashing."""
    return msgpack.packb((key, bucket), use_bin_type=True)


def shard_of(key: Any, bucket: str, n_shards: int) -> int:
    if isinstance(key, int) and not isinstance(key, bool):
        return key % n_shards  # direct-int path
    return xxh64(key_bytes(key, bucket)) % n_shards


def shard_batch(keys: Sequence[Any], buckets: Sequence[str],
                n_shards: int) -> np.ndarray:
    return np.asarray([shard_of(k, b, n_shards)
                       for k, b in zip(keys, buckets)], np.int64)
