"""Key→shard router: the port's native XXH64 (``store/cpp/router.cc``) with
a batched route, and a pure-Python XXH64 as its plain version, bit-exact
with each other and with the JAX package's router, so both packages place
every key on the same shard.

Integer keys map directly (``key % n_shards``); other keys hash the
canonical msgpack serialization of ``(key, bucket)``.  The native library
is built with g++ at first use (:mod:`antidote_tpu_torch.native_build`);
a store's construction loads it (:func:`load`) and raises when it cannot
be built — nothing falls back to the plain hash, which only the tests
call.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Any, Sequence

import msgpack
import numpy as np

from antidote_tpu_torch import native_build

SOURCE = Path(__file__).resolve().parent / "cpp" / "router.cc"

_M = (1 << 64) - 1
_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5

_lib = None
_lib_lock = threading.Lock()


class RouterUnavailable(RuntimeError):
    """The native router library could not be built or loaded."""


def load():
    """The native router library (built on first use).  Raises
    :class:`RouterUnavailable` when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(native_build.ensure(SOURCE, "router")))
        except (OSError, native_build.NativeBuildError) as e:
            raise RouterUnavailable(f"native router: {e}") from e
        lib.router_hash64.restype = ctypes.c_uint64
        lib.router_hash64.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                      ctypes.c_uint64]
        lib.router_shard_batch.restype = None
        lib.router_shard_batch.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_uint64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        _lib = lib
        return lib


# ---------------------------------------------------------------------------
# plain XXH64 (same spec as router.cc; must agree bit for bit)
# ---------------------------------------------------------------------------
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


# ---------------------------------------------------------------------------
# public API (the native library)
# ---------------------------------------------------------------------------
def key_bytes(key: Any, bucket: str) -> bytes:
    """Canonical serialization of a bound key for hashing."""
    return msgpack.packb((key, bucket), use_bin_type=True)


def hash64(data: bytes, seed: int = 0) -> int:
    return int(load().router_hash64(data, len(data), seed))


def shard_of(key: Any, bucket: str, n_shards: int) -> int:
    if isinstance(key, int) and not isinstance(key, bool):
        return key % n_shards  # direct-int path
    return hash64(key_bytes(key, bucket)) % n_shards


def shard_batch(keys: Sequence[Any], buckets: Sequence[str],
                n_shards: int) -> np.ndarray:
    """Vector route: one FFI crossing for the whole batch."""
    n = len(keys)
    out = np.empty(n, np.int64)
    ints = np.empty(n, bool)
    blobs = []
    offsets = [0]
    for i, (k, b) in enumerate(zip(keys, buckets)):
        if isinstance(k, int) and not isinstance(k, bool):
            ints[i] = True
            out[i] = k % n_shards
            continue
        ints[i] = False
        kb = key_bytes(k, b)
        blobs.append(kb)
        offsets.append(offsets[-1] + len(kb))
    if blobs:
        hashed = np.empty(len(blobs), np.int64)
        load().router_shard_batch(b"".join(blobs),
                                  np.asarray(offsets, np.uint64),
                                  len(blobs), 0, n_shards, hashed)
        out[~ints] = hashed
    return out
