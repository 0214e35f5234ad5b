"""The wire form of store packages: msgpack with numpy arrays as raw bytes.

The JAX package's checkpoint images and shard-handoff packages share this
encoding (``{"__nd": True, "d": dtype, "s": shape, "b": bytes}`` for an
array, ``{"__mp": bytes}`` for a pre-packed plain value), so an image
written by either package decodes in the other.  Moving shards between
replicas (export, import, drop, reshard) comes with the cold tier.
"""

from __future__ import annotations

from typing import Any, Dict

import msgpack
import numpy as np


def opaque(obj: Any) -> Dict[str, Any]:
    """Pre-pack a large plain-data value (no ndarrays inside) so
    :func:`pack`/:func:`unpack`'s recursive walk crosses it as ONE node: a
    million-entry directory list costs one C-speed msgpack pass instead of
    millions of Python calls."""
    return {"__mp": msgpack.packb(obj, use_bin_type=True)}


def pack(pkg: Dict[str, Any]) -> bytes:
    """Encode a package (nested dicts/lists, numpy arrays, plain data)."""

    def enc(x):
        if isinstance(x, np.ndarray):
            return {"__nd": True, "d": str(x.dtype), "s": list(x.shape),
                    "b": x.tobytes()}
        if isinstance(x, dict):
            return {k: enc(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [enc(v) for v in x]
        return x

    return msgpack.packb(enc(pkg), use_bin_type=True)


def unpack(data: bytes) -> Dict[str, Any]:
    """Decode :func:`pack`'s output (arrays come back owned and writable)."""

    def dec(x):
        if isinstance(x, dict):
            if x.get("__nd"):
                return np.frombuffer(x["b"], x["d"]).reshape(x["s"]).copy()
            if x.get("__mp") is not None:
                return msgpack.unpackb(x["__mp"], raw=False,
                                       strict_map_key=False)
            return {k: dec(v) for k, v in x.items()}
        if isinstance(x, list):
            return [dec(v) for v in x]
        return x

    return dec(msgpack.unpackb(data, raw=False, strict_map_key=False))
