"""Frame + message codec.

Framing mirrors the reference's ``antidote_pb_protocol``: a 4-byte
big-endian length prefix (``{packet, 4}``), then a 1-byte message code
and the body.  The body is msgpack rather than protobuf; the request set
mirrors the ``antidote_pb_process`` clauses.  The frames are byte for
byte the JAX package's.
"""

from __future__ import annotations

import enum
import socket
import struct
from typing import Any, Tuple

import msgpack


class MessageCode(enum.IntEnum):
    # requests (antidote_pb_process:process/1 clauses)
    START_TRANSACTION = 1
    READ_OBJECTS = 2
    UPDATE_OBJECTS = 3
    COMMIT_TRANSACTION = 4
    ABORT_TRANSACTION = 5
    STATIC_UPDATE_OBJECTS = 6
    STATIC_READ_OBJECTS = 7
    GET_CONNECTION_DESCRIPTOR = 8
    CONNECT_TO_DCS = 9
    CREATE_DC = 10
    NODE_STATUS = 11  # console/ops extension (no reference pb equivalent)
    CHECKPOINT_NOW = 12  # ops extension: synchronous checkpoint cycle
    REPLICA_ADMIN = 13  # ops extension: follower-replica registry
    # (add/remove/status against the owner's replica plane)
    # responses
    OPERATION_RESP = 64
    START_TRANSACTION_RESP = 65
    READ_OBJECTS_RESP = 66
    COMMIT_RESP = 67
    ERROR_RESP = 127


MAX_FRAME = 64 * 1024 * 1024


def freeze(x: Any) -> Any:
    """msgpack round-trips tuples as lists; keys and ops must come back
    hashable/structured, so freeze lists into tuples recursively."""
    if isinstance(x, list):
        return tuple(freeze(v) for v in x)
    return x


def encode_value(v: Any) -> Any:
    """Client-visible CRDT values may be dicts keyed by (field, type)
    tuples (map_rr/map_go); msgpack maps cannot carry tuple keys, so dicts
    ride as tagged pair lists."""
    if isinstance(v, dict):
        return {"__map__": [[list(k), encode_value(x)] for k, x in v.items()]}
    if isinstance(v, (list, tuple)):
        return [encode_value(x) for x in v]
    return v


def decode_value(v: Any) -> Any:
    if isinstance(v, dict) and "__map__" in v:
        return {freeze(k): decode_value(x) for k, x in v["__map__"]}
    if isinstance(v, list):
        return [decode_value(x) for x in v]
    return v


def merge_clock(token, clock):
    """Entry-wise max of two session clocks (either may be None) — the
    SESSION TOKEN update rule: a client folds every commit clock and
    read snapshot it observes into its token, and sends the token as the
    causal ``clock`` of later requests, so read-your-writes and
    monotonic reads hold across any replica it fails over to.  Lives in
    the codec because the token IS the wire clock — one place owns its
    shape (a plain list of per-DC ints)."""
    if token is None:
        return None if clock is None else [int(x) for x in clock]
    if clock is None:
        return [int(x) for x in token]
    a, b = [int(x) for x in token], [int(x) for x in clock]
    if len(b) > len(a):
        a += [0] * (len(b) - len(a))
    if len(a) > len(b):
        b += [0] * (len(a) - len(b))
    return [max(x, y) for x, y in zip(a, b)]


def encode(code: MessageCode, body: Any) -> bytes:
    payload = msgpack.packb(body, use_bin_type=True)
    return struct.pack(">IB", len(payload) + 1, int(code)) + payload


def encode_with(packer: "msgpack.Packer", code: MessageCode,
                body: Any) -> bytes:
    """Framed encode through a caller-owned persistent Packer (hot-path
    clients skip per-call packer construction) — same frame layout as
    :func:`encode`, owned here so the wire contract lives in one file."""
    payload = packer.pack(body)
    return struct.pack(">IB", len(payload) + 1, int(code)) + payload


def decode(frame: bytes) -> Tuple[MessageCode, Any]:
    code = MessageCode(frame[0])
    body = msgpack.unpackb(frame[1:], raw=False, strict_map_key=False)
    return code, body


def read_frame(sock: socket.socket) -> bytes:
    """Read one length-prefixed frame (code byte + body) off a socket."""
    hdr = _read_exact(sock, 4)
    (n,) = struct.unpack(">I", hdr)
    if not 1 <= n <= MAX_FRAME:
        raise ConnectionError(f"bad frame length {n}")
    return _read_exact(sock, n)


def read_frame_buffered(rfile) -> bytes:
    """Read one frame off a buffered binary file (``sock.makefile('rb')``)
    — the serving hot path's framing: the buffer coalesces the header +
    body reads into ~one syscall per request instead of 2+ recv calls."""
    hdr = rfile.read(4)
    if len(hdr) < 4:
        raise ConnectionError("peer closed")
    (n,) = struct.unpack(">I", hdr)
    if not 1 <= n <= MAX_FRAME:
        raise ConnectionError(f"bad frame length {n}")
    body = rfile.read(n)
    if len(body) < n:
        raise ConnectionError("peer closed")
    return body


def write_message(sock: socket.socket, code: MessageCode, body: Any) -> None:
    sock.sendall(encode(code, body))


def write_frame_body(sock: socket.socket, body: bytes) -> None:
    """Frame pre-encoded (code byte + payload) bytes — the apb codec
    builds its own bodies."""
    sock.sendall(struct.pack(">I", len(body)) + body)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)
