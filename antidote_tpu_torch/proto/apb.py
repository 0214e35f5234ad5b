"""antidote_pb wire-compatibility codec (the ``antidotec_pb`` dialect).

The reference speaks length-prefixed protobuf on port 8087: a 4-byte
big-endian frame length, then a 1-byte message code and a proto2 body
(``antidote_pb_protocol``).  The message set and code table live in
the reference's ``antidote_pb_codec`` dependency (``antidote.proto``, the
public AntidoteDB client protocol); they are reproduced here from that
public definition so existing Antidote clients can connect unmodified.
The dispatch below mirrors the ``antidote_pb_process:process/1``
clauses.  Every frame is byte for byte the JAX package's codec's.

The proto2 wire format is hand-rolled (varint + length-delimited fields —
no generated-code dependency at runtime).

One server socket speaks BOTH dialects: the apb request codes the
server dispatches (``APB_REQUEST_CODES`` = {116, 118-123}) are disjoint
from the native msgpack codec's request codes (1-11), so the server
dispatches per-frame on the code byte (proto/server.py).
"""

from __future__ import annotations

import contextlib
import re
from typing import Any, Dict, List, Optional, Tuple

import msgpack
import numpy as np

from antidote_tpu_torch.overload import (BusyError, ColdMiss,
                                         DeadlineExceeded, ForwardFailed,
                                         InsufficientRightsError,
                                         NotOwnerError, ReadOnlyError,
                                         ReplicaLagging, TenantBusyError,
                                         deadline_from_ms)

# ---------------------------------------------------------------------------
# proto2 wire primitives
# ---------------------------------------------------------------------------
_WT_VARINT, _WT_LEN = 0, 2


def _enc_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _dec_varint(data: bytes, pos: int) -> Tuple[int, int]:
    shift = n = 0
    while True:
        b = data[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint overflow")


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


# ---------------------------------------------------------------------------
# message schemas — antidote.proto (proto2), field numbers per the public
# antidote_pb_codec definition
# ---------------------------------------------------------------------------
#: name -> [(field_no, field_name, label, type)]; type is a scalar kind or
#: another message name
SCHEMAS: Dict[str, list] = {
    "ApbErrorResp": [(1, "errmsg", "required", "bytes"),
                     (2, "errcode", "required", "uint32")],
    "ApbCounterUpdate": [(1, "inc", "optional", "sint64")],
    "ApbGetCounterResp": [(1, "value", "required", "sint32")],
    "ApbSetUpdate": [(1, "optype", "required", "enum"),
                     (2, "adds", "repeated", "bytes"),
                     (3, "rems", "repeated", "bytes")],
    "ApbGetSetResp": [(1, "value", "repeated", "bytes")],
    "ApbRegUpdate": [(1, "value", "required", "bytes")],
    "ApbGetRegResp": [(1, "value", "required", "bytes")],
    "ApbGetMVRegResp": [(1, "values", "repeated", "bytes")],
    "ApbMapKey": [(1, "key", "required", "bytes"),
                  (2, "type", "required", "enum")],
    "ApbMapUpdate": [(1, "updates", "repeated", "ApbMapNestedUpdate"),
                     (2, "removedKeys", "repeated", "ApbMapKey")],
    "ApbMapNestedUpdate": [(1, "key", "required", "ApbMapKey"),
                           (2, "update", "required", "ApbUpdateOperation")],
    "ApbMapEntry": [(1, "key", "required", "ApbMapKey"),
                    (2, "value", "required", "ApbReadObjectResp")],
    "ApbGetMapResp": [(1, "entries", "repeated", "ApbMapEntry")],
    "ApbFlagUpdate": [(1, "value", "required", "bool")],
    "ApbGetFlagResp": [(1, "value", "required", "bool")],
    "ApbCrdtReset": [],
    "ApbBoundObject": [(1, "key", "required", "bytes"),
                       (2, "type", "required", "enum"),
                       (3, "bucket", "required", "bytes")],
    "ApbReadObjects": [(1, "boundobjects", "repeated", "ApbBoundObject"),
                       (2, "transaction_descriptor", "required", "bytes")],
    "ApbUpdateOperation": [(1, "counterop", "optional", "ApbCounterUpdate"),
                           (2, "setop", "optional", "ApbSetUpdate"),
                           (3, "regop", "optional", "ApbRegUpdate"),
                           (4, "resetop", "optional", "ApbCrdtReset"),
                           (5, "flagop", "optional", "ApbFlagUpdate"),
                           (6, "mapop", "optional", "ApbMapUpdate")],
    "ApbUpdateOp": [(1, "boundobject", "required", "ApbBoundObject"),
                    (2, "operation", "required", "ApbUpdateOperation")],
    "ApbUpdateObjects": [(1, "updates", "repeated", "ApbUpdateOp"),
                         (2, "transaction_descriptor", "required", "bytes")],
    "ApbStartTransaction": [(1, "timestamp", "optional", "bytes"),
                            (2, "properties", "optional", "ApbTxnProperties")],
    "ApbTxnProperties": [(1, "read_write", "optional", "uint32"),
                         (2, "red_blue", "optional", "uint32")],
    "ApbAbortTransaction": [(1, "transaction_descriptor", "required", "bytes")],
    "ApbCommitTransaction": [(1, "transaction_descriptor", "required", "bytes")],
    "ApbStaticUpdateObjects": [(1, "transaction", "required", "ApbStartTransaction"),
                               (2, "updates", "repeated", "ApbUpdateOp")],
    "ApbStaticReadObjects": [(1, "transaction", "required", "ApbStartTransaction"),
                             (2, "objects", "repeated", "ApbBoundObject")],
    "ApbCreateDC": [(1, "nodes", "repeated", "bytes")],
    "ApbConnectToDCs": [(1, "descriptors", "repeated", "bytes")],
    "ApbGetConnectionDescriptor": [],
    "ApbGetConnectionDescriptorResp": [(1, "success", "required", "bool"),
                                       (2, "descriptor", "optional", "bytes")],
    "ApbStartTransactionResp": [(1, "success", "required", "bool"),
                                (2, "transaction_descriptor", "optional", "bytes"),
                                (3, "errorcode", "optional", "uint32")],
    "ApbOperationResp": [(1, "success", "required", "bool"),
                         (2, "errorcode", "optional", "uint32")],
    "ApbReadObjectResp": [(1, "counter", "optional", "ApbGetCounterResp"),
                          (2, "set", "optional", "ApbGetSetResp"),
                          (3, "reg", "optional", "ApbGetRegResp"),
                          (4, "mvreg", "optional", "ApbGetMVRegResp"),
                          (6, "map", "optional", "ApbGetMapResp"),
                          (7, "flag", "optional", "ApbGetFlagResp")],
    "ApbReadObjectsResp": [(1, "success", "required", "bool"),
                           (2, "objects", "repeated", "ApbReadObjectResp"),
                           (3, "errorcode", "optional", "uint32")],
    "ApbCommitResp": [(1, "success", "required", "bool"),
                      (2, "commit_time", "optional", "bytes"),
                      (3, "errorcode", "optional", "uint32")],
    "ApbStaticReadObjectsResp": [(1, "objects", "required", "ApbReadObjectsResp"),
                                 (2, "committime", "required", "ApbCommitResp"),
                                 # ring-hint extension: msgpack
                                 # {owner, followers, vnodes} attached to
                                 # PROXIED replies; proto2 decoders that
                                 # predate it skip the unknown field
                                 (3, "ring_hint", "optional", "bytes")],
}

#: message code byte (antidote_pb_codec's messageCodes table)
MSG_CODES: Dict[str, int] = {
    "ApbErrorResp": 0,
    "ApbRegUpdate": 107,
    "ApbGetRegResp": 108,
    "ApbCounterUpdate": 109,
    "ApbGetCounterResp": 110,
    "ApbOperationResp": 111,
    "ApbSetUpdate": 112,
    "ApbGetSetResp": 113,
    "ApbTxnProperties": 114,
    "ApbBoundObject": 115,
    "ApbReadObjects": 116,
    "ApbUpdateOp": 117,
    "ApbUpdateObjects": 118,
    "ApbStartTransaction": 119,
    "ApbAbortTransaction": 120,
    "ApbCommitTransaction": 121,
    "ApbStaticUpdateObjects": 122,
    "ApbStaticReadObjects": 123,
    "ApbStartTransactionResp": 124,
    "ApbReadObjectResp": 125,
    "ApbReadObjectsResp": 126,
    "ApbCommitResp": 127,
    "ApbStaticReadObjectsResp": 128,
    # DC management (antidote_pb_process:process create_dc /
    # get_connection_descriptor / connect_to_dcs clauses); the
    # descriptor payload is an opaque blob to clients in the reference
    # too (term_to_binary there, msgpack here)
    "ApbCreateDC": 129,
    "ApbConnectToDCs": 130,
    "ApbGetConnectionDescriptor": 131,
    "ApbGetConnectionDescriptorResp": 132,
}
CODE_TO_NAME = {v: k for k, v in MSG_CODES.items()}

#: request codes the server dispatches to this codec (the antidotec_pb
#: client surface); disjoint from the native msgpack codec's codes 1-11
APB_REQUEST_CODES = frozenset((116, 118, 119, 120, 121, 122, 123,
                               129, 130, 131))

#: antidote.proto CRDT_type enum <-> our type registry names
CRDT_TYPES = {
    3: "counter_pn", 4: "set_aw", 5: "register_lww", 6: "register_mv",
    8: "map_go", 10: "set_rw", 11: "map_rr", 12: "counter_fat",
    13: "flag_ew", 14: "flag_dw", 15: "counter_b",
}
TYPE_IDS = {v: k for k, v in CRDT_TYPES.items()}

_SET_ADD, _SET_REMOVE = 1, 2


def _enc_scalar(kind: str, v) -> bytes:
    if kind == "bytes":
        v = v if isinstance(v, (bytes, bytearray)) else str(v).encode()
        return _enc_varint(len(v)) + bytes(v)
    if kind in ("uint32", "enum"):
        return _enc_varint(int(v))
    if kind == "bool":
        return _enc_varint(1 if v else 0)
    if kind == "sint64" or kind == "sint32":
        return _enc_varint(_zigzag(int(v)) & 0xFFFFFFFFFFFFFFFF)
    raise TypeError(kind)


def encode_msg(name: str, d: Dict[str, Any]) -> bytes:
    """One message body (no code byte), fields in schema order."""
    out = bytearray()
    for no, fname, label, kind in SCHEMAS[name]:
        v = d.get(fname)
        if v is None:
            if label == "required":
                raise ValueError(f"{name}.{fname} is required")
            continue
        vals = v if label == "repeated" else [v]
        for x in vals:
            if kind in SCHEMAS:  # nested message
                body = encode_msg(kind, x)
                out += _enc_varint((no << 3) | _WT_LEN)
                out += _enc_varint(len(body)) + body
            elif kind == "bytes":
                out += _enc_varint((no << 3) | _WT_LEN)
                out += _enc_scalar(kind, x)
            else:
                out += _enc_varint((no << 3) | _WT_VARINT)
                out += _enc_scalar(kind, x)
    return bytes(out)


def decode_msg(name: str, data: bytes) -> Dict[str, Any]:
    schema = {no: (fname, label, kind) for no, fname, label, kind in SCHEMAS[name]}
    out: Dict[str, Any] = {
        fname: [] for _, (fname, label, _) in schema.items() if label == "repeated"
    }
    pos = 0
    while pos < len(data):
        tag, pos = _dec_varint(data, pos)
        no, wt = tag >> 3, tag & 7
        if wt == _WT_VARINT:
            raw, pos = _dec_varint(data, pos)
        elif wt == _WT_LEN:
            ln, pos = _dec_varint(data, pos)
            raw = data[pos:pos + ln]
            pos += ln
        elif wt == 5:  # 32-bit, skip (unused by this schema)
            raw, pos = data[pos:pos + 4], pos + 4
        elif wt == 1:  # 64-bit, skip
            raw, pos = data[pos:pos + 8], pos + 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        ent = schema.get(no)
        if ent is None:
            continue  # unknown field: skip (proto2 forward compat)
        fname, label, kind = ent
        if kind in SCHEMAS:
            val = decode_msg(kind, raw)
        elif kind == "bytes":
            val = bytes(raw)
        elif kind in ("uint32", "enum"):
            val = int(raw)
        elif kind == "bool":
            val = bool(raw)
        elif kind in ("sint64", "sint32"):
            val = _unzigzag(int(raw))
        else:
            raise TypeError(kind)
        if label == "repeated":
            out[fname].append(val)
        else:
            out[fname] = val
    return out


def encode_frame_body(name: str, d: Dict[str, Any]) -> bytes:
    """Code byte + message body — what goes inside the 4-byte length frame."""
    return bytes([MSG_CODES[name]]) + encode_msg(name, d)


def decode_frame_body(body: bytes) -> Tuple[str, Dict[str, Any]]:
    name = CODE_TO_NAME[body[0]]
    return name, decode_msg(name, body[1:])


# ---------------------------------------------------------------------------
# semantic bridge: Apb messages <-> node API shapes
# ---------------------------------------------------------------------------
def _enc_clock(vc) -> bytes:
    """Commit clocks ride as opaque bytes (the reference ships
    term_to_binary'd vectorclocks the same way — clients echo them back)."""
    return msgpack.packb([int(x) for x in np.asarray(vc)])


def _dec_clock(data: Optional[bytes]):
    if not data:
        return None
    return msgpack.unpackb(data, raw=False)


def to_bytes(v) -> bytes:
    """Client-visible payloads as apb bytes: values written through this
    codec are stored as bytes and round-trip exactly; values written by
    native clients render best-effort."""
    if isinstance(v, (bytes, bytearray)):
        return bytes(v)
    if isinstance(v, str):
        return v.encode()
    return msgpack.packb(v, use_bin_type=True)


def _bound_object(bo: Dict[str, Any]) -> Tuple[bytes, str, bytes]:
    t = CRDT_TYPES.get(bo["type"])
    if t is None:
        raise ValueError(f"unknown CRDT_type enum {bo['type']}")
    return bo["key"], t, bo["bucket"]


def ops_from_update_operation(upop: Dict[str, Any], type_name: str,
                              my_dc: int = 0) -> List[tuple]:
    """ApbUpdateOperation -> our op tuples (one apb op may expand to
    several, e.g. a set update carrying both adds and rems).  ``my_dc``
    is the actor lane for bounded-counter ops (the reference's BCOUNTER
    updates act on the receiving DC's rights the same way)."""
    if upop.get("counterop") is not None:
        inc = int(upop["counterop"].get("inc", 1))
        if type_name == "counter_b":
            # counter_b ops carry (amount, actor-lane)
            if inc >= 0:
                return [("increment", (inc, my_dc))]
            return [("decrement", (-inc, my_dc))]
        return [("increment", inc)]
    if upop.get("setop") is not None:
        so = upop["setop"]
        ops: List[tuple] = []
        if so.get("adds"):
            ops.append(("add_all", list(so["adds"])))
        if so.get("rems"):
            ops.append(("remove_all", list(so["rems"])))
        return ops
    if upop.get("regop") is not None:
        return [("assign", upop["regop"]["value"])]
    if upop.get("flagop") is not None:
        return [("enable" if upop["flagop"]["value"] else "disable", None)]
    if upop.get("resetop") is not None:
        return [("reset", None)]
    if upop.get("mapop") is not None:
        mo = upop["mapop"]
        ops = []
        fields = []
        for nest in mo.get("updates", []):
            fkey = nest["key"]["key"]
            ftype = CRDT_TYPES[nest["key"]["type"]]
            for sub in ops_from_update_operation(nest["update"], ftype,
                                                 my_dc):
                fields.append(((fkey, ftype), sub))
        if fields:
            ops.append(("update", fields))
        removed = [
            (mk["key"], CRDT_TYPES[mk["type"]])
            for mk in mo.get("removedKeys", [])
        ]
        if removed:
            ops.append(("remove_all", removed))
        return ops
    raise ValueError("empty ApbUpdateOperation")


def updates_from_update_ops(ups: List[Dict[str, Any]],
                            my_dc: int = 0) -> List[tuple]:
    out = []
    for up in ups:
        key, t, bucket = _bound_object(up["boundobject"])
        for op in ops_from_update_operation(up["operation"], t, my_dc):
            out.append((key, t, bucket, op))
    return out


def value_to_read_resp(type_name: str, value) -> Dict[str, Any]:
    """Our client value -> ApbReadObjectResp (per-type lane)."""
    if type_name in ("counter_pn", "counter_fat", "counter_b"):
        if type_name == "counter_b":
            # reference renders a bounded counter as its usable value
            value = int(value) if not isinstance(value, dict) else value.get(
                "value", 0
            )
        return {"counter": {"value": int(value)}}
    if type_name in ("set_aw", "set_rw", "set_go"):
        return {"set": {"value": [to_bytes(v) for v in value]}}
    if type_name == "register_lww":
        return {"reg": {"value": to_bytes(value) if value is not None else b""}}
    if type_name == "register_mv":
        return {"mvreg": {"values": [to_bytes(v) for v in value]}}
    if type_name in ("flag_ew", "flag_dw"):
        return {"flag": {"value": bool(value)}}
    if type_name in ("map_rr", "map_go"):
        entries = []
        for (f, ft), v in sorted(value.items(), key=lambda kv: to_bytes(kv[0][0])):
            entries.append({
                "key": {"key": to_bytes(f), "type": TYPE_IDS[ft]},
                "value": value_to_read_resp(ft, v),
            })
        return {"map": {"entries": entries}}
    raise ValueError(f"no apb value lane for {type_name}")


def read_resp_to_value(resp: Dict[str, Any]):
    """Client-side inverse of :func:`value_to_read_resp`: one decoded
    ApbReadObjectResp -> the client-visible value (counter int, set
    bytes list, register bytes, flag bool, map dict) — what an
    apb-dialect session client folds into its loop."""
    if resp.get("counter") is not None:
        return int(resp["counter"]["value"])
    if resp.get("set") is not None:
        return list(resp["set"].get("value", []))
    if resp.get("reg") is not None:
        return resp["reg"]["value"]
    if resp.get("mvreg") is not None:
        return list(resp["mvreg"].get("values", []))
    if resp.get("flag") is not None:
        return bool(resp["flag"]["value"])
    if resp.get("map") is not None:
        out = {}
        for ent in resp["map"].get("entries", []):
            k = ent["key"]
            out[(k["key"], CRDT_TYPES[k["type"]])] = read_resp_to_value(
                ent["value"])
        return out
    return None


def _op_to_operation(type_name: str, op: tuple) -> Dict[str, Any]:
    """One native op tuple -> ApbUpdateOperation (client-side inverse of
    :func:`ops_from_update_operation` for the wire-expressible ops)."""
    kind, arg = op[0], (op[1] if len(op) > 1 else None)
    if type_name in ("map_rr", "map_go"):
        # map ops ride the mapop lane — the generic branches below
        # would mis-encode a field tuple as a set payload
        if kind == "update":
            fields = list(arg) if isinstance(arg, (list, tuple)) \
                and arg and isinstance(arg[0], (list, tuple)) \
                and len(arg[0]) == 2 and isinstance(
                    arg[0][0], (list, tuple)) else [arg]
            return {"mapop": {"updates": [
                {"key": {"key": to_bytes(fk), "type": TYPE_IDS[ft]},
                 "update": _op_to_operation(ft, sub)}
                for (fk, ft), sub in fields
            ]}}
        if kind in ("remove", "remove_all"):
            fields = [arg] if kind == "remove" else list(arg)
            return {"mapop": {"removedKeys": [
                {"key": to_bytes(fk), "type": TYPE_IDS[ft]}
                for fk, ft in fields
            ]}}
        if kind == "reset":
            return {"resetop": {}}
        raise ValueError(f"map op {kind!r} has no apb wire form")
    if kind in ("increment", "decrement"):
        amt = arg if not isinstance(arg, (tuple, list)) else arg[0]
        amt = 1 if amt is None else int(amt)
        return {"counterop": {"inc": amt if kind == "increment"
                              else -amt}}
    if kind in ("add", "add_all", "remove", "remove_all"):
        vals = (list(arg) if kind.endswith("_all")
                else [arg])
        field = "adds" if kind.startswith("add") else "rems"
        return {"setop": {"optype": _SET_ADD if field == "adds"
                          else _SET_REMOVE,
                          field: [to_bytes(v) for v in vals]}}
    if kind == "assign":
        return {"regop": {"value": to_bytes(arg)}}
    if kind in ("enable", "disable"):
        return {"flagop": {"value": kind == "enable"}}
    if kind == "reset":
        return {"resetop": {}}
    raise ValueError(f"op {kind!r} has no apb wire form")


def update_op_from_native(update: tuple) -> Dict[str, Any]:
    """One native update tuple ``(key, type, bucket, op)`` ->
    ApbUpdateOp — what an apb-dialect session client sends for its
    writes."""
    key, t, bucket, op = update
    return {
        "boundobject": {"key": to_bytes(key), "type": TYPE_IDS[t],
                        "bucket": to_bytes(bucket)},
        "operation": _op_to_operation(t, op),
    }


def _error(msg: str) -> bytes:
    return encode_frame_body("ApbErrorResp", {
        "errmsg": to_bytes(msg), "errcode": 0,
    })


def error_text(kind: str, msg: str, retry_after_ms: int = 0,
               redirect=None, fleet=None, tenant=None) -> str:
    """Typed error text: proto2 ApbErrorResp has no structured retry or
    redirect field, so the kind + retry-after hint + owner redirect ride
    the errmsg prefix (``"lagging retry_after_ms=NN
    redirect=HOST:PORT: ..."``), which antidotec_pb clients surface
    verbatim and session-aware ones parse back with
    :func:`parse_error_text` — the apb twin of the native dialect's
    structured error fields.  ``fleet`` (a list of follower
    endpoints) is the errmsg-encoded ring hint: space-free
    ``fleet=H:P,H:P`` so the existing param grammar carries it.
    ``tenant`` names the refusing tenant lane on
    ``tenant_busy`` replies — registry names are space-free by
    construction, so the same param grammar carries it."""
    out = kind
    if retry_after_ms:
        out += f" retry_after_ms={int(retry_after_ms)}"
    if tenant:
        out += f" tenant={tenant}"
    if redirect:
        out += f" redirect={redirect[0]}:{int(redirect[1])}"
    if fleet:
        out += " fleet=" + ",".join(
            f"{h}:{int(p)}" for h, p in fleet)
    return f"{out}: {msg}"


#: "kind key=val key=val: detail" — values are space-free (the redirect
#: value's own colon is fine: the detail separator is colon+SPACE)
_ERR_RE = re.compile(r"^([a-z_]+)((?: [a-z_]+=\S+)*): (.*)$", re.DOTALL)


def parse_error_text(errmsg) -> Dict[str, Any]:
    """Inverse of :func:`error_text`: decode an ApbErrorResp errmsg into
    ``{kind, retry_after_ms, redirect, detail}``.  Unrecognized shapes
    come back as ``kind="error"`` with the whole text as detail, so a
    plain reference-server error never crashes a session client."""
    text = errmsg.decode("utf-8", "replace") \
        if isinstance(errmsg, (bytes, bytearray)) else str(errmsg)
    m = _ERR_RE.match(text)
    if m is None:
        return {"kind": "error", "retry_after_ms": 0, "redirect": None,
                "detail": text}
    kind, params, detail = m.group(1), m.group(2), m.group(3)
    out: Dict[str, Any] = {"kind": kind, "retry_after_ms": 0,
                           "redirect": None, "fleet": None,
                           "tenant": None, "detail": detail}
    for part in params.split():
        k, _, v = part.partition("=")
        if k == "tenant":
            out["tenant"] = v
            continue
        # a malformed value (a foreign server whose errmsg happens to
        # match the prefix shape) falls back to the default, never a
        # crash — the documented never-breaks-a-session contract
        if k == "retry_after_ms":
            try:
                out["retry_after_ms"] = int(v)
            except ValueError:
                pass
        elif k == "redirect":
            host, _, port = v.rpartition(":")
            try:
                out["redirect"] = [host, int(port)]
            except ValueError:
                pass
        elif k == "fleet":
            eps = []
            for item in v.split(","):
                host, _, port = item.rpartition(":")
                try:
                    eps.append([host, int(port)])
                except ValueError:
                    eps = None
                    break
            if eps:
                out["fleet"] = eps
    return out


def overload_error(kind: str, msg: str, retry_after_ms: int = 0) -> bytes:
    """Pre-dispatch overload reply frame (the server's admission shed)."""
    return _error(error_text(kind, msg, retry_after_ms))


def _fleet_hint(server):
    """Errmsg ring-hint endpoints for a follower's typed redirect: the
    live fleet's followers as space-free ``H:P`` pairs for
    :func:`error_text`'s ``fleet=`` param (the owner rides the structured
    ``redirect=`` param; mixing the two would put the owner on a session
    client's read ring)."""
    plane = getattr(server, "proxy", None) if server is not None else None
    if plane is None:
        return None
    hint = plane.ring_hint()
    if hint is None:
        return None
    return hint.get("followers") or None


def _error_resp(e, server=None) -> Tuple[str, Dict[str, Any]]:
    """Map one exception to the typed ApbErrorResp reply — overload
    sheds, deadlines, read-only mode, escrow and cold-tier refusals,
    follower redirects (lagging/not_owner, with the retry hint and owner
    redirect in the errmsg), forwarding failures (``forward_failed``: the
    owner may have executed) — and the reference's catch-all shape for
    everything else.  ``server`` (fronting a follower) lets the
    redirect-class errors carry the errmsg-encoded fleet hint."""

    if isinstance(e, TenantBusyError):
        # tenant-scoped refusal: checked BEFORE BusyError
        # (its base class) so the tenant_busy kind — distinguishable
        # from global busy — survives the errmsg round trip
        text = error_text("tenant_busy", str(e), e.retry_after_ms,
                          tenant=e.tenant)
    elif isinstance(e, BusyError):
        text = error_text("busy", str(e), e.retry_after_ms)
    elif isinstance(e, InsufficientRightsError):
        # escrow refusal: counter_b rights exceeded — the
        # hint tracks the background transfer loop's expected grant
        text = error_text("insufficient_rights", str(e),
                          e.retry_after_ms)
    elif isinstance(e, ColdMiss):
        text = error_text("cold_miss", str(e), e.retry_after_ms)
    elif isinstance(e, DeadlineExceeded):
        text = error_text("deadline", str(e))
    elif isinstance(e, ReadOnlyError):
        text = error_text("read_only", str(e))
    elif isinstance(e, ReplicaLagging):
        text = error_text("lagging", str(e), e.retry_after_ms,
                          e.redirect, fleet=_fleet_hint(server))
    elif isinstance(e, NotOwnerError):
        text = error_text("not_owner", str(e), redirect=e.redirect,
                          fleet=_fleet_hint(server))
    elif isinstance(e, ForwardFailed):
        text = error_text("forward_failed", str(e),
                          fleet=_fleet_hint(server))
    else:
        text = f"{type(e).__name__}: {e}"
    return "ApbErrorResp", {"errmsg": to_bytes(text), "errcode": 0}


#: apb requests a FOLLOWER refuses with a typed not_owner redirect when it
#: has no proxy plane: writes and interactive transactions belong to the
#: owner, and the DC mesh mutations would subscribe the follower to
#: streams the owner never replicated (the native dialect's refusal set)
FOLLOWER_REFUSED = frozenset((
    "ApbStartTransaction", "ApbReadObjects", "ApbUpdateObjects",
    "ApbCommitTransaction", "ApbStaticUpdateObjects",
    "ApbConnectToDCs", "ApbCreateDC",
))

#: apb requests a follower with a proxy plane FORWARDS to the owner: the
#: refusal set minus the DC-mesh mutations (which stay refused), plus
#: abort (finishing a forwarded transaction must reach its owner)
FOLLOWER_FORWARDED = frozenset((
    "ApbStartTransaction", "ApbReadObjects", "ApbUpdateObjects",
    "ApbCommitTransaction", "ApbAbortTransaction",
    "ApbStaticUpdateObjects",
))


def handle_request(server, code: int, payload: bytes, conn_txns: set,
                   lock=None) -> bytes:
    """Dispatch one apb request; returns the response frame body (code
    byte + proto payload).  Mirrors antidote_pb_process:process/1; the
    error shape mirrors antidote_pb_protocol's catch-all.

    ``lock`` (the server's dispatch lock) is held only around the
    node/_txns mutation — protobuf decode/encode run outside it, like the
    native dialect.

    On a follower (``server.follower``) static reads pass the follower's
    token gate and ring routing (in :func:`_dispatch_static`), writes and
    transactions forward to the owner over the proxy plane, and without
    one they — and the DC mesh mutations always — answer the typed
    not_owner redirect, errmsg-encoded (proto2 ApbErrorResp has no
    structured fields)."""
    name = CODE_TO_NAME[code]
    fol = getattr(server, "follower", None)
    plane = getattr(server, "proxy", None)
    if fol is not None and name in FOLLOWER_REFUSED and (
            plane is None or name not in FOLLOWER_FORWARDED):
        server.metrics.session_redirects.inc(kind="not_owner",
                                             dialect="apb")
        return encode_frame_body(*_error_resp(
            NotOwnerError(fol.owner_client_addr), server=server))
    try:
        req = decode_msg(name, payload)  # outside the lock
    except Exception as e:
        return _error(f"{type(e).__name__}: {e}")
    if fol is not None and plane is not None and name in FOLLOWER_FORWARDED:
        return encode_frame_body(
            *_forward_apb(server, plane, name, req, conn_txns))
    if name in ("ApbStaticReadObjects", "ApbStaticUpdateObjects"):
        # static ops ride the server's gate helpers (batched: the gate's
        # dispatcher thread takes the lock; unbatched: they lock inline)
        # — the only static dispatch path, so it cannot drift from a
        # duplicate branch in _dispatch
        resp_name, resp = _dispatch_static(server, name, req)
        return encode_frame_body(resp_name, resp)
    with (lock if lock is not None else contextlib.nullcontext()):
        resp_name, resp = _dispatch(server, name, req, conn_txns)
    return encode_frame_body(resp_name, resp)  # outside the lock


def _forward_apb(server, plane, name: str, req: Dict[str, Any],
                 conn_txns: set) -> Tuple[str, Dict[str, Any]]:
    """Forward one apb write or transaction request from a follower to
    the owner's write plane: decoded once here, relayed over the plane's
    native channels, the owner's reply re-encoded apb — so both dialects
    share one failover loop, one at-most-once discipline and one
    ``proxy.forward`` fault site."""
    from antidote_tpu_torch.proto.codec import MessageCode, decode_value

    node = server.node
    my_dc = getattr(node, "dc_id", 0)
    deadline = deadline_from_ms(None, server.default_deadline_ms)
    try:
        if name == "ApbStaticUpdateObjects":
            clock = _dec_clock(req["transaction"].get("timestamp"))
            vc = plane.forward_update(
                updates_from_update_ops(req.get("updates", []), my_dc),
                clock, deadline)
            return "ApbCommitResp", {
                "success": True, "commit_time": _enc_clock(vc),
            }
        if name == "ApbStartTransaction":
            resp = plane.txn_call(MessageCode.START_TRANSACTION, {
                "clock": _dec_clock(req.get("timestamp")),
            })
            txid = resp["txid"]
            plane.forwarded_txns.add(txid)
            conn_txns.add(txid)
            return "ApbStartTransactionResp", {
                "success": True,
                "transaction_descriptor": str(txid).encode(),
            }
        txid = int(req["transaction_descriptor"])
        if name == "ApbReadObjects":
            objs = [_bound_object(bo) for bo in req["boundobjects"]]
            resp = plane.txn_call(MessageCode.READ_OBJECTS, {
                "txid": txid, "objects": [list(o) for o in objs],
            })
            vals = [decode_value(v) for v in resp["values"]]
            return "ApbReadObjectsResp", {
                "success": True,
                "objects": [
                    value_to_read_resp(t, v)
                    for (_, t, _), v in zip(objs, vals)
                ],
            }
        if name == "ApbUpdateObjects":
            ups = updates_from_update_ops(req["updates"], my_dc)
            try:
                plane.txn_call(MessageCode.UPDATE_OBJECTS, {
                    "txid": txid, "updates": [list(u) for u in ups],
                })
            except Exception:
                # the owner aborted + unregistered the txn (its update
                # failure discipline) — drop the forwarded bookkeeping
                plane.forwarded_txns.discard(txid)
                conn_txns.discard(txid)
                raise
            return "ApbOperationResp", {"success": True}
        if name == "ApbCommitTransaction":
            try:
                resp = plane.txn_call(MessageCode.COMMIT_TRANSACTION,
                                      {"txid": txid})
            except BusyError:
                raise  # txn stays OPEN at the owner — retryable
            except Exception:
                plane.forwarded_txns.discard(txid)
                conn_txns.discard(txid)
                raise
            plane.forwarded_txns.discard(txid)
            conn_txns.discard(txid)
            return "ApbCommitResp", {
                "success": True,
                "commit_time": _enc_clock(resp["commit_clock"]),
            }
        # ApbAbortTransaction
        plane.txn_call(MessageCode.ABORT_TRANSACTION, {"txid": txid})
        plane.forwarded_txns.discard(txid)
        conn_txns.discard(txid)
        return "ApbOperationResp", {"success": True}
    except Exception as e:
        return _error_resp(e, server=server)


def _dispatch_static(server, name: str, req: Dict[str, Any]):
    node = server.node
    my_dc = getattr(node, "dc_id", 0)
    # proto2 ApbStaticRead/Update carry no deadline field, but the
    # server's configured default still applies: parked apb work that
    # outlives it is aborted at the batch-gate dequeue like any other
    deadline = deadline_from_ms(None, server.default_deadline_ms)
    try:
        if name == "ApbStaticUpdateObjects":
            clock = _dec_clock(req["transaction"].get("timestamp"))
            vc = server.static_update(
                updates_from_update_ops(req.get("updates", []), my_dc),
                clock, deadline=deadline,
            )
            return "ApbCommitResp", {
                "success": True, "commit_time": _enc_clock(vc),
            }
        clock = _dec_clock(req["transaction"].get("timestamp"))
        objs = [_bound_object(bo) for bo in req.get("objects", [])]
        via_proxy = False
        if getattr(server, "follower", None) is not None:
            # the session token gate and ring routing, the native
            # dialect's discipline (typed lagging only as the last
            # resort, errmsg-encoded)
            (vals, vc), via_proxy = server._follower_read(
                objs, clock, deadline, dialect="apb")
        else:
            vals, vc = server.static_read(objs, clock, deadline=deadline)
        resp = {
            "objects": {
                "success": True,
                "objects": [
                    value_to_read_resp(t, v)
                    for (_, t, _), v in zip(objs, vals)
                ],
            },
            "committime": {"success": True, "commit_time": _enc_clock(vc)},
        }
        if via_proxy:
            # teach capable clients the ring (proto2-safe: an unknown
            # optional field, skipped by decoders that predate it)
            hint = server.proxy.ring_hint()
            if hint is not None:
                resp["ring_hint"] = msgpack.packb(hint)
        return "ApbStaticReadObjectsResp", resp
    except Exception as e:
        return _error_resp(e, server=server)


def _dispatch(server, name: str, req: Dict[str, Any],
              conn_txns: set) -> Tuple[str, Dict[str, Any]]:
    node = server.node
    my_dc = getattr(node, "dc_id", 0)
    try:
        if name == "ApbStartTransaction":
            txn = node.start_transaction(
                clock=_dec_clock(req.get("timestamp"))
            )
            server._txns[txn.txid] = txn
            conn_txns.add(txn.txid)
            return "ApbStartTransactionResp", {
                "success": True,
                "transaction_descriptor": str(txn.txid).encode(),
            }
        if name == "ApbReadObjects":
            txn = server._txns.get(int(req["transaction_descriptor"]))
            if txn is None:
                raise KeyError("unknown transaction")
            objs = [_bound_object(bo) for bo in req["boundobjects"]]
            vals = node.read_objects(objs, txn)
            return "ApbReadObjectsResp", {
                "success": True,
                "objects": [
                    value_to_read_resp(t, v)
                    for (_, t, _), v in zip(objs, vals)
                ],
            }
        if name == "ApbUpdateObjects":
            txid = int(req["transaction_descriptor"])
            txn = server._txns.get(txid)
            if txn is None:
                raise KeyError("unknown transaction")
            try:
                node.update_objects(
                    updates_from_update_ops(req["updates"], my_dc), txn
                )
            except Exception:
                # a failed update aborts the txn (as the reference's
                # coordinator FSM does) — merely dropping the handle
                # would leak an active txn that pins the cert-GC floor
                server._txns.pop(txid, None)
                conn_txns.discard(txid)
                if txn.active:
                    node.abort_transaction(txn)
                raise
            return "ApbOperationResp", {"success": True}
        if name == "ApbCommitTransaction":
            txid = int(req["transaction_descriptor"])
            txn = server._txns.get(txid)
            if txn is None:
                raise KeyError("unknown transaction")
            # keep the txn registered until the outcome is known: a
            # commit-backlog BusyError leaves it OPEN (the shed happens
            # before the group touches it), so the busy errmsg's retry
            # hint is honest — the SAME descriptor can be resubmitted
            # (mirrors the native dialect's COMMIT_TRANSACTION)
            try:
                vc = node.commit_transaction(txn)
            except BusyError:
                raise
            except BaseException:
                server._txns.pop(txid, None)  # txn is dead
                conn_txns.discard(txid)
                raise
            server._txns.pop(txid, None)
            conn_txns.discard(txid)
            return "ApbCommitResp", {
                "success": True, "commit_time": _enc_clock(vc),
            }
        if name == "ApbAbortTransaction":
            txid = int(req["transaction_descriptor"])
            txn = server._txns.pop(txid, None)
            conn_txns.discard(txid)
            if txn is not None:
                node.abort_transaction(txn)
            return "ApbOperationResp", {"success": True}
        if name == "ApbGetConnectionDescriptor":
            return "ApbGetConnectionDescriptorResp", {
                "success": True,
                "descriptor": msgpack.packb(server._get_descriptor()),
            }
        if name == "ApbConnectToDCs":
            server._connect_to_dcs(
                [msgpack.unpackb(b, raw=False)
                 for b in req.get("descriptors", [])]
            )
            return "ApbOperationResp", {"success": True}
        if name == "ApbCreateDC":
            server._create_dc([b.decode() if isinstance(b, bytes) else b
                               for b in req.get("nodes", [])])
            return "ApbOperationResp", {"success": True}
        return "ApbErrorResp", {
            "errmsg": to_bytes(f"unhandled apb request {name}"), "errcode": 0,
        }
    except Exception as e:  # mirror the reference's catch-all error reply
        return _error_resp(e)
