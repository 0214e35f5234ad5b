"""Client wire protocol.

The reference speaks length-prefixed protobuf over TCP port 8087
(antidote_pb_protocol / antidote_pb_process / antidote_pb_sup).  Here the
same semantic surface rides 4-byte-length frames carrying a 1-byte message
code plus a msgpack body, and the same port also speaks the reference's
protobuf dialect (:mod:`apb`).
"""

from antidote_tpu_torch.proto.client import AntidoteClient
from antidote_tpu_torch.proto.codec import MessageCode, decode, encode
from antidote_tpu_torch.proto.server import ProtocolServer, DEFAULT_PORT

__all__ = [
    "AntidoteClient",
    "MessageCode",
    "ProtocolServer",
    "DEFAULT_PORT",
    "decode",
    "encode",
]
