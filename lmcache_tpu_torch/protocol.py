"""Framed binary wire protocol for the remote cache server (a copy of
``lmcache_tpu/protocol.py``: both packages speak it byte for byte).

Capability parity with reference lmcache/protocol.py:17-70 (client/server
meta messages for PUT/GET/EXIST/LIST), redesigned to fix its structural
limits: the key field is length-prefixed instead of a fixed 150-byte pad
(reference TODO at protocol.py:4), the header is versioned, and **PUT is
acknowledged** (the reference server sent no ack — known bug, TODO:1).

Client request frame (little endian):

    magic   u16  0xC7C0
    version u8   = 1
    command u8   PUT / GET / EXIST / LIST / DEL / PING / HEALTH / MEXIST
    key_len u32
    payload u64  payload byte length
    key     key_len bytes (utf-8 key string; LIST: prefix filter, may be "")
    payload payload bytes (PUT: blob; MEXIST: '\\n'-joined key strings)

MEXIST batches existence checks into ONE round trip (the reference —
remote_backend.py:98-117 — and our r1 protocol probed per chunk: a
62-chunk store at this environment's 33 ms RTT burned ~2 s in EXISTs).
The response payload is one byte per key, 1 = present, in request order.

Server response frame:

    magic   u16  0xC7C1
    version u8   = 1
    code    u16  OK / FAIL / NOT_FOUND (HTTP-style codes)
    payload u64  payload byte length
    payload payload bytes (GET: blob; LIST: '\\n'-joined key strings)
"""

import enum
import struct
from dataclasses import dataclass

MAGIC_REQUEST = 0xC7C0
MAGIC_RESPONSE = 0xC7C1
VERSION = 1

_REQ = struct.Struct("<HBBIQ")
_RESP = struct.Struct("<HBHQ")

REQUEST_HEADER_SIZE = _REQ.size  # 16
RESPONSE_HEADER_SIZE = _RESP.size  # 13

MAX_KEY_LEN = 1 << 16
MAX_PAYLOAD_LEN = 1 << 40


class Command(enum.IntEnum):
    PUT = 1
    GET = 2
    EXIST = 3
    LIST = 4
    DEL = 5
    PING = 6
    HEALTH = 7
    MEXIST = 8


class Code(enum.IntEnum):
    OK = 200
    FAIL = 400
    NOT_FOUND = 404


@dataclass
class RequestHeader:
    command: Command
    key: str
    payload_length: int = 0

    def pack(self) -> bytes:
        key_bytes = self.key.encode("utf-8")
        if len(key_bytes) > MAX_KEY_LEN:
            raise ValueError("key too long")
        return _REQ.pack(MAGIC_REQUEST, VERSION, int(self.command),
                         len(key_bytes), self.payload_length) + key_bytes

    @staticmethod
    def unpack_fixed(bs: bytes) -> tuple:
        """Parse the fixed 16-byte prefix ->
        (command, key_len, payload_len)."""
        magic, version, command, key_len, payload_len = _REQ.unpack(bs)
        if magic != MAGIC_REQUEST:
            raise ValueError(f"Bad request magic: {magic:#x}")
        if version != VERSION:
            raise ValueError(f"Unsupported protocol version: {version}")
        if key_len > MAX_KEY_LEN or payload_len > MAX_PAYLOAD_LEN:
            raise ValueError("Frame limits exceeded")
        return Command(command), key_len, payload_len


@dataclass
class ResponseHeader:
    code: Code
    payload_length: int = 0

    def pack(self) -> bytes:
        return _RESP.pack(MAGIC_RESPONSE, VERSION, int(self.code),
                          self.payload_length)

    @staticmethod
    def unpack(bs: bytes) -> "ResponseHeader":
        magic, version, code, payload_len = _RESP.unpack(bs)
        if magic != MAGIC_RESPONSE:
            raise ValueError(f"Bad response magic: {magic:#x}")
        if version != VERSION:
            raise ValueError(f"Unsupported protocol version: {version}")
        return ResponseHeader(Code(code), payload_len)
