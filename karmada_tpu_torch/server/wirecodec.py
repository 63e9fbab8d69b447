"""The negotiated binary body codec that `httpbase.read_json` sniffs: one
JSON message as a zlib-compressed, length-prefixed frame.

A copy of the message half of karmada_tpu/server/wirecodec.py (the wire
literals, the frame header, `pack_message` / `unpack_message`); the watch
stream's event and delta frames serve the control plane, which the port
does not have yet.

Frame format (network byte order):

    2s  magic   b"KW"
    B   version WIRE_VERSION
    B   type    FRAME_*
    I   payload length
    [payload]
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Optional

# wire literals, as the reference defines them
CONTENT_TYPE_BIN = "application/x-karmada-bin"
WIRE_MAGIC = b"KW"
WIRE_VERSION = 1
HEADER_WIRE = "X-Karmada-Wire"

FRAME_MESSAGE = 3

_HDR = struct.Struct("!2sBBI")
HEADER_LEN = _HDR.size  # 8

# one frame may not claim more than this: a corrupt/hostile length prefix
# must not make a reader buffer gigabytes before noticing
MAX_FRAME_BYTES = 64 << 20


class WireProtocolError(Exception):
    """Framing violation: bad magic, unknown version/type, oversized or
    malformed payload."""


def pack_frame(ftype: int, payload: bytes = b"") -> bytes:
    return _HDR.pack(WIRE_MAGIC, WIRE_VERSION, ftype, len(payload)) + payload


def unpack_header(data: bytes) -> tuple[int, int]:
    """(frame type, payload length) from one 8-byte header."""
    magic, version, ftype, length = _HDR.unpack(data)
    if magic != WIRE_MAGIC:
        raise WireProtocolError(f"bad frame magic {magic!r}")
    if version != WIRE_VERSION:
        raise WireProtocolError(f"unsupported wire version {version}")
    if length > MAX_FRAME_BYTES:
        raise WireProtocolError(f"frame length {length} exceeds cap")
    return ftype, length


def pack_message(obj: Any) -> bytes:
    """One JSON message as a single zlib-compressed FRAME_MESSAGE — the
    request-body encoding negotiated via HEADER_WIRE."""
    return pack_frame(FRAME_MESSAGE,
                      zlib.compress(json.dumps(obj).encode(), 6))


def unpack_message(data: bytes) -> Any:
    """Inverse of pack_message; raises WireProtocolError on any framing
    or compression violation."""
    if len(data) < HEADER_LEN:
        raise WireProtocolError("short message frame")
    ftype, length = unpack_header(data[:HEADER_LEN])
    if ftype != FRAME_MESSAGE:
        raise WireProtocolError(f"expected message frame, got type {ftype}")
    if len(data) != HEADER_LEN + length:
        raise WireProtocolError("message frame length mismatch")
    try:
        # decompressobj bounds the EXPANDED size (a bare zlib.decompress
        # bufsize is only an initial allocation hint, not a cap)
        d = zlib.decompressobj()
        raw = d.decompress(data[HEADER_LEN:], MAX_FRAME_BYTES)
        if d.unconsumed_tail:
            raise WireProtocolError("message frame expands past cap")
        return json.loads(raw.decode())
    except (zlib.error, ValueError) as e:
        raise WireProtocolError(f"undecodable message frame: {e}") from None


def is_binary_content_type(content_type: Optional[str]) -> bool:
    return bool(content_type) and CONTENT_TYPE_BIN in content_type
