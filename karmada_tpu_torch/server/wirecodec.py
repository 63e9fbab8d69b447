"""Negotiated binary wire codec: length-prefixed frames + rv-based deltas
(the port's copy of server/wirecodec.py; every literal and frame byte is
the reference's, so the two packages interoperate on one wire).

This module is the ONE defining site for every literal the codec puts on
the wire (content type, frame magic/version, the advertise header) — the
constant-drift analyzer (analysis/constant_drift.py) holds the rest of the
tree to re-exporting these by assignment, so a client and a server can
never disagree about a negotiation literal.

Negotiation (docs/PERF.md "Async wire plane"):

- watch streams: the client sends `Accept: application/x-karmada-bin`;
  a codec-aware server answers with that Content-Type and frames, a
  pre-binary server answers `application/json-lines` and the client falls
  back to line parsing — negotiation is observable per response, never
  assumed.
- POST bodies (batch writes, replication appends, the coalesced
  agent-status path): a codec-aware server advertises
  `X-Karmada-Wire: <version>` on every response; a client upgrades its
  subsequent request bodies only after seeing it (a pre-binary server
  would 500 on a frame it cannot parse), and downgrades stickily if a
  binary body is ever rejected.

Frame format (network byte order):

    2s  magic   b"KW"
    B   version WIRE_VERSION
    B   type    FRAME_*
    I   payload length
    [payload]

FRAME_HEARTBEAT has an empty payload. FRAME_EVENT carries the UTF-8 JSON
of the same {"kind","event","rv","obj"} object a JSON line carries — the
bit-parity baseline. FRAME_DELTA carries {"kind","event","rv","ns","name",
"base","patch"}: only the fields that changed against the object at rv
`base`, which the client provably holds — the rv-exact stream contract
(store/watchcache.py, store/replication.py) means a client whose
contiguous stream covered `base` has byte-identical state for that key.
A client whose recorded rv for the key disagrees with `base` ends the
attachment for a replay resync instead of applying onto a wrong base.
FRAME_MESSAGE is a zlib-compressed JSON message — the body framing the
replication shipper and batch POSTs ride.

Patch grammar (`diff`/`apply_patch`): a patch is a 2- or 3-element list —
`[OP_REPLACE, value]` replaces the node wholesale; `[OP_MERGE, {key:
subpatch}, [deleted_keys]]` edits a dict in place (dicts recurse, lists
and scalars replace). `apply_patch(base, diff(base, new)) == new` exactly,
for any JSON-safe values.
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Iterator, Optional

# wire literals — single defining module (see module docstring)
CONTENT_TYPE_BIN = "application/x-karmada-bin"
CONTENT_TYPE_JSON_LINES = "application/json-lines"
WIRE_MAGIC = b"KW"
WIRE_VERSION = 1
HEADER_WIRE = "X-Karmada-Wire"

FRAME_HEARTBEAT = 0
FRAME_EVENT = 1
FRAME_DELTA = 2
FRAME_MESSAGE = 3

_HDR = struct.Struct("!2sBBI")
HEADER_LEN = _HDR.size  # 8

# one frame may not claim more than this: a corrupt/hostile length prefix
# must not make a reader buffer gigabytes before noticing
MAX_FRAME_BYTES = 64 << 20

OP_REPLACE = 0
OP_MERGE = 1


class WireProtocolError(Exception):
    """Framing violation: bad magic, unknown version/type, oversized or
    malformed payload. Readers treat it as a broken stream (resync)."""


def pack_frame(ftype: int, payload: bytes = b"") -> bytes:
    return _HDR.pack(WIRE_MAGIC, WIRE_VERSION, ftype, len(payload)) + payload


HEARTBEAT_FRAME = pack_frame(FRAME_HEARTBEAT)


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


class FrameReader:
    """Incremental frame parser for a byte stream: feed() chunks as they
    arrive, iterate complete (type, payload) frames. Partial frames stay
    buffered; framing violations raise WireProtocolError."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> Iterator[tuple[int, bytes]]:
        self._buf += data
        buf = self._buf
        off = 0
        while len(buf) - off >= HEADER_LEN:
            ftype, length = unpack_header(bytes(buf[off:off + HEADER_LEN]))
            end = off + HEADER_LEN + length
            if len(buf) < end:
                break
            yield ftype, bytes(buf[off + HEADER_LEN:end])
            off = end
        if off:
            del buf[:off]


# -- structural deltas -----------------------------------------------------


def diff(base: Any, new: Any) -> list:
    """A patch turning `base` into `new`. Dicts are merged key-wise
    (recursing into dict-valued keys); everything else — scalars, lists,
    type changes — replaces wholesale. Exact by construction: the wire
    JSON has no float NaN/-0.0 subtleties the equality check would miss
    (codec output is round-trippable JSON)."""
    if not isinstance(base, dict) or not isinstance(new, dict):
        return [OP_REPLACE, new]
    edits: dict[str, list] = {}
    deleted = [k for k in base if k not in new]
    for k, v in new.items():
        if k not in base:
            edits[k] = [OP_REPLACE, v]
        elif base[k] != v:
            edits[k] = diff(base[k], v)
    return [OP_MERGE, edits, deleted]


def apply_patch(base: Any, patch: Any) -> Any:
    """Apply a `diff` patch. Returns a NEW value (the base is never
    mutated; unchanged subtrees are shared). Raises WireProtocolError on
    a malformed patch or an OP_MERGE against a non-dict base."""
    if not isinstance(patch, (list, tuple)) or not patch:
        raise WireProtocolError(f"malformed patch {patch!r}")
    op = patch[0]
    if op == OP_REPLACE:
        if len(patch) != 2:
            raise WireProtocolError("malformed replace patch")
        return patch[1]
    if op != OP_MERGE:
        raise WireProtocolError(f"unknown patch op {op!r}")
    if len(patch) != 3 or not isinstance(patch[1], dict):
        raise WireProtocolError("malformed merge patch")
    if not isinstance(base, dict):
        raise WireProtocolError("merge patch against non-dict base")
    out = dict(base)
    for k in patch[2]:
        out.pop(k, None)
    for k, sub in patch[1].items():
        out[k] = apply_patch(out.get(k), sub)
    return out


def canonical(enc: Any) -> str:
    """Canonical JSON text of a wire encoding — the bit-parity check the
    delta tests and the bench assert (delta-applied state must reproduce
    this exactly at every rv)."""
    return json.dumps(enc, sort_keys=True, separators=(",", ":"))


# -- event frames ----------------------------------------------------------


def event_frame(kind: str, event: str, rv: int, enc: Any) -> bytes:
    """Full event as one FRAME_EVENT — same JSON object as the line
    codec, so JSON stays the parity baseline byte-for-byte."""
    payload = json.dumps(
        {"kind": kind, "event": event, "rv": rv, "obj": enc}
    ).encode()
    return pack_frame(FRAME_EVENT, payload)


def delta_frame(kind: str, event: str, rv: int, namespace: str, name: str,
                base_rv: int, patch: list) -> bytes:
    payload = json.dumps({
        "kind": kind, "event": event, "rv": rv, "ns": namespace,
        "name": name, "base": base_rv, "patch": patch,
    }).encode()
    return pack_frame(FRAME_DELTA, payload)


# -- framed message bodies (replication / batch POSTs) ---------------------


def pack_message(obj: Any) -> bytes:
    """One JSON message as a single zlib-compressed FRAME_MESSAGE — the
    request-body encoding negotiated via HEADER_WIRE. zlib is stdlib: no
    new dependency, and replication append batches (many near-identical
    records) compress hard."""
    return pack_frame(FRAME_MESSAGE,
                      zlib.compress(json.dumps(obj).encode(), 6))


def unpack_message(data: bytes) -> Any:
    """Inverse of pack_message; raises WireProtocolError on any framing
    or compression violation (the server maps it to HTTP 400)."""
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


def accepts_binary(accept_header: Optional[str]) -> bool:
    return bool(accept_header) and CONTENT_TYPE_BIN in accept_header


def body_rejected(status: int, message: str = "") -> bool:
    """Did this HTTP error mean "the request body could not be parsed"?
    Drives the client's sticky downgrade after a binary POST. 400/415 is
    the binary-aware server's explicit answer (WireProtocolError -> 400);
    a genuinely pre-binary server has no such mapping — its json parse of
    the frame dies in a generic 500 whose message carries the decoder's
    exception name (UnicodeDecodeError / JSONDecodeError), so that shape
    counts too. A retry the downgrade triggers is safe exactly because a
    server that could not parse the body cannot have committed it."""
    if status in (400, 415):
        return True
    return status == 500 and "decode" in (message or "").lower()


def is_binary_content_type(content_type: Optional[str]) -> bool:
    return bool(content_type) and CONTENT_TYPE_BIN in content_type
