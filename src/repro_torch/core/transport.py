"""Length-prefixed framed TCP transport for the edge↔cloud wire bytes (a
copy of ``repro.core.transport``: a JAX peer and a torch peer talk over
it, so its bytes must stay equal to the reference's).

``core.wire`` defines WHAT crosses the link — packed ``DraftPayload`` /
``VerdictPayload`` bytes.  This module defines HOW they cross a real
socket: a minimal frame layer plus the session-control messages the
two-process deployment needs (``serve.net.CloudServer`` /
``serve.net.EdgeClient``).  It deliberately knows nothing about models,
engines or scheduling — it moves bytes, so the determinism invariant
(transports move bytes and clocks, never tokens) holds by construction.

Frame layout (everything big-endian):

    length:u32  type:u8  body:length-1 bytes

``length`` counts the type byte plus the body, so an empty-bodied frame
has length 1.  Lengths above ``MAX_FRAME`` are rejected before any
allocation — a garbage length prefix cannot make the receiver try to
buffer gigabytes.  Short reads raise ``TransportError`` (the peer went
away mid-frame); corrupt *payloads* inside a well-formed frame are the
wire codec's problem and surface as ``wire.WireDecodeError``, on which
the server closes the offending connection.

Message types (one TCP connection per radio cell, mirroring the
simulator's per-cell ``SharedLink`` isolation):

    HELLO / HELLO_OK — JSON session handshake: protocol version, the
        arch/smoke/method/engine config digest both processes must
        derive identical models from, the negotiated wire codec, and
        the connecting cell id.  The server validates the digest
        against the session (first cell creates it, later cells must
        match bit-for-bit) and rejects mismatches with ERROR.
    ADMIT            — JSON slot admission (slot, seed, codec override,
        prompt token ids); the cloud mirrors the edge's admit.
    VERIFY           — binary: count:u16, then per item slot:u16
        len:u32 payload-bytes.  The hot uplink path: packed draft
        payloads for one verify call.
    VERDICTS         — binary: t_llm:f64, mode:u8, then either mode 0
        (per-slot verdicts: count:u16, per item slot:u16 len:u32
        bytes) or mode 1 (one coalesced downlink frame: len:u32
        bytes).  t_llm is the server's MEASURED verify wall-clock.
    ERROR            — JSON {"error": reason}; the sender closes the
        connection right after.
    BYE              — clean shutdown of one connection.
    STATS            — JSON request/response (empty-object request): the
        edge pulls the server's metrics snapshot (frame counters, decode
        errors, measured verify-time stats) over the same connection.
        Observability only — the reply never feeds the token path.
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Dict, List, Optional, Tuple

PROTO_VERSION = 1
MAX_FRAME = 64 * 1024 * 1024          # 64 MiB: no sane frame is larger

MSG_HELLO = 1
MSG_HELLO_OK = 2
MSG_ADMIT = 3
MSG_VERIFY = 4
MSG_VERDICTS = 5
MSG_ERROR = 6
MSG_BYE = 7
MSG_STATS = 8

_LEN = struct.Struct(">I")
_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_F64 = struct.Struct(">d")


class TransportError(ConnectionError):
    """Framing-level failure: peer EOF mid-frame, oversized length
    prefix, unknown message type, or a rejected handshake."""


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes, reassembling across partial recv() returns
    (TCP is a byte stream — a frame routinely arrives in pieces)."""
    parts = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise TransportError(
                f"connection closed mid-frame ({got}/{n} bytes)")
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


def send_frame(sock: socket.socket, msg_type: int, body: bytes = b""):
    assert 0 < msg_type < 256, msg_type
    n = 1 + len(body)
    if n > MAX_FRAME:
        raise TransportError(f"frame of {n} bytes exceeds MAX_FRAME")
    sock.sendall(_LEN.pack(n) + bytes([msg_type]) + body)


def recv_frame(sock: socket.socket) -> Tuple[int, bytes]:
    (n,) = _LEN.unpack(recv_exact(sock, 4))
    if not 1 <= n <= MAX_FRAME:
        raise TransportError(f"frame length {n} out of range")
    data = recv_exact(sock, n)
    return data[0], data[1:]


class Conn:
    """One framed connection (either end).  Thin wrapper so the serving
    code never touches raw sockets, plus JSON helpers for the control
    messages."""

    def __init__(self, sock: socket.socket, timeout_s: Optional[float] = None):
        self.sock = sock
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if timeout_s is not None:
            sock.settimeout(timeout_s)

    def fileno(self) -> int:
        return self.sock.fileno()

    def send(self, msg_type: int, body: bytes = b""):
        send_frame(self.sock, msg_type, body)

    def send_json(self, msg_type: int, obj) -> None:
        self.send(msg_type, json.dumps(obj).encode("utf-8"))

    def recv(self) -> Tuple[int, bytes]:
        return recv_frame(self.sock)

    def recv_expect(self, msg_type: int) -> bytes:
        """Receive one frame that must be of the given type; an ERROR
        frame surfaces the peer's reason as a TransportError."""
        kind, body = self.recv()
        if kind == MSG_ERROR:
            raise TransportError(
                f"peer error: {decode_json(body).get('error', '?')}")
        if kind != msg_type:
            raise TransportError(
                f"expected message type {msg_type}, got {kind}")
        return body

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


def decode_json(body: bytes) -> dict:
    try:
        obj = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise TransportError(f"malformed JSON control body: {e}") from e
    if not isinstance(obj, dict):
        raise TransportError("JSON control body must be an object")
    return obj


# ----------------------------------------------------------------------
# Binary bodies for the hot path (uplink drafts, downlink verdicts)
# ----------------------------------------------------------------------
def pack_verify_body(items: List[Tuple[int, bytes]]) -> bytes:
    """count:u16 then (slot:u16 len:u32 bytes) per packed draft."""
    out = [_U16.pack(len(items))]
    for slot, data in items:
        out.append(_U16.pack(slot))
        out.append(_U32.pack(len(data)))
        out.append(data)
    return b"".join(out)


def unpack_verify_body(body: bytes) -> List[Tuple[int, bytes]]:
    view, off = memoryview(body), 0
    try:
        (m,) = _U16.unpack_from(view, off)
        off += 2
        items = []
        for _ in range(m):
            (slot,) = _U16.unpack_from(view, off)
            (n,) = _U32.unpack_from(view, off + 2)
            off += 6
            if off + n > len(body):
                raise TransportError("VERIFY body truncated")
            items.append((slot, bytes(view[off:off + n])))
            off += n
    except struct.error as e:
        raise TransportError(f"VERIFY body truncated: {e}") from e
    if off != len(body):
        raise TransportError("VERIFY body has trailing bytes")
    return items


def pack_verdicts_body(t_llm_s: float,
                       verdicts: Optional[List[Tuple[int, bytes]]] = None,
                       frame: Optional[bytes] = None) -> bytes:
    """t_llm:f64 mode:u8 then per-slot verdicts (mode 0) or one
    coalesced downlink frame (mode 1) — exactly one of the two."""
    assert (verdicts is None) != (frame is None)
    out = [_F64.pack(t_llm_s)]
    if frame is not None:
        out.append(b"\x01" + _U32.pack(len(frame)) + frame)
    else:
        out.append(b"\x00" + _U16.pack(len(verdicts)))
        for slot, data in verdicts:
            out.append(_U16.pack(slot))
            out.append(_U32.pack(len(data)))
            out.append(data)
    return b"".join(out)


def unpack_verdicts_body(body: bytes):
    """Returns (t_llm_s, per_slot_verdicts_or_None, frame_or_None)."""
    view, off = memoryview(body), 0
    try:
        (t_llm,) = _F64.unpack_from(view, off)
        off += 8
        mode = view[off]
        off += 1
        if mode == 1:
            (n,) = _U32.unpack_from(view, off)
            off += 4
            if off + n != len(body):
                raise TransportError("VERDICTS frame body length mismatch")
            return t_llm, None, bytes(view[off:off + n])
        if mode != 0:
            raise TransportError(f"unknown VERDICTS mode {mode}")
        (m,) = _U16.unpack_from(view, off)
        off += 2
        items = []
        for _ in range(m):
            (slot,) = _U16.unpack_from(view, off)
            (n,) = _U32.unpack_from(view, off + 2)
            off += 6
            if off + n > len(body):
                raise TransportError("VERDICTS body truncated")
            items.append((slot, bytes(view[off:off + n])))
            off += n
    except (struct.error, IndexError) as e:
        raise TransportError(f"VERDICTS body truncated: {e}") from e
    if off != len(body):
        raise TransportError("VERDICTS body has trailing bytes")
    return t_llm, items, None


def admit_body(slot: int, seed: int, wire_codec: Optional[str],
               prompt) -> Dict:
    return {"slot": int(slot), "seed": int(seed),
            "wire_codec": wire_codec,
            "prompt": [int(t) for t in prompt]}
