"""RFC 6455 frame codec, server side (counterpart of
``gofr_tpu/websocket/frames.py``): client frames are masked, server
frames are not; text, binary, close, ping, pong and continuation frames.
"""

from __future__ import annotations

import base64
import hashlib
import os
import struct
from typing import Optional, Tuple

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA

MAGIC_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

CLOSE_PROTOCOL_ERROR = 1002
CLOSE_MESSAGE_TOO_BIG = 1009


class ProtocolError(ValueError):
    """An RFC 6455 violation: the connection is failed with close 1002."""

    close_code = CLOSE_PROTOCOL_ERROR


class FrameTooLarge(ProtocolError):
    """A declared frame length over the server's limit: close 1009."""

    close_code = CLOSE_MESSAGE_TOO_BIG


def encode_close(code: int, reason: bytes = b"") -> bytes:
    """A CLOSE frame carrying a 2-byte status code and a reason."""
    return encode_frame(OP_CLOSE, struct.pack(">H", code) + reason)


def accept_key(sec_websocket_key: str) -> str:
    digest = hashlib.sha1(
        (sec_websocket_key + MAGIC_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def encode_frame(opcode: int, payload: bytes, fin: bool = True,
                 mask: bool = False) -> bytes:
    head = bytearray()
    head.append((0x80 if fin else 0) | opcode)
    length = len(payload)
    mask_bit = 0x80 if mask else 0
    if length < 126:
        head.append(mask_bit | length)
    elif length < 65536:
        head.append(mask_bit | 126)
        head += struct.pack(">H", length)
    else:
        head.append(mask_bit | 127)
        head += struct.pack(">Q", length)
    if mask:
        key = os.urandom(4)
        head += key
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return bytes(head) + payload


def decode_frame(buffer: bytes, max_length: Optional[int] = None,
                 require_mask: bool = False,
                 ) -> Optional[Tuple[int, bool, bytes, int]]:
    """Parse one frame from ``buffer``: (opcode, fin, payload, consumed),
    or None while it is incomplete.

    ``max_length`` refuses a frame from its declared length, before its
    payload is buffered (:class:`FrameTooLarge`); ``require_mask`` fails
    an unmasked frame (:class:`ProtocolError`), since every client frame
    must be masked.
    """
    if len(buffer) < 2:
        return None
    b0, b1 = buffer[0], buffer[1]
    fin = bool(b0 & 0x80)
    opcode = b0 & 0x0F
    masked = bool(b1 & 0x80)
    length = b1 & 0x7F
    offset = 2
    if length == 126:
        if len(buffer) < offset + 2:
            return None
        length = struct.unpack_from(">H", buffer, offset)[0]
        offset += 2
    elif length == 127:
        if len(buffer) < offset + 8:
            return None
        length = struct.unpack_from(">Q", buffer, offset)[0]
        offset += 8
    if require_mask and not masked:
        raise ProtocolError("unmasked client frame")
    if max_length is not None and length > max_length:
        raise FrameTooLarge(f"frame of {length} bytes exceeds {max_length}")
    key = b""
    if masked:
        if len(buffer) < offset + 4:
            return None
        key = buffer[offset:offset + 4]
        offset += 4
    if len(buffer) < offset + length:
        return None
    payload = buffer[offset:offset + length]
    if masked:
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
    return opcode, fin, bytes(payload), offset + length
