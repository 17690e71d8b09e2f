"""KV handoff wire codec for disaggregated serving (a copy of
``gofr_tpu/tpu/kv_wire.py``: the same bytes on the wire, bit for bit).

A prefill replica ships a finished prompt's KV to a decode replica as
page-aligned pool rows — the same ``(L, n_pages, page, Hkv, Dh)`` layout
:class:`~gofr_tpu_torch.tpu.page_pool.PagePool` leaves use on device, so the
receiver admits the payload as page-table entries without reshaping or
re-prefilling (``prefill_bucket_tokens`` stays 0 on the decode side).

The format dodges the tensor-payload pitfalls the gRPC micro-benchmark
study documents (PAPERS.md, arxiv 1804.01138): leaves travel as raw
little-endian buffers behind one fixed-layout header — no per-element
boxing, one copy at ``tobytes()`` and one at ``frombuffer`` — and
:func:`iter_chunks` splits the blob into bounded messages so a 7B
prompt's KV never lands as a single oversized RPC frame.

Layout (all little-endian, no padding)::

    magic "GKVW" | version u16 | codec u8 | flags u8 | page u16
    | tokens u32 | n_layers u16 | n_kv_heads u16 | head_dim u16
    | n_pages u32 | first_token i32 | key0 u32 | key1 u32
    | dtype_len u8 | dtype utf-8 | model_len u8 | model utf-8
    then per leaf (order fixed by codec): nbytes u64 | raw buffer

Codec 0 (``CODEC_RAW``) carries ``k``/``v`` in the pool dtype
(bf16 by default); codec 1 (``CODEC_INT8``) carries int8 ``k``/``v``
plus the f32 ``ks``/``vs`` scale planes. Decoding is strict: a bad
magic, unknown version/codec, truncated buffer, size mismatch, or
trailing bytes all raise :class:`KVWireError` — a corrupt handoff must
fail loudly before it poisons a decode replica's pool.

The port carries a bf16 leaf as its raw 16-bit words (numpy ``uint16``)
under the header dtype ``"bfloat16"``: ``pack`` writes the same bytes as
the JAX package's ``ml_dtypes`` leaves, ``unpack`` of a JAX blob gives
the words, and nothing here imports ``ml_dtypes``.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from gofr_tpu_torch.tpu import faults

__all__ = [
    "CODEC_RAW", "CODEC_INT8", "FLAG_SESSION", "KVPayload", "KVWireError",
    "codec_for_cfg", "resolve_codec", "leaf_names", "leaf_shape",
    "pack", "unpack", "iter_chunks", "assemble", "DEFAULT_CHUNK_BYTES",
    "MIN_CHUNK_BYTES", "MAX_CHUNK_BYTES", "resolve_chunk_bytes",
]

MAGIC = b"GKVW"
VERSION = 1
CODEC_RAW = 0    # k/v in the pool dtype (bf16 unless cfg overrides)
CODEC_INT8 = 1   # int8 k/v + float32 ks/vs scale planes
# the header's dtype string of a bf16 pool's leaves (its numpy leaves are
# the raw 16-bit words, see _resolve_dtype)
BF16 = "bfloat16"

# header flag bits: a SESSION payload is a live decode session snapshot
# (mid-stream migration) — its first_token is the *last
# committed* token decode resumes from, not a freshly-sampled prompt
# token, and it must be admitted through adopt_session, never adopt_kv
FLAG_SESSION = 0x01

# gRPC defaults cap messages at 4 MiB; 256 KiB chunks keep each frame
# far under the cap and let the receiver overlap reassembly with I/O
DEFAULT_CHUNK_BYTES = 256 << 10
# the KV_WIRE_CHUNK_BYTES knob is clamped to this window: below 4 KiB
# the per-frame overhead dominates, at/above the 4 MiB gRPC message cap
# a frame head-of-line blocks the transport (arxiv 1804.01138)
MIN_CHUNK_BYTES = 4 << 10
MAX_CHUNK_BYTES = 4 << 20


def resolve_chunk_bytes(value: Optional[Any] = None) -> int:
    """Resolve the transfer-frame size: an explicit ``value`` wins, else
    the ``KV_WIRE_CHUNK_BYTES`` env knob, else the default. The knob is
    validated at resolve time — a malformed or out-of-bounds value is a
    deploy-time config error (fail loudly), never a silently-degenerate
    frame size."""
    if value is None:
        raw = os.environ.get("KV_WIRE_CHUNK_BYTES", "").strip()
        if not raw:
            return DEFAULT_CHUNK_BYTES
        try:
            n = int(raw)
        except ValueError:
            raise ValueError(
                f"KV_WIRE_CHUNK_BYTES={raw!r} is not an integer") from None
        if not MIN_CHUNK_BYTES <= n < MAX_CHUNK_BYTES:
            raise ValueError(
                f"KV_WIRE_CHUNK_BYTES={n} outside [{MIN_CHUNK_BYTES}, "
                f"{MAX_CHUNK_BYTES}): frames must stay under the 4 MiB "
                "gRPC message cap and above the framing-overhead floor")
        return n
    n = int(value)
    if n <= 0:
        raise ValueError("chunk_bytes must be positive")
    return n

# magic, version, codec, flags, page, tokens, n_layers, n_kv_heads,
# head_dim, n_pages, first_token, key0, key1
_HEAD = struct.Struct("<4sHBBHIHHHIiII")
_SIZE = struct.Struct("<Q")


class KVWireError(ValueError):
    """Malformed/incompatible KV wire payload. 400-class semantics: the
    sender shipped something this replica must refuse to adopt."""

    status_code = 400


class KVPayload:
    """One prompt's exported KV: geometry header + host leaf buffers
    shaped ``(L, n_pages, page, Hkv, Dh)`` (scale planes drop the last
    axis). ``first_token`` is the token the prefill executable already
    sampled; ``sample_key`` the advanced per-request PRNG key decode
    continues from — shipping both is what makes the handoff
    zero-re-prefill AND token-identical."""

    __slots__ = ("codec", "dtype", "page", "tokens", "n_layers",
                 "n_kv_heads", "head_dim", "n_pages", "first_token",
                 "sample_key", "model", "leaves", "flags")

    def __init__(self, codec: int, dtype: str, page: int, tokens: int,
                 n_layers: int, n_kv_heads: int, head_dim: int,
                 n_pages: int, first_token: int,
                 sample_key: Tuple[int, int], model: str,
                 leaves: Dict[str, Any], flags: int = 0):
        self.flags = int(flags)
        self.codec = int(codec)
        self.dtype = str(dtype)
        self.page = int(page)
        self.tokens = int(tokens)
        self.n_layers = int(n_layers)
        self.n_kv_heads = int(n_kv_heads)
        self.head_dim = int(head_dim)
        self.n_pages = int(n_pages)
        self.first_token = int(first_token)
        self.sample_key = (int(sample_key[0]), int(sample_key[1]))
        self.model = str(model)
        self.leaves = leaves

    def describe(self) -> Dict[str, Any]:
        return {
            "codec": "int8" if self.codec == CODEC_INT8 else "raw",
            "dtype": self.dtype,
            "page": self.page,
            "tokens": self.tokens,
            "n_pages": self.n_pages,
            "model": self.model,
            "session": bool(self.flags & FLAG_SESSION),
        }


def codec_for_cfg(cfg) -> int:
    """The only codec a pool built from ``cfg`` can adopt without
    transcoding (the wire never requantizes)."""
    return CODEC_INT8 if getattr(cfg, "kv_int8", False) else CODEC_RAW


def resolve_codec(name: str, cfg) -> int:
    """Map the ``KV_WIRE_CODEC`` knob to a codec id, validated against
    the pool's storage format: ``auto`` follows the config; asking for a
    codec the pool cannot hold is a deploy-time config error, not a
    per-request surprise."""
    name = (name or "auto").strip().lower()
    want = codec_for_cfg(cfg)
    if name == "auto":
        return want
    if name in ("bf16", "raw"):
        asked = CODEC_RAW
    elif name == "int8":
        asked = CODEC_INT8
    else:
        raise ValueError(
            f"KV_WIRE_CODEC={name!r}: expected auto, bf16, or int8")
    if asked != want:
        raise ValueError(
            f"KV_WIRE_CODEC={name!r} does not match the pool storage "
            f"format ({'int8' if want == CODEC_INT8 else 'bf16'}); the "
            "wire ships pool rows verbatim and never transcodes")
    return asked


def leaf_names(codec: int) -> Tuple[str, ...]:
    if codec == CODEC_RAW:
        return ("k", "v")
    if codec == CODEC_INT8:
        return ("k", "v", "ks", "vs")
    raise KVWireError(f"unknown KV wire codec {codec}")


def leaf_shape(payload: "KVPayload", name: str) -> Tuple[int, ...]:
    base = (payload.n_layers, payload.n_pages, payload.page,
            payload.n_kv_heads)
    if name in ("ks", "vs"):
        return base
    return base + (payload.head_dim,)


def _leaf_dtype(payload: "KVPayload", name: str):
    if payload.codec == CODEC_INT8:
        return np.dtype(np.float32 if name in ("ks", "vs") else np.int8)
    return _resolve_dtype(payload.dtype)


def _resolve_dtype(name: str):
    """The numpy type a leaf of wire dtype ``name`` unpacks to. A
    ``bfloat16`` leaf (numpy has no such type) unpacks to its raw 16-bit
    words (``uint16``); the engine views them as ``torch.bfloat16``
    without a numeric cast. So no ``ml_dtypes`` is needed, and the bytes
    are the JAX package's."""
    if name == BF16:
        return np.dtype(np.uint16)
    try:
        return np.dtype(name)
    except TypeError:
        raise KVWireError(f"unknown leaf dtype {name!r}") from None


def pack(payload: KVPayload) -> bytes:
    """Serialize a payload. Leaves must already be host ``np.ndarray``s
    in the canonical page layout; the caller (the engine's export path)
    stages device→host off the event loop."""
    names = leaf_names(payload.codec)
    missing = [n for n in names if n not in payload.leaves]
    if missing:
        raise KVWireError(f"payload lacks leaves {missing}")
    dtype_b = payload.dtype.encode("utf-8")
    model_b = payload.model.encode("utf-8")
    if len(dtype_b) > 255 or len(model_b) > 255:
        raise KVWireError("dtype/model names exceed 255 bytes")
    parts: List[bytes] = [
        _HEAD.pack(MAGIC, VERSION, payload.codec,
                   payload.flags & 0xFF, payload.page,
                   payload.tokens, payload.n_layers, payload.n_kv_heads,
                   payload.head_dim, payload.n_pages,
                   payload.first_token,
                   payload.sample_key[0] & 0xFFFFFFFF,
                   payload.sample_key[1] & 0xFFFFFFFF),
        bytes([len(dtype_b)]), dtype_b,
        bytes([len(model_b)]), model_b,
    ]
    for name in names:
        arr = np.ascontiguousarray(payload.leaves[name])
        want = leaf_shape(payload, name)
        if tuple(arr.shape) != want:
            raise KVWireError(
                f"leaf {name!r} has shape {tuple(arr.shape)}, "
                f"expected {want}")
        buf = arr.tobytes()
        parts.append(_SIZE.pack(len(buf)))
        parts.append(buf)
    return b"".join(parts)


def unpack(data) -> KVPayload:
    """Parse + validate one payload. Strict: any structural defect —
    short header, bad magic, version/codec mismatch, leaf size that
    disagrees with the declared geometry, or trailing garbage — raises
    :class:`KVWireError` before a single leaf is admitted.

    Zero-copy: ``data`` may be ``bytes``, ``bytearray``, or a
    ``memoryview`` straight off the socket; leaves are ``np.frombuffer``
    **views** into it, so the only copy on the adopt path is the H2D
    upload. The caller must keep ``data`` alive as long as the leaves."""
    if not isinstance(data, (bytes, bytearray, memoryview)):
        data = memoryview(data)
    if len(data) < _HEAD.size:
        raise KVWireError(
            f"truncated KV payload: {len(data)} bytes < "
            f"{_HEAD.size}-byte header")
    (magic, version, codec, flags, page, tokens, n_layers, n_kv_heads,
     head_dim, n_pages, first_token, key0, key1) = _HEAD.unpack_from(data)
    if magic != MAGIC:
        raise KVWireError(f"bad KV payload magic {magic!r}")
    if version != VERSION:
        raise KVWireError(
            f"unsupported KV wire version {version} (speak {VERSION})")
    names = leaf_names(codec)   # raises on unknown codec
    off = _HEAD.size
    dtype, off = _read_str(data, off, "dtype")
    model, off = _read_str(data, off, "model")
    if page <= 0 or tokens <= 0 or n_pages <= 0:
        raise KVWireError(
            f"degenerate geometry: page={page} tokens={tokens} "
            f"n_pages={n_pages}")
    if n_pages != -(-tokens // page):
        raise KVWireError(
            f"geometry mismatch: {tokens} tokens need "
            f"{-(-tokens // page)} pages of {page}, header says {n_pages}")
    payload = KVPayload(codec, dtype, page, tokens, n_layers, n_kv_heads,
                        head_dim, n_pages, first_token, (key0, key1),
                        model, {}, flags=flags)
    for name in names:
        if off + _SIZE.size > len(data):
            raise KVWireError(f"truncated KV payload at leaf {name!r}")
        (nbytes,) = _SIZE.unpack_from(data, off)
        off += _SIZE.size
        shape = leaf_shape(payload, name)
        dt = _leaf_dtype(payload, name)
        want = int(np.prod(shape)) * dt.itemsize
        if nbytes != want:
            raise KVWireError(
                f"leaf {name!r} declares {nbytes} bytes, geometry "
                f"needs {want}")
        if off + nbytes > len(data):
            raise KVWireError(
                f"truncated KV payload: leaf {name!r} short by "
                f"{off + nbytes - len(data)} bytes")
        payload.leaves[name] = np.frombuffer(
            data, dtype=dt, count=want // dt.itemsize,
            offset=off).reshape(shape)
        off += nbytes
    if off != len(data):
        raise KVWireError(
            f"{len(data) - off} trailing bytes after the last leaf")
    return payload


def _read_str(data, off: int, what: str) -> Tuple[str, int]:
    if off >= len(data):
        raise KVWireError(f"truncated KV payload at {what} length")
    n = data[off]
    off += 1
    if off + n > len(data):
        raise KVWireError(f"truncated KV payload at {what} bytes")
    # bytes() here copies only the short name, never a leaf buffer
    return bytes(data[off:off + n]).decode("utf-8", errors="replace"), off + n


def iter_chunks(data: bytes,
                chunk_bytes: Optional[int] = None) -> Iterator[bytes]:
    """Split a packed payload into bounded transfer frames (the gRPC
    stream / chunked-HTTP unit). Order-preserving; ``assemble`` is the
    inverse. ``chunk_bytes=None`` resolves the validated
    ``KV_WIRE_CHUNK_BYTES`` knob (default 256 KiB) — large migrations
    must not head-of-line block the transport behind one giant frame.

    Chaos sites ``kv_chunk_truncate`` (drop the tail of the last frame)
    and ``kv_chunk_corrupt`` (flip a magic byte in the header frame)
    damage the stream when a fault plan is installed — the receiver's
    strict ``unpack`` must turn either into a loud :class:`KVWireError`
    before a damaged handoff reaches the pool."""
    chunk_bytes = resolve_chunk_bytes(chunk_bytes)
    plan = faults.active()
    end = len(data)
    corrupt = False
    if plan.enabled and data:
        if plan.should("kv_chunk_truncate"):
            end = max(1, end - max(1, min(64, end // 2)))
        corrupt = plan.should("kv_chunk_corrupt")
    for start in range(0, end, chunk_bytes):
        chunk = data[start:start + chunk_bytes]
        if corrupt and start == 0:
            flipped = bytearray(chunk)
            flipped[0] ^= 0xFF
            chunk = bytes(flipped)
        yield chunk
    if not data:
        yield b""


def assemble(chunks: Iterable[bytes]) -> bytes:
    """Rejoin transfer frames. A single-frame payload is returned as-is —
    no copy — which is the common case for in-process handoffs and small
    prompts; multi-frame payloads pay exactly one join."""
    chunks = list(chunks)
    if len(chunks) == 1 and isinstance(chunks[0], (bytes, bytearray)):
        return bytes(chunks[0]) if isinstance(chunks[0], bytearray) \
            else chunks[0]
    return b"".join(bytes(c) for c in chunks)
