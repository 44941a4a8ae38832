"""Change-block codec: JSON + compression with a tagged header.

Parity target: the reference packs each change as brotli-compressed JSON
with a 2-byte magic header and falls back to raw JSON when compression
doesn't help, sniffing `{` for legacy blocks (reference src/Block.ts:6-29).

Dispatch is by header:
  '\\xc5\\x01' binary change frame            (crdt/codec.py, preferred
                                            for change blocks)
  'BR' + uint32le raw_len + brotli stream   (native layer, preferred)
  'ZL' + zlib stream                        (pure-Python fallback)
  '{' / '['                                 raw JSON (incompressible)

Writers pick brotli when the native layer loaded (HM_BLOCK_CODEC=zlib
forces the fallback); readers handle every format, so feeds written by
either configuration stay readable — except brotli-written feeds on a
machine that cannot load the native layer, which fail loudly rather
than silently misparse. Change blocks go through `pack_change`, which
prefers the binary change frame (GIL-free native encode/decode; the
HM_NATIVE_CODEC=0 hatch reverts new writes to the JSON formats while
readers keep handling frames already on disk).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Any

from .. import native
from ..crdt import codec as change_codec
from ..utils.json_buffer import bufferify, parse

_ZLIB_MAGIC = b"ZL"
_BROTLI_MAGIC = b"BR"
_BR_LEN = struct.Struct("<I")
_BR_QUALITY = 5  # block packing wants speed; q5 beats zlib-6 on JSON


def _use_brotli() -> bool:
    if os.environ.get("HM_BLOCK_CODEC") == "zlib":
        return False
    return bool(native.caps() & native.CAP_BROTLI)


def pack(obj: Any) -> bytes:
    return pack_raw(bufferify(obj))


def pack_change(obj: Any) -> bytes:
    """Pack a change dict, preferring the binary change frame for the
    small interactive blocks the per-edit hot loop emits — the encode
    runs in C with the GIL released and the frame undercuts raw JSON.
    Big blocks (bulk text pastes) keep the brotli path: there the
    payload dominates and compression beats a flat frame on disk.
    Off-canon shapes and the HM_NATIVE_CODEC=0 hatch fall back to the
    JSON block path."""
    if change_codec.enabled():
        frame = change_codec.encode_change(obj)
        if frame is not None and len(frame) < _MIN_COMPRESS:
            return frame
    return pack_raw(bufferify(obj))


_MIN_COMPRESS = 512  # tiny interactive blocks: framing+cpu beats the
# handful of saved bytes, store raw JSON


def pack_raw(raw: bytes) -> bytes:
    """Pack already-serialized JSON bytes (callers that template/replay
    serialized changes skip the re-serialization)."""
    if len(raw) < _MIN_COMPRESS:
        return raw
    if _use_brotli():
        compressed = native.compress(
            native.CODEC_BROTLI, raw, quality=_BR_QUALITY
        )
        if compressed is not None:
            framed = _BROTLI_MAGIC + _BR_LEN.pack(len(raw)) + compressed
            if len(framed) < len(raw):
                return framed
            return raw  # incompressible: store raw JSON
    compressed = zlib.compress(raw, level=6)
    if len(compressed) + 2 < len(raw):
        return _ZLIB_MAGIC + compressed
    return raw  # incompressible: store raw JSON (starts with '{' or '[')


# Blocks arrive from untrusted peers: the framed raw_len must be bounded
# before it sizes an allocation. Brotli tops out around ~1000:1 on
# pathological input; honest JSON change blocks sit far below 2048x.
_MAX_RATIO = 2048


def unpack(data: bytes) -> Any:
    magic = data[:2]
    if magic == change_codec.MAGIC:
        # binary change frame: decode (native when available) back to
        # canonical JSON bytes, then parse like any raw block. Readers
        # take this branch regardless of HM_NATIVE_CODEC — the hatch
        # only stops new frames being written.
        return parse(change_codec.decode_change(data))
    if magic == _BROTLI_MAGIC:
        if len(data) < 2 + _BR_LEN.size:
            raise ValueError("corrupt brotli block: truncated header")
        (raw_len,) = _BR_LEN.unpack_from(data, 2)
        stream = data[2 + _BR_LEN.size :]
        if raw_len > max(4096, len(stream) * _MAX_RATIO):
            raise ValueError(
                "corrupt brotli block: implausible raw length "
                f"{raw_len} for {len(stream)} compressed bytes"
            )
        if not native.caps() & native.CAP_BROTLI:
            raise ValueError(
                "brotli block but native codec unavailable "
                "(build hypermerge_tpu_torch/native or set HM_BLOCK_CODEC=zlib "
                "before writing)"
            )
        raw = native.decompress(native.CODEC_BROTLI, stream, raw_len)
        if raw is None:
            raise ValueError("corrupt brotli block: stream failed to decode")
        return parse(raw)
    if magic == _ZLIB_MAGIC:
        try:
            return parse(zlib.decompress(data[2:]))
        except zlib.error as exc:
            raise ValueError(f"corrupt zlib block: {exc}") from exc
    return parse(data)
