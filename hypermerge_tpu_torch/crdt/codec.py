"""Binary change-frame codec: canonical change JSON <-> compact frame.

The reference measured its write plane's ceiling as ~0.9ms of per-edit
pure-Python CPU under one GIL, much of it JSON change-frame work. This
module moves that hot loop behind `native/src/hm_native.cpp`'s
`hm_change_encode` / `hm_change_decode` (plain ctypes.CDLL, so the C
call runs GIL-FREE — frames from N connections parse on real
threads), with this file's pure-Python twin as the always-available
fallback and the parity oracle.

The parity trick that makes bit-identical twins cheap: the frame
stores every string field as its JSON-ESCAPED inner bytes exactly as
`utils/json_buffer.bufferify` produced them, and op values as their
full canonical JSON token bytes. The native side only SCANS tokens
out of canonical JSON on encode and copies them back verbatim on
decode — it never formats a float or escapes a string, so there is no
formatter to keep in sync with CPython. The only bytes either side
formats itself are decimal integers and the fixed canonical key
skeleton. Pinned by tests/test_native_codec.py's fuzz across
HM_NATIVE_CODEC=1/0 in both orders.

Frame layout (varint = unsigned LEB128, token = varint len + bytes),
fields in canonical JSON key order so encode is one forward pass:

    b"\\xc5\\x01" magic; token actor;
    varint n_deps; n_deps * (token key, varint seq);
    token message;
    varint n_ops; per op: varint action; uint8 flags
      (1=key 2=ref 4=insert 8=value 16=datatype 32=pred);
      token obj; [token key] [token ref] [token value-JSON]
      [token datatype] [varint n_pred + n_pred * token];
    varint seq, startOp, time.

`HM_NATIVE_CODEC=0` is the escape hatch: it stops NEW blocks being
written as binary frames (and routes decode through the twin), but
readers always handle both formats — a feed written with the codec on
stays readable with it off, and vice versa.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

from .. import native
from ..utils.json_buffer import bufferify

MAGIC = b"\xc5\x01"

_IMAX = (1 << 63) - 1  # native ch_int / ch_rd_varint ceiling

_F_KEY = 1
_F_REF = 2
_F_INSERT = 4
_F_VALUE = 8
_F_DATATYPE = 16
_F_PRED = 32

_TOP_KEYS = frozenset(
    ("actor", "deps", "message", "ops", "seq", "startOp", "time")
)
_OP_KEYS = frozenset("adikoprv")


def enabled() -> bool:
    """Whether writers should emit binary change frames at all."""
    return os.environ.get("HM_NATIVE_CODEC", "1") != "0"


def is_frame(data: bytes) -> bool:
    return data[:2] == MAGIC


# ---------------------------------------------------------------------
# shared primitives


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _jstr(s: str) -> bytes:
    """The JSON-escaped inner bytes of `s`, exactly as bufferify would
    embed them (ensure_ascii keeps the result pure ASCII)."""
    return json.dumps(s)[1:-1].encode("ascii")


def _token(b: bytes) -> bytes:
    return _varint(len(b)) + b


def _uint_ok(v: Any) -> bool:
    # `type is int` on purpose: True/False are ints by subclass but
    # serialize as true/false, which the native scanner rejects
    return type(v) is int and 0 <= v <= _IMAX


# ---------------------------------------------------------------------
# encode


def _encode_py(obj: Any) -> Optional[bytes]:
    """The twin: canonical change dict -> frame bytes, or None when the
    shape is outside what the native scanner accepts (caller falls back
    to the JSON block format). The supported-shape rules here MUST
    match hm_change_encode's strictness exactly — that agreement is
    what the fuzz pins."""
    if type(obj) is not dict or set(obj) != _TOP_KEYS:
        return None
    actor, deps, message, ops = (
        obj["actor"], obj["deps"], obj["message"], obj["ops"],
    )
    if type(actor) is not str or type(message) is not str:
        return None
    if not (_uint_ok(obj["seq"]) and _uint_ok(obj["startOp"])
            and _uint_ok(obj["time"])):
        return None
    if type(deps) is not dict or type(ops) is not list:
        return None
    out = bytearray(MAGIC)
    out += _token(_jstr(actor))
    out += _varint(len(deps))
    for k in sorted(deps):
        v = deps[k]
        if type(k) is not str or not _uint_ok(v):
            return None
        out += _token(_jstr(k))
        out += _varint(v)
    out += _token(_jstr(message))
    out += _varint(len(ops))
    for op in ops:
        if type(op) is not dict or "a" not in op or "o" not in op:
            return None
        if not _OP_KEYS.issuperset(op):
            return None
        if not _uint_ok(op["a"]) or type(op["o"]) is not str:
            return None
        flags = 0
        if "k" in op:
            if type(op["k"]) is not str:
                return None
            flags |= _F_KEY
        if "r" in op:
            if type(op["r"]) is not str:
                return None
            flags |= _F_REF
        if "i" in op:
            if op["i"] is not True:
                return None
            flags |= _F_INSERT
        if "v" in op:
            flags |= _F_VALUE
        if "d" in op:
            if type(op["d"]) is not str:
                return None
            flags |= _F_DATATYPE
        if "p" in op:
            if type(op["p"]) is not list or any(
                type(p) is not str for p in op["p"]
            ):
                return None
            flags |= _F_PRED
        out += _varint(op["a"])
        out.append(flags)
        out += _token(_jstr(op["o"]))
        if flags & _F_KEY:
            out += _token(_jstr(op["k"]))
        if flags & _F_REF:
            out += _token(_jstr(op["r"]))
        if flags & _F_VALUE:
            out += _token(bufferify(op["v"]))
        if flags & _F_DATATYPE:
            out += _token(_jstr(op["d"]))
        if flags & _F_PRED:
            out += _varint(len(op["p"]))
            for p in op["p"]:
                out += _token(_jstr(p))
    out += _varint(obj["seq"])
    out += _varint(obj["startOp"])
    out += _varint(obj["time"])
    return bytes(out)


def _use_native() -> bool:
    return enabled() and native.codec_lib() is not None


def encode_change(obj: Any) -> Optional[bytes]:
    """Change dict -> binary frame; None when the shape is unsupported
    (caller stores the JSON block instead). Native-first: the C scan
    of bufferify output runs without the GIL."""
    if _use_native():
        frame = native.change_encode(bufferify(obj))
        if frame is not None:
            return frame
        # native said unsupported; the twin must agree (fuzz-pinned),
        # so fall through to it only to produce the same None
    return _encode_py(obj)


# ---------------------------------------------------------------------
# decode


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes) -> None:
        self.buf = buf
        self.pos = 0

    def varint(self) -> int:
        v = 0
        shift = 0
        while True:
            if self.pos >= len(self.buf):
                raise ValueError("corrupt change frame: truncated varint")
            b = self.buf[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                if v > _IMAX:
                    raise ValueError("corrupt change frame: varint range")
                return v
            shift += 7
            if shift > 63:
                raise ValueError("corrupt change frame: varint overflow")

    def count(self) -> int:
        # list/dict lengths from untrusted frames must be bounded by
        # the bytes that could possibly back them before sizing loops
        n = self.varint()
        if n > len(self.buf):
            raise ValueError("corrupt change frame: implausible count")
        return n

    def token(self) -> bytes:
        n = self.varint()
        if n > len(self.buf) - self.pos:
            raise ValueError("corrupt change frame: truncated token")
        t = self.buf[self.pos : self.pos + n]
        self.pos += n
        return t


def _decode_py(frame: bytes) -> bytes:
    """The twin: frame bytes -> canonical change JSON bytes. Raises
    ValueError on malformed input (same frames hm_change_decode
    rejects with -1)."""
    if not is_frame(frame):
        raise ValueError("corrupt change frame: bad magic")
    r = _Reader(frame)
    r.pos = 2
    out = bytearray(b'{"actor":"')
    out += r.token()
    out += b'","deps":{'
    for i in range(r.count()):
        if i:
            out += b","
        out += b'"' + r.token() + b'":' + str(r.varint()).encode()
    out += b'},"message":"'
    out += r.token()
    out += b'","ops":['
    for i in range(r.count()):
        if i:
            out += b","
        out += b'{"a":' + str(r.varint()).encode()
        if r.pos >= len(frame):
            raise ValueError("corrupt change frame: truncated op")
        flags = frame[r.pos]
        r.pos += 1
        if flags & ~0x3F:
            raise ValueError("corrupt change frame: unknown op flags")
        o = r.token()
        k = r.token() if flags & _F_KEY else b""
        ref = r.token() if flags & _F_REF else b""
        val = r.token() if flags & _F_VALUE else b""
        dt = r.token() if flags & _F_DATATYPE else b""
        if flags & _F_DATATYPE:
            out += b',"d":"' + dt + b'"'
        if flags & _F_INSERT:
            out += b',"i":true'
        if flags & _F_KEY:
            out += b',"k":"' + k + b'"'
        out += b',"o":"' + o + b'"'
        if flags & _F_PRED:
            out += b',"p":['
            for j in range(r.count()):
                if j:
                    out += b","
                out += b'"' + r.token() + b'"'
            out += b"]"
        if flags & _F_REF:
            out += b',"r":"' + ref + b'"'
        if flags & _F_VALUE:
            out += b',"v":' + val
        out += b"}"
    out += b'],"seq":' + str(r.varint()).encode()
    out += b',"startOp":' + str(r.varint()).encode()
    out += b',"time":' + str(r.varint()).encode()
    out += b"}"
    if r.pos != len(frame):
        raise ValueError("corrupt change frame: trailing bytes")
    return bytes(out)


def decode_change(frame: bytes) -> bytes:
    """Binary frame -> canonical change JSON bytes. Works regardless of
    HM_NATIVE_CODEC (the hatch only stops new frames being WRITTEN and
    routes this through the twin); raises ValueError when malformed."""
    if _use_native():
        raw = native.change_decode(frame)
        if raw is not None:
            return raw
        # fall through: the twin raises the descriptive error
    return _decode_py(frame)
