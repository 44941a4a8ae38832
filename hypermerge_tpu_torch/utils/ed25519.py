"""Ed25519 signatures (RFC 8032), pure Python.

The reference gets ed25519 keypairs/signatures from hypercore-crypto ->
sodium-native (reference src/Keys.ts:2-5, package.json resolutions). This
implementation is written directly from the RFC 8032 specification so the
framework has zero external crypto dependencies; the hot path (feed appends)
signs batched merkle roots, not individual blocks, so pure-Python throughput
is acceptable. A C++ implementation can replace this behind the same API.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

_P = 2**255 - 19
_L = 2**252 + 27742317777372353535851937790883648493
_D = (-121665 * pow(121666, _P - 2, _P)) % _P
_I = pow(2, (_P - 1) // 4, _P)


def _sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


def _inv(x: int) -> int:
    return pow(x, _P - 2, _P)


def _xrecover(y: int) -> int:
    xx = (y * y - 1) * _inv(_D * y * y + 1)
    x = pow(xx, (_P + 3) // 8, _P)
    if (x * x - xx) % _P != 0:
        x = (x * _I) % _P
    if x % 2 != 0:
        x = _P - x
    return x


_BY = (4 * _inv(5)) % _P
_BX = _xrecover(_BY)
_B = (_BX % _P, _BY % _P, 1, (_BX * _BY) % _P)  # extended coords
_IDENT = (0, 1, 1, 0)


def _edwards_add(p: Tuple[int, int, int, int], q: Tuple[int, int, int, int]):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = ((y1 - x1) * (y2 - x2)) % _P
    b = ((y1 + x1) * (y2 + x2)) % _P
    c = (t1 * 2 * _D * t2) % _P
    dd = (z1 * 2 * z2) % _P
    e = b - a
    f = dd - c
    g = dd + c
    h = b + a
    return ((e * f) % _P, (g * h) % _P, (f * g) % _P, (e * h) % _P)


def _scalarmult(p: Tuple[int, int, int, int], e: int):
    q = _IDENT
    while e > 0:
        if e & 1:
            q = _edwards_add(q, p)
        p = _edwards_add(p, p)
        e >>= 1
    return q


def _compress(p: Tuple[int, int, int, int]) -> bytes:
    x, y, z, _ = p
    zi = _inv(z)
    x, y = (x * zi) % _P, (y * zi) % _P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def _decompress(s: bytes) -> Tuple[int, int, int, int]:
    n = int.from_bytes(s, "little")
    y = n & ((1 << 255) - 1)
    sign = n >> 255
    if y >= _P:  # RFC 8032 §5.1.3: non-canonical y must fail
        raise ValueError("non-canonical point encoding")
    x = _xrecover(y)
    if x == 0 and sign == 1:  # -0 is not a valid encoding
        raise ValueError("non-canonical point encoding")
    if x & 1 != sign:
        x = _P - x
    if (-x * x + y * y - 1 - _D * x * x * y * y) % _P != 0:
        raise ValueError("invalid point encoding")
    return (x, y, 1, (x * y) % _P)


def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def public_key(seed: bytes) -> bytes:
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    a = _clamp(_sha512(seed))
    return _compress(_scalarmult(_B, a))


def sign(message: bytes, seed: bytes, pub: bytes | None = None) -> bytes:
    if pub is None:
        pub = public_key(seed)
    h = _sha512(seed)
    a = _clamp(h)
    r = int.from_bytes(_sha512(h[32:] + message), "little") % _L
    rp = _compress(_scalarmult(_B, r))
    k = int.from_bytes(_sha512(rp + pub + message), "little") % _L
    s = (r + k * a) % _L
    return rp + int.to_bytes(s, 32, "little")


def verify(message: bytes, signature: bytes, pub: bytes) -> bool:
    if len(signature) != 64 or len(pub) != 32:
        return False
    try:
        a_point = _decompress(pub)
        r_point = _decompress(signature[:32])
    except ValueError:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= _L:
        return False
    k = int.from_bytes(_sha512(signature[:32] + pub + message), "little") % _L
    left = _scalarmult(_B, s)
    right = _edwards_add(r_point, _scalarmult(a_point, k))
    # compare affine coords
    x1, y1, z1, _ = left
    x2, y2, z2, _ = right
    return (x1 * z2 - x2 * z1) % _P == 0 and (y1 * z2 - y2 * z1) % _P == 0
