"""Pure-Python X25519 + ChaCha20-Poly1305-IETF — transport-crypto fallback.

Used by net/secure.py when the native layer (libsodium via native/)
didn't load. Implements RFC 7748 (X25519 montgomery ladder) and RFC 8439
(ChaCha20, Poly1305, AEAD construction) exactly, so pure and native
endpoints interoperate on the wire. Far slower than the C path, but
correct; ChaCha20 computes all of a frame's blocks in one pass of
lane-packed integers (below), which is what keeps hosts without
libsodium usable.

The port's copy of hypermerge_tpu/utils/chacha.py.
"""

from __future__ import annotations

import hmac
import struct
from functools import lru_cache
from typing import Optional

# ---------------------------------------------------------------------------
# X25519 (RFC 7748)

_P = 2**255 - 19
_A24 = 121665


def x25519(k: bytes, u: bytes) -> bytes:
    kb = bytearray(k[:32])
    kb[0] &= 248
    kb[31] &= 127
    kb[31] |= 64
    scalar = int.from_bytes(kb, "little")
    x1 = int.from_bytes(u[:32], "little") & ((1 << 255) - 1)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in reversed(range(255)):
        k_t = (scalar >> t) & 1
        swap ^= k_t
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = z3 * z3 % _P
        z3 = z3 * x1 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return (x2 * pow(z2, _P - 2, _P) % _P).to_bytes(32, "little")


def x25519_base(sk: bytes) -> bytes:
    return x25519(sk, (9).to_bytes(32, "little"))


# ---------------------------------------------------------------------------
# ChaCha20 (RFC 8439)
#
# All the blocks of one call run at once: word i of block j sits in bits
# [64j, 64j + 32) of one Python integer, so each add, xor and rotate of
# the round function is one integer operation for every block (a carry
# lands in the 32 spare bits above its lane and the lane mask clears it).
# The bytes are those of the block-by-block definition, several times
# faster: on hosts without libsodium every transport frame takes this
# route.

_M32 = 0xFFFFFFFF
_SIGMA = struct.unpack("<4I", b"expand 32-byte k")
_CHUNK = 256  # blocks a pass: integers of 16 KiB at most


@lru_cache(maxsize=64)
def _lanes(nblocks: int) -> tuple:
    """(1 in every lane, lane j holding j, the 32-bit lane mask)."""
    one = int.from_bytes(b"\x01\x00\x00\x00\x00\x00\x00\x00" * nblocks,
                         "little")
    ramp = int.from_bytes(
        b"".join(j.to_bytes(8, "little") for j in range(nblocks)), "little"
    )
    return one, ramp, _M32 * one


def _chacha20_blocks(k: tuple, counter: int, n: tuple, nblocks: int) -> bytes:
    """Blocks counter .. counter + nblocks - 1 from 8 key words and 3
    nonce words, 64 bytes each, in order."""
    one, ramp, M = _lanes(nblocks)
    j0, j1, j2, j3 = (w * one for w in _SIGMA)
    j4, j5, j6, j7, j8, j9, j10, j11 = (w * one for w in k)
    j12 = ((counter & _M32) * one + ramp) & M
    j13, j14, j15 = (w * one for w in n)
    x0, x1, x2, x3, x4, x5, x6, x7 = j0, j1, j2, j3, j4, j5, j6, j7
    x8, x9, x10, x11, x12, x13, x14, x15 = (
        j8, j9, j10, j11, j12, j13, j14, j15
    )
    for _ in range(10):
        # columns
        x0 = (x0 + x4) & M; x12 ^= x0; x12 = ((x12 << 16) | (x12 >> 16)) & M
        x8 = (x8 + x12) & M; x4 ^= x8; x4 = ((x4 << 12) | (x4 >> 20)) & M
        x0 = (x0 + x4) & M; x12 ^= x0; x12 = ((x12 << 8) | (x12 >> 24)) & M
        x8 = (x8 + x12) & M; x4 ^= x8; x4 = ((x4 << 7) | (x4 >> 25)) & M
        x1 = (x1 + x5) & M; x13 ^= x1; x13 = ((x13 << 16) | (x13 >> 16)) & M
        x9 = (x9 + x13) & M; x5 ^= x9; x5 = ((x5 << 12) | (x5 >> 20)) & M
        x1 = (x1 + x5) & M; x13 ^= x1; x13 = ((x13 << 8) | (x13 >> 24)) & M
        x9 = (x9 + x13) & M; x5 ^= x9; x5 = ((x5 << 7) | (x5 >> 25)) & M
        x2 = (x2 + x6) & M; x14 ^= x2; x14 = ((x14 << 16) | (x14 >> 16)) & M
        x10 = (x10 + x14) & M; x6 ^= x10; x6 = ((x6 << 12) | (x6 >> 20)) & M
        x2 = (x2 + x6) & M; x14 ^= x2; x14 = ((x14 << 8) | (x14 >> 24)) & M
        x10 = (x10 + x14) & M; x6 ^= x10; x6 = ((x6 << 7) | (x6 >> 25)) & M
        x3 = (x3 + x7) & M; x15 ^= x3; x15 = ((x15 << 16) | (x15 >> 16)) & M
        x11 = (x11 + x15) & M; x7 ^= x11; x7 = ((x7 << 12) | (x7 >> 20)) & M
        x3 = (x3 + x7) & M; x15 ^= x3; x15 = ((x15 << 8) | (x15 >> 24)) & M
        x11 = (x11 + x15) & M; x7 ^= x11; x7 = ((x7 << 7) | (x7 >> 25)) & M
        # diagonals
        x0 = (x0 + x5) & M; x15 ^= x0; x15 = ((x15 << 16) | (x15 >> 16)) & M
        x10 = (x10 + x15) & M; x5 ^= x10; x5 = ((x5 << 12) | (x5 >> 20)) & M
        x0 = (x0 + x5) & M; x15 ^= x0; x15 = ((x15 << 8) | (x15 >> 24)) & M
        x10 = (x10 + x15) & M; x5 ^= x10; x5 = ((x5 << 7) | (x5 >> 25)) & M
        x1 = (x1 + x6) & M; x12 ^= x1; x12 = ((x12 << 16) | (x12 >> 16)) & M
        x11 = (x11 + x12) & M; x6 ^= x11; x6 = ((x6 << 12) | (x6 >> 20)) & M
        x1 = (x1 + x6) & M; x12 ^= x1; x12 = ((x12 << 8) | (x12 >> 24)) & M
        x11 = (x11 + x12) & M; x6 ^= x11; x6 = ((x6 << 7) | (x6 >> 25)) & M
        x2 = (x2 + x7) & M; x13 ^= x2; x13 = ((x13 << 16) | (x13 >> 16)) & M
        x8 = (x8 + x13) & M; x7 ^= x8; x7 = ((x7 << 12) | (x7 >> 20)) & M
        x2 = (x2 + x7) & M; x13 ^= x2; x13 = ((x13 << 8) | (x13 >> 24)) & M
        x8 = (x8 + x13) & M; x7 ^= x8; x7 = ((x7 << 7) | (x7 >> 25)) & M
        x3 = (x3 + x4) & M; x14 ^= x3; x14 = ((x14 << 16) | (x14 >> 16)) & M
        x9 = (x9 + x14) & M; x4 ^= x9; x4 = ((x4 << 12) | (x4 >> 20)) & M
        x3 = (x3 + x4) & M; x14 ^= x3; x14 = ((x14 << 8) | (x14 >> 24)) & M
        x9 = (x9 + x14) & M; x4 ^= x9; x4 = ((x4 << 7) | (x4 >> 25)) & M
    words = (
        x0 + j0, x1 + j1, x2 + j2, x3 + j3, x4 + j4, x5 + j5, x6 + j6,
        x7 + j7, x8 + j8, x9 + j9, x10 + j10, x11 + j11, x12 + j12,
        x13 + j13, x14 + j14, x15 + j15,
    )
    out = bytearray(64 * nblocks)
    width = 8 * nblocks
    for i, w in enumerate(words):
        raw = (w & M).to_bytes(width, "little")
        for b in range(4):
            out[4 * i + b :: 64] = raw[b::8]
    return bytes(out)


def _chacha20_stream(key: bytes, nonce: bytes, n: int) -> bytes:
    """Block 0 (whose first 32 bytes are the Poly1305 key) and then the
    n bytes of keystream from block 1 on."""
    k = struct.unpack("<8I", key)
    nw = struct.unpack("<3I", nonce)
    total = 1 + (n + 63) // 64
    return b"".join(
        _chacha20_blocks(k, at, nw, min(_CHUNK, total - at))
        for at in range(0, total, _CHUNK)
    )[: 64 + n]


def _xor(data: bytes, stream: bytes) -> bytes:
    n = len(data)
    return (
        int.from_bytes(data, "little") ^ int.from_bytes(stream, "little")
    ).to_bytes(n, "little")


# ---------------------------------------------------------------------------
# Poly1305 (RFC 8439)


def _poly1305(key: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key[:16], "little") & 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key[16:32], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        block = msg[i : i + 16]
        n = int.from_bytes(block + b"\x01", "little")
        acc = (acc + n) * r % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(data: bytes) -> bytes:
    return data + b"\x00" * ((-len(data)) % 16)


# ---------------------------------------------------------------------------
# AEAD construction (RFC 8439 §2.8, no associated data)


def aead_encrypt(key: bytes, nonce: bytes, msg: bytes) -> bytes:
    stream = _chacha20_stream(key, nonce, len(msg))
    ct = _xor(msg, stream[64:])
    mac_data = _pad16(ct) + struct.pack("<QQ", 0, len(ct))
    return ct + _poly1305(stream[:32], mac_data)


def aead_decrypt(key: bytes, nonce: bytes, data: bytes) -> Optional[bytes]:
    """Plaintext, or None when authentication fails."""
    if len(data) < 16:
        return None
    ct, tag = data[:-16], data[-16:]
    stream = _chacha20_stream(key, nonce, len(ct))
    mac_data = _pad16(ct) + struct.pack("<QQ", 0, len(ct))
    if not hmac.compare_digest(_poly1305(stream[:32], mac_data), tag):
        return None
    return _xor(ct, stream[64:])
