"""Pure-Python X25519 + ChaCha20-Poly1305-IETF — transport-crypto fallback.

Used by net/secure.py when the native layer (libsodium via native/)
didn't load. Implements RFC 7748 (X25519 montgomery ladder) and RFC 8439
(ChaCha20, Poly1305, AEAD construction) exactly, so pure and native
endpoints interoperate on the wire. Slow (~1 MB/s) but correct; real
deployments get the C path.

The port's copy of hypermerge_tpu/utils/chacha.py.
"""

from __future__ import annotations

import hmac
import struct
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


def _rotl(v: int, n: int) -> int:
    return ((v << n) | (v >> (32 - n))) & 0xFFFFFFFF


def _chacha20_block(key: bytes, counter: int, nonce: bytes) -> bytes:
    state = list(
        struct.unpack(
            "<16I",
            b"expand 32-byte k" + key + struct.pack("<I", counter) + nonce,
        )
    )
    w = list(state)

    def qr(a, b, c, d):
        w[a] = (w[a] + w[b]) & 0xFFFFFFFF
        w[d] = _rotl(w[d] ^ w[a], 16)
        w[c] = (w[c] + w[d]) & 0xFFFFFFFF
        w[b] = _rotl(w[b] ^ w[c], 12)
        w[a] = (w[a] + w[b]) & 0xFFFFFFFF
        w[d] = _rotl(w[d] ^ w[a], 8)
        w[c] = (w[c] + w[d]) & 0xFFFFFFFF
        w[b] = _rotl(w[b] ^ w[c], 7)

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return struct.pack(
        "<16I", *((w[i] + state[i]) & 0xFFFFFFFF for i in range(16))
    )


def _chacha20_xor(
    key: bytes, counter: int, nonce: bytes, data: bytes
) -> bytes:
    out = bytearray(len(data))
    for i in range(0, len(data), 64):
        block = _chacha20_block(key, counter + i // 64, nonce)
        chunk = data[i : i + 64]
        out[i : i + len(chunk)] = bytes(
            x ^ y for x, y in zip(chunk, block)
        )
    return bytes(out)


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
    otk = _chacha20_block(key, 0, nonce)[:32]
    ct = _chacha20_xor(key, 1, nonce, msg)
    mac_data = _pad16(ct) + struct.pack("<QQ", 0, len(ct))
    return ct + _poly1305(otk, mac_data)


def aead_decrypt(key: bytes, nonce: bytes, data: bytes) -> Optional[bytes]:
    """Plaintext, or None when authentication fails."""
    if len(data) < 16:
        return None
    ct, tag = data[:-16], data[-16:]
    otk = _chacha20_block(key, 0, nonce)[:32]
    mac_data = _pad16(ct) + struct.pack("<QQ", 0, len(ct))
    if not hmac.compare_digest(_poly1305(otk, mac_data), tag):
        return None
    return _chacha20_xor(key, 1, nonce, ct)
