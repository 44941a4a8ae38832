"""Crypto facade: native (libsodium via native/) with pure-Python fallback.

The reference's crypto arrives through hypercore-crypto -> sodium-native
(reference src/Keys.ts:2-5); here the same primitives route through the
C++ native layer when it loaded with libsodium, else the RFC 8032
implementation in utils/ed25519.py; signing and verifying take OpenSSL's
libcrypto (utils/ossl.py) between the two. Throughput matters: feed
integrity signs a merkle root per append (storage/integrity.py), the DHT
verifies every record a lookup returns, and pure-Python ed25519 costs
milliseconds per signature or check, held under the GIL, where sodium or
libcrypto cost microseconds.

blake2b stays on hashlib (already C, same libsodium algorithm); the
merkle tree has a native bulk path for many-leaf recomputes.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

from .. import native
from . import ed25519 as _pure
from . import ossl

_LEAF_PREFIX = b"\x00"
_NODE_PREFIX = b"\x01"


def public_key(seed: bytes) -> bytes:
    pub = native.ed25519_public(seed)
    return pub if pub is not None else _pure.public_key(seed)


def sign(message: bytes, seed: bytes) -> bytes:
    sig = native.ed25519_sign(seed, message)
    if sig is None:
        sig = ossl.ed25519_sign(seed, message)
    return sig if sig is not None else _pure.sign(message, seed)


def verify(message: bytes, signature: bytes, pub: bytes) -> bool:
    if len(signature) != 64 or len(pub) != 32:
        return False
    ok = native.ed25519_verify(pub, message, signature)
    if ok is None:
        ok = ossl.ed25519_verify(pub, message, signature)
    return ok if ok is not None else _pure.verify(message, signature, pub)


def blake2b32(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


def leaf_hash(block: bytes) -> bytes:
    """Domain-separated leaf hash (0x00 prefix, second-preimage guard)."""
    return blake2b32(_LEAF_PREFIX + block)


def merkle_root(leaf_hashes: Sequence[bytes]) -> bytes:
    """Root over 32-byte leaf hashes: parent = blake2b32(0x01||l||r),
    an odd trailing node is promoted; 0 leaves -> 32 zero bytes. The
    native path computes the whole tree in C; the fallback is identical
    level-by-level Python."""
    if not leaf_hashes:
        return b"\x00" * 32
    concat = b"".join(leaf_hashes)
    root = native.merkle_root(concat)
    if root is not None:
        return root
    level: List[bytes] = list(leaf_hashes)
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            nxt.append(blake2b32(_NODE_PREFIX + level[i] + level[i + 1]))
        if len(level) % 2 == 1:
            nxt.append(level[-1])
        level = nxt
    return level[0]
