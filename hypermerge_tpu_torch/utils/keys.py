"""Keypair creation + base58 encoding + discovery keys.

Maps reference src/Keys.ts:22-60 (create/encode/decode/encodePair/decodePair,
discoveryKey). Discovery key = BLAKE2b-32 keyed hash of the public key with a
fixed context string, matching hypercore's scheme in shape (the exact context
differs — this framework defines its own wire identity).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Optional

from . import base58, crypto

_DISCOVERY_CONTEXT = b"hypermerge-tpu"


@dataclass(frozen=True)
class KeyPair:
    public_key: str  # base58
    secret_key: Optional[str]  # base58 seed, None for readonly


@dataclass(frozen=True)
class KeyBuffer:
    public_key: bytes
    secret_key: Optional[bytes]


def create_buffer(seed: Optional[bytes] = None) -> KeyBuffer:
    seed = seed if seed is not None else os.urandom(32)
    return KeyBuffer(public_key=crypto.public_key(seed), secret_key=seed)


def create(seed: Optional[bytes] = None) -> KeyPair:
    return encode_pair(create_buffer(seed))


def encode(key: bytes) -> str:
    return base58.encode(key)


def decode(key: str) -> bytes:
    raw = base58.decode(key)
    if len(raw) != 32:
        raise ValueError(f"key must decode to 32 bytes, got {len(raw)}")
    return raw


def encode_pair(pair: KeyBuffer) -> KeyPair:
    return KeyPair(
        public_key=encode(pair.public_key),
        secret_key=base58.encode(pair.secret_key) if pair.secret_key else None,
    )


def decode_pair(pair: KeyPair) -> KeyBuffer:
    return KeyBuffer(
        public_key=decode(pair.public_key),
        secret_key=base58.decode(pair.secret_key) if pair.secret_key else None,
    )


def discovery_key(public_key: bytes) -> bytes:
    """Public-key-derived rendezvous id that does not reveal the key itself."""
    return hashlib.blake2b(
        _DISCOVERY_CONTEXT, key=public_key, digest_size=32
    ).digest()


def discovery_id(public_id: str) -> str:
    return encode(discovery_key(decode(public_id)))
