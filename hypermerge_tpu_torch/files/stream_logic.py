"""Chunking + hashing primitives for the hyperfile write path.

Parity: reference src/StreamLogic.ts:4-63 — MaxChunkSizeTransform splits
oversized chunks while counting bytes/chunks; HashPassThrough computes a
sha256 while the data streams by. Node object streams become plain byte
iterators here; the transforms become generator combinators.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Iterator, Union

# Matches the reference's hyperfile chunk limit (src/FileStore.ts:10).
MAX_BLOCK_SIZE = 62 * 1024

Chunkable = Union[bytes, bytearray, memoryview, Iterable[bytes]]


def iter_chunks(data: Chunkable) -> Iterator[bytes]:
    """Normalize bytes-or-iterable-of-bytes into an iterator of bytes."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        yield bytes(data)
        return
    for chunk in data:
        yield bytes(chunk)


def rechunk(
    chunks: Iterable[bytes], max_size: int = MAX_BLOCK_SIZE
) -> Iterator[bytes]:
    """Split any chunk larger than max_size; pass smaller chunks through
    unchanged (split-only, like MaxChunkSizeTransform — it never
    coalesces, reference src/StreamLogic.ts:20-38). Empty chunks are
    dropped."""
    if max_size <= 0:
        raise ValueError("max_size must be positive")
    for chunk in chunks:
        for start in range(0, len(chunk), max_size):
            yield chunk[start : start + max_size]


class HashCounter:
    """sha256 + byte/chunk counters updated as data streams through.

    Parity: HashPassThrough + the transform's byte/chunk counters
    (reference src/StreamLogic.ts:40-63)."""

    def __init__(self) -> None:
        self._hash = hashlib.sha256()
        self.bytes = 0
        self.chunks = 0

    def feed(self, chunk: bytes) -> bytes:
        self._hash.update(chunk)
        self.bytes += len(chunk)
        self.chunks += 1
        return chunk

    def wrap(self, chunks: Iterable[bytes]) -> Iterator[bytes]:
        for chunk in chunks:
            yield self.feed(chunk)

    @property
    def digest_hex(self) -> str:
        return self._hash.hexdigest()
