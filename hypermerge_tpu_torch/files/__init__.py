"""Hyperfile subsystem: write-once binary blobs as chunked feeds.

Parity target: reference src/FileStore.ts, src/FileServer.ts,
src/FileServerClient.ts, src/StreamLogic.ts (SURVEY.md §1.6, §3.6).
A file is its own feed: data blocks of at most MAX_BLOCK_SIZE bytes,
followed by ONE trailing JSON header block (size, mimeType, sha256) —
header last so readers can detect a complete upload.
"""

from .file_store import FileHeader, FileStore
from .stream_logic import MAX_BLOCK_SIZE, HashCounter, iter_chunks, rechunk

__all__ = [
    "FileHeader",
    "FileStore",
    "MAX_BLOCK_SIZE",
    "HashCounter",
    "iter_chunks",
    "rechunk",
]
