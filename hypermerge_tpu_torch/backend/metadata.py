"""Metadata ledger: a durable feed of file-metadata entries.

Parity: reference src/Metadata.ts:125-262 — a dedicated "ledger" feed
(keypair persisted in the KeyStore, like `self.repo` at
src/RepoBackend.ts:92) whose entries record hyperfile metadata
(bytes, mimeType). Entries are written through (append to the feed,
then apply in-memory, src/Metadata.ts:178-192); on open the ledger is
replayed, skipping corrupt entries rather than failing
(src/Metadata.ts:160-170, src/JsonBuffer.ts:11-22).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..storage.feed import FeedStore
from ..utils import json_buffer
from ..utils.ids import url_to_id


class Metadata:
    LEDGER_KEY_NAME = "self.ledger"

    def __init__(self, feeds: FeedStore, key_store) -> None:
        pair = key_store.get_or_create(self.LEDGER_KEY_NAME)
        self.ledger = feeds.create(pair)
        self.files: Dict[str, dict] = {}
        self._load_ledger()

    def _load_ledger(self) -> None:
        for entry in json_buffer.parse_all_valid(self.ledger.read_all()):
            self._apply(entry)

    def _apply(self, entry: dict) -> None:
        if not isinstance(entry, dict):
            return
        if entry.get("type") == "File" and "fileId" in entry:
            self.files[entry["fileId"]] = {
                "type": "File",
                "bytes": entry.get("bytes", 0),
                "mimeType": entry.get("mimeType", "application/octet-stream"),
            }

    def add_file(self, url: str, size: int, mime_type: str) -> None:
        """Write-through: durable first, then visible. Re-announcing a
        fileId the ledger already holds with identical metadata is not
        re-appended. (Uploads mint a fresh keypair per file, so this
        guards direct re-announcement of a known id, not content-level
        dedup of identical blobs.)"""
        file_id = url_to_id(url)
        entry = {
            "type": "File",
            "fileId": file_id,
            "bytes": size,
            "mimeType": mime_type,
        }
        existing = self.files.get(file_id)
        if existing is not None and (
            existing.get("bytes") == size
            and existing.get("mimeType") == mime_type
        ):
            return
        self.ledger.append(json_buffer.bufferify(entry))
        self._apply(entry)

    def is_file(self, id_: str) -> bool:
        return id_ in self.files

    def file_metadata(self, id_: str) -> Optional[dict]:
        entry = self.files.get(id_)
        return dict(entry) if entry is not None else None
