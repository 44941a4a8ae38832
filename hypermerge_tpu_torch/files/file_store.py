"""FileStore: write-once binary blobs stored as chunked feeds.

Parity: reference src/FileStore.ts:20-80 — write chunks data at
MAX_BLOCK_SIZE, sha256s while streaming, and appends a JSON header block
LAST (so a feed whose tail parses as a header is a complete upload);
read streams every block except the trailing header; header reads just
the head block.

Remote fetch (reference src/FileStore.ts:33-36 +
src/ReplicationManager.ts:71-89 — file feeds replicate like any feed
and reads stream blocks as they arrive): a hyperfile URL carries the
feed public key, so `read(file_id, timeout=...)` opens the feed,
announces it to the swarm (the `announce` hook wired by RepoBackend),
and streams data blocks progressively as replication backfills them —
header-last means the trailing header doubles as the completion marker.
`subscribe_progress` surfaces per-block download progress.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

from ..storage.feed import FeedStore
from ..utils import json_buffer
from ..utils import keys as keymod
from ..utils.ids import to_hyperfile_url, url_to_id
from ..utils.queue import Queue
from .stream_logic import MAX_BLOCK_SIZE, Chunkable, HashCounter, iter_chunks, rechunk


@dataclass(frozen=True)
class FileHeader:
    """The trailing header block (reference src/FileStore.ts:44-67:
    `{type: 'File', url, bytes, mimeType, sha256}`)."""

    url: str
    size: int
    mime_type: str
    sha256: str
    blocks: int  # data blocks, header excluded

    def to_json(self) -> dict:
        return {
            "type": "File",
            "url": self.url,
            "bytes": self.size,
            "mimeType": self.mime_type,
            "sha256": self.sha256,
            "blocks": self.blocks,
        }

    @staticmethod
    def from_json(obj: dict) -> "FileHeader":
        if obj.get("type") != "File":
            raise ValueError(f"not a file header: {obj!r}")
        return FileHeader(
            url=obj["url"],
            size=obj["bytes"],
            mime_type=obj["mimeType"],
            sha256=obj["sha256"],
            blocks=obj.get("blocks", -1),
        )


class FileStore:
    """Writes/reads hyperfiles over a FeedStore. Completed writes are
    announced on `write_log` (the backend's Metadata ledger subscribes —
    reference src/RepoBackend.ts:105-107)."""

    def __init__(
        self,
        feeds: FeedStore,
        announce: Optional[Callable] = None,
        forget: Optional[Callable] = None,
        remote_capable: Optional[Callable[[], bool]] = None,
    ) -> None:
        self.feeds = feeds
        self.write_log: Queue = Queue("filestore:writelog")
        # called with each file feed we create or fetch so the owner
        # (RepoBackend) can join the swarm + announce for replication;
        # `forget` undoes that for a speculative feed that fetched
        # nothing; `remote_capable` says whether a fetch could even
        # succeed (a swarm is attached)
        self._announce = announce
        self._forget = forget
        self._remote_capable = remote_capable

    def remote_capable(self) -> bool:
        return (
            self._announce is not None
            and (self._remote_capable is None or self._remote_capable())
        )

    def write(self, data: Chunkable, mime_type: str) -> FileHeader:
        pair = keymod.create()
        feed = self.feeds.create(pair)
        if self._announce is not None:
            # announce at write START: peers stream blocks during the
            # upload; header-last marks completion for them too
            self._announce(feed)
        counter = HashCounter()
        n_blocks = 0
        for chunk in counter.wrap(rechunk(iter_chunks(data), MAX_BLOCK_SIZE)):
            feed.append(chunk)
            n_blocks += 1
        header = FileHeader(
            url=to_hyperfile_url(pair.public_key),
            size=counter.bytes,
            mime_type=mime_type,
            sha256=counter.digest_hex,
            blocks=n_blocks,
        )
        feed.append(json_buffer.bufferify(header.to_json()))  # header LAST
        self.write_log.push(header)
        return header

    def _existing_feed(self, file_id: str):
        # open_if_present, not open_feed: a lookup for an unknown id must
        # not create (and forever register/announce) an empty feed, but a
        # feed persisted by a previous run must still be reachable.
        feed = self.feeds.open_if_present(file_id)
        if feed is None or feed.length == 0:
            raise FileNotFoundError(f"hyperfile {file_id} has no blocks")
        return feed

    def header(self, file_id: str) -> FileHeader:
        feed = self._existing_feed(file_id)
        try:
            return FileHeader.from_json(
                json_buffer.parse(feed.get(feed.length - 1))
            )
        except (ValueError, KeyError) as exc:
            # tail block isn't a header: incomplete upload or not a file
            raise FileNotFoundError(f"hyperfile {file_id}: {exc}") from exc

    def read(self, file_id: str, timeout: float = 0.0) -> Iterator[bytes]:
        """Stream every data block (all blocks except the trailing
        header, reference src/FileStore.ts:33-36).

        timeout == 0: local-only — the feed must already hold a
        complete upload. timeout > 0: remote-capable — the feed is
        opened + announced to the swarm and data blocks stream
        PROGRESSIVELY as replication delivers them (backfill is
        contiguous-from-head, so block i is readable the moment it
        lands); the trailing header ends the stream. TimeoutError if
        the upload hasn't completed within `timeout` seconds."""
        if timeout <= 0:
            feed = self._existing_feed(file_id)
            for i in range(feed.length - 1):
                yield feed.get(i)
            return
        feed = self._remote_feed(file_id)
        deadline = time.monotonic() + timeout
        i = 0
        while True:
            if feed.length > i:
                block = feed.get(i)
                if feed.length == i + 1:
                    hdr = self._try_header(block)
                    if hdr is not None and hdr.blocks in (-1, i):
                        return  # trailing header: upload complete
                    if hdr is None:
                        yield block  # tail is plainly data: stream it
                        i += 1
                        continue
                    # parses as header but counts the wrong number of
                    # data blocks: a DATA block whose content happens
                    # to be header JSON — wait for the next block to
                    # disambiguate (a real upload always has one)
                else:
                    yield block
                    i += 1
                    continue
            if time.monotonic() > deadline:
                self._forget_if_empty(file_id)
                raise TimeoutError(
                    f"hyperfile {file_id}: incomplete after {timeout}s "
                    f"({feed.length} blocks)"
                )
            time.sleep(0.01)

    def read_bytes(self, file_id: str, timeout: float = 0.0) -> bytes:
        return b"".join(self.read(file_id, timeout=timeout))

    def _remote_feed(self, file_id: str):
        """Open (possibly empty) + announce a file feed so replication
        can pull it from whoever holds it."""
        feed = self.feeds.get_feed(file_id)
        if feed is None:
            feed = self.feeds.open_feed(file_id)
            if self._announce is not None:
                self._announce(feed)
        return feed

    def _forget_if_empty(self, file_id: str) -> None:
        """A speculative remote open that fetched NOTHING leaves no
        trace: a bogus-id lookup must not permanently register/announce
        a feed."""
        feed = self.feeds.get_feed(file_id)
        if (
            feed is not None
            and feed.length == 0
            and not feed._sparse
        ):
            self.feeds.remove(file_id)
            if self._forget is not None:
                self._forget(feed)

    @staticmethod
    def _try_header(block: bytes) -> Optional[FileHeader]:
        try:
            return FileHeader.from_json(json_buffer.parse(block))
        except (ValueError, KeyError):
            return None

    def header_wait(self, file_id: str, timeout: float) -> FileHeader:
        """The trailing header, waiting up to `timeout` seconds for the
        upload to finish replicating in."""
        feed = self._remote_feed(file_id)
        deadline = time.monotonic() + timeout
        while True:
            if feed.length > 0:
                hdr = self._try_header(feed.get(feed.length - 1))
                if hdr is not None and hdr.blocks in (
                    -1, feed.length - 1
                ):
                    return hdr
            if time.monotonic() > deadline:
                self._forget_if_empty(file_id)
                raise TimeoutError(
                    f"hyperfile {file_id}: no complete header after "
                    f"{timeout}s ({feed.length} blocks)"
                )
            time.sleep(0.01)

    def subscribe_progress(
        self, file_id: str, cb: Callable[[int, int], None]
    ) -> Callable[[], None]:
        """cb(blocks_so_far, bytes_so_far) per arriving block (the
        Download-progress analogue for hyperfiles). Counters start at
        the feed's CURRENT state, so a retry after a partial fetch
        reports true totals. Attaches BEFORE the feed is announced, so
        the first replicated block can't slip past the subscription.
        Returns an unsubscribe callable."""
        feed = self.feeds.get_feed(file_id)
        fresh = feed is None
        if fresh:
            feed = self.feeds.open_feed(file_id)
        state = {
            "blocks": feed.length,
            "bytes": sum(len(b) for b in feed.read_all()),
        }

        def on_append(_index: int, data: bytes) -> None:
            state["blocks"] += 1
            state["bytes"] += len(data)
            cb(state["blocks"], state["bytes"])

        feed.on_append(on_append)
        if state["blocks"]:
            cb(state["blocks"], state["bytes"])  # baseline for retries
        if fresh and self._announce is not None:
            self._announce(feed)
        return lambda: feed.off_append(on_append)

    @staticmethod
    def id_of(url: str) -> str:
        return url_to_id(url)
