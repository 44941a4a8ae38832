"""Corpus slab — every feed's columnar sidecar in ONE append-only file.

The per-feed single-file sidecar (storage/colcache.py FileColumnStorageV2)
made each sidecar one open+read — but a 10k-doc cold open still paid ~10k
opens plus the directory-walk stats to find them, about 2s of the
cold-open wall clock (the reference's bench, its t_io stage). The slab
collapses all of that to
O(1) opens and large sequential reads: one file of framed segments plus a
tiny extent index, mmap'd once and sliced per feed.

Layout (`feeds/cols.slab`):

    header   b"HMSB" <u32 version=1>
    segment  <u8 kind> <u16 name_len> name <u64 payload_len> payload

kinds:
    1  image     the feed's full sidecar image in FileColumnStorageV2
                 byte format (v3 checkpoint blob, possibly followed by
                 framed v2 records). Supersedes every earlier segment of
                 the feed (written by checkpoint/compaction, and by the
                 lazy migration of a legacy `.cols2` file on first read).
    2  record    one framed v2 record appended after the feed's image
                 (live writer path, storage/colcache.py commit_change).
    3  tombstone the feed was reset/destroyed; earlier segments are dead.

Index (`feeds/cols.slab.idx`): one entry per segment —
    <u8 kind> <u16 name_len> name <u64 payload_off> <u64 payload_len>
so open() reads the small index instead of scanning the slab. The index
is advisory: a torn/missing/short index rebuilds (or repairs forward)
by scanning slab segment headers; a torn slab tail — a segment whose
declared payload runs past EOF — is ignored and overwritten by the next
append. Crash model matches the sidecars it replaces: the columnar cache
is derived data, blocks remain the source of truth.

Superseded bytes (old images, tombstoned feeds) are reclaimed by
`compact()`, which `close()` runs automatically when more than
HM_SLAB_SLACK (default 25%) of the file is dead — tmp + atomic rename,
so a crash mid-compaction leaves either the old file or the new one.
"""

from __future__ import annotations

import io
import mmap
import os
import struct
import threading
from typing import Dict, List, Optional, Tuple

from ..analysis.lockdep import make_rlock
from ..utils.debug import log
from .faults import io_fsync, io_open, io_remove, io_replace

_MAGIC = b"HMSB"
_VERSION = 1
_HDR = struct.Struct("<4sI")
_SEG = struct.Struct("<BH")  # kind, name_len  (then name, then <Q len)
_LEN = struct.Struct("<Q")

KIND_IMAGE = 1
KIND_RECORD = 2
KIND_TOMBSTONE = 3


def _slack_fraction() -> float:
    return float(os.environ.get("HM_SLAB_SLACK", "0.25"))


class CorpusSlab:
    """One repo's sidecar slab: extent index + append/read/compact."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.idx_path = path + ".idx"
        self._lock = make_rlock("store.slab")
        self._loaded = False
        # name -> live extents [(kind, payload_off, payload_len)]:
        # an image resets the list, records append, a tombstone clears
        self._feeds: Dict[str, List[Tuple[int, int, int]]] = {}
        self._end = 0  # valid end of the slab file
        self._live_bytes = 0  # header+payload bytes of live segments
        self._fh: Optional[io.BufferedRandom] = None
        self._mm: Optional[mmap.mmap] = None
        self._mm_size = 0
        self._idx_fh = None
        self._closed = False
        # crash-recovery accounting from the last _ensure_loaded: how
        # many segments were repaired forward past the index, and
        # whether the index itself was unusable (tools/scrub.py)
        self.last_repair: Dict[str, int] = {}

    # -- index ----------------------------------------------------------

    def _ensure_loaded(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        self._end = len(_HDR.pack(_MAGIC, _VERSION))
        try:
            slab_size = os.path.getsize(self.path)
        except OSError:
            return
        entries, idx_ok, idx_end = self._read_index(slab_size)
        if not idx_ok:
            entries = []
        pos = len(_HDR.pack(_MAGIC, _VERSION))
        for kind, name, off, ln in entries:
            self._apply(kind, name, off, ln)
            pos = off + ln
        # repair forward: segments appended after the last indexed one
        # (crash between the slab append and the index append), or the
        # whole file when the index was unusable
        recovered = self._scan(pos, slab_size)
        self.last_repair = {
            "segments_recovered": len(recovered),
            "idx_rebuilt": 0 if idx_ok else 1,
            "bytes_ignored": max(0, slab_size - (
                recovered[-1][2] + recovered[-1][3] if recovered else pos
            )),
        }
        if recovered:
            for kind, name, off, ln in recovered:
                self._apply(kind, name, off, ln)
            if idx_ok:
                # a torn partial entry may trail the last good one; drop
                # it BEFORE appending, or every later open would parse
                # the fragment as a bogus entry, fail the monotonic
                # check, and rescan the whole slab
                self._truncate_idx(idx_end)
                for e in recovered:
                    self._append_idx(*e)
            else:
                self._rewrite_idx()
        elif not idx_ok:
            self._rewrite_idx()
        elif idx_end is not None:
            self._truncate_idx(idx_end)

    def _read_index(self, slab_size: int):
        """([(kind, name, payload_off, payload_len)], usable, torn_at) —
        usable is False when the index is missing or inconsistent with
        the slab; torn_at is the byte offset of a trailing partial entry
        fragment (None when the file parsed cleanly to its end)."""
        try:
            with open(self.idx_path, "rb") as fh:
                raw = fh.read()
        except OSError:
            return [], False, None
        out = []
        pos = 0
        end = len(raw)
        prev_end = len(_HDR.pack(_MAGIC, _VERSION))
        while pos + _SEG.size <= end:
            kind, nlen = _SEG.unpack_from(raw, pos)
            p = pos + _SEG.size
            if p + nlen + 16 > end:
                break  # torn index tail: entries so far remain usable
            name = raw[p : p + nlen].decode("ascii", "replace")
            off, ln = struct.unpack_from("<QQ", raw, p + nlen)
            if off < prev_end or off + ln > slab_size:
                return [], False, None  # inconsistent: rebuild by scan
            out.append((kind, name, off, ln))
            prev_end = off + ln
            pos = p + nlen + 16
        return out, True, (pos if pos < end else None)

    def _truncate_idx(self, torn_at: Optional[int]) -> None:
        """Drop a torn partial entry fragment from the index tail so
        later appends land on a clean boundary."""
        if torn_at is None:
            return
        try:
            with io_open(self.idx_path, "r+b") as fh:
                fh.truncate(torn_at)
        except OSError:
            pass  # read-only media: the fragment stays, scan still heals

    def _scan(self, start: int, slab_size: int):
        """Parse slab segment headers in [start, slab_size); stops at a
        torn tail."""
        if start >= slab_size:
            return []
        out = []
        with open(self.path, "rb") as fh:
            mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
            try:
                pos = start
                while pos + _SEG.size <= slab_size:
                    kind, nlen = _SEG.unpack_from(mm, pos)
                    p = pos + _SEG.size
                    if kind not in (
                        KIND_IMAGE, KIND_RECORD, KIND_TOMBSTONE
                    ) or p + nlen + _LEN.size > slab_size:
                        break
                    name = mm[p : p + nlen].decode("ascii", "replace")
                    (ln,) = _LEN.unpack_from(mm, p + nlen)
                    off = p + nlen + _LEN.size
                    if off + ln > slab_size:
                        break  # torn tail
                    out.append((kind, name, off, ln))
                    pos = off + ln
            finally:
                mm.close()
        return out

    def _apply(self, kind: int, name: str, off: int, ln: int) -> None:
        seg_bytes = _SEG.size + len(name) + _LEN.size + ln
        if kind == KIND_IMAGE:
            for _k, _o, dead in self._feeds.get(name, ()):
                self._live_bytes -= _SEG.size + len(name) + _LEN.size + dead
            self._feeds[name] = [(kind, off, ln)]
            self._live_bytes += seg_bytes
        elif kind == KIND_RECORD:
            self._feeds.setdefault(name, []).append((kind, off, ln))
            self._live_bytes += seg_bytes
        else:  # tombstone
            for _k, _o, dead in self._feeds.get(name, ()):
                self._live_bytes -= _SEG.size + len(name) + _LEN.size + dead
            self._feeds[name] = []
        self._end = off + ln

    # -- reads ----------------------------------------------------------

    def has(self, name: str) -> bool:
        with self._lock:
            self._ensure_loaded()
            return name in self._feeds

    def feed_live(self, name: str) -> bool:
        """True iff the feed has live (non-tombstoned) segments."""
        with self._lock:
            self._ensure_loaded()
            return bool(self._feeds.get(name))

    def feed_names(self) -> List[str]:
        with self._lock:
            self._ensure_loaded()
            return [n for n, segs in self._feeds.items() if segs]

    def _mapped(self) -> Optional[mmap.mmap]:
        # caller holds the lock. The mapping is reused stat-free until
        # an append invalidates it (_mm is cleared there) — a bulk cold
        # open slices it thousands of times.
        if self._mm is not None:
            return self._mm
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return None
        if size == 0:
            return None
        with open(self.path, "rb") as fh:
            self._mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        self._mm_size = size
        return self._mm

    def prefetch(self, names) -> None:
        """Read-ahead hint for the streaming pipeline's io stage: ask
        the OS (madvise WILLNEED) to page in the live extents of
        `names` before image_bytes slices them, so a cold-cache bulk
        open's reads are sequential prefetches instead of per-feed
        demand faults. Advisory only — unknown names and platforms
        without madvise are silently fine."""
        with self._lock:
            self._ensure_loaded()
            mm = self._mapped()
            if mm is None or not hasattr(mm, "madvise"):
                return
            page = mmap.PAGESIZE
            for name in names:
                for _k, off, ln in self._feeds.get(name, ()):
                    start = off - (off % page)
                    try:
                        mm.madvise(
                            mmap.MADV_WILLNEED, start, off + ln - start
                        )
                    except (OSError, ValueError):
                        # advisory only: a transient per-extent failure
                        # (ENOMEM/EAGAIN) must not abandon the hints
                        # for the rest of the chunk
                        continue

    def image_bytes(self, name: str) -> bytes:
        """The feed's sidecar image in FileColumnStorageV2 byte format:
        live image segment + record segments, concatenated. One mmap
        slice per segment — the cold-open common case is exactly one."""
        with self._lock:
            self._ensure_loaded()
            segs = self._feeds.get(name)
            if not segs:
                return b""
            mm = self._mapped()
            if mm is None:
                return b""
            if len(segs) == 1:
                _k, off, ln = segs[0]
                return mm[off : off + ln]
            return b"".join(mm[off : off + ln] for _k, off, ln in segs)

    # -- writes ---------------------------------------------------------

    def _writable(self):
        if self._fh is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            fresh = not os.path.exists(self.path)
            self._fh = io_open(self.path, "w+b" if fresh else "r+b")
            if fresh:
                self._fh.write(_HDR.pack(_MAGIC, _VERSION))
                self._fh.flush()
                self._end = self._fh.tell()
            self._idx_fh = io_open(self.idx_path, "ab")
        return self._fh

    def append(self, kind: int, name: str, payload: bytes) -> None:
        with self._lock:
            self._ensure_loaded()
            nb = name.encode("ascii")
            head = _SEG.pack(kind, len(nb)) + nb + _LEN.pack(len(payload))
            # exception safety under mid-write ENOSPC/EIO: in-memory
            # extents (_apply) only advance after the whole segment is
            # on disk, and a failed write drops the persistent handles
            # (their buffers may hold torn bytes in an ambiguous state)
            # — the next append reopens, seeks the unchanged _end, and
            # overwrites the torn tail, exactly like a crash would heal
            try:
                fh = self._writable()
                fh.seek(self._end)  # overwrite any torn tail
                fh.write(head)
                fh.write(payload)
                fh.truncate()
                fh.flush()
            except OSError:
                self._close_files()
                raise
            off = self._end + len(head)
            self._apply(kind, name, off, len(payload))
            if self._mm is not None:
                self._mm.close()  # stale mapping: remap on next read
                self._mm = None
                self._mm_size = 0
            self._append_idx(kind, name, off, len(payload))

    def _append_idx(self, kind, name, off, ln) -> None:
        # the index is advisory: a failed/torn idx append just means the
        # next open repairs forward from the slab's segment headers
        try:
            if self._idx_fh is None:
                self._idx_fh = io_open(self.idx_path, "ab")
            nb = name.encode("ascii")
            self._idx_fh.write(
                _SEG.pack(kind, len(nb)) + nb + struct.pack("<QQ", off, ln)
            )
            self._idx_fh.flush()
        except OSError as e:
            log("storage:slab", f"idx append failed {self.idx_path}: {e}")
            if self._idx_fh is not None:
                try:
                    self._idx_fh.close()
                except OSError:
                    pass
                self._idx_fh = None

    def _rewrite_idx(self) -> None:
        # entries MUST be offset-ordered: _read_index treats any
        # non-monotonic offset as corruption (a feed-grouped dump of
        # interleaved segments would fail that check on every open)
        entries = sorted(
            (off, ln, kind, name)
            for name, segs in self._feeds.items()
            for kind, off, ln in segs
        )
        tmp = self.idx_path + ".tmp"
        with io_open(tmp, "wb") as fh:
            for off, ln, kind, name in entries:
                nb = name.encode("ascii")
                fh.write(
                    _SEG.pack(kind, len(nb))
                    + nb
                    + struct.pack("<QQ", off, ln)
                )
        io_replace(tmp, self.idx_path)

    # -- lifecycle ------------------------------------------------------

    def compact(self, force: bool = False) -> bool:
        """Rewrite the slab keeping only live segments. Returns True when
        a rewrite happened. Without `force`, only when the dead fraction
        exceeds HM_SLAB_SLACK (and at least 4KB of dead bytes)."""
        with self._lock:
            self._ensure_loaded()
            if not os.path.exists(self.path):
                return False
            dead = self._end - len(_HDR.pack(_MAGIC, _VERSION)) - (
                self._live_bytes
            )
            if not force and (
                dead < 4096
                or dead < _slack_fraction() * max(self._end, 1)
            ):
                return False
            mm = self._mapped()
            if mm is None:
                return False
            tmp = self.path + ".tmp"
            new_feeds: Dict[str, List[Tuple[int, int, int]]] = {}
            with io_open(tmp, "wb") as fh:
                fh.write(_HDR.pack(_MAGIC, _VERSION))
                for name, segs in self._feeds.items():
                    if not segs:
                        continue  # tombstoned: simply absent after rewrite
                    nb = name.encode("ascii")
                    out = []
                    for kind, off, ln in segs:
                        head = _SEG.pack(kind, len(nb)) + nb + _LEN.pack(ln)
                        fh.write(head)
                        fh.write(mm[off : off + ln])
                        out.append((kind, fh.tell() - ln, ln))
                    new_feeds[name] = out
                fh.flush()
                io_fsync(fh)
                new_end = fh.tell()
            self._close_files()
            io_replace(tmp, self.path)
            self._feeds = new_feeds
            self._end = new_end
            self._live_bytes = new_end - len(_HDR.pack(_MAGIC, _VERSION))
            self._rewrite_idx()
            return True

    def _close_files(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
            self._mm_size = 0
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._idx_fh is not None:
            self._idx_fh.close()
            self._idx_fh = None

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._loaded:
                try:
                    self.compact()
                except OSError:
                    pass  # read-only media: slack stays until writable
            self._close_files()

    def destroy(self) -> None:
        with self._lock:
            self._close_files()
            for p in (self.path, self.idx_path):
                if os.path.exists(p):
                    io_remove(p)
            self._feeds = {}
            self._loaded = True
            self._end = len(_HDR.pack(_MAGIC, _VERSION))
            self._live_bytes = 0
