"""Whole-repo crash recovery: audit → truncate → repair-forward →
reconcile sqlite against feed reality (the port's copy of
hypermerge_tpu/storage/scrub.py: the same passes in the same order, the
same report).

Each on-disk format heals its own torn tail lazily (feed.py length-
prefix scan, slab.py repair-forward, colcache.py commit records,
integrity.py fixed records) — but a doc's persistent state SPANS those
files plus the sqlite clock/cursor rows, and a crash can land between
any pair of writes. This module is the cross-file reconciler:

  recover_repo(back)   runs on RepoBackend open when the previous
                       session did not close cleanly (the repo.dirty
                       marker): physically truncates torn tails,
                       drops signature records that claim blocks the
                       log lost, re-signs (seals) writable feeds'
                       crash-orphaned unsigned tails, truncates
                       READ-ONLY feeds' unverifiable tails back to the
                       last signed record (those blocks re-replicate
                       from peers), resets columnar sidecars that ran
                       ahead of their block log, and clamps sqlite
                       clock rows down to what the feeds actually hold
                       (clocks-ahead-of-feeds is the direction nothing
                       else recovers: a stale row advertises state the
                       repo cannot supply). Writes its report to
                       <repo>/scrub.json so operators can see crash
                       damage after the fact (`last_report`).

  wal_status(...)      per-doc journal verdict from that report:
                       replayed / checkpointed / clean.

  doc_status(...)      cheap per-doc verdict: ok / recovered /
                       truncated-N-blocks / unsigned_tail.

The run order inside `_recover_repo`: journal replay first
(storage/wal.py `recover`), then the slab's repair-forward, the feed
scan (bounded by the journal's dirty ledger when its session stamp
matches the crash marker), each feed's torn tail, sig chain, sealed or
dropped unsigned tail and columnar sidecar reset, and last the clamp of
the sqlite clock rows. The backend runs it before its clock mirror
attaches, so the mirror seeds from the clamped rows.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Set

from ..utils.debug import log
from .. import telemetry
from .integrity import allow_unsigned

REPORT_NAME = "scrub.json"
_COUNTERS = (
    "feeds",
    "blocks_truncated",
    "bytes_truncated",
    "sig_fragment_bytes",
    "sig_records_dropped",
    "tail_blocks_dropped",
    "unsigned_tails_sealed",
    "colcache_reset",
    "clock_rows_clamped",
    "slab_segments_recovered",
    "slab_idx_rebuilt",
)


def feed_names_on_disk(feeds_root: str) -> Set[str]:
    """Every block-log name under feeds/: files with no extension in
    the two-char fan-out dirs (sidecars carry .len/.sig/.cols2)."""
    out: Set[str] = set()
    if not os.path.isdir(feeds_root):
        return out
    for sub in os.listdir(feeds_root):
        d = os.path.join(feeds_root, sub)
        if len(sub) != 2 or not os.path.isdir(d):
            continue
        for name in os.listdir(d):
            if "." not in name and os.path.isfile(os.path.join(d, name)):
                out.add(name)
    return out


def _repair_sig_chain(sig_store, n_blocks: int, write: bool = True):
    """(records_kept, fragment_bytes, records_dropped): truncate a torn
    trailing fragment, then drop records claiming more blocks than the
    log holds (a power cut can persist the sig append but drop the
    block bytes; without this the next audit brands a plain crash as
    TAMPERED). write=False measures without touching disk (dry run)."""
    if hasattr(sig_store, "repair"):
        fragment = (
            sig_store.repair()
            if write
            else _sig_fragment_bytes(sig_store)
        )
    else:
        fragment = 0
    records = sig_store.load()
    kept = [r for r in records if r[0] <= n_blocks]
    dropped = len(records) - len(kept)
    if write and dropped and hasattr(sig_store, "rewrite"):
        sig_store.rewrite(kept)
    return kept, fragment, dropped


def _sig_fragment_bytes(sig_store) -> int:
    """Torn trailing fragment size without repairing (dry run)."""
    from .integrity import _REC

    path = getattr(sig_store, "path", None)
    if path is None or not os.path.exists(path):
        return 0
    return os.path.getsize(path) % _REC.size


def _colcache_changes(cache_storage) -> Optional[int]:
    """Committed change count in a columnar sidecar, or None when the
    sidecar has no commits to speak of."""
    try:
        lv3 = getattr(cache_storage, "load_v3", None)
        if lv3 is not None:
            commits = lv3()[4]
        else:
            commits = cache_storage.load()[3]
    except Exception as e:  # unreadable sidecar: rebuild it
        log("storage:scrub", f"sidecar unreadable ({e}): resetting")
        return -1
    return len(commits)


def recover_repo(back, repair: bool = True) -> Dict:
    """Crash recovery over an already-constructed (file-backed)
    RepoBackend, BEFORE any doc is opened. Returns (and persists) the
    report. With repair=False nothing is written — the report describes
    what a repair would do (a dry run)."""
    # span lands even when recovery RAISES (the trace you want most is
    # the failed one); the counter only counts completed recoveries
    sp = telemetry.begin("storage.recover", "storage")
    ok = False
    try:
        report = _recover_repo(back, repair)
        ok = True
    finally:
        sp.end(ok=ok)
    telemetry.counter("storage.recoveries").add(1)
    return report


def _recover_repo(back, repair: bool) -> Dict:
    t0 = time.perf_counter()
    report: Dict = {k: 0 for k in _COUNTERS}
    per_feed: Dict[str, Dict] = {}
    report["per_feed"] = per_feed

    # -- journal replay FIRST (storage/wal.py): acked blocks a power
    # cut dropped from the (unfsynced-at-ack) per-feed logs come back
    # from the fsynced journal, so the torn-tail/sig/clock passes
    # below see the replayed reality. The journal's session stamp +
    # dirty-name ledger also BOUND the scan: a matching durable-tier
    # journal proves which feeds the crashed session could have
    # touched, and every other sidecar is skipped unopened (the
    # 100k-feed recovery constant).
    from . import wal as walmod

    wal_report = walmod.recover(back, repair)
    report["wal"] = wal_report
    bounded = bool(wal_report.get("bounded"))

    # -- slab: loading IS the repair-forward (torn segments ignored,
    # index rebuilt/extended from segment headers) ---------------------
    slab = getattr(back, "_col_slab", None)
    if slab is not None:
        slab.feed_names()  # forces _ensure_loaded
        rep = getattr(slab, "last_repair", {})
        report["slab_segments_recovered"] = rep.get(
            "segments_recovered", 0
        )
        report["slab_idx_rebuilt"] = rep.get("idx_rebuilt", 0)

    feeds_root = os.path.join(back.path, "feeds")
    names = set(back.feed_info.all_public_ids())
    names |= feed_names_on_disk(feeds_root)
    if bounded:
        dirty = set(wal_report.get("dirty", ()))
        report["feeds_skipped"] = len(names - dirty)
        names &= dirty
    blocks_by_feed: Dict[str, int] = {}
    for name in sorted(names):
        entry: Dict = {}
        storage = back.feeds._storage_fn(name)
        try:
            if hasattr(storage, "repair"):
                r = storage.repair(write=repair)
                n_blocks = r["blocks"]
                if r["bytes_truncated"]:
                    entry["bytes_truncated"] = r["bytes_truncated"]
                    report["bytes_truncated"] += r["bytes_truncated"]
            else:
                n_blocks = len(storage)

            # -- signature chain vs block log ----------------------------
            sig_store = back.feeds._sig_fn(name)
            kept, fragment, dropped = _repair_sig_chain(
                sig_store, n_blocks, write=repair
            )
            if fragment:
                entry["sig_fragment_bytes"] = fragment
                report["sig_fragment_bytes"] += fragment
            if dropped:
                entry["sig_records_dropped"] = dropped
                report["sig_records_dropped"] += dropped
            signed = kept[-1][0] if kept else 0
            writable = name in getattr(back, "_actor_keys", {})
            if n_blocks > signed:
                if writable:
                    # locally authored crash-orphaned tail: re-sign it
                    # (Feed.seal via the real feed machinery)
                    if repair:
                        feed = back.feeds.create(back._actor_keys[name])
                        feed.seal()
                    entry["sealed"] = n_blocks - signed
                    report["unsigned_tails_sealed"] += 1
                elif kept and not allow_unsigned():
                    # read-only feed: an uncovered tail is
                    # indistinguishable from a foreign append — drop
                    # back to the verified prefix; the blocks
                    # re-replicate from whichever peer served them
                    n = n_blocks - signed
                    if repair and hasattr(storage, "truncate_to"):
                        n = storage.truncate_to(signed)
                    entry["tail_blocks_dropped"] = n
                    report["tail_blocks_dropped"] += n
                    n_blocks = signed
                else:
                    entry["unsigned_tail"] = n_blocks - signed

            # -- columnar sidecar ahead of the block log -----------------
            cache_storage = (
                back.feeds._cache_fn(name)
                if back.feeds._cache_fn is not None
                else None
            )
            if cache_storage is not None:
                n_changes = _colcache_changes(cache_storage)
                if n_changes is not None and (
                    n_changes < 0 or n_changes > n_blocks
                ):
                    if repair:
                        cache_storage.reset()
                    entry["colcache_reset"] = 1
                    report["colcache_reset"] += 1
                cache_storage.close()
        finally:
            storage.close()
        blocks_by_feed[name] = n_blocks
        report["feeds"] += 1
        if entry:
            per_feed[name] = entry

    # -- sqlite clock rows vs feed reality -----------------------------
    # Our own repo's clock rows advertise what we can SUPPLY; a row
    # ahead of the (possibly truncated) feed would gossip state no
    # peer can ever pull from us. Clamp down to the block counts.
    # (Cursor rows are intent — "include this actor up to here" — and
    # monotonic-safe: replication re-fills them, so they stay.)
    for doc_id in back.clocks.all_doc_ids(back.id):
        clock = back.clocks.get(back.id, doc_id)
        # bounded runs: an actor OUTSIDE the scan set is session-clean
        # by the journal's ledger — its clock row stands. Full scans
        # keep the strict rule: no feed on disk means clamp to zero.
        clamped = {
            a: min(s, blocks_by_feed.get(a, s if bounded else 0))
            for a, s in clock.items()
        }
        if clamped != clock:
            n = sum(
                1 for a in clock if clamped.get(a, 0) != clock[a]
            )
            report["clock_rows_clamped"] += n
            if repair:
                back.clocks.set(
                    back.id,
                    doc_id,
                    {a: s for a, s in clamped.items() if s > 0},
                )

    report["t_recover_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
    if repair:
        from .faults import io_open

        try:
            with io_open(os.path.join(back.path, REPORT_NAME), "wb") as fh:
                fh.write(json.dumps(report).encode("utf-8"))
        except OSError as e:
            log("storage:scrub", f"report write failed: {e}")
    repairs = sum(report[k] for k in _COUNTERS if k != "feeds")
    if repairs:
        log(
            "storage:scrub",
            f"crash recovery repaired {repairs} item(s) across "
            f"{report['feeds']} feed(s) in {report['t_recover_ms']}ms",
        )
    return report


def last_report(path: str) -> Optional[Dict]:
    """The report recover_repo persisted on the last crash recovery of
    the repo at `path`, or None."""
    p = os.path.join(path, REPORT_NAME)
    if not os.path.exists(p):
        return None
    try:
        with open(p) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def wal_status(report: Optional[Dict], actors) -> str:
    """Per-doc journal verdict, from the persisted
    scrub report's `wal` section:

      replayed      the last recovery re-appended journaled blocks
                    into one of this doc's feeds (a power cut had
                    dropped unfsynced log pages)
      checkpointed  the crashed session touched a feed of this doc,
                    but its blocks were already durable in the logs
                    (nothing to replay)
      clean         untouched by the crashed session (or no journal
                    ran)
    """
    wal = (report or {}).get("wal") or {}
    actors = set(actors)
    if actors & set(wal.get("replayed_feeds", ())):
        return "replayed"
    if actors & set(wal.get("dirty", ())):
        return "checkpointed"
    return "clean"


def doc_status(back, doc_id: str, report: Optional[Dict] = None) -> str:
    """Cheap per-doc crash/scrub verdict — no block re-hashing (that is
    the feeds' full merkle audit):

      truncated-N-blocks  the last recovery dropped N of this doc's
                          blocks (read-only unverifiable tails)
      recovered           the last recovery repaired something for one
                          of this doc's feeds (torn tails, sidecar
                          resets, seals — no block loss)
      unsigned_tail       a feed currently holds blocks beyond its
                          last signature record
      ok                  none of the above
    """
    actors = list(back.cursors.get(back.id, doc_id))
    dropped = 0
    repaired = False
    per_feed = (report or {}).get("per_feed", {})
    for a in actors:
        entry = per_feed.get(a)
        if entry:
            dropped += entry.get("tail_blocks_dropped", 0)
            repaired = True
    unsigned = False
    for a in actors:
        feed = back.feeds.get_feed(a)
        if feed is None:
            storage = back.feeds._storage_fn(a)
            try:
                n_blocks = len(storage)
            finally:
                storage.close()
            sig_store = back.feeds._sig_fn(a)
            try:
                recs = sig_store.load()
            finally:
                sig_store.close()
            signed = recs[-1][0] if recs else 0
        else:
            n_blocks = feed.length
            signed = (
                feed.integrity.signed_length
                if feed.integrity is not None
                else 0
            )
        if n_blocks > signed:
            unsigned = True
    if dropped:
        return f"truncated-{dropped}-blocks"
    if repaired:
        return "recovered"
    if unsigned:
        return "unsigned_tail"
    return "ok"
