"""SQLite database: one file (or memory), migrated on open — the port's
copy of hypermerge_tpu/storage/sql.py, with the identical schema.

Parity: the reference's SqlDatabase + migration (reference
src/SqlDatabase.ts:11-22, src/migrations/0001_initial_schema.sql — tables
Clocks/Keys/Cursors/Feeds). Python's stdlib sqlite3 replaces the
better-sqlite3 native addon.

Crash model: sqlite's own journal makes each commit atomic and durable;
for the simulated crash tests (storage/faults.py CrashRecorder) every
statement is journaled per-connection into the active recorder and lands
in its event log as one batch per commit — a crash between statements of
a transaction drops the whole transaction, exactly sqlite's semantics,
and the batches are the ones the reference hands its recorder. Clock and
cursor rows committed ahead of unfsynced feed bytes are the one skew
sqlite cannot prevent; recovery-on-open (storage/scrub.py) reconciles
them back to feed reality, and HM_FSYNC>=1 prevents the skew outright
(the store flusher's durability barrier syncs feeds before committing).
Each commit runs inside `lockdep.blocking("sqlite_commit")`, the
reference's seam for its lock-order checker, which the port keeps as a
no-op context.
"""

from __future__ import annotations

import contextlib
import sqlite3
import threading

from ..analysis import lockdep
from ..analysis.lockdep import make_rlock
from .faults import active_recorder

_SCHEMA = """
CREATE TABLE IF NOT EXISTS clocks (
  repo_id  TEXT NOT NULL,
  doc_id   TEXT NOT NULL,
  actor_id TEXT NOT NULL,
  seq      INTEGER NOT NULL,
  PRIMARY KEY (repo_id, doc_id, actor_id)
);
CREATE TABLE IF NOT EXISTS cursors (
  repo_id  TEXT NOT NULL,
  doc_id   TEXT NOT NULL,
  actor_id TEXT NOT NULL,
  seq      INTEGER NOT NULL,
  PRIMARY KEY (repo_id, doc_id, actor_id)
);
CREATE INDEX IF NOT EXISTS cursors_by_actor ON cursors (repo_id, actor_id);
CREATE TABLE IF NOT EXISTS keys (
  name       TEXT PRIMARY KEY,
  public_key TEXT NOT NULL,
  secret_key TEXT
);
CREATE TABLE IF NOT EXISTS feeds (
  public_id    TEXT PRIMARY KEY,
  discovery_id TEXT NOT NULL,
  is_writable  INTEGER NOT NULL DEFAULT 0
);
CREATE INDEX IF NOT EXISTS feeds_by_discovery ON feeds (discovery_id);
"""


class SqlDatabase:
    def __init__(self, path: str = ":memory:") -> None:
        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = make_rlock("store.sql")
        self._defer_commit = 0
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._record("script", _SCHEMA, None)
            self._commit()

    def _record(self, kind: str, sql: str, params) -> None:
        if self.path == ":memory:":
            return
        rec = active_recorder()
        if rec is not None:
            rec.db_stmt(self.path, kind, sql, params)

    def _commit(self) -> None:
        # every commit routes through here: the lockdep blocking seam
        # for sqlite (a commit under an emission lock would stall
        # every doc's patch pushes on disk latency)
        with lockdep.blocking("sqlite_commit", self.path):
            self._conn.commit()
        if self.path == ":memory:":
            return
        rec = active_recorder()
        if rec is not None:
            rec.db_commit(self.path)

    @contextlib.contextmanager
    def bulk(self):
        """Defer commits for a batch of writes (bulk cold start issues
        thousands of per-feed/per-doc upserts; one fsync, not N). Holds
        the db lock for the duration so writes from other threads can't
        slip into the deferred window and silently lose durability."""
        with self._lock:
            self._defer_commit += 1
            try:
                yield self
            finally:
                self._defer_commit -= 1
                if self._defer_commit == 0:
                    self._commit()

    def execute(self, sql: str, params=()) -> sqlite3.Cursor:
        with self._lock:
            cur = self._conn.execute(sql, params)
            self._record("exec", sql, tuple(params))
            if not self._defer_commit:
                self._commit()
            return cur

    def executemany(self, sql: str, rows) -> None:
        with self._lock:
            if active_recorder() is not None and self.path != ":memory:":
                rows = [tuple(r) for r in rows]  # generators: journal too
            self._conn.executemany(sql, rows)
            self._record("many", sql, rows)
            if not self._defer_commit:
                self._commit()

    def query(self, sql: str, params=()) -> list:
        with self._lock:
            return self._conn.execute(sql, params).fetchall()

    def close(self) -> None:
        with self._lock:
            self._conn.close()
