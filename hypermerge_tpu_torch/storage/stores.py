"""Clock and cursor stores over SqlDatabase — the port of the ClockStore
and CursorStore of hypermerge_tpu/storage/stores.py.

Parity (SURVEY.md §2.1): ClockStore (monotonic upsert, get/getMultiple/
update/set, reference src/ClockStore.ts:24-119), CursorStore (INFINITY_SEQ
clamping, docsWithActor reverse lookup, reference src/CursorStore.ts:19-91).

ClockStore.union_query / dominated_query run the bulk vector-clock folds
on the clock kernels (ops/clock_kernels.py) — the 100k-doc query of
BASELINE.json config 5 — instead of row-at-a-time SQL aggregation: over
the attached DeviceClockMirror for the whole corpus, or over a doc subset
packed from sqlite and uploaded to the store's device. The store resolves
its device at construction (cuda unless `device="cpu"`).

KeyStore (named keypairs) and FeedInfoStore (the feeds table) are plain
copies of the reference's.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Tuple

from ..analysis.lockdep import make_rlock
from ..crdt import clock as clockmod
from ..device import DeviceLike, resolve
from ..ops import clock_kernels as K
from ..utils import keys as keymod
from .sql import SqlDatabase

INFINITY_SEQ = clockmod.INFINITY_SEQ


def _clamp(seq: float) -> int:
    if seq == math.inf or seq >= INFINITY_SEQ:
        return INFINITY_SEQ
    return int(seq)


class ClockStore:
    def __init__(self, db: SqlDatabase, device: DeviceLike = None) -> None:
        self.db = db
        self.device = resolve(device)  # where doc-subset queries run
        self.mirror = None  # optional DeviceClockMirror (attach_mirror)
        self._mirror_repo: Optional[str] = None

    def attach_mirror(self, repo_id: str, mirror) -> None:
        """Keep a DeviceClockMirror (ops/clock_mirror.py) consistent
        with every clock write FOR ONE REPO, seeding it with the
        existing rows; whole-corpus union/dominated queries then run as
        kernel launches over the device-resident matrix instead of
        sqlite scans + re-uploads. Writes scoped to other repo ids
        sharing this database never touch the mirror (set() is a hard
        per-repo overwrite — merging repos would corrupt it)."""
        rows = self.db.query(
            "SELECT doc_id, actor_id, seq FROM clocks WHERE repo_id=?",
            (repo_id,),
        )
        by_doc: Dict[str, clockmod.Clock] = {}
        for doc_id, actor, seq in rows:
            by_doc.setdefault(doc_id, {})[actor] = seq
        mirror.update_many(by_doc)
        self.mirror = mirror
        self._mirror_repo = repo_id

    def _mirror_for(self, repo_id: str):
        return self.mirror if repo_id == self._mirror_repo else None

    def get(self, repo_id: str, doc_id: str) -> clockmod.Clock:
        rows = self.db.query(
            "SELECT actor_id, seq FROM clocks WHERE repo_id=? AND doc_id=?",
            (repo_id, doc_id),
        )
        return {a: s for a, s in rows}

    def get_multiple(
        self, repo_id: str, doc_ids: Iterable[str]
    ) -> Dict[str, clockmod.Clock]:
        ids = list(doc_ids)
        out: Dict[str, clockmod.Clock] = {d: {} for d in ids}
        for base in range(0, len(ids), 500):  # see CursorStore note
            chunk = ids[base : base + 500]
            marks = ",".join("?" for _ in chunk)
            rows = self.db.query(
                f"SELECT doc_id, actor_id, seq FROM clocks "
                f"WHERE repo_id=? AND doc_id IN ({marks})",
                (repo_id, *chunk),
            )
            for doc_id, actor, seq in rows:
                out[doc_id][actor] = seq
        return out

    def update(
        self, repo_id: str, doc_id: str, clock: clockmod.Clock
    ) -> clockmod.Clock:
        """Monotonic merge: only raises seqs (reference's
        `seq=excluded.seq WHERE excluded.seq > seq` upsert)."""
        self.db.executemany(
            "INSERT INTO clocks (repo_id, doc_id, actor_id, seq) "
            "VALUES (?,?,?,?) "
            "ON CONFLICT (repo_id, doc_id, actor_id) DO UPDATE "
            "SET seq=excluded.seq WHERE excluded.seq > seq",
            [
                (repo_id, doc_id, a, _clamp(s))
                for a, s in clock.items()
            ],
        )
        m = self._mirror_for(repo_id)
        if m is not None:
            m.update(doc_id, clock)
        return self.get(repo_id, doc_id)

    def update_many(
        self, repo_id: str, clocks: Dict[str, clockmod.Clock]
    ) -> None:
        """Monotonic merge for many docs in one executemany (no per-doc
        read-back — the bulk cold start writes thousands of clock rows)."""
        self.db.executemany(
            "INSERT INTO clocks (repo_id, doc_id, actor_id, seq) "
            "VALUES (?,?,?,?) "
            "ON CONFLICT (repo_id, doc_id, actor_id) DO UPDATE "
            "SET seq=excluded.seq WHERE excluded.seq > seq",
            [
                (repo_id, d, a, _clamp(s))
                for d, clock in clocks.items()
                for a, s in clock.items()
            ],
        )
        m = self._mirror_for(repo_id)
        if m is not None:
            m.update_many(clocks)

    def set(
        self, repo_id: str, doc_id: str, clock: clockmod.Clock
    ) -> None:
        """Hard overwrite (reference ClockStore.set)."""
        self.db.execute(
            "DELETE FROM clocks WHERE repo_id=? AND doc_id=?",
            (repo_id, doc_id),
        )
        self.db.executemany(
            "INSERT INTO clocks (repo_id, doc_id, actor_id, seq) "
            "VALUES (?,?,?,?)",
            [(repo_id, doc_id, a, _clamp(s)) for a, s in clock.items()],
        )
        m = self._mirror_for(repo_id)
        if m is not None:
            m.set(doc_id, clock)

    def delete_doc(self, doc_id: str) -> None:
        """Drop every repo's clock rows for a doc (doc destroy)."""
        self.db.execute("DELETE FROM clocks WHERE doc_id=?", (doc_id,))
        if self.mirror is not None:  # destroy is cross-repo by design
            self.mirror.delete_doc(doc_id)

    def all_doc_ids(self, repo_id: str) -> List[str]:
        return [
            r[0]
            for r in self.db.query(
                "SELECT DISTINCT doc_id FROM clocks WHERE repo_id=?",
                (repo_id,),
            )
        ]

    # -- device bulk queries -------------------------------------------

    def _packed(self, repo_id: str, doc_ids: List[str]):
        clocks = self.get_multiple(repo_id, doc_ids)
        ordered = [clocks[d] for d in doc_ids]
        actors = clockmod.actor_axis(ordered)
        if not actors:
            return None, []
        rows = clockmod.pack(ordered, actors)
        return K.pack_clocks(rows, device=self.device), actors

    def union_query(
        self, repo_id: str, doc_ids: Optional[List[str]] = None
    ) -> clockmod.Clock:
        """Union of many docs' clocks in one column max. With a
        mirror attached, the whole-corpus form never touches sqlite —
        the matrix is already device-resident."""
        m = self._mirror_for(repo_id)
        if m is not None and doc_ids is None:
            return m.union()
        ids = doc_ids if doc_ids is not None else self.all_doc_ids(repo_id)
        if not ids:
            return {}
        rows, actors = self._packed(repo_id, ids)
        if rows is None:
            return {}
        merged = K.union_reduce(rows).tolist()
        return clockmod.unpack([merged], actors)[0]

    def dominated_query(
        self, repo_id: str, query: clockmod.Clock,
        doc_ids: Optional[List[str]] = None,
    ) -> List[str]:
        """All docs whose clock is dominated by `query` (one pairwise
        gte, the query row broadcast in place; device-resident when a
        mirror is attached)."""
        m = self._mirror_for(repo_id)
        if m is not None and doc_ids is None:
            return m.dominated(query)
        ids = doc_ids if doc_ids is not None else self.all_doc_ids(repo_id)
        if not ids:
            return []
        rows, actors = self._packed(repo_id, ids)
        if rows is None:
            return list(ids)
        q = K.pack_clocks(
            clockmod.pack([{a: query.get(a, 0) for a in actors}], actors),
            device=self.device,
        )[0]
        ok = K.gte(q, rows).tolist()
        return [d for d, good in zip(ids, ok) if good]


class CursorStore:
    """Which actors (and up to what seq) a repo includes in each doc.

    Reads serve from a write-through in-memory mirror (hydrated per
    repo_id on first touch): cursor lookups sit on the replication hot
    path (_sync_changes runs docs_with_actor + entry per feed append
    burst) and a ~1ms SQLite round trip under writer contention there
    throttles live convergence. SQLite stays the durable copy — every
    mutation still lands in the table; the mirror merges with the same
    monotonic max-wins rule as the upsert."""

    def __init__(self, db: SqlDatabase) -> None:
        self.db = db
        self._lock = make_rlock("store.cursors")
        # repo_id -> doc_id -> {actor: seq}; repo_id -> actor -> docs
        self._mem: Dict[str, Dict[str, Dict[str, int]]] = {}
        self._by_actor: Dict[str, Dict[str, Dict[str, None]]] = {}
        self._hydrated: set = set()  # repo_ids with SQLite rows merged
        # bumped by delete_doc: deletion is NOT monotonic, so a
        # hydration snapshot taken before a racing delete must be
        # thrown away and re-queried (see _ensure_hydrated)
        self._del_gen: Dict[str, int] = {}

    def _repo(self, repo_id: str) -> Dict[str, Dict[str, int]]:
        """The repo's mirror dicts (created empty on demand).
        REQUIRES store.cursors (the reference's analysis/guards.py).
        Hydration from SQLite happens ONLY in _ensure_hydrated — never
        here, never under the mirror lock."""
        mem = self._mem.get(repo_id)
        if mem is None:
            mem = self._mem[repo_id] = {}
            self._by_actor[repo_id] = {}
        return mem

    def _ensure_hydrated(self, repo_id: str) -> None:
        """Merge the repo's SQLite rows into the mirror, once. The
        query runs with NO mirror lock held: the write batches absorb
        into the mirror from inside `db.bulk()` (sql lock HELD), so
        the declared order is store.sql -> store.cursors (the
        reference's analysis/hierarchy.py) — hydrating under the mirror
        lock was the other half of a real sql<->cursors AB/BA deadlock
        the reference's lock-order checker caught (bulk-load /
        store-flush thread vs a replication cursor lookup).

        Upsert races are safe by monotonicity: a row committed after
        our query was also write-through absorbed by its writer, and a
        concurrent hydration merging the same snapshot is idempotent
        (max-wins). DELETION is not monotonic — a delete_doc landing
        between our query and our merge would be resurrected by the
        stale snapshot — so delete_doc bumps a per-repo generation and
        we re-query whenever it moved."""
        while repo_id not in self._hydrated:  # membership: GIL-atomic
            with self._lock:
                gen = self._del_gen.get(repo_id, 0)
            rows = self.db.query(
                "SELECT doc_id, actor_id, seq FROM cursors "
                "WHERE repo_id=?",
                (repo_id,),
            )
            with self._lock:
                if repo_id in self._hydrated:
                    return
                if self._del_gen.get(repo_id, 0) != gen:
                    continue  # a delete raced the query: snapshot stale
                for doc_id, actor, seq in rows:
                    self._absorb(repo_id, doc_id, actor, seq)
                self._hydrated.add(repo_id)

    def _absorb(
        self, repo_id: str, doc_id: str, actor: str, seq: int
    ) -> None:
        """Max-wins merge into the mirror (the upsert's twin).
        REQUIRES store.cursors."""
        cur = self._repo(repo_id).setdefault(doc_id, {})
        if actor not in cur or seq > cur[actor]:
            cur[actor] = seq
        self._by_actor[repo_id].setdefault(actor, {})[doc_id] = None

    def get(self, repo_id: str, doc_id: str) -> clockmod.Clock:
        self._ensure_hydrated(repo_id)
        with self._lock:
            return dict(self._repo(repo_id).get(doc_id, {}))

    def entry(self, repo_id: str, doc_id: str, actor_id: str) -> int:
        self._ensure_hydrated(repo_id)
        with self._lock:
            return self._repo(repo_id).get(doc_id, {}).get(actor_id, 0)

    def update(
        self, repo_id: str, doc_id: str, clock: clockmod.Clock
    ) -> clockmod.Clock:
        self._ensure_hydrated(repo_id)  # the read-back below merges
        self.db.executemany(
            "INSERT INTO cursors (repo_id, doc_id, actor_id, seq) "
            "VALUES (?,?,?,?) "
            "ON CONFLICT (repo_id, doc_id, actor_id) DO UPDATE "
            "SET seq=excluded.seq WHERE excluded.seq > seq",
            [(repo_id, doc_id, a, _clamp(s)) for a, s in clock.items()],
        )
        with self._lock:
            for a, s in clock.items():
                self._absorb(repo_id, doc_id, a, _clamp(s))
            return dict(self._repo(repo_id).get(doc_id, {}))

    def merge_mem(
        self, repo_id: str, doc_id: str, clock: clockmod.Clock
    ) -> clockmod.Clock:
        """Mirror-only monotonic merge, returning the merged cursor.
        The durable sqlite rows ride the caller's DEBOUNCED store
        flush (RepoBackend._stores -> update_many_rows): cursor gossip
        ingest is the fleet's hottest message path, and a synchronous
        executemany per inbound frame puts sqlite on it O(actors) deep
        (a fleet doc carries one actor per peer). Crash safety is
        unchanged: cursor rows rebuild from feeds on recovery."""
        self._ensure_hydrated(repo_id)
        with self._lock:
            for a, s in clock.items():
                self._absorb(repo_id, doc_id, a, _clamp(s))
            return dict(self._repo(repo_id).get(doc_id, {}))

    def update_many_rows(
        self, repo_id: str, rows: Iterable[Tuple[str, str, int]]
    ) -> None:
        """Monotonic merge of (doc_id, actor_id, seq) rows in one
        statement, no read-back (the debounced live-path store flush)."""
        rows = list(rows)
        self.db.executemany(
            "INSERT INTO cursors (repo_id, doc_id, actor_id, seq) "
            "VALUES (?,?,?,?) "
            "ON CONFLICT (repo_id, doc_id, actor_id) DO UPDATE "
            "SET seq=excluded.seq WHERE excluded.seq > seq",
            [(repo_id, d, a, _clamp(s)) for d, a, s in rows],
        )
        with self._lock:
            for d, a, s in rows:
                self._absorb(repo_id, d, a, _clamp(s))

    def add_actor(
        self, repo_id: str, doc_id: str, actor_id: str,
        seq: float = math.inf,
    ) -> None:
        self.update(repo_id, doc_id, {actor_id: seq})

    def add_actors(
        self, repo_id: str, entries, seq: float = math.inf
    ) -> None:
        """add_actor for many (doc_id, actor_id) pairs in one statement."""
        entries = list(entries)
        s = _clamp(seq)
        self.db.executemany(
            "INSERT INTO cursors (repo_id, doc_id, actor_id, seq) "
            "VALUES (?,?,?,?) "
            "ON CONFLICT (repo_id, doc_id, actor_id) DO UPDATE "
            "SET seq=excluded.seq WHERE excluded.seq > seq",
            [(repo_id, d, a, s) for d, a in entries],
        )
        with self._lock:
            for d, a in entries:
                self._absorb(repo_id, d, a, s)

    def get_multiple(
        self, repo_id: str, doc_ids: Iterable[str]
    ) -> Dict[str, clockmod.Clock]:
        """Cursors for many docs in one pass over the mirror."""
        ids = list(doc_ids)
        self._ensure_hydrated(repo_id)
        with self._lock:
            mem = self._repo(repo_id)
            return {d: dict(mem.get(d, {})) for d in ids}

    def docs_with_actor(self, repo_id: str, actor_id: str) -> List[str]:
        self._ensure_hydrated(repo_id)
        with self._lock:
            self._repo(repo_id)
            return list(self._by_actor[repo_id].get(actor_id, ()))

    def actors_for(self, repo_id: str, doc_id: str) -> List[str]:
        return list(self.get(repo_id, doc_id).keys())

    def delete_doc(self, repo_id: str, doc_id: str) -> None:
        self.db.execute(
            "DELETE FROM cursors WHERE repo_id=? AND doc_id=?",
            (repo_id, doc_id),
        )
        with self._lock:
            # invalidate in-flight hydrations: a snapshot queried
            # before this delete must not merge the doc back in
            self._del_gen[repo_id] = self._del_gen.get(repo_id, 0) + 1
            if repo_id in self._mem:
                self._mem[repo_id].pop(doc_id, None)
                for docs in self._by_actor[repo_id].values():
                    docs.pop(doc_id, None)


class KeyStore:
    def __init__(self, db: SqlDatabase) -> None:
        self.db = db

    def get(self, name: str) -> Optional[keymod.KeyPair]:
        rows = self.db.query(
            "SELECT public_key, secret_key FROM keys WHERE name=?", (name,)
        )
        if not rows:
            return None
        return keymod.KeyPair(public_key=rows[0][0], secret_key=rows[0][1])

    def set(self, name: str, pair: keymod.KeyPair) -> keymod.KeyPair:
        self.db.execute(
            "INSERT OR REPLACE INTO keys (name, public_key, secret_key) "
            "VALUES (?,?,?)",
            (name, pair.public_key, pair.secret_key),
        )
        return pair

    def get_or_create(self, name: str) -> keymod.KeyPair:
        pair = self.get(name)
        if pair is None:
            pair = keymod.create()
            self.set(name, pair)
        return pair

    def all_pairs(self) -> Dict[str, keymod.KeyPair]:
        """Every stored keypair in ONE query (the backend hydrates its
        actor-key map from this at open — a per-actor SELECT would put
        sqlite back on the bulk cold-open path)."""
        return {
            name: keymod.KeyPair(public_key=pub, secret_key=sec)
            for name, pub, sec in self.db.query(
                "SELECT name, public_key, secret_key FROM keys"
            )
        }

    def clear(self, name: str) -> None:
        self.db.execute("DELETE FROM keys WHERE name=?", (name,))


class FeedInfoStore:
    def __init__(self, db: SqlDatabase) -> None:
        self.db = db

    def save(
        self, public_id: str, discovery_id: str, is_writable: bool
    ) -> None:
        self.db.execute(
            "INSERT OR REPLACE INTO feeds "
            "(public_id, discovery_id, is_writable) VALUES (?,?,?)",
            (public_id, discovery_id, 1 if is_writable else 0),
        )

    def save_many(self, rows) -> None:
        """(public_id, discovery_id, is_writable) triples, one statement."""
        self.db.executemany(
            "INSERT OR REPLACE INTO feeds "
            "(public_id, discovery_id, is_writable) VALUES (?,?,?)",
            [(p, d, 1 if w else 0) for p, d, w in rows],
        )

    def delete(self, public_id: str) -> None:
        self.db.execute(
            "DELETE FROM feeds WHERE public_id=?", (public_id,)
        )

    def all_public_ids(self) -> List[str]:
        return [r[0] for r in self.db.query("SELECT public_id FROM feeds")]

    def by_discovery_id(self, discovery_id: str) -> Optional[str]:
        rows = self.db.query(
            "SELECT public_id FROM feeds WHERE discovery_id=?",
            (discovery_id,),
        )
        return rows[0][0] if rows else None

    def remove(self, public_id: str) -> None:
        self.db.execute(
            "DELETE FROM feeds WHERE public_id=?", (public_id,)
        )

    def is_writable(self, public_id: str) -> bool:
        rows = self.db.query(
            "SELECT is_writable FROM feeds WHERE public_id=?", (public_id,)
        )
        return bool(rows and rows[0][0])
