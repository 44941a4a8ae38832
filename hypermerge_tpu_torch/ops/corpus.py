"""On-disk benchmark corpus writer — valid repo state, written fast.

The cold-start benchmark (BASELINE configs 3/4: re-materialize 10k docs
x 1k ops from disk) needs a repo directory holding real product state:
per-actor block logs (storage/feed.py framing), columnar sidecars
(storage/colcache.py layout), and the sqlite rows (cursors/clocks/feeds)
a live repo would have persisted. Writing 10M ops through the
interactive `repo.change` path takes minutes of pure Python; this writer
produces byte-equivalent state directly:

- `distinct` template histories come from ops/synth.py `synth_changes`
  (single-writer chat-shaped docs, contiguous seqs 1..n);
- each template's change blocks and sidecar files are rendered once,
  then instantiated per doc by substituting the doc's actor id (the only
  per-doc content) and re-packing blocks;
- sqlite rows are written in one executemany per table.

Equivalence with the interactive write path is pinned by
tests/test_corpus.py: a corpus doc opens to exactly the state a repo
that executed the same changes persists.
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

from ..crdt.change import Change
from ..storage import block as blockmod
from ..storage.colcache import FeedColumnCache, MemoryColumnStorage
from ..storage.sql import SqlDatabase
from ..utils import keys as keymod
from ..utils.ids import to_doc_url
from ..utils.json_buffer import bufferify
from .synth import synth_changes

_HDR = struct.Struct("<I")  # storage/feed.py block framing
_TEMPLATE_ACTOR = "actor00"  # synth_changes' single-writer actor name
INFINITY_SEQ = 2**53 - 1  # crdt/clock.py INFINITY_SEQ


class _Template:
    """One synthetic history, pre-rendered for per-doc instantiation.

    The sidecar is one v3 checkpoint (storage/colcache.py): the planes,
    preds, and row-ends bytes are doc-invariant and rendered ONCE as
    `_body`; only the interner-tables blob names the writer actor, so
    per doc the checkpoint re-frames that blob around the shared body."""

    def __init__(self, changes: List[Change]) -> None:
        from ..storage.colcache import (
            planes_from_rows,
            v3_body_bytes,
            v3_frame,
        )

        self.n_changes = len(changes)
        self.raw_blocks = [bufferify(c.to_json()) for c in changes]
        cc = FeedColumnCache(
            MemoryColumnStorage(), writer=_TEMPLATE_ACTOR
        )
        for c in changes:
            cc.append_change(c)
        fc = cc.columns()
        planes = (
            fc.planes
            if fc.planes is not None
            else planes_from_rows(fc.ensure_rows())
        )
        row_ends = np.asarray(cc._commits_arr[:, 0], np.int64)
        flags = np.asarray(cc._commits_arr[:, 3], np.uint8)
        self._body = v3_body_bytes(planes, fc.preds, row_ends, flags)
        self._shape = (fc.n_rows, len(row_ends), len(fc.preds))
        self._tables = cc._tables_blob()
        self._frame = v3_frame

    def checkpoint_bytes(self, writer_pk: str) -> bytes:
        """The doc's sidecar: the shared checkpoint body framed with the
        writer actor substituted in the tables blob."""
        tables = self._tables.replace(
            _TEMPLATE_ACTOR.encode("ascii"), writer_pk.encode("ascii")
        )
        return self._frame(self._body, *self._shape, tables)


def _write_doc(
    feeds_root: str, pair: keymod.KeyPair, tpl: _Template, sign: bool,
    slab=None,
) -> None:
    from ..storage.integrity import sign_chain

    pk = pair.public_key
    d = os.path.join(feeds_root, pk[:2])
    os.makedirs(d, exist_ok=True)
    pkb = pk.encode("ascii")
    tab = _TEMPLATE_ACTOR.encode("ascii")
    # block log: template JSON with the doc's actor substituted, packed
    # through the product codec (storage/block.py); the .sig sidecar is
    # the same record chain a live writer persists (integrity.sign_chain
    # is the single source of truth for that format)
    blocks = [
        blockmod.pack_raw(raw.replace(tab, pkb)) for raw in tpl.raw_blocks
    ]
    parts: List[bytes] = []
    for b in blocks:
        parts.append(_HDR.pack(len(b)))
        parts.append(b)
    log_bytes = b"".join(parts)
    with open(os.path.join(d, pk), "wb") as fh:
        fh.write(log_bytes)
    # block-count index (storage/feed.py FileFeedStorage._LEN)
    with open(os.path.join(d, pk + ".len"), "wb") as fh:
        fh.write(struct.pack("<QQ", len(blocks), len(log_bytes)))
    if sign:
        with open(os.path.join(d, pk + ".sig"), "wb") as fh:
            fh.write(sign_chain(blocks, keymod.decode(pair.secret_key)))
    # columnar sidecar: one v3 checkpoint with this doc's writer
    # substituted in the tables blob (everything else is doc-invariant),
    # framed into the corpus slab (storage/slab.py) — or a per-feed
    # `.cols2` file when the slab layout is disabled
    ckpt = tpl.checkpoint_bytes(pk)
    if slab is not None:
        from ..storage.slab import KIND_IMAGE

        slab.append(KIND_IMAGE, pk, ckpt)
    else:
        with open(os.path.join(d, pk + ".cols2"), "wb") as fh:
            fh.write(ckpt)


def make_corpus(
    path: str,
    n_docs: int,
    n_ops: int,
    ops_per_change: int = 16,
    distinct: int = 8,
    seed: int = 0,
    threads: int = 8,
    sign: bool = True,
    text_frac: float = 0.85,
) -> List[str]:
    """Write a repo directory of `n_docs` single-writer docs with `n_ops`
    ops each; returns their doc urls. Safe to call once per directory.
    `sign=False` skips the .sig sidecars (faster; such feeds cannot
    replicate to strict peers). `text_frac` is synth_changes' share of
    text inserts (1.0: the automerge-perf trace's shape)."""
    feeds_root = os.path.join(path, "feeds")
    os.makedirs(feeds_root, exist_ok=True)

    templates = [
        _Template(
            synth_changes(
                n_ops,
                n_actors=1,
                ops_per_change=ops_per_change,
                text_frac=text_frac,
                seed=seed + t,
            )
        )
        for t in range(min(distinct, n_docs))
    ]

    pairs = [keymod.create() for _ in range(n_docs)]

    slab = None
    if os.environ.get("HM_SLAB", "1") != "0":
        from ..storage.slab import CorpusSlab

        slab = CorpusSlab(os.path.join(feeds_root, "cols.slab"))
    try:
        with ThreadPoolExecutor(max_workers=threads) as pool:
            list(
                pool.map(
                    lambda i: _write_doc(
                        feeds_root,
                        pairs[i],
                        templates[i % len(templates)],
                        sign,
                        slab,
                    ),
                    range(n_docs),
                )
            )
    finally:
        if slab is not None:
            slab.close()

    db = SqlDatabase(os.path.join(path, "repo.db"))
    repo_pair = keymod.create()
    db.execute(
        "INSERT OR REPLACE INTO keys (name, public_key, secret_key) "
        "VALUES (?,?,?)",
        ("self.repo", repo_pair.public_key, repo_pair.secret_key),
    )
    rid = repo_pair.public_key
    with db.bulk():
        db.executemany(
            "INSERT OR REPLACE INTO cursors "
            "(repo_id, doc_id, actor_id, seq) VALUES (?,?,?,?)",
            [(rid, p.public_key, p.public_key, INFINITY_SEQ) for p in pairs],
        )
        db.executemany(
            "INSERT OR REPLACE INTO clocks "
            "(repo_id, doc_id, actor_id, seq) VALUES (?,?,?,?)",
            [
                (
                    rid,
                    p.public_key,
                    p.public_key,
                    templates[i % len(templates)].n_changes,
                )
                for i, p in enumerate(pairs)
            ],
        )
        db.executemany(
            "INSERT OR REPLACE INTO feeds "
            "(public_id, discovery_id, is_writable) VALUES (?,?,0)",
            [
                (p.public_key, keymod.discovery_id(p.public_key))
                for p in pairs
            ],
        )
    db.close()
    return [to_doc_url(p.public_key) for p in pairs]
