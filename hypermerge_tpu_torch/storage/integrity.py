"""Feed integrity: ed25519-signed merkle log per feed — the trust model.

Parity: hypercore's signed merkle tree (reference
src/types/hypercore.d.ts:132-188 — every feed is an append-only log whose
state is an ed25519 signature over a merkle root; replicas verify every
extension against the feed's public key before storing it). SURVEY §2.4
calls this the biggest native build item; the crypto primitives live in
the C++ layer (native/src/hm_native.cpp) behind utils/crypto.py.

Design (host-side, but built for the bulk scale):

- leaf hash = blake2b32(0x00 || block) (domain-separated, crypto.leaf_hash)
- tree = the promote-odd merkle over leaf hashes (crypto.merkle_root);
  maintained incrementally as binary-counter PEAKS so a writer's append
  is O(log n) hashing, not O(n) — equivalence with the bulk recompute is
  pinned by tests/test_integrity.py.
- signature = ed25519(seed, b"hm-feed-v1" || uint64le(length) || root),
  records (length, root, sig) persist in a `.sig` sidecar next to the
  block log (104-byte fixed records; a torn tail truncates to the last
  whole record). Only the newest record is needed to verify a full
  prefix. A live writer signs PERIODICALLY (every HM_SIGN_INTERVAL
  appends, default 1024 — the replication chunk size) plus ON DEMAND at
  any boundary via record_for (the incremental peaks give the head root
  for free; older boundaries recompute from the cached leaves), so an
  interactive burst of appends costs one signature per replication
  flush, not one per append. The dense-record corpus format
  (sign_chain) remains valid input: record_for prefers stored records.
- replication (net/replication.py) verifies every inbound extension:
  recompute root over (own leaves[0:start] + received blocks) and check
  the sender's signature against the feed public key BEFORE _append_raw.
  Tampered or unsigned extensions are dropped and logged
  (HM_ALLOW_UNSIGNED_FEEDS=1 restores pre-signature interop).
- `audit(feed)` re-hashes the whole log against the newest stored
  record — detects on-disk tampering of blocks or sig records.

Local writes by this process are inside the local trust boundary (as in
the reference — hypercore trusts its own storage, sqlite rows included);
verification guards the REPLICATION boundary, audit guards the disk.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import List, Optional, Tuple

from ..analysis.lockdep import make_rlock
from ..utils import crypto
from ..utils import keys as keymod
from ..utils.debug import log
from .faults import io_open, io_remove

_SIG_CONTEXT = b"hm-feed-v1"
_REC = struct.Struct("<Q32s64s")  # length, root, signature

# audit_status() results: OK / recoverable crash-orphan / tampered.
# Lazy signing (sign_interval) means a crash can legitimately leave a
# writable feed with blocks beyond its last signed record; that is NOT
# the same evidence as on-disk tampering, and tooling (tools/ls.py)
# surfaces it separately with the seal() recovery path.
AUDIT_OK = "ok"
AUDIT_UNSIGNED_TAIL = "unsigned_tail"
AUDIT_TAMPERED = "tampered"

_NODE_PREFIX = b"\x01"


def sign_interval() -> int:
    return int(os.environ.get("HM_SIGN_INTERVAL", "1024"))


def _parent(left: bytes, right: bytes) -> bytes:
    return crypto.blake2b32(_NODE_PREFIX + left + right)


def signable(length: int, root: bytes) -> bytes:
    return _SIG_CONTEXT + struct.pack("<Q", length) + root


class Peaks:
    """Incremental promote-odd merkle: binary-counter peaks.

    `append(leaf)` is O(log n) amortized; `root()` folds the peaks
    right-to-left with the same parent hash the bulk
    crypto.merkle_root(leaves) computes, so both paths agree bit-for-bit
    on every length."""

    def __init__(self) -> None:
        self.sizes: List[int] = []
        self.hashes: List[bytes] = []
        self.length = 0

    def append(self, leaf_hash: bytes) -> None:
        self.sizes.append(1)
        self.hashes.append(leaf_hash)
        while len(self.sizes) >= 2 and self.sizes[-1] == self.sizes[-2]:
            right = self.hashes.pop()
            left = self.hashes.pop()
            s = self.sizes.pop() + self.sizes.pop()
            self.hashes.append(_parent(left, right))
            self.sizes.append(s)
        self.length += 1

    def root(self) -> bytes:
        if not self.hashes:
            return b"\x00" * 32
        acc = self.hashes[-1]
        for h in reversed(self.hashes[:-1]):
            acc = _parent(h, acc)
        return acc


# ---------------------------------------------------------------------------
# signature-record storage


class MemorySigStorage:
    def __init__(self) -> None:
        self.records: List[Tuple[int, bytes, bytes]] = []

    def append(self, length: int, root: bytes, sig: bytes) -> None:
        self.records.append((length, root, sig))

    def load(self) -> List[Tuple[int, bytes, bytes]]:
        return list(self.records)

    def destroy(self) -> None:
        self.records.clear()

    def close(self) -> None:  # pragma: no cover - nothing to do
        pass


class FileSigStorage:
    """Fixed-size (length, root, sig) records; torn tail ignored."""

    def __init__(self, path: str) -> None:
        self.path = path

    def append(self, length: int, root: bytes, sig: bytes) -> None:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with io_open(self.path, "ab") as fh:
            fh.write(_REC.pack(length, root, sig))

    def load(self) -> List[Tuple[int, bytes, bytes]]:
        if not os.path.exists(self.path):
            return []
        with open(self.path, "rb") as fh:
            raw = fh.read()
        n = len(raw) // _REC.size
        return [
            _REC.unpack_from(raw, i * _REC.size) for i in range(n)
        ]

    def repair(self) -> int:
        """Truncate a torn trailing fragment (load() already ignores
        it; repair drops the bytes so audits and byte accounting see a
        clean chain). Returns bytes dropped."""
        if not os.path.exists(self.path):
            return 0
        size = os.path.getsize(self.path)
        keep = (size // _REC.size) * _REC.size
        if size > keep:
            with io_open(self.path, "r+b") as fh:
                fh.truncate(keep)
        return size - keep

    def rewrite(self, records: List[Tuple[int, bytes, bytes]]) -> None:
        """Replace the whole chain (scrub dropping records that claim
        blocks the log lost after a power cut)."""
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with io_open(self.path, "wb") as fh:
            for length, root, sig in records:
                fh.write(_REC.pack(length, root, sig))

    def destroy(self) -> None:
        if os.path.exists(self.path):
            io_remove(self.path)

    def close(self) -> None:  # pragma: no cover - nothing to do
        pass


def memory_sig_storage_fn(_name: str) -> MemorySigStorage:
    return MemorySigStorage()


def file_sig_storage_fn(root: str):
    def fn(name: str) -> FileSigStorage:
        return FileSigStorage(os.path.join(root, name[:2], name + ".sig"))

    return fn


# ---------------------------------------------------------------------------


class FeedIntegrity:
    """Signed-merkle state of one feed.

    Lazily loaded: bulk cold opens never touch it; replication and audit
    do. The leaf-hash cache rebuilds from the feed's blocks on demand
    (blocks are the source of truth, as with the columnar sidecar)."""

    def __init__(self, store, public_key: str) -> None:
        self._store = store
        self.public_key = public_key
        self._lock = make_rlock("store.integrity")
        self._records: Optional[List[Tuple[int, bytes, bytes]]] = None
        self._peaks: Optional[Peaks] = None
        self._leaves: List[bytes] = []
        # per-length interior merkle levels for the proof server
        # (build_proof_ctx): the tree at a given length is immutable in
        # an append-only log, so entries stay valid forever — the tiny
        # LRU just bounds memory. Serving a repeated RequestRange costs
        # O(range x log n) hash LOOKUPS, zero hash computations.
        self._proof_cache: Dict[int, tuple] = {}
        # appends this session not yet covered by a stored record
        # (periodic signing skipped them) — Feed.close/seal signs then
        self.unsigned_tail = False

    # -- records --------------------------------------------------------

    def _ensure_records(self) -> List[Tuple[int, bytes, bytes]]:
        if self._records is None:
            self._records = self._store.load()
        return self._records

    @property
    def signed_length(self) -> int:
        recs = self._ensure_records()
        return recs[-1][0] if recs else 0

    def latest(self) -> Optional[Tuple[int, bytes, bytes]]:
        recs = self._ensure_records()
        return recs[-1] if recs else None

    def records(self) -> List[Tuple[int, bytes, bytes]]:
        return list(self._ensure_records())

    def record_at(self, length: int) -> Optional[Tuple[int, bytes, bytes]]:
        """The stored (length, root, sig) covering exactly `length`."""
        for rec in reversed(self._ensure_records()):
            if rec[0] == length:
                return rec
            if rec[0] < length:
                break
        return None

    # -- leaf cache ------------------------------------------------------

    def _ensure_leaves(self, feed, upto: int) -> List[bytes]:
        """Leaf hashes for feed blocks [0, upto) — cached, extended from
        the block log as needed.

        Lock order: the documented order is feed lock BEFORE integrity
        lock (Feed.append -> sign_append). Callers that hold neither
        (range_proofs serving a RequestRange with a stale leaf cache)
        must not acquire them inverted, so the block snapshot
        (feed.get_batch, feed lock) happens OUTSIDE the integrity lock;
        the extension then re-checks under the lock — leaves are a pure
        function of the blocks, so a concurrent extension that won the
        race simply means fewer entries left for us to append."""
        while True:
            with self._lock:
                have = len(self._leaves)
                if have >= upto:
                    return self._leaves[:upto]
            blocks = feed.get_batch(have, upto)  # feed lock only
            hashes = [crypto.leaf_hash(b) for b in blocks]
            with self._lock:
                cur = len(self._leaves)
                if cur >= upto:
                    return self._leaves[:upto]
                if cur >= have:
                    # a concurrent extension may have won part of the
                    # race; leaves are a pure function of the blocks, so
                    # the overlap is identical and we append the rest
                    self._leaves.extend(hashes[cur - have :])
                    return self._leaves[:upto]
                # cur < have: the cache was RESET (destroy) between the
                # snapshot and the re-lock — our hashes are misaligned;
                # retry from the fresh state

    def _ensure_peaks(self, feed, upto: int) -> Peaks:
        with self._lock:
            if self._peaks is None:
                self._peaks = Peaks()
            if self._peaks.length < upto:
                for leaf in self._ensure_leaves(feed, upto)[
                    self._peaks.length :
                ]:
                    self._peaks.append(leaf)
            return self._peaks

    # -- writer path ------------------------------------------------------

    def sign_append(self, feed, index: int, data: bytes) -> None:
        """Writer appended block `index`: extend the tree, and store a
        fresh signed record every sign_interval appends (any other
        boundary signs on demand in record_for — per-append ed25519 +
        sidecar IO is the dominant cost of an interactive write)."""
        with self._lock:
            peaks = self._ensure_peaks(feed, index)
            leaf = crypto.leaf_hash(data)
            if len(self._leaves) == index:
                self._leaves.append(leaf)
            peaks.append(leaf)
            if (index + 1) % sign_interval() == 0:
                root = peaks.root()
                sig = crypto.sign(
                    signable(index + 1, root),
                    keymod.decode(feed.secret_key),
                )
                try:
                    self._store.append(index + 1, root, sig)
                except OSError as e:
                    # sig sidecar full/bad (ENOSPC/EIO): the BLOCK is
                    # already durable and locally authored — degrade to
                    # an unsigned tail (recoverable: seal()/record_for
                    # re-signs) instead of failing the acked append
                    log(
                        "repo:integrity",
                        f"sig append failed {self.public_key[:6]}: {e}",
                    )
                    self.unsigned_tail = True
                else:
                    self._ensure_records().append((index + 1, root, sig))
                    self.unsigned_tail = False
            else:
                self.unsigned_tail = True

    def record_for(self, feed, length: int):
        """The (length, root, sig) covering exactly `length`: a stored
        record when one exists, else — for a feed we hold the secret key
        of — a freshly signed one. At the head the incremental peaks
        yield the root directly (the live-tail flush path: one signature
        per flush window); older boundaries recompute from the cached
        leaf hashes. Newly signed head records persist; off-head ones
        are served without storing (the sidecar stays sorted).

        Lock order: feed lock BEFORE integrity lock — the same order
        the writer path uses (Feed.append -> sign_append), so a flusher
        signing on demand cannot deadlock against a concurrent append.
        """
        rec = self.record_at(length)
        if rec is not None:
            return rec
        if feed.secret_key is None or length <= 0:
            return None
        with feed._lock:
            if length > feed.length:
                return None
            seed = keymod.decode(feed.secret_key)
            with self._lock:
                peaks = self._ensure_peaks(feed, length)
                if peaks.length == length:
                    root = peaks.root()
                else:  # boundary behind the head: rebuild to length
                    probe = Peaks()
                    for leaf in self._ensure_leaves(feed, length):
                        probe.append(leaf)
                    root = probe.root()
                sig = crypto.sign(signable(length, root), seed)
                rec = (length, root, sig)
                recs = self._ensure_records()
                if not recs or recs[-1][0] < length:
                    try:
                        self._store.append(length, root, sig)
                    except OSError as e:
                        # serve the record anyway (it is valid); the
                        # chain stays un-extended so a later seal or
                        # sign retries persistence
                        log(
                            "repo:integrity",
                            f"sig store failed "
                            f"{self.public_key[:6]}: {e}",
                        )
                        if length == feed.length:
                            self.unsigned_tail = True
                    else:
                        recs.append(rec)
                        if length == feed.length:
                            self.unsigned_tail = False
                return rec

    # -- replication boundary ---------------------------------------------

    def verify_extension(
        self, feed, start: int, blocks: List[bytes], length: int,
        root_sig: bytes,
    ) -> Optional[Tuple[bytes, List[bytes]]]:
        """Check a claimed extension: blocks fill [start, length) on top
        of our local prefix [0, start). Returns (root, new leaf hashes)
        when the signature verifies against the feed public key; None
        otherwise. Nothing is appended here. The prefix root comes from
        the incremental peaks, so verifying a feed chunk-by-chunk is
        O(chunk log n), not O(n) hashing per chunk."""
        if length != start + len(blocks) or start > feed.length:
            return None
        with self._lock:
            peaks = self._ensure_peaks(feed, start)
            probe = Peaks()
            probe.sizes = list(peaks.sizes)
            probe.hashes = list(peaks.hashes)
            probe.length = peaks.length
            new_leaves = [crypto.leaf_hash(b) for b in blocks]
            for leaf in new_leaves:
                probe.append(leaf)
            root = probe.root()
            ok = crypto.verify(
                signable(length, root),
                root_sig,
                keymod.decode(self.public_key),
            )
            return (root, new_leaves) if ok else None

    def record_verified(
        self, length: int, root: bytes, sig: bytes,
        new_leaves: List[bytes],
    ) -> None:
        """Store the record for an extension that verify_extension
        accepted and whose blocks the caller appended."""
        with self._lock:
            self._leaves.extend(new_leaves)
            if self._peaks is not None:
                for leaf in new_leaves:
                    self._peaks.append(leaf)
            self._ensure_records().append((length, root, sig))
            try:
                self._store.append(length, root, sig)
            except OSError as e:
                # the blocks are stored and the in-memory chain serves
                # this session; after a crash the uncovered tail is
                # scrub-truncated and re-replicates from peers
                log(
                    "repo:integrity",
                    f"sig store failed {self.public_key[:6]}: {e}",
                )

    def range_proofs(self, feed, start: int, end: int):
        """Serve a sparse range: (proof_length, sig, [(block, proof)])
        for blocks [start, end) against a signed record — a stored one
        covering the range, else (writable feeds) one signed on demand
        at the head. None when no record can cover `end`."""
        rec = None
        for r in self._ensure_records():
            if r[0] >= end:
                rec = r
                break
        if rec is None:
            rec = self.record_for(feed, feed.length)
            if rec is None or rec[0] < end:
                return None
        length, _root, sig = rec
        ctx = self._proof_ctx(feed, length)
        blocks = feed.get_batch(start, end)
        proofs = proofs_from_ctx(ctx, start, end)
        return (length, sig, list(zip(blocks, proofs)))

    def _proof_ctx(self, feed, length: int):
        """The forest levels at `length`, cached. First build is the
        O(length) hashing pass; every later range served against the
        same signed record is pure lookup (the pre-cache server re-built
        the whole level set per request: O(range x length))."""
        with self._lock:
            ctx = self._proof_cache.get(length)
            if ctx is not None:
                return ctx
        # leaves snapshot outside the integrity lock: store.integrity
        # is a LEAF class in the lock hierarchy (analysis/hierarchy.py
        # — same rule as _ensure_leaves: never integrity -> feed)
        leaves = self._ensure_leaves(feed, length)
        ctx = build_proof_ctx(leaves, length)
        with self._lock:
            self._proof_cache[length] = ctx
            while len(self._proof_cache) > 4:
                self._proof_cache.pop(next(iter(self._proof_cache)))
        return ctx

    # -- disk audit ---------------------------------------------------------

    def destroy(self) -> None:
        """Drop all records + cached state (doc destroy)."""
        with self._lock:
            self._store.destroy()
            self._records = []
            self._peaks = None
            self._leaves = []
            self._proof_cache = {}

    def audit(self, feed) -> bool:
        """Strict boolean audit: True only for AUDIT_OK (see
        audit_status — an unsigned tail is NOT ok, but callers that
        need to distinguish recoverable-unsigned from tampered must use
        audit_status; this keeps the historical contract that anything
        short of a fully verified chain fails)."""
        return self.audit_status(feed) == AUDIT_OK

    def audit_status(self, feed) -> str:
        """Re-hash the entire block log against EVERY stored record —
        the newest covers the signed prefix; intermediate ones are
        load-bearing for chunked replication serving, so a corrupted
        record anywhere in the chain fails the audit (pinned by the
        tamper fuzz). Reads the feed and recomputes independently of
        the cached state — and takes no integrity lock while reading
        the feed, so a concurrent writer (feed lock -> integrity lock)
        cannot deadlock against it.

        Returns one of:
        - AUDIT_OK: every block is covered by a verified record chain.
        - AUDIT_UNSIGNED_TAIL: the signed prefix verifies, but a
          WRITABLE feed holds blocks beyond its last record — the
          shape lazy signing leaves after a crash between an append
          and the periodic record (sign_interval). Distinct from
          tampering: the tail is locally authored and recoverable —
          `Feed.seal()` signs a fresh head record and the next audit
          is clean. (Feed.close() seals tails appended in-process; a
          crash skips that, hence this status on reopen.)
        - AUDIT_TAMPERED: blocks or records fail verification, records
          claim blocks the log no longer holds, or a READ-ONLY feed
          carries uncovered blocks (a foreign tail must never audit as
          recoverable — we cannot distinguish it from an attacker's
          append, and must not sign it into validity)."""
        recs = self.records()
        n_blocks = feed.length
        if not recs:
            if n_blocks == 0:
                return AUDIT_OK
            # blocks but no chain at all: an interrupted writable feed
            # that never reached its first sign_interval, or a foreign/
            # unverifiable log
            return (
                AUDIT_UNSIGNED_TAIL if feed.writable else AUDIT_TAMPERED
            )
        last_len = recs[-1][0]
        if last_len > n_blocks:
            return AUDIT_TAMPERED  # records claim blocks the log lost
        wanted = {length for length, _r, _s in recs}
        blocks = feed.get_batch(0, last_len)
        peaks = Peaks()
        roots = {}
        for b in blocks:
            peaks.append(crypto.leaf_hash(b))
            if peaks.length in wanted:
                roots[peaks.length] = peaks.root()
        pub = keymod.decode(self.public_key)
        for length, root, sig in recs:
            if roots.get(length) != root:
                return AUDIT_TAMPERED
            if not crypto.verify(signable(length, root), sig, pub):
                return AUDIT_TAMPERED
        if last_len < n_blocks:
            # signed prefix intact, tail uncovered: crash-orphaned
            # unsigned tail on a writable feed (recoverable via seal);
            # on a read-only feed, indistinguishable from a foreign
            # append — fail hard
            if feed.writable:
                log(
                    "repo:integrity",
                    f"feed {self.public_key[:6]}: unsigned tail beyond "
                    f"last record ({n_blocks - last_len} block(s) past "
                    f"{last_len}) — seal() re-signs the head",
                )
                return AUDIT_UNSIGNED_TAIL
            return AUDIT_TAMPERED
        return AUDIT_OK


def _peak_sizes(length: int) -> List[int]:
    """Subtree sizes of the promote-odd forest at `length`: the set
    bits of length, largest first (binary-counter peaks). Peak j covers
    leaves [sum(sizes[:j]), sum(sizes[:j+1]))."""
    sizes = []
    bit = 1 << (length.bit_length() - 1) if length else 0
    while bit:
        if length & bit:
            sizes.append(bit)
        bit >>= 1
    return sizes


def _peak_levels(leaves: List[bytes]) -> List[List[bytes]]:
    """All levels of one perfect subtree, bottom-up (levels[-1][0] is
    its root)."""
    levels = [list(leaves)]
    while len(levels[-1]) > 1:
        lvl = levels[-1]
        levels.append(
            [_parent(lvl[i], lvl[i + 1]) for i in range(0, len(lvl), 2)]
        )
    return levels


def build_proof_ctx(leaves: List[bytes], length: int):
    """(sizes, offs, levels, roots): every interior level of the
    promote-odd forest at `length` — the one O(length) hashing pass the
    proof server needs; serving any range afterwards is pure lookup.
    Cached per length on FeedIntegrity (append-only logs never mutate
    the tree at a given length)."""
    sizes = _peak_sizes(length)
    offs: List[int] = []
    levels: List[List[List[bytes]]] = []
    roots: List[bytes] = []
    o = 0
    for s in sizes:
        lv = _peak_levels(leaves[o : o + s])
        offs.append(o)
        levels.append(lv)
        roots.append(lv[-1][0])
        o += s
    return sizes, offs, levels, roots


def proofs_from_ctx(ctx, start: int, end: int) -> List[List[bytes]]:
    """Proofs for leaves [start, end) from a built forest context:
    O((end - start) x log(length)) hash lookups, zero hashing."""
    sizes, offs, levels, roots = ctx
    out: List[List[bytes]] = []
    for index in range(start, end):
        j = 0
        while index >= offs[j] + sizes[j]:
            j += 1
        proof: List[bytes] = []
        p = index - offs[j]
        for lvl in levels[j][:-1]:
            proof.append(lvl[p ^ 1])
            p >>= 1
        proof.extend(roots[q] for q in range(len(sizes)) if q != j)
        out.append(proof)
    return out


def range_inclusion_proofs(
    leaves: List[bytes], start: int, end: int, length: int
) -> List[List[bytes]]:
    """Merkle inclusion proofs for leaves [start, end) against the
    promote-odd root at `length` (hypercore's sparse-download
    verification model: a peer verifies blocks against a signed root
    without holding the prefix). Each proof = the sibling path inside
    the leaf's peak subtree (bottom-up), then every OTHER peak root in
    forest order — positions derive client-side from (index, length),
    so a proof is just hashes, ≤ 2·log2(length) of them."""
    return proofs_from_ctx(build_proof_ctx(leaves, length), start, end)


def inclusion_proof(
    leaves: List[bytes], index: int, length: int
) -> List[bytes]:
    """Single-leaf convenience over range_inclusion_proofs."""
    return range_inclusion_proofs(leaves, index, index + 1, length)[0]


def verify_inclusion(
    public_key: str,
    leaf: bytes,
    index: int,
    length: int,
    proof: List[bytes],
    root_sig: bytes,
) -> bool:
    """Check a single leaf hash against a SIGNED promote-odd root at
    `length` using an inclusion_proof. The signature binds (length,
    root) to the feed key, so a verified sparse block is as trusted as
    a contiguously replicated one."""
    sizes = _peak_sizes(length)
    off = 0
    for peak_idx, size in enumerate(sizes):
        if index < off + size:
            break
        off += size
    else:
        return False
    k = size.bit_length() - 1  # path length inside the peak
    if len(proof) != k + len(sizes) - 1:
        return False
    acc = leaf
    p = index - off
    for lvl in range(k):
        sib = proof[lvl]
        acc = _parent(acc, sib) if p % 2 == 0 else _parent(sib, acc)
        p >>= 1
    peaks = []
    others = iter(proof[k:])
    for j in range(len(sizes)):
        peaks.append(acc if j == peak_idx else next(others))
    root = peaks[-1]
    for h in reversed(peaks[:-1]):
        root = _parent(h, root)
    return crypto.verify(
        signable(length, root), root_sig, keymod.decode(public_key)
    )


def sign_chain(blocks: List[bytes], seed: bytes) -> bytes:
    """The packed .sig-file content a writer produces appending `blocks`
    in order — one (length, root, sig) record per append. Single source
    of truth for the record chain; the corpus writer and tests use this
    so their on-disk state is byte-compatible with sign_append's."""
    peaks = Peaks()
    out: List[bytes] = []
    for b in blocks:
        peaks.append(crypto.leaf_hash(b))
        root = peaks.root()
        out.append(
            _REC.pack(
                peaks.length,
                root,
                crypto.sign(signable(peaks.length, root), seed),
            )
        )
    return b"".join(out)


def allow_unsigned() -> bool:
    return os.environ.get("HM_ALLOW_UNSIGNED_FEEDS") == "1"


def capability(
    public_key: str,
    challenge: bytes,
    binding: bytes = b"",
    prover_is_client: Optional[bool] = None,
) -> str:
    """Proof of feed-key knowledge for the replication protocol
    (hypercore-protocol's capability verification, reference
    src/types/hypercore-protocol.d.ts:62-106): a keyed hash only a
    holder of the feed PUBLIC key can compute — discovery ids alone
    (which peers learn from announcements) must not unlock block data.

    The MAC input binds three things (hypercore-protocol binds its
    capabilities to the noise session the same way):
    - the VERIFIER's per-connection random `challenge`;
    - the transport session's channel `binding` (net/secure.py
      exporter over the ephemeral handshake transcript), so a proof
      obtained on one connection cannot be replayed on another even by
      a peer that controls the challenge it hands out;
    - the PROVER's transport role (client/server), so a proof we send
      on a connection cannot be mirrored straight back to us on that
      same connection by a peer that chose its challenge equal to ours.
    """
    import hashlib

    role = b""
    if prover_is_client is not None:
        role = b"C" if prover_is_client else b"S"
    return keymod.encode(
        hashlib.blake2b(
            b"hm-cap:" + challenge + b"|" + binding + b"|" + role,
            key=keymod.decode(public_key),
            digest_size=32,
        ).digest()
    )
