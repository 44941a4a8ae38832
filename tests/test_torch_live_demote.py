"""Every case of tests/test_live_demote.py under its own name on the
port's live engine (hypermerge_tpu_torch/backend/live.py:
HM_LIVE_MAX_BYTES and `demote_idle`), repos on `Repo(path,
device="cpu")` (the live tick runs the plain version of doc_kernel.cu's
tick), peers on the port's Site (tests/port_helpers.py). Each outcome is
also held against the reference package: the demote twin's HM_LIVE=0
outcome against the reference's workload on the same seeded directory,
and the other cases' final docs against the reference Repo reading a
copy of the port's directory; tolerance 0.

`test_adoption_hammer_stress` keeps the reference's `slow` mark.

The twinned file's own docstring follows.

Byte-bounded LRU demotion (backend/live.py, HM_LIVE_MAX_BYTES).

Adopted docs' LiveColumns are no longer pinned until close: idle docs
demote back to the lazy path (serving clock synced, columns dropped)
and re-adopt from the sidecars on their next live change. Pinned here:

- twin fuzz: a feed-backed multi-actor workload with FORCED
  demote/re-adopt cycles between deliveries produces bit-identical
  clocks, snapshots, local patch echoes, and frontend state across
  HM_LIVE=1/0, in both delivery orders;
- the byte cap holds: resident live bytes stay under HM_LIVE_MAX_BYTES
  (beyond the one-doc MRU floor) while demoted docs keep serving
  correct values and re-adopt on the next edit;
- a frontend reopened on a DEMOTED doc receives the current state (the
  demoted snapshot closure), not the stale bulk-load decode;
- docs whose admitted changes have no backing feed are never demoted
  (demotion would silently lose them).
"""

import json
import os
import random
import shutil
import tempfile

import pytest

from hypermerge_tpu_torch.utils import keys as keymod
from hypermerge_tpu_torch.utils.ids import validate_doc_url
from port_helpers import (
    REF_SWITCHES,
    Repo,
    Site,
    assert_reference_reads,
    env_vars,
    plainify,
    random_mutation,
    sync,
    wait_until,
)


@pytest.fixture
def live_env(monkeypatch):
    monkeypatch.setenv("HM_LIVE", "1")


def _seed(base):
    repo = Repo(path=base)
    url = repo.create({"edits": [], "k": 0})
    for i in range(5):
        repo.change(url, lambda d, i=i: d["edits"].append(i))
    doc_id = validate_doc_url(url)
    pairs = [keymod.create() for _ in range(2)]
    meta = {
        "url": url,
        "doc_id": doc_id,
        "pairs": [[p.public_key, p.secret_key] for p in pairs],
    }
    with open(os.path.join(base, "_meta"), "w") as fh:
        json.dump(meta, fh)
    repo.close()
    return meta


def _stored_changes(repo, doc_id):
    out = []
    for actor_id, end in repo.back.docs[doc_id].clock.items():
        actor = repo.back._get_or_create_actor(actor_id)
        out.extend(actor.changes_in_window(0, end))
    return out


def _gen_script(stored, pair_ids, seed, n_rounds=8):
    """Deterministic multi-peer batches extending `stored`; peers are
    keyed by REAL feed keypairs so deliveries can be feed-backed."""
    r = random.Random(seed)
    peers = [Site(a) for a in pair_ids]
    for p in peers:
        p.receive(stored)
    script = []
    for rnd in range(n_rounds):
        idx = r.randrange(2)
        site = peers[idx]
        batch = []
        for _ in range(r.randint(1, 3)):
            before = len(site.opset.history)
            random_mutation(site, r)
            batch.extend(site.opset.history[before:])
        if batch:
            script.append((idx, batch))
        if rnd % 3 == 2:
            sync(*peers)
    return script


def _run_demote_workload(base, live, order_flip, seed=23):
    """Replay the same feed-backed remote script + local edits under
    HM_LIVE=`live`, forcing a demote of every idle doc between
    deliveries (live mode). Returns the normalized observable
    outcome."""
    os.environ["HM_LIVE"] = live
    work = tempfile.mkdtemp()
    shutil.rmtree(work)
    shutil.copytree(base, work)
    try:
        repo = Repo(path=work)
        with open(os.path.join(base, "_meta")) as fh:
            meta = json.load(fh)
        url, doc_id = meta["url"], meta["doc_id"]
        local_patches = []
        orig_push = repo.back.to_frontend.push

        def record(msg):
            if msg.get("type") == "Patch" and msg["patch"].get("actor"):
                local_patches.append(msg["patch"])
            orig_push(msg)

        repo.back.to_frontend.push = record
        h = repo.open(url)
        assert h.value(timeout=20) is not None
        back = repo.back
        doc = back.docs[doc_id]
        stored = _stored_changes(repo, doc_id)
        pair_ids = [pk for pk, _sk in meta["pairs"]]
        script = _gen_script(stored, pair_ids, seed)
        if order_flip:
            script = [b for b in script if b[0] == 1] + [
                b for b in script if b[0] == 0
            ]
        # peer feeds are REAL writable feeds in this repo: deliveries
        # go through the feeds + _sync_changes, so a demoted doc can
        # always rebuild from the sidecars
        actors = [
            back._init_actor(keymod.KeyPair(pk, sk))
            for pk, sk in meta["pairs"]
        ]
        for a in actors:
            back.cursors.add_actor(back.id, doc_id, a.id)
        from hypermerge_tpu_torch.crdt.opset import OpSet

        oracle = OpSet()
        oracle.apply_changes(stored)
        peer_actors = set()
        for k, (idx, batch) in enumerate(script):
            oracle.apply_changes(list(batch))
            peer_actors.update(c.actor for c in batch)
            for ch in batch:
                actors[idx].write_change(ch)
            back.cursors.update(
                back.id, doc_id, {actors[idx].id: batch[-1].seq}
            )
            back._sync_changes(actors[idx])
            wait_until(
                lambda: all(
                    doc.clock.get(a, 0) == oracle.clock.get(a, 0)
                    for a in peer_actors
                )
            )
            repo.change(url, lambda d, k=k: d.__setitem__(f"k{k}", k))
            if back.live is not None:
                back.live.flush_now()
                back.live.demote_idle(0)  # force the lifecycle
        # final demote -> one more local edit -> re-adopt
        if back.live is not None:
            back.live.flush_now()
            back.live.demote_idle(0)
        repo.change(url, lambda d: d.__setitem__("fin", 1))
        if back.live is not None:
            back.live.flush_now()
            stats = dict(back.live.stats)
            assert stats["demoted"] > 0, stats
            assert stats["readopted"] > 0, stats
        outcome = {
            "snap": doc.snapshot_patch().to_json(),
            "clock": dict(doc.clock),
            "hist": doc.history_len,
            "state": plainify(h.value()),
            "local_patches": local_patches,
        }
        actor_id = doc.actor_id
        repo.close()

        def scrub(v):
            if isinstance(v, str):
                return v.replace(actor_id, "<LOCAL-ACTOR>")
            if isinstance(v, dict):
                return {scrub(k): scrub(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [scrub(x) for x in v]
            return v

        return json.dumps(scrub(outcome), sort_keys=True, default=str)
    finally:
        shutil.rmtree(work, ignore_errors=True)


@pytest.mark.parametrize("order_flip", [False, True], ids=["fwd", "rev"])
def test_demote_readopt_twin_bit_identical(tmp_path, order_flip):
    """HM_LIVE=1 with forced demote/re-adopt cycles stays bit-identical
    to the HM_LIVE=0 host path, in both delivery orders."""
    base = str(tmp_path / "seed")
    os.makedirs(base)
    old = os.environ.get("HM_LIVE")
    try:
        os.environ["HM_LIVE"] = "0"
        _seed(base)
        host = _run_demote_workload(base, "0", order_flip)
        live = _run_demote_workload(base, "1", order_flip)
        # the reference's workload on the same seeded directory (its own
        # Site makes the same peer script from the same stored history)
        from test_live_demote import _run_demote_workload as ref_workload

        with env_vars(**{k: v for k, v in REF_SWITCHES.items()
                         if k != "HM_LIVE"}):
            ref = ref_workload(base, "0", order_flip)
    finally:
        if old is None:
            os.environ.pop("HM_LIVE", None)
        else:
            os.environ["HM_LIVE"] = old
    assert live == host
    assert host == ref


def test_byte_cap_bounds_resident_columns(tmp_path, live_env, monkeypatch):
    """With HM_LIVE_MAX_BYTES set, resident live bytes stay under the
    cap (MRU floor aside), demoted docs re-adopt on their next edit,
    and every doc still serves correct values."""
    repo = Repo(path=str(tmp_path))
    urls = [repo.create({"i": i, "edits": []}) for i in range(6)]
    ids = [validate_doc_url(u) for u in urls]
    for u in urls:
        for k in range(20):
            repo.change(u, lambda d, k=k: d["edits"].append(k))
    repo.close()

    monkeypatch.setenv("HM_LIVE_MAX_BYTES", "40000")  # ~2 docs
    repo2 = Repo(path=str(tmp_path))
    repo2.back.load_documents_bulk(ids)
    eng = repo2.back.live
    r = random.Random(5)
    for step in range(30):
        u = urls[r.randrange(len(urls))]
        repo2.change(u, lambda d, step=step: d.__setitem__("s", step))
        if step % 5 == 4:
            eng.flush_now()
            assert eng.stats["live_bytes"] <= 40000, eng.stats
    eng.flush_now()
    assert eng.stats["demoted"] > 0, eng.stats
    assert eng.stats["readopted"] > 0, eng.stats
    assert eng.stats["live_bytes"] <= 40000, eng.stats
    for i, u in enumerate(urls):
        v = repo2.doc(u)
        assert v["i"] == i and len(v["edits"]) == 20, (i, v)
    # no doc regressed to the host path
    for did in ids:
        assert repo2.back.docs[did].opset is None, did
    final = [plainify(repo2.doc(u)) for u in urls]
    repo2.close()
    assert_reference_reads(tmp_path, urls, final)


def test_reopen_on_demoted_doc_serves_current_state(
    tmp_path, live_env
):
    """A second frontend handle opened while the doc is DEMOTED gets
    the CURRENT state via the demoted snapshot closure — not the stale
    bulk-load decode the doc was first opened with."""
    repo = Repo(path=str(tmp_path))
    url = repo.create({"v": 0})
    for k in range(6):
        repo.change(url, lambda d, k=k: d.__setitem__("v", k))
    doc_id = validate_doc_url(url)
    repo.close()

    repo2 = Repo(path=str(tmp_path))
    h1 = repo2.open(url)
    assert h1.value(timeout=20) is not None
    repo2.change(url, lambda d: d.__setitem__("fresh", True))
    eng = repo2.back.live
    eng.flush_now()
    assert eng.demote_idle(0) == 1, eng.stats
    doc = repo2.back.docs[doc_id]
    assert doc.opset is None and not doc._live_adopted
    h2 = repo2.open(url)
    wait_until(lambda: (h2.value(timeout=5) or {}).get("fresh"))
    # the doc is STILL lazy afterwards (reads must not force a replay)
    assert doc.opset is None
    final = plainify(h2.value())
    repo2.close()
    assert_reference_reads(tmp_path, [url], [final])


@pytest.mark.slow
def test_adoption_hammer_stress(tmp_path, live_env, monkeypatch):
    """Stress: adoptions hammered from worker threads while other hot
    docs tick, under a byte cap. Asserts (a) the engine lock is never
    held for an adoption-sized window (lock-held install time stays a
    tiny fraction of the lock-free build time), (b) resident bytes
    respect the cap at every flush, (c) every doc converges to the
    right state with no host-path fallbacks."""
    import threading as _th

    from hypermerge_tpu_torch.ops.corpus import make_corpus

    n_docs, n_ops = 12, 2048
    urls = make_corpus(str(tmp_path), n_docs, n_ops, threads=8)
    ids = [validate_doc_url(u) for u in urls]
    # ~3 docs of resident footprint (a 2048-op doc's columns + opid
    # index + decoded-state estimate is ~700KB): the cap clears the
    # one-doc MRU floor but binds well below 12 resident docs
    cap = 2_200_000
    monkeypatch.setenv("HM_LIVE_MAX_BYTES", str(cap))
    repo = Repo(path=str(tmp_path))
    handles = repo.open_many(urls)
    for h in handles:
        assert h.value(timeout=60) is not None
    eng = repo.back.live

    errors = []
    n_workers = 4
    rounds = 6

    def worker(w):
        try:
            r = random.Random(w)
            for step in range(rounds):
                u = urls[(w + step * n_workers) % n_docs]
                repo.change(
                    u,
                    lambda d, w=w, step=step: d.__setitem__(
                        f"w{w}", step
                    ),
                )
                if r.random() < 0.3:
                    eng.flush_now()
        except Exception as e:  # pragma: no cover - surfaced below
            errors.append(e)

    threads = [
        _th.Thread(target=worker, args=(w,)) for w in range(n_workers)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive(), "stress worker wedged"
    assert not errors, errors
    eng.flush_now()
    stats = eng.stats
    assert stats["live_bytes"] <= cap, stats
    assert stats["adopted"] >= n_docs, stats
    assert stats["refused"] == 0, stats
    assert stats["demoted"] > 0, stats
    # the lock-held install window must be a sliver of the build work:
    # a regression that rebuilds under the engine lock flips this ratio
    assert (
        stats["t_adopt_lock_held"]
        < 0.2 * stats["t_adopt_lock_free"] + 0.01
    ), stats
    for w in range(n_workers):
        for step in range(rounds):
            u = urls[(w + step * n_workers) % n_docs]
            wait_until(
                lambda u=u, w=w: repo.doc(u).get(f"w{w}") is not None
            )
    for did in ids:
        assert repo.back.docs[did].opset is None, did
    final = [plainify(repo.doc(u)) for u in urls]
    repo.close()
    assert_reference_reads(tmp_path, urls, final)


def _seed_dir(tmp, n_changes=6, seed=7):
    """tests/test_live.py's stored single-writer doc on disk + its
    history snapshot, written by the port."""
    from hypermerge_tpu_torch.models import Text

    repo = Repo(path=tmp)
    url = repo.create({"edits": [], "t": Text("hi")})
    r = random.Random(seed)
    for _ in range(n_changes):
        repo.change(url, lambda d: d["edits"].append(r.randint(0, 99)))
    repo.change(url, lambda d: d["t"].insert(2, "!"))
    doc_id = validate_doc_url(url)
    stored = list(repo.back.docs[doc_id].opset.history)
    repo.close()
    return url, doc_id, stored


def test_unbacked_changes_pin_doc_resident(tmp_path, live_env):
    """Changes injected straight into the engine (no backing feed —
    synthetic peers) make a doc non-demotable: demoting would lose
    them on re-adoption."""
    with env_vars(HM_LIVE="0"):
        url, doc_id, stored = _seed_dir(str(tmp_path))
    repo = Repo(path=str(tmp_path))
    repo.back.load_documents_bulk([doc_id])
    doc = repo.back.docs[doc_id]
    peer = Site("pinpeer000000001")
    peer.receive(stored)
    ch, _ = peer.change(lambda d: d.__setitem__("ghost", 1))
    doc.apply_remote_changes([ch])  # NOT in any feed
    eng = repo.back.live
    eng.flush_now()
    wait_until(lambda: repo.doc(url).get("ghost") == 1)
    assert eng.demote_idle(0) == 0, "unbacked doc must stay resident"
    assert eng.stats["demoted"] == 0
    assert repo.doc(url)["ghost"] == 1
    # the reference's OpSet on the stored history and the ghost change
    from port_helpers import ref_opset, ref_plain

    assert plainify(repo.doc(url)) == ref_plain(
        ref_opset(stored + [ch]).materialize())
    repo.close()
