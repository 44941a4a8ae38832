"""Every case of tests/test_destroy.py under its own name on the port
(hypermerge_tpu_torch), repos on the CPU.

The twinned file's own docstring follows.

destroy() reclaims disk: feed blocks, sidecars, and signature records
of doc-exclusive actors are deleted; shared actors survive (VERDICT r3
missing #7 / next-round item 9)."""

import os

from hypermerge_tpu_torch.repo import Repo as _PortRepo
from hypermerge_tpu_torch.utils.ids import validate_doc_url

from test_torch_advice_fixes import plainify


def Repo(*args, **kw):
    """The port's Repo on the CPU (tests run where no card is present)."""
    kw.setdefault("device", "cpu")
    return _PortRepo(*args, **kw)


def _feed_files(path, actor_id):
    d = os.path.join(path, "feeds", actor_id[:2])
    out = []
    if os.path.isdir(d):
        for name in os.listdir(d):
            if name.startswith(actor_id):
                out.append(os.path.join(d, name))
    return out


def test_destroy_deletes_disk_state(tmp_path):
    path = str(tmp_path)
    repo = Repo(path=path)
    url = repo.create({"x": 1})
    repo.change(url, lambda d: d.__setitem__("y", 2))
    keep_url = repo.create({"keep": True})
    doc_id = validate_doc_url(url)
    keep_id = validate_doc_url(keep_url)
    assert _feed_files(path, doc_id)  # block log + .cols + .sig on disk

    repo.destroy(url)
    assert _feed_files(path, doc_id) == [], "feed files not reclaimed"
    # store rows gone
    assert repo.back.clocks.get(repo.back.id, doc_id) == {}
    assert repo.back.cursors.get(repo.back.id, doc_id) == {}
    assert (
        repo.back.db.query(
            "SELECT * FROM feeds WHERE public_id=?", (doc_id,)
        )
        == []
    )
    # unrelated doc untouched
    assert _feed_files(path, keep_id)
    assert plainify(repo.doc(keep_url))["keep"] is True
    repo.close()

    # a fresh process sees an empty, never-seen doc (pending until some
    # peer replicates it back in) — not stale content
    repo2 = Repo(path=path)
    h = repo2.open(url)
    doc = repo2.back.docs[doc_id]
    assert not doc._announced
    assert repo2.back.feeds.open_feed(doc_id).length == 0
    assert plainify(repo2.doc(keep_url))["keep"] is True
    repo2.close()


def test_destroy_without_opening_reclaims_disk(tmp_path):
    """destroy() in a FRESH process (doc never opened this session) must
    still delete the prior session's feed files — FeedStore.remove can't
    rely on the in-memory map."""
    path = str(tmp_path)
    repo = Repo(path=path)
    url = repo.create({"x": 1})
    doc_id = validate_doc_url(url)
    repo.close()

    repo2 = Repo(path=path)
    assert _feed_files(path, doc_id)
    repo2.destroy(url)
    assert _feed_files(path, doc_id) == [], "unopened feed not reclaimed"
    repo2.close()


def test_destroy_keeps_shared_actor_feeds(tmp_path):
    """An actor included in two docs (merge) survives destroying one."""
    path = str(tmp_path)
    repo = Repo(path=path)
    a = repo.create({"a_key": 1})
    b = repo.create({"b_key": 2})
    repo.merge(b, a)  # b's cursor now includes a's root actor
    a_id = validate_doc_url(a)
    repo.destroy(a)
    # a's root actor is still in b's cursor -> feed stays
    assert _feed_files(path, a_id), "shared feed wrongly deleted"
    merged = plainify(repo.doc(b))
    assert merged["b_key"] == 2 and merged["a_key"] == 1
    repo.close()
