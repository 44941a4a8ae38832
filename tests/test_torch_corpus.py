"""The port's corpus writer (hypermerge_tpu_torch/ops/corpus.py), on the
CPU: the cases of tests/test_corpus.py under their names. Directly
written disk state must be exactly what the product would persist, and
must open through the product's fast (no-replay) paths: each doc equals
the host OpSet replay of its template history, re-actored to the doc.
Repos run on the CPU (`device="cpu"`). Tolerance: exact.
"""

import json
import time

from hypermerge_tpu_torch.crdt.change import Change
from hypermerge_tpu_torch.crdt.opset import OpSet
from hypermerge_tpu_torch.ops.corpus import make_corpus
from hypermerge_tpu_torch.ops.synth import synth_changes
from hypermerge_tpu_torch.repo import Repo as _PortRepo
from hypermerge_tpu_torch.utils.ids import validate_doc_url
from hypermerge_tpu_torch.utils.json_buffer import bufferify

from test_torch_advice_fixes import plainify


def Repo(**kwargs):
    return _PortRepo(device="cpu", **kwargs)


def _ground_truth(doc_id: str, n_ops: int, opc: int, seed: int):
    """Host OpSet replay of the template history re-actored to doc_id."""
    tpl = synth_changes(n_ops, n_actors=1, ops_per_change=opc, seed=seed)
    changes = [
        Change.from_json(
            json.loads(
                bufferify(c.to_json())
                .decode("utf-8")
                .replace("actor00", doc_id)
            )
        )
        for c in tpl
    ]
    ops = OpSet()
    ops.apply_changes(changes)
    return plainify(ops.materialize())


def test_corpus_opens_to_replayed_state(tmp_path):
    urls = make_corpus(
        str(tmp_path), 3, 48, ops_per_change=8, distinct=2, seed=5
    )
    repo = Repo(path=str(tmp_path))
    try:
        for i, url in enumerate(urls):
            doc_id = validate_doc_url(url)
            want = _ground_truth(doc_id, 48, 8, 5 + (i % 2))
            assert plainify(repo.doc(url)) == want
            # sidecar-backed open: no host OpSet replay happened
            assert repo.back.docs[doc_id].opset is None
    finally:
        repo.close()


def test_corpus_doc_replicates_to_second_repo(tmp_path):
    """End-to-end: a corpus doc (signed feeds on disk) replicates from a
    disk repo to a fresh peer over encrypted TCP with capability checks
    and chunked verified backfill — the whole trust stack at once."""
    from hypermerge_tpu_torch.net.tcp import TcpSwarm

    src_dir = str(tmp_path / "src")
    urls = make_corpus(src_dir, 2, 48, ops_per_change=8, distinct=1, seed=3)
    ra = Repo(path=src_dir)
    ra.open_many(urls)  # feeds registered + announced
    rb = Repo(path=str(tmp_path / "dst"))
    sa, sb = TcpSwarm(), TcpSwarm()
    try:
        ra.set_swarm(sa)
        rb.set_swarm(sb)
        sb.connect(sa.address)

        url = urls[0]
        doc_id = validate_doc_url(url)
        h = rb.open(url)
        deadline = time.time() + 60
        while time.time() < deadline:
            doc = rb.back.docs.get(doc_id)
            if doc is not None and doc._announced:
                break
            time.sleep(0.05)
        want = _ground_truth(doc_id, 48, 8, 3)
        assert plainify(h.value()) == want
        # the replica can audit what it stored
        assert rb.back.feeds.open_feed(doc_id).audit()
    finally:
        ra.close()
        rb.close()
        sa.destroy()
        sb.destroy()


def test_corpus_bulk_open_and_block_log_agree(tmp_path):
    urls = make_corpus(
        str(tmp_path), 4, 32, ops_per_change=8, distinct=2, seed=9
    )
    repo = Repo(path=str(tmp_path))
    try:
        handles = repo.open_many(urls)
        for i, (url, h) in enumerate(zip(urls, handles)):
            doc_id = validate_doc_url(url)
            want = _ground_truth(doc_id, 32, 8, 9 + (i % 2))
            assert plainify(h.value()) == want
            # the block log (not just the sidecar) holds the same
            # changes: force a host replay from decoded blocks
            actor = repo.back.actors[doc_id]
            changes = actor.changes_in_window(0, float("inf"))
            ops = OpSet()
            ops.apply_changes(changes)
            assert plainify(ops.materialize()) == want
        # an incremental change on a corpus doc still works end-to-end
        handles[0].change(lambda d: d.__setitem__("added", 1))
        assert plainify(handles[0].value())["added"] == 1
    finally:
        repo.close()
