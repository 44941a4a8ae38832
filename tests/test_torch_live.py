"""The port's live apply engine (hypermerge_tpu_torch/backend/live.py) and
its tick program against the JAX package's, on the CPU.

- The tick program: `materialize_live_device` of the port (its plain
  version, CPU tensors) against the reference's (jitted, CPU jax) on the
  padded batch `_kernel_device` builds (`live.tick_batch`), from the
  LiveColumns of seeded multi-actor histories (maps, lists, text,
  counters with INC, deletes, nested objects; A and K at their bucket
  floors and above) adopted from a packed prefix and appended to, as the
  engine does, carried across with `convert.live_columns_from_reference`.
  (D, N) in {(1, 64), (3, 256), (8, 1024)}; every lane exact, the clock
  all zeros.
- LiveColumns: after `from_batch` + `append_changes` of the same stream,
  the port's columns, pred edges, interner items, opids and `slots()`
  equal the reference's; appending decodes to the same state as packing
  the whole history, and both equal the port OpSet's snapshot.
- The fuzz twin of tests/test_live.py: one seeded remote script with
  interleaved local edits, on copies of one reference-written directory,
  through the reference with HM_LIVE=1 and the port with HM_LIVE=1, with
  HM_LIVE=0, and with every kernel group on the device route
  (HM_DEVICE_MIN_CELLS=0, HM_LIVE_INC_BUDGET=0: the plain version through
  `_kernel_device`), in both delivery orders: one normalized outcome
  (snapshot patch, clock, history length, frontend state, every local
  patch echo). The engine applies a tick of at most 8 ops incrementally
  whatever the budget, so the script runs as tests/test_live.py has it
  and again with more than 8 ops in every delivery.
- The demote / re-adopt twin of tests/test_live_demote.py, the same way.
- No lazy-loader call on the first live edit (local and remote).

The reference runs with HM_PIPELINE=0 HM_WAL=0 HM_SERVICE=0 (what the
port leaves out), the port with device="cpu". Tolerance: exact.
"""

import json
import os
import random
import shutil
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import Site, random_mutation, sync, wait_until
from hypermerge_tpu.crdt.opset import OpSet as RefOpSet
from hypermerge_tpu.models import Counter as RefCounter
from hypermerge_tpu.models import Text as RefText
from hypermerge_tpu.ops import columnar as ref_columnar
from hypermerge_tpu.ops import crdt_kernels as ref_ck
from hypermerge_tpu.repo import Repo as RefRepo
from hypermerge_tpu.utils import keys as ref_keys
from hypermerge_tpu.utils.ids import validate_doc_url
from hypermerge_tpu_torch import convert
from hypermerge_tpu_torch.backend import live
from hypermerge_tpu_torch.crdt.change import Action
from hypermerge_tpu_torch.crdt.opset import OpSet
from hypermerge_tpu_torch.ops import columnar
from hypermerge_tpu_torch.ops import crdt_kernels as ck
from hypermerge_tpu_torch.repo import Repo
from hypermerge_tpu_torch.utils import keys as keymod

# the reference's switches for what the port leaves out (live stays on)
OFF = {"HM_PIPELINE": "0", "HM_WAL": "0", "HM_SERVICE": "0"}
LANES = ("dead", "visible", "map_winner", "elem_winner", "elem_live",
         "rank", "inc_total")


def to_port(changes):
    return convert.changes_from_reference([c.to_json() for c in changes])


# ---------------------------------------------------------------------------
# the tick program


def _history(seed, n_sites, fill, wide):
    """A seeded multi-actor history (reference Changes in causal order)
    and where its live appends start: every op family of
    `random_mutation`, a counter set by one site and incremented by
    another, `wide` extra root keys, and a text run of `fill` chars."""
    r = random.Random(seed)
    sites = [Site(f"{chr(97 + i)}{seed:05d}live000001") for i in range(n_sites)]
    sites[0].change(lambda d: d.__setitem__("cnt", RefCounter(1)))
    sync(*sites)
    for step in range(12):
        random_mutation(sites[step % n_sites], r)
        if r.random() < 0.3:
            sync(*sites)
    sync(*sites)
    sites[-1].change(lambda d: d.increment("cnt", 5))
    if wide:
        sites[0].change(
            lambda d: [d.__setitem__(f"w{i}", i) for i in range(wide)]
        )
    sites[1 % n_sites].change(lambda d: d.__setitem__("run", RefText("")))
    sync(*sites)
    split = len(sites[0].opset.history)
    sites[1 % n_sites].change(lambda d: d["run"].insert(0, "xyz" * (fill // 3)))
    for step in range(6):
        random_mutation(sites[(step + 1) % n_sites], r)
    sync(*sites)
    sites[0].change(lambda d: d.increment("cnt", -2))
    return list(sites[0].opset.history), split


def _ref_live_columns(changes, split):
    """The reference's LiveColumns as the engine holds them: adopted from
    a packed prefix, the rest appended."""
    lv = ref_columnar.LiveColumns.from_batch(
        ref_columnar.pack_docs([changes[:split]]), 0
    )
    lv.append_changes(changes[split:])
    return lv


# (D docs, N rows, sites per doc, text fill, extra keys)
TICK_CASES = [(1, 64, 2, 12, 0), (3, 256, 5, 150, 20), (8, 1024, 3, 700, 24)]


@pytest.mark.parametrize("D,N,n_sites,fill,wide", TICK_CASES,
                         ids=[f"{c[0]}x{c[1]}" for c in TICK_CASES])
def test_tick_program_equals_reference(D, N, n_sites, fill, wide):
    ref_lvs, lvs = [], []
    for d in range(D):
        changes, split = _history(100 * N + d, n_sites, fill, wide)
        ref_lv = _ref_live_columns(changes, split)
        ref_lvs.append(ref_lv)
        lvs.append(convert.live_columns_from_reference(ref_lv))
    bucket = ck.live_bucket(max(lv.n for lv in lvs), ck.LIVE_MIN_ROWS)
    assert bucket == N
    planes, A, K = live.tick_batch(lvs, bucket)
    ref_planes, ref_A, ref_K = live.tick_batch(ref_lvs, bucket)
    assert (A, K) == (ref_A, ref_K)
    for a, b in zip(planes, ref_planes):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    flags = planes[0]
    assert flags.shape == (ck.live_bucket(D, ck.LIVE_MIN_DOCS), N)
    assert np.any((flags & 7) == int(Action.INC)), "no INC op in the batch"
    if wide:
        assert K > 16 and (n_sites < 5 or A > 4)

    launches = dict(ck.launches)
    got = ck.materialize_live_device(
        *(torch.from_numpy(a) for a in planes), A=A, K=K
    )
    assert ck.launches == launches  # CPU tensors: the plain version
    want = ref_ck.materialize_live_device(
        *(jnp.asarray(a) for a in planes), A=A, K=K
    )
    for name in LANES:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    assert got.clock.shape == (flags.shape[0], A)
    assert not got.clock.any()
    assert not np.asarray(want.clock).any()


def test_live_bucket_equals_reference():
    for n in (0, 1, 3, 4, 63, 64, 65, 1000, 262144, 259778 + 256):
        for floor in (1, 4, 16, 64):
            assert ck.live_bucket(n, floor) == ref_ck.live_bucket(n, floor)
    assert (ck.LIVE_MIN_ROWS, ck.LIVE_MIN_DOCS) == (
        ref_ck.LIVE_MIN_ROWS, ref_ck.LIVE_MIN_DOCS)


# ---------------------------------------------------------------------------
# LiveColumns


def _state_diffs(lv):
    state = live._decode_state(lv, live.LiveApplyEngine._host_lanes(lv))
    return [d.to_json() for d in live._diff_states(live._DocState(), state)]


@pytest.mark.parametrize("seed", range(4))
def test_live_columns_equal_reference(seed):
    """Adopted from the same packed prefix and appended the same stream,
    the port's LiveColumns hold the reference's rows, tables and slots;
    appending decodes to the same state as packing the whole history,
    and both equal the OpSet snapshot."""
    changes, split = _history(seed * 991, 3, 30, 18 * (seed % 2))
    ref_lv = _ref_live_columns(changes, split)
    ported = to_port(changes)
    lv = columnar.LiveColumns.from_batch(
        columnar.pack_docs([ported[:split]]), 0
    )
    lv.append_changes(ported[split:])

    assert (lv.n, lv.n_preds) == (ref_lv.n, ref_lv.n_preds)
    for name in columnar.COLUMNS:
        np.testing.assert_array_equal(
            lv.cols[name][: lv.n], ref_lv.cols[name][: lv.n], err_msg=name
        )
    np.testing.assert_array_equal(
        lv.psrc[: lv.n_preds], ref_lv.psrc[: lv.n_preds])
    np.testing.assert_array_equal(
        lv.ptgt[: lv.n_preds], ref_lv.ptgt[: lv.n_preds])
    for name in ("actors", "keys", "strings", "floats", "bigints"):
        assert getattr(lv, name).items == getattr(ref_lv, name).items, name
    np.testing.assert_array_equal(lv.slots(), ref_lv.slots())
    assert [tuple(o) for o in lv.opids] == [tuple(o) for o in ref_lv.opids]
    assert {tuple(k): v for k, v in lv.row_of.items()} == {
        tuple(k): v for k, v in ref_lv.row_of.items()}
    assert lv.nbytes == ref_lv.nbytes
    rows = np.arange(lv.n)
    assert lv.decode_values(rows) == ref_lv.decode_values(rows)
    carried = convert.live_columns_from_reference(ref_lv)
    for name in columnar.COLUMNS:
        np.testing.assert_array_equal(carried.cols[name], ref_lv.cols[name])

    incremental = columnar.LiveColumns()
    incremental.append_changes(ported)
    adopted = columnar.LiveColumns.from_batch(columnar.pack_docs([ported]), 0)
    opset = OpSet()
    opset.apply_changes(ported)
    want = [d.to_json() for d in opset.snapshot_patch().diffs]
    assert _state_diffs(incremental) == want
    assert _state_diffs(adopted) == want
    assert _state_diffs(lv) == want
    ref_opset = RefOpSet()
    ref_opset.apply_changes(changes)
    assert want == [d.to_json() for d in ref_opset.snapshot_patch().diffs]


# ---------------------------------------------------------------------------
# the engine twins


@pytest.fixture
def env(monkeypatch):
    for k, v in OFF.items():
        monkeypatch.setenv(k, v)
    return monkeypatch


def plain(v):
    """A frontend value of either package as plain Python: the two
    packages' Text, Counter and Table are different classes."""
    name = type(v).__name__
    if name == "Text":
        return ["__text__", str(v)]
    if name == "Counter":
        return ["__counter__", int(v)]
    if name == "Table":
        return ["__table__", {k: plain(v.by_id(k)) for k in v.ids}]
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    return v


def _scrubbed(outcome, actor_id):
    """The outcome as sorted JSON with the writable actor (minted per
    reopen, not in the doc url) replaced by a placeholder."""

    def scrub(v):
        if isinstance(v, str):
            return v.replace(actor_id, "<LOCAL-ACTOR>")
        if isinstance(v, dict):
            return {scrub(k): scrub(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [scrub(x) for x in v]
        return v

    return json.dumps(scrub(outcome), sort_keys=True, default=str)


def _open_copy(base, port):
    work = tempfile.mkdtemp()
    shutil.rmtree(work)
    shutil.copytree(base, work)
    repo = Repo(path=work, device="cpu") if port else RefRepo(path=work)
    return work, repo


def _record_local_patches(repo):
    local_patches = []
    orig_push = repo.back.to_frontend.push

    def record(msg):
        if msg.get("type") == "Patch" and msg["patch"].get("actor"):
            local_patches.append(msg["patch"])
        orig_push(msg)

    repo.back.to_frontend.push = record
    return local_patches


def _seed_fuzz_dir(base):
    """tests/test_live.py's seeded single-writer doc, written by the
    reference; returns (url, doc id, stored history)."""
    repo = RefRepo(path=base)
    url = repo.create({"edits": [], "t": RefText("hi")})
    r = random.Random(7)
    for _ in range(6):
        repo.change(url, lambda d: d["edits"].append(r.randint(0, 99)))
    repo.change(url, lambda d: d["t"].insert(2, "!"))
    doc_id = validate_doc_url(url)
    stored = list(repo.back.docs[doc_id].opset.history)
    repo.close()
    return url, doc_id, stored


def _remote_script(stored, seed, order_flip, min_ops=0, n_rounds=10,
                   peer_ids=None):
    """tests/test_live.py's `_gen_remote_script` (two peers mutating
    concurrently, merging every third round; tests/test_live_demote.py's
    `_gen_script` with `peer_ids` and 8 rounds), the order flip, and the
    peer clocks an OpSet oracle reaches after each delivery. With
    `min_ops`, each batch takes more mutations until it carries more
    than that many ops."""
    r = random.Random(seed)
    peers = [Site(a) for a in (
        peer_ids or [f"peer{i:1d}0000000000001" for i in range(2)])]
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
        while sum(len(c.ops) for c in batch) <= min_ops:
            before = len(site.opset.history)
            random_mutation(site, r)
            batch.extend(site.opset.history[before:])
        if batch:
            script.append((idx, batch))
        if rnd % 3 == 2:
            sync(*peers)
    if order_flip:
        script = [b for b in script if b[0] == 1] + [
            b for b in script if b[0] == 0]
    oracle = RefOpSet()
    oracle.apply_changes(stored)
    peer_actors, clocks = set(), []
    for _idx, batch in script:
        oracle.apply_changes(list(batch))
        peer_actors.update(c.actor for c in batch)
        clocks.append({a: oracle.clock.get(a, 0) for a in peer_actors})
    return script, clocks


def _run_fuzz(base, url, doc_id, script, clocks, port):
    """Deliver the script with the interleaved local edits of
    tests/test_live.py; returns (normalized outcome, engine stats)."""
    work, repo = _open_copy(base, port)
    try:
        local_patches = _record_local_patches(repo)
        h = repo.open(url)
        assert h.value(timeout=20) is not None
        doc = repo.back.docs[doc_id]
        for k, ((_idx, batch), want) in enumerate(zip(script, clocks)):
            doc.apply_remote_changes(to_port(batch) if port else list(batch))
            wait_until(lambda: all(
                doc.clock.get(a, 0) == s for a, s in want.items()))
            repo.change(url, lambda d, k=k: d.__setitem__(f"k{k}", k))
            repo.change(url, lambda d, k=k: d["edits"].append(1000 + k))
        eng = repo.back.live
        if eng is not None:
            eng.flush_now()
        outcome = {
            "snap": doc.snapshot_patch().to_json(),
            "clock": dict(doc.clock),
            "hist": doc.history_len,
            "state": plain(h.value()),
            "local_patches": local_patches,
        }
        stats = None if eng is None else dict(eng.stats)
        actor_id = doc.actor_id
    finally:
        repo.close()
        shutil.rmtree(work, ignore_errors=True)
    return _scrubbed(outcome, actor_id), stats


@pytest.mark.parametrize("min_ops", [0, 8], ids=["script", "ticks9"])
@pytest.mark.parametrize("order_flip", [False, True], ids=["fwd", "rev"])
def test_live_twin_fuzz_equals_reference(tmp_path, env, order_flip, min_ops):
    """`script`: tests/test_live.py's script (seed 13), whose small
    ticks apply incrementally, as the engine applies any tick of at
    most 8 ops; `ticks9`: the same generator with more than 8 ops in
    every delivery, so that remote ticks join the kernel group (the
    numpy twin at the default cutover, `_kernel_device` below it)."""
    base = str(tmp_path / "seed")
    os.makedirs(base)
    env.setenv("HM_LIVE", "0")
    url, doc_id, stored = _seed_fuzz_dir(base)
    script, clocks = _remote_script(stored, 13, order_flip, min_ops)
    env.setenv("HM_LIVE", "1")
    want, ref_stats = _run_fuzz(base, url, doc_id, script, clocks, False)
    assert ref_stats["adopted"] >= 1
    got, stats = _run_fuzz(base, url, doc_id, script, clocks, True)
    assert got == want
    assert stats["adopted"] >= 1 and stats["refused"] == 0, stats
    # every tick of more than 8 ops joins a kernel group: the numpy twin
    # below the cutover, then _kernel_device (the plain version here)
    env.setenv("HM_LIVE_INC_BUDGET", "0")
    got_twin, twin_stats = _run_fuzz(base, url, doc_id, script, clocks, True)
    assert got_twin == want
    assert twin_stats["device_dispatches"] == 0, twin_stats
    env.setenv("HM_DEVICE_MIN_CELLS", "0")
    got_dev, dev_stats = _run_fuzz(base, url, doc_id, script, clocks, True)
    assert got_dev == want
    assert dev_stats["device_dispatches"] == dev_stats["kernel_runs"]
    if min_ops:
        assert twin_stats["kernel_runs"] > 0, twin_stats
        assert dev_stats["device_dispatches"] > 0, dev_stats
    env.delenv("HM_DEVICE_MIN_CELLS")
    env.delenv("HM_LIVE_INC_BUDGET")
    env.setenv("HM_LIVE", "0")
    got_host, host_stats = _run_fuzz(base, url, doc_id, script, clocks, True)
    assert host_stats is None
    assert got_host == want


def _seed_demote_dir(base):
    """tests/test_live_demote.py's seeded doc and two peer keypairs,
    written by the reference."""
    repo = RefRepo(path=base)
    url = repo.create({"edits": [], "k": 0})
    for i in range(5):
        repo.change(url, lambda d, i=i: d["edits"].append(i))
    doc_id = validate_doc_url(url)
    pairs = [ref_keys.create() for _ in range(2)]
    stored = list(repo.back.docs[doc_id].opset.history)
    repo.close()
    return url, doc_id, [(p.public_key, p.secret_key) for p in pairs], stored


def _run_demote(base, url, doc_id, pairs, script, clocks, port):
    """tests/test_live_demote.py's workload: feed-backed peer deliveries,
    a local edit after each, every idle doc demoted between deliveries,
    a final demote and re-adopting edit."""
    work, repo = _open_copy(base, port)
    km = keymod if port else ref_keys
    try:
        local_patches = _record_local_patches(repo)
        h = repo.open(url)
        assert h.value(timeout=20) is not None
        back = repo.back
        doc = back.docs[doc_id]
        actors = [back._init_actor(km.KeyPair(pk, sk)) for pk, sk in pairs]
        for a in actors:
            back.cursors.add_actor(back.id, doc_id, a.id)
        for k, ((idx, batch), want) in enumerate(zip(script, clocks)):
            for ch in (to_port(batch) if port else batch):
                actors[idx].write_change(ch)
            back.cursors.update(
                back.id, doc_id, {actors[idx].id: batch[-1].seq})
            back._sync_changes(actors[idx])
            wait_until(lambda: all(
                doc.clock.get(a, 0) == s for a, s in want.items()))
            repo.change(url, lambda d, k=k: d.__setitem__(f"k{k}", k))
            if back.live is not None:
                back.live.flush_now()
                back.live.demote_idle(0)
        if back.live is not None:
            back.live.flush_now()
            back.live.demote_idle(0)
        repo.change(url, lambda d: d.__setitem__("fin", 1))
        stats = None
        if back.live is not None:
            back.live.flush_now()
            stats = dict(back.live.stats)
        outcome = {
            "snap": doc.snapshot_patch().to_json(),
            "clock": dict(doc.clock),
            "hist": doc.history_len,
            "state": plain(h.value()),
            "local_patches": local_patches,
        }
        actor_id = doc.actor_id
    finally:
        repo.close()
        shutil.rmtree(work, ignore_errors=True)
    return _scrubbed(outcome, actor_id), stats


@pytest.mark.parametrize("order_flip", [False, True], ids=["fwd", "rev"])
def test_demote_readopt_twin_equals_reference(tmp_path, env, order_flip):
    base = str(tmp_path / "seed")
    os.makedirs(base)
    env.setenv("HM_LIVE", "0")
    url, doc_id, pairs, stored = _seed_demote_dir(base)
    script, clocks = _remote_script(
        stored, 23, order_flip, n_rounds=8,
        peer_ids=[pk for pk, _sk in pairs])
    env.setenv("HM_LIVE", "1")
    want, ref_stats = _run_demote(
        base, url, doc_id, pairs, script, clocks, False)
    assert ref_stats["demoted"] > 0 and ref_stats["readopted"] > 0
    got, stats = _run_demote(base, url, doc_id, pairs, script, clocks, True)
    assert got == want
    assert stats["demoted"] == ref_stats["demoted"], stats
    assert stats["readopted"] == ref_stats["readopted"], stats
    env.setenv("HM_LIVE", "0")
    got_host, _ = _run_demote(base, url, doc_id, pairs, script, clocks, True)
    assert got_host == want


def test_first_live_edit_replays_nothing(tmp_path, env):
    """No full host replay on the first live change to a bulk-loaded
    doc, local AND remote; the explicit history API still replays."""
    env.setenv("HM_LIVE", "0")
    url, doc_id, stored = _seed_fuzz_dir(str(tmp_path))
    env.setenv("HM_LIVE", "1")
    repo = Repo(path=str(tmp_path), device="cpu")
    try:
        repo.back.load_documents_bulk([doc_id])
        doc = repo.back.docs[doc_id]
        assert doc.opset is None and doc._lazy_loader is not None
        calls = []
        orig = doc._lazy_loader

        def spy():
            calls.append(1)
            return orig()

        doc._lazy_loader = spy
        repo.change(url, lambda d: d.__setitem__("new", 1))
        assert repo.doc(url)["new"] == 1
        assert doc.opset is None and not calls

        # a remote change from another actor ticks through the engine
        peer = Site("peerpeerpeer0001")
        local = [c.to_json() for c in doc._lazy_loader()]
        calls.clear()
        from hypermerge_tpu.crdt.change import Change as RefChange

        peer.receive([RefChange.from_json(c) for c in local])
        ch, _ = peer.change(lambda d: d.__setitem__("remote", 2))
        doc.apply_remote_changes(to_port([ch]))
        wait_until(lambda: repo.doc(url).get("remote") == 2)
        assert doc.opset is None and not calls
        assert repo.back.live.stats["adopted"] == 1

        hist = doc.materialize_at(doc.history_len)
        assert plain(hist)["new"] == 1
        assert calls, "time travel should use the host replay"
        assert doc.opset is None
    finally:
        repo.close()
