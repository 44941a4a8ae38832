"""Every case of tests/test_parallel.py not already in
tests/test_torch_parallel.py, under its own name on the port's
multi-device plane (hypermerge_tpu_torch/parallel/: `make_mesh`,
`shard_batch` and the sharded programs) over virtual CPU ranks
(`[torch.device("cpu")] * n`: the ring runs `ring_gather_plain`, the
folds the plain clock_union). Inputs come from the port's synth, the
same seeds as the reference's; each answer is also held against the
reference package's on its 8-device CPU mesh; tolerance 0.

The cases that test JAX machinery test the port's counterpart of the
same guarantee, as their docstrings say: the program table's "no
retrace" is each kernel library built and loaded once per process
(kernels/_build.py); the Pallas remote-copy capability gate is the ring
mode check (parallel/ring.py `Ring`, parallel/mesh.py `Mesh.mode`); the
graft entries are `hypermerge_tpu_torch.graft_entry`.

The twinned file's own docstring follows.

Sharded execution over the 8-device virtual CPU mesh + graft entries."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hypermerge_tpu.ops import crdt_kernels as ref_ck
from hypermerge_tpu.ops import synth as ref_synth
from hypermerge_tpu.parallel import mesh as ref_mesh
from hypermerge_tpu.parallel import sharded as ref_sharded
from hypermerge_tpu_torch.ops.crdt_kernels import run_batch as _run_batch
from hypermerge_tpu_torch.ops.synth import synth_batch, synth_changes
from hypermerge_tpu_torch.parallel import mesh as meshmod
from hypermerge_tpu_torch.parallel.sharded import (
    sharded_clock_union,
    sharded_dominated,
    sharded_materialize,
    step,
)
from port_helpers import (
    assert_batch_equal,
    assert_kernel_built_once,
    plainify,
    ref_plain,
)
from test_torch_parallel import host_local_union

CPU = torch.device("cpu")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = ("visible", "map_winner", "elem_live", "rank", "clock")


def make_mesh(n, sp=1):
    """A port mesh over n virtual CPU ranks."""
    return meshmod.make_mesh(n, sp=sp, devices=[CPU] * max(n, 1))


def run_batch(batch):
    return _run_batch(batch, device="cpu")


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def test_mesh_shapes():
    mesh = make_mesh(8, sp=2)
    assert dict(mesh.shape) == {"dp": 4, "sp": 2}
    mesh1 = make_mesh(4)
    assert dict(mesh1.shape) == {"dp": 4, "sp": 1}
    with pytest.raises(ValueError):
        meshmod.make_mesh(1000, devices=[CPU] * 8)
    assert dict(mesh.shape) == dict(ref_mesh.make_mesh(8, sp=2).shape)
    assert dict(mesh1.shape) == dict(ref_mesh.make_mesh(4).shape)
    with pytest.raises(ValueError):
        ref_mesh.make_mesh(1000)


def test_sharded_materialize_matches_single_device():
    batch = synth_batch(n_docs=16, n_ops=128)
    ref_batch = ref_synth.synth_batch(n_docs=16, n_ops=128)
    assert_batch_equal(batch, ref_batch)
    single = run_batch(batch)
    mesh = make_mesh(8, sp=1)
    sharded = sharded_materialize(batch, mesh)
    want = ref_sharded.sharded_materialize(ref_batch, ref_mesh.make_mesh(8))
    for field in LANES:
        a = _np(getattr(single, field))
        b = _np(getattr(sharded, field))[: batch.n_docs]
        np.testing.assert_array_equal(a, b, err_msg=field)
        np.testing.assert_array_equal(
            b, np.asarray(getattr(want, field))[: batch.n_docs],
            err_msg=field)


def test_sharded_materialize_pads_ragged_doc_axis():
    batch = synth_batch(n_docs=13, n_ops=64)  # not divisible by dp
    mesh = make_mesh(8, sp=1)
    out = sharded_materialize(batch, mesh)
    assert out.rank.shape[0] == 16  # padded to dp multiple
    single = run_batch(batch)
    np.testing.assert_array_equal(_np(single.rank), _np(out.rank)[:13])
    want = ref_sharded.sharded_materialize(
        ref_synth.synth_batch(n_docs=13, n_ops=64), ref_mesh.make_mesh(8))
    np.testing.assert_array_equal(_np(out.rank)[:13],
                                  np.asarray(want.rank)[:13])


def test_sharded_clock_union_and_dominated():
    mesh = make_mesh(8, sp=2)
    rng = np.random.default_rng(0)
    clocks = rng.integers(0, 100, (64, 16)).astype(np.int32)
    union = _np(sharded_clock_union(clocks, mesh))
    np.testing.assert_array_equal(union, clocks.max(axis=0))

    query = clocks[7]
    dom = _np(sharded_dominated(clocks, query, mesh))
    np.testing.assert_array_equal(dom, np.all(clocks <= query, axis=-1))
    rmesh = ref_mesh.make_mesh(8, sp=2)
    np.testing.assert_array_equal(
        union, np.asarray(ref_sharded.sharded_clock_union(clocks, rmesh)))
    np.testing.assert_array_equal(
        dom, np.asarray(ref_sharded.sharded_dominated(clocks, query, rmesh)))


def test_full_step():
    batch = synth_batch(n_docs=8, n_ops=64)
    mesh = make_mesh(8, sp=2)
    out, union = step(batch, mesh)
    assert union.shape[-1] == len(batch.actors)
    _rout, runion = ref_sharded.step(ref_synth.synth_batch(n_docs=8, n_ops=64),
                                     ref_mesh.make_mesh(8, sp=2))
    np.testing.assert_array_equal(_np(union), np.asarray(runion))


def test_synth_changes_replay_host():
    """The Change-object form of the synthetic workload is causally valid
    and replays fully on the host OpSet."""
    from hypermerge_tpu.crdt.opset import OpSet as RefOpSet
    from hypermerge_tpu_torch.crdt.opset import OpSet

    changes = synth_changes(200, seed=3)
    opset = OpSet()
    opset.apply_changes(changes)
    assert not opset._pending
    doc = opset.materialize()
    assert "t" in doc and len(str(doc["t"])) > 0
    ref_changes = ref_synth.synth_changes(200, seed=3)
    assert [c.to_json() for c in changes] == [c.to_json() for c in ref_changes]
    ref = RefOpSet()
    ref.apply_changes(ref_changes)
    assert plainify(doc) == ref_plain(ref.materialize())


def test_synth_columns_equal_synth_changes_on_device():
    """Both generator forms produce the same materialized state."""
    from hypermerge_tpu.ops import columnar as ref_columnar
    from hypermerge_tpu.ops import materialize as ref_mat
    from hypermerge_tpu_torch.crdt.opset import OpSet
    from hypermerge_tpu_torch.ops.columnar import pack_docs
    from hypermerge_tpu_torch.ops.materialize import (
        DecodedBatch,
        materialize_docs,
    )

    changes = synth_changes(150, seed=5)
    opset = OpSet()
    opset.apply_changes(changes)
    dec = DecodedBatch(*_run(pack_docs([changes])))
    docs = materialize_docs(dec)
    assert plainify(docs[0]) == plainify(opset.materialize())
    rb = ref_columnar.pack_docs([ref_synth.synth_changes(150, seed=5)])
    ref_docs = ref_mat.materialize_docs(
        ref_mat.DecodedBatch(rb, ref_ck.run_batch(rb)))
    assert plainify(docs[0]) == ref_plain(ref_docs[0])


def _run(batch):
    return batch, run_batch(batch)


# -- mesh shapes the fuzz matrix pins: (dp, sp) ------------------------
_MESH_SHAPES = [(8, 1), (4, 2), (2, 2), (1, 1)]


def _mesh_for(dp, sp):
    return make_mesh(dp * sp, sp=sp)


def test_mesh_reductions_fuzz_bit_identical_across_shapes():
    """sharded_clock_union / sharded_dominated match the numpy twin on
    every mesh shape, including ragged (non-multiple) doc and actor
    counts that force padding on both axes — and the reference's
    programs on the same inputs."""
    rng = np.random.default_rng(7)
    for dp, sp in _MESH_SHAPES:
        mesh = _mesh_for(dp, sp)
        rmesh = ref_mesh.make_mesh(dp * sp, sp=sp)
        for D, A in [(13, 5), (32, 16), (7, 11), (1, 1), (64, 3)]:
            clocks = rng.integers(0, 1000, (D, A)).astype(np.int32)
            union = _np(sharded_clock_union(clocks, mesh))
            np.testing.assert_array_equal(
                union, clocks.max(axis=0), err_msg=f"{dp}x{sp} {D}x{A}"
            )
            np.testing.assert_array_equal(
                union,
                np.asarray(ref_sharded.sharded_clock_union(clocks, rmesh)),
                err_msg=f"{dp}x{sp} {D}x{A}")
            query = clocks[rng.integers(0, D)]
            dom = _np(sharded_dominated(clocks, query, mesh))
            np.testing.assert_array_equal(
                dom,
                np.all(clocks <= query, axis=-1),
                err_msg=f"{dp}x{sp} {D}x{A}",
            )
            np.testing.assert_array_equal(
                dom,
                np.asarray(ref_sharded.sharded_dominated(clocks, query,
                                                         rmesh)),
                err_msg=f"{dp}x{sp} {D}x{A}")


def test_step_fuzz_bit_identical_to_single_device_across_shapes():
    """The one-program collective merge step (materialize + clock
    union) matches the single-device twin on every mesh shape, ragged
    doc counts included, and the reference's step."""
    from hypermerge_tpu_torch.ops.crdt_kernels import bucket_doc_actors

    for seed, (dp, sp) in enumerate(_MESH_SHAPES):
        mesh = _mesh_for(dp, sp)
        for n_docs in (13, 8):
            batch = synth_batch(n_docs=n_docs, n_ops=96, seed=seed)
            single = run_batch(batch)
            da, _A, _K = bucket_doc_actors(batch)
            n_actors = len(batch.actors)
            out, union = step(batch, mesh)
            for field in LANES:
                np.testing.assert_array_equal(
                    _np(getattr(single, field)),
                    _np(getattr(out, field))[:n_docs],
                    err_msg=f"{dp}x{sp} D={n_docs} {field}",
                )
            np.testing.assert_array_equal(
                _np(union),
                host_local_union(_np(single.clock), _np(da), n_actors),
                err_msg=f"{dp}x{sp} D={n_docs} union",
            )
            rout, runion = ref_sharded.step(
                ref_synth.synth_batch(n_docs=n_docs, n_ops=96, seed=seed),
                ref_mesh.make_mesh(dp * sp, sp=sp))
            np.testing.assert_array_equal(_np(union), np.asarray(runion))
            np.testing.assert_array_equal(
                _np(out.rank)[:n_docs], np.asarray(rout.rank)[:n_docs])


def test_mesh_programs_cached_no_retrace(tmp_path, monkeypatch):
    """The reference pins its program table (one trace per shape). The
    port runs eagerly; its counterpart is that each kernel library is
    built and loaded once per process (kernels/_build.py `load`): a
    second load of a stem adds no build and returns the same library,
    and repeated same-shape mesh calls leave the builds untouched and
    give the same answers."""
    from hypermerge_tpu_torch.kernels import _build
    from hypermerge_tpu_torch.parallel import sharded as sharded_mod

    mesh = make_mesh(8, sp=1)
    batch = synth_batch(n_docs=16, n_ops=64, seed=1)
    n_actors = max(1, len(batch.actors))
    log = dict(_build.build_log)

    def calls():
        out, da = sharded_mod._materialize_on_mesh(batch, mesh)
        return (
            sharded_mod.local_clock_union(out.clock, da, n_actors, mesh),
            sharded_mod.sharded_full(batch, mesh, lean=False)[1].cpu(),
            step(batch, mesh)[1],
            sharded_clock_union(np.ones((16, 8), np.int32), mesh).cpu(),
        )

    first = calls()
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(calls(), first))
    assert _build.build_log == log

    assert_kernel_built_once(tmp_path, monkeypatch)


def test_remote_copy_capability_gate(monkeypatch):
    """The reference's gate: CPU meshes never select its Pallas remote-
    copy path. The port's counterpart is the ring's mode: a CPU mesh is
    "plain" (ring_gather_plain; the kernel refuses it), one card repeated
    is "virtual", distinct cards are "peer" only where every pair has
    peer access, a mix raises, and `Ring` takes only its four modes."""
    from hypermerge_tpu.parallel.sharded import remote_copy_capable
    from hypermerge_tpu_torch.parallel import ring as ringmod

    mesh = make_mesh(8, sp=1)
    assert mesh.mode == "plain"
    assert mesh.ring().mode == "plain"
    with pytest.raises(ValueError, match="plain"):
        ringmod.ring_gather_cuda(
            [torch.zeros(2, 4, dtype=torch.uint8)] * 8, mesh.ring())
    for mode in ("virtual", "peer", "protocol", "plain"):
        assert ringmod.Ring([CPU] * 2, mode).mode == mode
    with pytest.raises(ValueError, match="ring mode"):
        ringmod.Ring([CPU] * 2, "ici")

    # CUDA meshes, their mode decided from the devices alone (no card is
    # touched: peer access is asked of torch, monkeypatched here)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert meshmod.Mesh([[cards[0]]] * 4).mode == "virtual"
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: True)
    assert meshmod.Mesh([[c] for c in cards]).mode == "peer"
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: False)
    with pytest.raises(ValueError, match="no peer access"):
        meshmod.Mesh([[c] for c in cards])
    with pytest.raises(ValueError, match="not a mix"):
        meshmod.Mesh([[cards[0]], [cards[0]], [cards[1]]])
    with pytest.raises(ValueError, match="all cpu or all cuda"):
        meshmod.Mesh([[CPU], [cards[0]]])

    # the reference's gate on its CPU mesh
    rmesh = ref_mesh.make_mesh(8, sp=1)
    assert remote_copy_capable(rmesh) is False
    assert remote_copy_capable() is False
    monkeypatch.setenv("HM_ICI_PALLAS", "0")
    assert remote_copy_capable(rmesh) is False


def test_graft_entry_single_chip():
    """`hypermerge_tpu_torch.graft_entry.entry` on the CPU: the forward
    over its example args gives 8 docs, lane for lane the reference
    entry's."""
    import jax

    sys.path.insert(0, REPO_ROOT)
    import __graft_entry__ as g
    from hypermerge_tpu_torch import graft_entry

    fn, args = graft_entry.entry(device="cpu")
    out = fn(*args)
    assert out.rank.shape[0] == 8
    rfn, rargs = g.entry()
    want = jax.jit(rfn)(*rargs)
    jax.block_until_ready(want)
    for field in LANES:
        np.testing.assert_array_equal(_np(getattr(out, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)


def test_graft_dryrun_multichip(monkeypatch, capsys):
    """The measured multi-device run of the port over 8 and 4 CPU ranks
    (small corpus, device slabs forced, as the reference's case runs it),
    in process and through `python -m hypermerge_tpu_torch.graft_entry
    4 --device cpu`."""
    from hypermerge_tpu_torch import graft_entry

    monkeypatch.setenv("HM_DRYRUN_DOCS", "64")
    monkeypatch.setenv("HM_DRYRUN_OPS", "96")
    monkeypatch.setenv("HM_DEVICE_MIN_CELLS", "1")  # force device slabs
    for n in (8, 4):
        line = graft_entry.dryrun_multichip(n, device="cpu")
        assert line.startswith("measured_multichip ok: ")
        assert f"{n} CPU ranks" in line
        assert "multi-device == single-device summaries" in line
    out = subprocess.run(
        [sys.executable, "-m", "hypermerge_tpu_torch.graft_entry", "4",
         "--device", "cpu"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ),
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "entry ok: (8, 256)"
    assert lines[-1].startswith("measured_multichip ok: 4 CPU ranks")
