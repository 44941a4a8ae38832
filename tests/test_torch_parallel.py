"""The port's multi-device plane (hypermerge_tpu_torch/parallel/) on
virtual CPU ranks against the JAX package's on its 8-device CPU mesh,
case for case after tests/test_parallel.py.

Port meshes are `[torch.device("cpu")] * n` (the ring then runs its plain
version, `ring_gather_plain`); the reference's are its forced host
devices (tests/conftest.py). The same seeded inputs go through both: the
reference's batches cross with `convert.batch_from_numpy`.

- mesh shapes and errors; `device_topology` keys;
- `sharded_materialize` / `sharded_full` (full and lean) against the
  reference's sharded outputs and the single device, ragged D included;
- the union/dominated fuzz over the four mesh shapes and five (D, A);
- `step` and `local_clock_union`;
- least-loaded placement skipping a saturated rank, and its gate;
- `MeshBulkScheduler`'s collective union and summary gather in dispatch
  order, and nothing after `reset_resident`;
- `ring_gather_plain` against the reference's gather program;
- the port's `Repo(path, device="cpu")` over 4 (and 3) ranks against the
  reference's `Repo` on the same corpus: byte-equal summaries, equal
  patches, `sharded_slabs >= 1`.

Tolerance: exact.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from hypermerge_tpu.ops import columnar as ref_columnar
from hypermerge_tpu.ops import synth as ref_synth
from hypermerge_tpu.ops.corpus import make_corpus as ref_make_corpus
from hypermerge_tpu.parallel import mesh as ref_mesh
from hypermerge_tpu.parallel import sharded as ref_sharded
from hypermerge_tpu.repo import Repo as RefRepo
from hypermerge_tpu_torch import convert
from hypermerge_tpu_torch.kernels import _build
from hypermerge_tpu_torch.ops import crdt_kernels as ck
from hypermerge_tpu_torch.ops.materialize import DecodedBatch, decode_patch
from hypermerge_tpu_torch.parallel import mesh as meshmod
from hypermerge_tpu_torch.parallel import ring as ringmod
from hypermerge_tpu_torch.parallel import sharded
from hypermerge_tpu_torch.parallel.mesh import Mesh, make_mesh
from hypermerge_tpu_torch.repo import Repo
from hypermerge_tpu_torch.utils.ids import validate_doc_url
from test_torch_repo import _assert_rows_equal, _bulk_open, _summary_rows
from test_torch_serve import REF_SWITCHES

CPU = torch.device("cpu")
LANES = ("visible", "map_winner", "elem_live", "rank", "clock")
# the (dp, sp) shapes of the reference's fuzz matrix
MESH_SHAPES = [(8, 1), (4, 2), (2, 2), (1, 1)]
CLOCK_SHAPES = [(13, 5), (32, 16), (7, 11), (1, 1), (64, 3)]


def port_mesh(dp, sp=1):
    return make_mesh(dp * sp, sp=sp, devices=[CPU] * (dp * sp))


def ref_mesh_for(dp, sp=1):
    return ref_mesh.make_mesh(dp * sp, sp=sp)


def port_batch(ref_batch):
    return convert.batch_from_numpy(**convert.batch_to_numpy(ref_batch))


def host_local_union(clock, doc_actors, n_actors):
    """Numpy twin of the collective local clock union."""
    want = np.zeros(n_actors + 1, np.int64)
    c = np.asarray(clock)
    da = np.asarray(doc_actors)
    np.maximum.at(want, np.where(da >= 0, da, n_actors).ravel(),
                  np.where(da >= 0, c, 0).ravel())
    return want[:n_actors].astype(np.int32)


# ---------------------------------------------------------------------------
# the mesh


def test_mesh_shapes_and_errors():
    cpu8 = [CPU] * 8
    for (n, sp), (dp, _) in zip([(8, 2), (4, 1)], [(4, 2), (4, 1)]):
        m = make_mesh(n, sp=sp, devices=cpu8)
        assert m.shape == {"dp": dp, "sp": sp}
        assert m.shape == dict(ref_mesh.make_mesh(n, sp=sp).shape)
        assert m.size == n and m.devices == [CPU] * n and m.mode == "plain"
    with pytest.raises(ValueError):
        make_mesh(1000, devices=cpu8)
    with pytest.raises(ValueError):
        make_mesh(6, sp=4, devices=cpu8)
    with pytest.raises(ValueError):
        make_mesh(devices=[])
    # a CUDA mesh repeats one card or uses distinct cards, never a mix;
    # cpu and cuda never share a mesh (both raise before touching a card)
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    with pytest.raises(ValueError, match="not a mix"):
        Mesh([[c0, c0, c1]])
    with pytest.raises(ValueError, match="all cpu or all cuda"):
        Mesh([[CPU, c0]])


def test_device_topology_keys(monkeypatch):
    topo = meshmod.device_topology(port_mesh(4))
    assert set(topo) == {"n_devices", "platform", "device_kind", "mesh",
                         "mesh_mode", "peer_access", "process_count"}
    assert topo["mesh"] == {"dp": 4, "sp": 1} and topo["peer_access"] is None
    monkeypatch.setattr(meshmod, "visible_devices", lambda: [])
    assert meshmod.device_topology()["mesh"] is None


# ---------------------------------------------------------------------------
# per-doc programs over dp


@pytest.mark.parametrize("n_docs", [16, 13])
def test_sharded_materialize_matches_reference_and_single_device(n_docs):
    ref_batch = ref_synth.synth_batch(n_docs=n_docs, n_ops=64)
    batch = port_batch(ref_batch)
    want = ref_sharded.sharded_materialize(ref_batch, ref_mesh_for(8))
    got = sharded.sharded_materialize(batch, port_mesh(8))
    single = ck.run_batch(batch, device="cpu")
    assert got.rank.shape[0] == 16  # padded to a dp multiple
    for f in LANES:
        g = np.asarray(getattr(got, f))
        np.testing.assert_array_equal(g, np.asarray(getattr(want, f)), f)
        np.testing.assert_array_equal(g[:n_docs], getattr(single, f).numpy(), f)


@pytest.mark.parametrize("lean", [False, True])
@pytest.mark.parametrize("dp,n_docs", [(4, 16), (8, 13), (3, 7)])
def test_sharded_full_wire_equals_single_device(dp, n_docs, lean):
    """The shards' wires concatenate to the single-device bytes (and to
    the reference's sharded wire where its mesh can take the shape)."""
    ref_batch = ref_synth.synth_batch(n_docs=n_docs, n_ops=96, n_actors=3,
                                      seed=dp)
    batch = port_batch(ref_batch)
    out, wire = sharded.sharded_full(batch, port_mesh(dp), lean=lean)
    assert wire.shape[0] % dp == 0 and len(wire.shards) == dp
    _o, single = ck.run_batch_full(batch, lean=lean, device="cpu")
    host = np.asarray(wire)
    np.testing.assert_array_equal(host[:n_docs], single.numpy())
    # pad docs decode as PAD rows: nothing live, nothing in the map
    assert not np.asarray(out.elem_live)[n_docs:].any()
    assert not np.asarray(out.map_winner)[n_docs:].any()
    if 8 % dp == 0:
        _ro, ref_wire = ref_sharded.sharded_full(ref_batch, ref_mesh_for(dp),
                                                 lean=lean)
        np.testing.assert_array_equal(host, np.asarray(ref_wire))


def test_doc_view_reads_one_rank():
    """DecodedBatch over sharded lanes: doc j's view comes from rank
    j // (D_pad // dp) and equals the single-device view."""
    batch = port_batch(ref_synth.synth_batch(n_docs=11, n_ops=64, seed=4))
    out, _wire = sharded.sharded_full(batch, port_mesh(4))
    single, _w = ck.run_batch_full(batch, device="cpu")
    dec, dec1 = DecodedBatch(batch, out), DecodedBatch(batch, single)
    for j in range(batch.n_docs):
        assert decode_patch(dec.doc_view(j), 0).to_json() == decode_patch(
            dec1.doc_view(j), 0).to_json()
    assert out.rank[5].shape == (batch.n_rows,)
    with pytest.raises(IndexError):
        out.rank[12]


# ---------------------------------------------------------------------------
# cross-rank reductions


@pytest.mark.parametrize("dp,sp", MESH_SHAPES)
def test_mesh_reductions_fuzz_equal_reference(dp, sp):
    """sharded_clock_union / sharded_dominated equal the reference's and
    the numpy twin on every mesh shape, with ragged doc and actor counts
    that pad both axes."""
    rng = np.random.default_rng(7)
    pm, rm = port_mesh(dp, sp), ref_mesh_for(dp, sp)
    for D, A in CLOCK_SHAPES:
        clocks = rng.integers(0, 1000, (D, A)).astype(np.int32)
        union = np.asarray(sharded.sharded_clock_union(clocks, pm))
        np.testing.assert_array_equal(union, clocks.max(axis=0))
        np.testing.assert_array_equal(
            union, np.asarray(ref_sharded.sharded_clock_union(clocks, rm)))
        query = clocks[rng.integers(0, D)]
        dom = np.asarray(sharded.sharded_dominated(clocks, query, pm))
        assert dom.dtype == bool and dom.shape == (D,)
        np.testing.assert_array_equal(dom, np.all(clocks <= query, axis=-1))
        np.testing.assert_array_equal(
            dom, np.asarray(ref_sharded.sharded_dominated(clocks, query, rm)))


@pytest.mark.parametrize("dp,sp", MESH_SHAPES)
def test_step_equals_reference_and_single_device(dp, sp):
    seed = MESH_SHAPES.index((dp, sp))
    for n_docs in (13, 8):
        ref_batch = ref_synth.synth_batch(n_docs=n_docs, n_ops=96, seed=seed)
        batch = port_batch(ref_batch)
        out, union = sharded.step(batch, port_mesh(dp, sp))
        ref_out, ref_union = ref_sharded.step(ref_batch, ref_mesh_for(dp, sp))
        single = ck.run_batch(batch, device="cpu")
        da, _A, _K = ck.bucket_doc_actors(batch)
        for f in LANES:
            np.testing.assert_array_equal(
                np.asarray(getattr(out, f))[:n_docs],
                getattr(single, f).numpy(), f"{dp}x{sp} D={n_docs} {f}")
        np.testing.assert_array_equal(union.numpy(), np.asarray(ref_union))
        np.testing.assert_array_equal(
            union.numpy(),
            host_local_union(single.clock, da, len(batch.actors)))


def test_local_clock_union_equals_reference():
    ref_batch = ref_synth.synth_batch(n_docs=16, n_ops=64, seed=1)
    batch = port_batch(ref_batch)
    n_actors = max(1, len(batch.actors))
    out, da = sharded._materialize_on_mesh(batch, port_mesh(8))
    got = sharded.local_clock_union(out.clock, da, n_actors, port_mesh(8))
    rm = ref_mesh_for(8)
    ref_out, ref_da = ref_sharded._materialize_on_mesh(ref_batch, rm)
    want = ref_sharded.local_clock_union(ref_out.clock, ref_da, n_actors, rm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # whole (unsharded) inputs shard on the way in
    single = ck.run_batch(batch, device="cpu")
    da_np, _A, _K = ck.bucket_doc_actors(batch)
    again = sharded.local_clock_union(single.clock.numpy(), da_np, n_actors,
                                      port_mesh(3))
    np.testing.assert_array_equal(again.numpy(), np.asarray(want))


def test_repeated_calls_build_nothing():
    """The reference pins its program table against retraces; PyTorch
    runs eagerly, so the port's counterpart is that repeated calls leave
    the kernel builds untouched (on CPU ranks: never reach nvcc)."""
    mesh = port_mesh(8)
    batch = port_batch(ref_synth.synth_batch(n_docs=16, n_ops=64, seed=1))
    n_actors = max(1, len(batch.actors))
    log = dict(_build.build_log)
    first = None
    for _ in range(3):
        out, da = sharded._materialize_on_mesh(batch, mesh)
        res = (sharded.local_clock_union(out.clock, da, n_actors, mesh),
               sharded.sharded_full(batch, mesh)[1].cpu(),
               sharded.step(batch, mesh)[1],
               sharded.sharded_clock_union(np.ones((16, 8), np.int32), mesh).cpu())
        first = first or res
        assert all(torch.equal(a, b) for a, b in zip(res, first))
    assert _build.build_log == log


# ---------------------------------------------------------------------------
# streaming dispatch


class _Saturator:
    """In-flight entry that must never be waited on."""

    def synchronize(self):
        raise AssertionError(
            "dispatch waited on the saturated device instead of skipping "
            "to an idle one")


def _small_batch(seed=0, n_actors=1):
    return port_batch(ref_columnar.pack_docs([ref_synth.synth_changes(
        48, n_actors=n_actors, ops_per_change=8, seed=seed)]))


def test_least_loaded_skips_saturated_device():
    devices = [CPU] * 4
    rr = sharded.SlabRoundRobin(devices, depth=2, least_loaded=True)
    rr._inflight[0] = [_Saturator(), _Saturator()]
    _out, wire = rr.dispatch(_small_batch(), lean=False)
    assert rr.last_device == 1  # skipped 0, FIFO tiebreak picked 1
    assert wire.device == devices[1]
    assert len(rr._inflight[0]) == 2  # untouched
    assert rr.pack_device_for(0, rr.cursor()) is None
    strict = sharded.SlabRoundRobin(devices, depth=2, least_loaded=False)
    strict._inflight[0] = [_Saturator(), _Saturator()]
    assert strict.pack_device_for(3, strict.cursor()) == devices[3]
    with pytest.raises(AssertionError, match="saturated"):
        strict.dispatch(_small_batch(), lean=False)


def test_least_loaded_env_gate(monkeypatch):
    monkeypatch.setenv("HM_RR_LEAST_LOADED", "1")
    assert sharded.SlabRoundRobin([CPU]).least_loaded
    monkeypatch.setenv("HM_RR_LEAST_LOADED", "0")
    assert not sharded.SlabRoundRobin([CPU]).least_loaded
    monkeypatch.setenv("HM_RR_DEPTH", "5")
    assert sharded.SlabRoundRobin([CPU]).depth == 5


@pytest.mark.parametrize("dp,sp", [(4, 2), (4, 1)])
def test_mesh_scheduler_collective_union_and_gather(dp, sp):
    """Whole-slab dispatch stays equal to the per-slab wires, and the
    collective union and summary gather equal the reference's, in
    dispatch order."""
    ref_batches = [
        ref_columnar.pack_docs([ref_synth.synth_changes(
            48, n_actors=2, ops_per_change=8, seed=s)]) for s in range(5)
    ]
    sch = sharded.MeshBulkScheduler(port_mesh(dp, sp), depth=2)
    ref_sch = ref_sharded.MeshBulkScheduler(ref_mesh_for(dp, sp), depth=2)
    outs = []
    for rb in ref_batches:
        b = port_batch(rb)
        out, wire = sch.dispatch(b, lean=False)
        ref_sch.dispatch(rb, lean=False)
        outs.append((b, out, wire))
    n_actors = max(len(b.actors) for b, _o, _w in outs)
    want = np.zeros(n_actors, np.int32)
    for b, out, _w in outs:
        da, _A, _K = ck.bucket_doc_actors(b)
        want = np.maximum(want, host_local_union(out.clock, da, n_actors))
    got = sch.collective_clock_union(n_actors)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref_sch.collective_clock_union(n_actors))
    gathered, ref_gathered = sch.gather_summaries(), ref_sch.gather_summaries()
    assert [g[0] for g in gathered] == list(range(len(ref_batches)))
    for (seq, n, host), (rseq, rn, rhost), (_b, _o, wire) in zip(
            gathered, ref_gathered, outs):
        assert (seq, n) == (rseq, rn)
        np.testing.assert_array_equal(host, wire.numpy())
        np.testing.assert_array_equal(host, np.asarray(rhost))
    assert sum(sch.slabs_per_chip) == len(ref_batches)
    sch.drain()
    sch.release()
    sch.reset_resident()
    assert sch.gather_summaries() == []


# ---------------------------------------------------------------------------
# the ring gather


@pytest.mark.parametrize("n,rows,W", [(8, 3, 5), (4, 1, 1), (2, 7, 708)])
def test_ring_gather_plain_equals_reference_gather(n, rows, W):
    rng = np.random.default_rng(n * rows + W)
    host = rng.integers(0, 256, (n * rows, W)).astype(np.uint8)
    rm = ref_mesh_for(n)
    fn = ref_sharded._gather_program(rm, jnp.uint8)
    arr = jax.device_put(host, NamedSharding(rm, P(("dp", "sp"))))
    with rm:
        want = np.asarray(fn(arr))
    ring = port_mesh(n).ring()
    blocks = [torch.from_numpy(host[r * rows : (r + 1) * rows].copy())
              for r in range(n)]
    got = ringmod.ring_gather(blocks, ring)
    assert len(got) == n
    for g in got:
        np.testing.assert_array_equal(g.numpy(), want)
    for g in ringmod.ring_gather_plain(blocks, [CPU] * n):
        np.testing.assert_array_equal(g.numpy(), want)
    with pytest.raises(ValueError):
        ringmod.ring_gather(blocks[:-1], ring)


# each block the wrappers refuse, with the reason it names
BAD_BLOCKS = {
    "device": (lambda b: b.to("meta"), "on meta"),
    "shape": (lambda b: b[:, :-1].contiguous(), r"\(2, 4\)"),
    "dtype": (lambda b: b.to(torch.int16), "torch.int16"),
    "strided": (lambda b: b.t().contiguous().t(), "contiguous"),
}


@pytest.mark.parametrize("case", list(BAD_BLOCKS))
def test_ring_gather_rejects_a_bad_block(case):
    bad, reason = BAD_BLOCKS[case]
    ring = port_mesh(3).ring()
    blocks = [torch.zeros(2, 5, dtype=torch.uint8) for _ in range(3)]
    blocks[1] = bad(blocks[1])
    with pytest.raises(ValueError, match=reason):
        ringmod.ring_gather(blocks, ring)


# ---------------------------------------------------------------------------
# the product route: Repo.open_many over a mesh


@pytest.mark.parametrize("ranks,mesh_env", [(4, "1"), (3, "1"), (4, "0")])
def test_repo_over_ranks_matches_reference(tmp_path, monkeypatch, ranks,
                                           mesh_env):
    for k, v in REF_SWITCHES.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("HM_MESH", mesh_env)
    monkeypatch.setattr(meshmod, "visible_devices", lambda: [CPU] * ranks)
    src = tmp_path / "src"
    urls = ref_make_corpus(str(src), 13, 64, distinct=4)
    a, b = tmp_path / "ref", tmp_path / "port"
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    ref, port = RefRepo(path=str(a)), Repo(path=str(b), device="cpu")
    try:
        ids = [validate_doc_url(u) for u in urls]
        want = _summary_rows(_bulk_open(ref, urls), ids)
        got = _summary_rows(_bulk_open(port, urls), ids)
        _assert_rows_equal(got, want)
        stats = port.back.last_bulk_stats
        if mesh_env == "1":
            assert stats["sharded_slabs"] >= 1
        else:
            assert "sharded_slabs" not in stats
        for d in ids:
            rp = ref.back.docs[d].snapshot_patch().to_json()
            assert port.back.docs[d].snapshot_patch().to_json() == rp
    finally:
        ref.close()
        port.close()
