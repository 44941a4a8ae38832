"""The port's sidecar pack (`pack_docs_columns`, ops/columnar.py, with the
pack kernel's plain version on the CPU) against the JAX package's.

Each case packs the same histories' sidecars with both packages. The
reference runs twice: with HM_DEVICE_PACK=1 (its jitted device pack, on
the CPU backend) and with HM_DEVICE_PACK=0 HM_NATIVE_PACK=0 (its numpy
twin). The port's batch must equal both byte for byte: every column with
its dtype, psrc, ptgt, n_ops, doc_actors, slot and every table. The
cases are those of tests/test_native_pack.py — the fuzz, padded and
partial windows, a shared feed and an empty doc, a rows-backed cache,
the multi-actor general path, counter and text lanes — plus one doc with
N >= 32768 (`i16ok` false, int32 row planes). Tolerance: 0.

`test_pack_prefix_parity_traps` feeds crafted inputs to the reference's
traced program (`_build_pack`) and to the port's plain version: int16
wrap of "cast, then subtract", clamped LUT reads, the REF_HEAD/REF_NONE
mapping, and the value range with no pad cells.
"""

import random

import numpy as np
import pytest
import torch

from helpers import Site, random_mutation
from hypermerge_tpu.models import Counter, Text
from hypermerge_tpu.ops import columnar as ref_columnar
from hypermerge_tpu.ops import pack_kernels as ref_pk
from hypermerge_tpu.storage import colcache as ref_cc
from hypermerge_tpu_torch.ops import columnar as port_columnar
from hypermerge_tpu_torch.ops import pack_kernels as port_pk
from hypermerge_tpu_torch.storage import colcache as port_cc
from test_torch_colcache import (
    INF,
    fill_caches,
    multi_actor_histories,
    plane_caches,
    single_writer_history,
)


def assert_batches_identical(a, b):
    for name in ref_columnar.COLUMNS:
        assert a.cols[name].dtype == b.cols[name].dtype, name
        np.testing.assert_array_equal(a.cols[name], b.cols[name], err_msg=name)
    for name in ("psrc", "ptgt", "n_ops", "doc_actors"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    for name in ("actors", "keys", "strings", "floats", "bigints"):
        assert getattr(a, name) == getattr(b, name), name
    assert (a.slot is None) == (b.slot is None)
    if a.slot is not None:
        assert a.slot.dtype == b.slot.dtype
        np.testing.assert_array_equal(a.slot, b.slot)


def _windows(fcs_ref, fcs_port, wins):
    """Spec lists for both packages from [(feed index, end_seq)] per doc."""
    ref = [[(fcs_ref[i], 0, e)] for i, e in wins]
    port = [[(fcs_port[i], 0, e)] for i, e in wins]
    return ref, port


def _plane_feeds(tmp_path, seeds):
    pairs = [
        plane_caches(tmp_path, f"s{s}", single_writer_history(s)) for s in seeds
    ]
    return [r.columns() for r, _ in pairs], [p.columns() for _, p in pairs]


def case_fuzz(tmp_path):
    r, p = _plane_feeds(tmp_path, range(6))
    assert all(fc.planes is not None for fc in r + p)
    return (*_windows(r, p, [(i, INF) for i in range(6)]), {}, True)


def case_padded_partial(tmp_path):
    r, p = _plane_feeds(tmp_path, (11, 12))
    half = max(1, r[1].n_changes // 2)
    kw = dict(n_docs=8, n_rows=512, n_pred=128)
    return (*_windows(r, p, [(0, INF), (1, half)]), kw, True)


def case_ragged_shared_empty(tmp_path):
    r, p = _plane_feeds(tmp_path, (31, 32))
    half = max(1, r[1].n_changes // 2)
    wins = [(0, INF), (1, half), (0, INF), (1, 0)]
    kw = dict(n_docs=8, n_rows=512, n_pred=128)
    return (*_windows(r, p, wins), kw, True)


def case_shared_feed_empty_doc(tmp_path):
    r, p = _plane_feeds(tmp_path, (3,))
    return (*_windows(r, p, [(0, INF), (0, INF), (0, 0)]), {}, True)


def case_rows_backed(tmp_path):
    rnd = random.Random(17)
    site = Site("actor03")
    for _ in range(25):
        random_mutation(site, rnd)
    rc, pc = fill_caches(
        list(site.opset.history), ref_cc.MemoryColumnStorage(),
        port_cc.MemoryColumnStorage(),
    )
    r, p = rc.columns(), pc.columns()
    assert r.planes is None and p.planes is None
    return (*_windows([r], [p], [(0, INF)]), {}, True)


def case_multi_actor_general(tmp_path):
    ref, port = [], []
    for seed in (21, 22, 23):
        rs, ps = [], []
        for hist in multi_actor_histories(seed).values():
            rc, pc = fill_caches(
                hist, ref_cc.MemoryColumnStorage(), port_cc.MemoryColumnStorage()
            )
            rs.append((rc.columns(), 0, INF))
            ps.append((pc.columns(), 0, INF))
        ref.append(rs)
        port.append(ps)
    return ref, port, {}, False


def case_counter_text(tmp_path):
    site = Site("actor00")
    site.change(lambda d: d.__setitem__("n", Counter(2)))
    site.change(lambda d: d.increment("n", 5))
    site.change(lambda d: d.__setitem__("t", Text("hey")))
    site.change(lambda d: d["t"].insert(3, "!"))
    rc, pc = plane_caches(tmp_path, "ct", list(site.opset.history))
    return (*_windows([rc.columns()], [pc.columns()], [(0, INF)]), {}, True)


def case_i16_false(tmp_path):
    """One doc in a 32768-row bucket: every row plane is int32."""
    r, p = _plane_feeds(tmp_path, (5, 6))
    return (*_windows(r, p, [(0, INF), (1, INF)]), dict(n_rows=32768), True)


CASES = {
    "fuzz": case_fuzz,
    "padded_partial": case_padded_partial,
    "ragged_shared_empty": case_ragged_shared_empty,
    "shared_feed_empty_doc": case_shared_feed_empty_doc,
    "rows_backed": case_rows_backed,
    "multi_actor_general": case_multi_actor_general,
    "counter_text": case_counter_text,
    "i16_false": case_i16_false,
}


def ref_pack(monkeypatch, specs, mode, prefix, **kw):
    """The reference batch: its jitted device pack (mode "device", spied
    so that a silent fall-through to the host fails the test) or its
    numpy twin (mode "numpy")."""
    calls = []
    orig = ref_pk.device_pack_prefix

    def spy(*a, **k):
        out = orig(*a, **k)
        calls.append(bool(out))
        return out

    monkeypatch.setattr(ref_pk, "device_pack_prefix", spy)
    monkeypatch.setenv("HM_NATIVE_PACK", "0")
    monkeypatch.setenv("HM_DEVICE_PACK", "1" if mode == "device" else "0")
    batch = ref_columnar.pack_docs_columns(specs, **kw)
    if mode == "device" and prefix:
        assert calls and all(calls), "the reference's device pack did not run"
    return batch


def port_pack(monkeypatch, specs, **kw):
    """(port batch, the keyword arguments of each pack_prefix call)."""
    calls = []
    orig = port_pk.pack_prefix

    def spy(**k):
        calls.append(k)
        return orig(**k)

    monkeypatch.setattr(port_pk, "pack_prefix", spy)
    return port_columnar.pack_docs_columns(specs, device="cpu", **kw), calls


@pytest.mark.parametrize("mode", ["device", "numpy"])
@pytest.mark.parametrize("case", list(CASES))
def test_pack_identical(tmp_path, monkeypatch, case, mode):
    ref_specs, port_specs, kw, prefix = CASES[case](tmp_path)
    want = ref_pack(monkeypatch, ref_specs, mode, prefix, **kw)
    got, calls = port_pack(monkeypatch, port_specs, **kw)
    assert len(calls) == (1 if prefix else 0)
    assert_batches_identical(got, want)
    if case == "i16_false":
        assert got.cols["ctr"].dtype == np.int32


def test_pack_empty_windows(monkeypatch):
    """Zero rows in every window: the empty batch, padded to n_docs."""
    rc, pc = fill_caches(
        single_writer_history(2), ref_cc.MemoryColumnStorage(),
        port_cc.MemoryColumnStorage(),
    )
    specs_r = [[(rc.columns(), 0, 0)]] * 2
    specs_p = [[(pc.columns(), 0, 0)]] * 2
    want = ref_pack(monkeypatch, specs_r, "numpy", False, n_docs=4, n_rows=8)
    got, calls = port_pack(monkeypatch, specs_p, n_docs=4, n_rows=8)
    assert not calls
    assert_batches_identical(got, want)


# ---------------------------------------------------------------------------
# parity traps, on crafted inputs: the reference's traced pack program
# against the port's plain version (and, in test_torch_kernel_sources.py,
# the CUDA source compiled for the host)

_L = 6  # entries of each crafted LUT


def trap_inputs(variant):
    """pack_prefix keyword arguments (CPU tensors) for one trap variant.

    - "wrap": obj_ctr/ref_ctr beyond int16 with int16 row planes: the
      row is (int16)ctr - 1 in int16, wrapping like numpy;
    - "clamp": key and value indices outside their LUTs on the lanes
      the select discards (key -1 at offset 0, an inline int of 10**6):
      the read clamps, and the select drops it; kept string lanes read
      exactly the table's last entry;
    - "ref_map": ref_a of 0, -2, -3, -1 and 5 (-2 is REF_HEAD, any other
      non-zero is REF_NONE), and a value range whose low end is -1;
    - "no_pad_positive": every cell a real row and every value positive:
      vmin is still 0;
    - "no_pad_negative": every cell a real row and every value a negative
      inline int: vmax is still 0;
    - "row32": int32 row and key planes, values outside int16.
    """
    rng = np.random.default_rng(list(trap_variants()).index(variant))
    no_pad = variant in ("no_pad_positive", "no_pad_negative")
    ends = [8, 8, 8] if no_pad else [8, 5, 0]
    D, N = 3, 8
    Dp = D if no_pad else 4
    M = sum(ends)
    row32 = variant == "row32"
    ctr = np.arange(1, M + 1, dtype=np.int32)
    obj_ctr = rng.integers(1, 4, M).astype(np.int32)
    ref_ctr = rng.integers(1, 4, M).astype(np.int32)
    if variant in ("wrap", "row32"):
        obj_ctr[::2] = 40000
        ref_ctr[1::3] = 32768
        ctr[::3] = 70000
    obj_a = rng.choice([0, -1], M).astype(np.int8)
    ref_a = rng.choice([0, -2, -3], M).astype(np.int8)
    if variant == "ref_map":
        ref_a = np.resize(np.array([0, -2, -3, -1, 5], np.int8), M)
    key = rng.integers(-1, 3, M).astype(np.int16)
    vkind = np.resize(np.array([1, 2, 3, 4, 5, 0], np.uint8), M)
    value = rng.integers(0, 3, M).astype(np.int32)
    value[vkind == 1] = rng.integers(-(2**20), 2**20, int((vkind == 1).sum()))
    lut_off = rng.integers(0, 3, (4, D)).astype(np.int32)
    if variant == "clamp":
        lut_off[0] = 0
        key[::4] = -1  # index -1: clamps to 0, then dropped by key >= 0
        value[vkind == 1] = 10**6  # an inline int far past every LUT
        doc_of = np.repeat(np.arange(D), ends)
        value[vkind == 3] = (_L - 1 - lut_off[1])[doc_of][vkind == 3]
    if variant == "ref_map":
        value[vkind == 1] = -1  # the range's low end is exactly -1
    if variant == "no_pad_positive":
        value = np.abs(value) + 1
    if variant == "no_pad_negative":
        vkind[:] = 1
        value = -1 - np.abs(value)
    planes = [
        rng.integers(0, 7, M).astype(np.uint8),  # action
        ctr, ctr.copy(),  # ctr, seq
        obj_ctr, obj_a, key, ref_ctr, ref_a,
        rng.integers(0, 2, M).astype(np.uint8),  # insert
        vkind, value, rng.integers(0, 3, M).astype(np.uint8),  # dt
    ]
    doc_start = np.concatenate([[0], np.cumsum(ends)[:-1]]).astype(np.int64)
    luts = [rng.integers(0, 2**16 if row32 else 100, _L).astype(np.int32)
            for _ in range(4)]
    t = torch.from_numpy
    return dict(
        planes=[t(p) for p in planes], doc_start=t(doc_start),
        ends=t(np.asarray(ends, np.int32)),
        writer=t(np.asarray([2, 0, 1], np.int32)), lut_off=t(lut_off),
        luts=[t(x) for x in luts], Dp=Dp, N=N, row32=row32, key32=row32,
    )


def trap_variants():
    return ("wrap", "clamp", "ref_map", "no_pad_positive", "no_pad_negative",
            "row32")


# crafted shapes for the kernel's own seams (ends, dtypes of each source
# plane in _PACK_SRC_PLANES order, Dp, N, row32, key32): the same planes
# go through the reference's traced program, the plain version and the
# CUDA source compiled for the host
_I8, _I16, _I32, _U8 = np.int8, np.int16, np.int32, np.uint8
_NARROW = (_U8, _I32, _I16, _I16, _I8, _I16, _I16, _I8, _U8, _U8, _I32, _U8)
CRAFTED = {
    # rows of 4,096 cells: tiles of 512 (2,048 at 128 threads) whose
    # edges fall inside docs, a doc ending one row into a tile, pad docs
    "straddle": ([1500, 700, 513, 2048, 4000], _NARROW, 7, 4096, False, False),
    # 40 docs of 1 to 35 rows: every window offset mod 16 for the 1-byte
    # planes (and every even / 4-byte offset for the wider ones), docs
    # ending mid-vector, N = 64
    "offsets": ([1 + (7 * d) % 35 for d in range(40)], _NARROW, 41, 64,
                False, False),
    # every plane in each of the four source dtypes, in turn
    "codes_i8": ([20, 33, 16], (_I8,) * 12, 4, 48, False, False),
    "codes_u8": ([20, 33, 16], (_U8,) * 12, 4, 48, False, False),
    "codes_i16": ([20, 33, 16], (_I16,) * 12, 4, 48, False, False),
    "codes_i32": ([20, 33, 16], (_I32,) * 12, 4, 48, False, False),
    # int32 row and key planes, values outside int16, INC rows
    "row32_key32": ([90, 128, 3], _NARROW, 3, 128, True, True),
    # N not a multiple of 16: the scalar path, with several tiles' worth
    # of cells per thread
    "scalar_n": ([1000, 7, 999], _NARROW, 4, 1000, False, False),
}


def crafted_inputs(name):
    """pack_prefix keyword arguments (CPU tensors) for one CRAFTED shape:
    random source rows held inside each plane's dtype (ctr dense from 1, values
    spread over int32, a quarter of the actions INC), random LUT
    offsets, LUTs of 16 entries read in range."""
    ends, dtypes, Dp, N, row32, key32 = CRAFTED[name]
    rng = np.random.default_rng(list(CRAFTED).index(name) + 100)
    D = len(ends)
    M = int(sum(ends))
    cols = [
        np.where(rng.random(M) < 0.25, 6, rng.integers(0, 6, M)),  # action
        np.arange(1, M + 1), rng.integers(1, 50, M),  # ctr, seq
        rng.integers(-3, 40000, M), rng.choice([0, -1, 2], M),  # obj
        rng.integers(-2, 11, M),  # key
        rng.integers(-3, 40000, M), rng.choice([0, -1, -2, -3, 4], M),  # ref
        rng.integers(0, 2, M), rng.integers(0, 6, M),  # insert, vkind
        rng.integers(-(2**31), 2**31 - 1, M), rng.integers(0, 3, M),  # dt
    ]
    # held inside each dtype, as a sidecar's narrowing keeps them
    # table rows of the LUT kinds in range (the reference pads a LUT to a
    # power of two, so its clamp differs past the end)
    vkind = cols[9]
    lut_kind = (vkind == 2) | (vkind == 3) | (vkind == 5)
    cols[10] = np.where(lut_kind, rng.integers(0, 11, M), cols[10])
    planes = [np.clip(c, np.iinfo(dt).min, np.iinfo(dt).max).astype(dt)
              for c, dt in zip(cols, dtypes)]
    doc_start = np.concatenate([[0], np.cumsum(ends)[:-1]]).astype(np.int64)
    luts = [rng.integers(-(2**20), 2**20, 16).astype(np.int32)
            for _ in range(4)]
    t = torch.from_numpy
    return dict(
        planes=[t(p) for p in planes], doc_start=t(doc_start),
        ends=t(np.asarray(ends, np.int32)),
        writer=t(rng.integers(0, 9, D).astype(np.int32)),
        lut_off=t(rng.integers(0, 5, (4, D)).astype(np.int32)),
        luts=[t(x) for x in luts], Dp=Dp, N=N, row32=row32, key32=key32,
    )


def pack_inputs(case):
    """The keyword arguments of a trap variant or a CRAFTED shape."""
    return crafted_inputs(case) if case in CRAFTED else trap_inputs(case)


def reference_pack_program(kw):
    """The reference's traced `_build_pack`, run by jax on the CPU over
    the same inputs (its scatter formulation: [Mp] planes, per-row
    offsets and a flat index with a scratch slot)."""
    import jax

    D = kw["ends"].shape[0]
    Dp, N = kw["Dp"], kw["N"]
    ends = kw["ends"].numpy().astype(np.int64)
    M = int(ends.sum())
    Mp = ref_pk._round_up_pow2(M)
    doc_col = np.repeat(np.arange(D), ends)
    pos = np.arange(M) - kw["doc_start"].numpy()[doc_col]
    flat_idx = ref_pk._m_vec(doc_col * N + pos, Mp, fill=Dp * N)
    planes = [ref_pk._m_vec(p.numpy(), Mp) for p in kw["planes"]]
    actor_rows = ref_pk._m_vec(kw["writer"].numpy()[doc_col], Mp)
    offs = [ref_pk._m_vec(o[doc_col], Mp) for o in kw["lut_off"].numpy()]
    luts = [ref_pk._lut_vec(x.numpy()) for x in kw["luts"]]
    fn = ref_pk._build_pack(
        Mp, Dp, N, not kw["row32"], not kw["key32"], ref_columnar.PAD,
        ref_cc.OBJ_ROOT, ref_cc.REF_HEAD, ref_cc.REF_NONE, ref_cc.VK_STR,
        ref_cc.VK_FLOAT, ref_cc.VK_BIGINT, ref_columnar.COLUMNS,
    )
    out = jax.jit(fn)(*planes, flat_idx, actor_rows, *offs, *luts)
    return [np.asarray(o) for o in out[:-2]], (int(out[-2]), int(out[-1]))


@pytest.mark.parametrize("variant", list(trap_variants()) + list(CRAFTED))
def test_pack_prefix_parity_traps(variant):
    kw = pack_inputs(variant)
    want, (vmin, vmax) = reference_pack_program(kw)
    out = port_pk.pack_prefix(**kw)
    assert out.ranges[:2].tolist() == [vmin, vmax]
    if variant == "no_pad_positive":
        assert vmin == 0 < vmax
    if variant == "no_pad_negative":
        assert vmin < 0 == vmax
    for name, g, w in zip(ref_columnar.COLUMNS, out.planes, want):
        g = g.numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    # the hand-off: flags and slot as the dispatch's host_args builds them
    # from the reference's planes, the ranges as it scans them
    action, insert, ctr, seq, value = (
        want[ref_columnar.COLUMNS.index(n)]
        for n in ("action", "insert", "ctr", "seq", "value"))
    np.testing.assert_array_equal(
        out.flags.numpy(), action.astype(np.uint8) | (insert.astype(np.uint8) << 3))
    assert out.flags.dtype == torch.uint8 and out.slot.dtype == torch.int8
    assert not out.slot.any()
    assert out.ranges.tolist() == [
        int(value.min(initial=0)), int(value.max(initial=0)),
        int(ctr.max(initial=0)), int(seq.max(initial=0)),
        int((action == int(ref_columnar.Action.INC)).sum()),
    ]
