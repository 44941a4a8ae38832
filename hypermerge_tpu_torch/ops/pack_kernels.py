"""The prefix pack's padded-plane emit on the GPU — the port of
hypermerge_tpu/ops/pack_kernels.py — and its hand-off to the slab launch.

The cold open's fast pack (ops/columnar.py `_try_pack_prefix_single`:
one single-writer feed per doc, whole-prefix windows) ends by emitting
the padded [Dp, N] wire planes of the slab: row resolution of the
container and element references, the key and value LUT remaps into the
batch-global tables, the writer broadcast, the pad defaults, and the
value range that picks the value plane's wire dtype. The host part here
is marshalling only — each of the 12 source planes concatenated, in its
narrow sidecar dtype, over the docs' windows (one native call, GIL
released, where the native library loads), with the per-doc vectors
and the flat LUTs, into one staging buffer (`marshal_pack_inputs`) that
goes up in one copy (`upload`) — and one kernel derives and writes every
output cell:

- `pack_prefix_cuda`: the CUDA kernel `kernels/csrc/pack_prefix.cu` for
  tensors on the GPU (the reference's jitted `_build_pack`);
- `pack_prefix_plain`: its plain PyTorch version, for tensors on the CPU.

Which one runs follows only from where the tensors lie; a GPU tensor
never reaches the plain version. Both use one gather over the output
cells: cell (d, p) is a real row when p < ends[d], read from source row
doc_start[d] + p, and takes its column's pad default otherwise. The
reference pads M to a power of two and scatters through a flat index
with a scratch slot instead; those buckets exist to bound its retracing
and have no use here.

Beside the 11 wire planes both write the two lanes only the slab launch
reads (flags, slot) and fold the ranges the dispatch needs (`RANGES`).
`device_pack_prefix` hands the device planes on as the batch's launch
lanes (`columnar.SlabLanes`), and brings the wire planes to the host
behind the launch (`HostPlanes`: a copy stream, one pinned buffer, every
read waiting on its event). Host planes are byte-identical to the
reference's. Nothing here falls back: a failed build, copy, launch or
check raises out of the pack.

This is the port's default route on a card (`device_pack_enabled`:
unless HM_DEVICE_PACK=0); the reference's default is its host route
(HM_DEVICE_PACK=0 there too), which the port has beside it
(ops/columnar.py `_native_pack_prefix`). A pack may run on any thread
(the pipeline's pack pool): it launches on that thread's current stream,
and the hand-off carries the event recorded there after the launch
(`SlabLanes.packed`), which the slab launch and the host planes' copy
wait on.
"""

from __future__ import annotations

import os
import threading
from collections.abc import Mapping
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .columnar import (
    COL_DEFAULTS,
    COLUMNS,
    OBJ_ROOT,
    REF_HEAD,
    REF_NONE,
    VK_BIGINT,
    VK_FLOAT,
    VK_STR,
    SlabLanes,
    _CODE_DT,
    _DT_CODE,
    _PACK_SRC_PLANES,
    _native_pack_lib,
    _pack_src_idx,
    _pack_wire_dtypes,
    _ptr as _np_ptr,
    check_windows,
    feed_plane_ptrs,
)
from .crdt_kernels import (
    _INC,
    _TORCH_DTYPE,
    Staging,
    _check,
    _launched,
    _ptr,
    aligned_layout,
    kernel_fn,
    launch_scope,
    launch_stream,
)

# dtype codes of the source planes, as pack_prefix.cu reads them
_TORCH_CODE = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.uint8: 3}
# the ranges the pack folds, in its result's order: the value min and max,
# the ctr and seq maxima (each with 0 folded in) and the count of INC rows
RANGES = ("vmin", "vmax", "ctr_max", "seq_max", "n_inc")
# the per-doc vectors and LUTs after the 12 source planes in the staging
_PER_DOC = ("doc_start", "ends", "writer", "lut_off")
_NUMPY_DTYPE = {t: dt for dt, t in _TORCH_DTYPE.items()}


def device_pack_enabled() -> bool:
    """Whether the prefix pack takes the device route: unless
    HM_DEVICE_PACK=0 (the host route, ops/columnar.py)."""
    return os.environ.get("HM_DEVICE_PACK", "1") != "0"


class PackOut(NamedTuple):
    """What the pack writes: the 11 padded [Dp, N] wire planes (COLUMNS
    order), the slab launch's flags (uint8 action | insert << 3) and slot
    (int8 zeros), and the folded ranges (host int32 [5], RANGES order)."""

    planes: Tuple[torch.Tensor, ...]
    flags: torch.Tensor
    slot: torch.Tensor
    ranges: torch.Tensor


def marshal_pack_inputs(
    fcs, fc_idx, fc_idx_a, ends, writer_g, flat_lut, N: int,
    device: torch.device,
) -> Staging:
    """The host half of the pack: each source plane concatenated over the
    docs' windows (plane-backed feeds keep their narrow dtypes, promoted
    to one per plane; a feed without planes serves columns of its rows
    matrix), then doc_start, ends, writer, lut_off and the four flat
    LUTs, all in one staging buffer (pinned for a card). Plane-backed
    feeds are copied by one native call (`hm_pack_gather`, GIL released)
    where the native library loads, else by numpy per doc. Raises on a
    window that runs past its feed's rows (a corrupt sidecar) or past the
    bucket."""
    D = len(ends)
    check_windows(fcs, fc_idx_a, ends)
    if int(ends.max(initial=0)) > N:
        raise ValueError(f"a doc window exceeds the row bucket N={N}")
    M = int(ends.sum())
    doc_start = np.zeros(D, np.int64)
    np.cumsum(ends[:-1], out=doc_start[1:])
    planes = all(fc.planes is not None for fc in fcs)
    lib = _native_pack_lib() if planes else None
    rows = parts = ptrs = None
    if lib is not None:
        ptrs = feed_plane_ptrs(fcs)
        used = ptrs[1][np.unique(fc_idx_a)]
        dtypes = [
            np.result_type(*(_CODE_DT[c] for c in np.unique(used[:, k])))
            for k in range(len(_PACK_SRC_PLANES))
        ]
    elif planes:
        parts = [
            [fcs[fc_idx[d]].plane(name)[: ends[d]] for d in range(D)]
            for name in _PACK_SRC_PLANES
        ]
        dtypes = [np.result_type(*{a.dtype for a in p}) for p in parts]
    else:
        rows = np.concatenate(
            [fcs[fc_idx[d]].ensure_rows()[: ends[d]] for d in range(D)],
            axis=0,
        )
        dtypes = [rows.dtype] * len(_PACK_SRC_PLANES)
    tables = [flat_lut(kind) for kind in ("k", "s", "f", "b")]
    small = [
        doc_start,
        ends.astype(np.int32),
        writer_g[fc_idx_a].astype(np.int32),
        np.stack([offs[fc_idx_a] for _, offs in tables]).astype(np.int32),
        *(lut.astype(np.int32) for lut, _ in tables),
    ]
    st = Staging(
        [(dt, (M,)) for dt in dtypes] + [(a.dtype, a.shape) for a in small],
        device,
    )
    views = st.arrays[: len(dtypes)]
    if ptrs is not None:
        srcs, sdts, keep_alive = ptrs
        fc_i = np.ascontiguousarray(fc_idx_a, np.int64)
        ends64 = np.ascontiguousarray(ends, np.int64)
        out_ptrs = np.asarray([_np_ptr(v) for v in views], np.int64)
        out_dts = np.asarray([_DT_CODE[v.dtype] for v in views], np.uint8)
        rc = lib.hm_pack_gather(
            D, _np_ptr(fc_i), _np_ptr(ends64), _np_ptr(doc_start),
            _np_ptr(srcs), _np_ptr(sdts), _np_ptr(out_ptrs),
            _np_ptr(out_dts),
        )
        del keep_alive
        if rc != 0:
            raise RuntimeError(f"hm_pack_gather failed: {rc}")
    else:
        for k, view in enumerate(views):
            if rows is None:
                np.concatenate(parts[k], out=view)
            else:
                view[:] = rows[:, _pack_src_idx()[k]]
    for view, a in zip(st.arrays[len(dtypes):], small):
        view[...] = a
    return st


def upload(inp: Staging, device: torch.device) -> dict:
    """The keyword tensors of `pack_prefix` for `inp`, on `device`: one
    copy of the staging buffer (none on the CPU)."""
    t = inp.upload(device)
    n = len(_PACK_SRC_PLANES)
    return dict(planes=t[:n], **dict(zip(_PER_DOC, t[n : n + 4])),
                luts=t[n + 4 :])


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU path; the yardstick the kernel is held to)


def _out_dtypes(row32: bool, key32: bool) -> Dict[str, torch.dtype]:
    """The dtypes of the 11 packed planes (value int32: the host narrows
    it once the range is known)."""
    rdt = torch.int32 if row32 else torch.int16
    return {
        "action": torch.uint8, "actor": torch.int32, "ctr": rdt, "seq": rdt,
        "obj": rdt, "key": torch.int32 if key32 else torch.int16,
        "ref": rdt, "insert": torch.uint8, "vkind": torch.uint8,
        "value": torch.int32, "dt": torch.uint8,
    }


def pack_prefix_plain(
    planes: Sequence[torch.Tensor],
    doc_start: torch.Tensor,
    ends: torch.Tensor,
    writer: torch.Tensor,
    lut_off: torch.Tensor,
    luts: Sequence[torch.Tensor],
    Dp: int,
    N: int,
    row32: bool,
    key32: bool,
) -> PackOut:
    """The PackOut of the same gather as the kernel. Row planes are int16
    unless `row32`, the key plane int16 unless `key32`; action, insert,
    vkind and dt are uint8, actor and value int32."""
    dev = planes[0].device
    D = ends.shape[0]
    dtypes = _out_dtypes(row32, key32)
    rdt = dtypes["ctr"]

    def per_doc(t):  # [D] -> [Dp, 1], zeros for the pad docs
        out = torch.zeros(Dp, dtype=torch.int64, device=dev)
        out[:D] = t.to(torch.int64)
        return out[:, None]

    p = torch.arange(N, device=dev)[None, :]
    real = p < per_doc(ends)
    src = torch.where(real, per_doc(doc_start) + p, 0)
    (action, ctr, seq, obj_ctr, obj_a, key, ref_ctr, ref_a, insert,
     vkind, value, dt) = (t[src] for t in planes)

    def lut_at(lut, off, idx):  # clamped: the kernel never reads out of range
        return lut[(off + idx).clamp(0, lut.shape[0] - 1)].to(torch.int64)

    def const(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    def fill(t, name):
        wdt = dtypes[name]
        pad = const(COL_DEFAULTS.get(name, 0), wdt)
        return torch.where(real, t.to(wdt), pad)

    # row arithmetic is "cast, then subtract" in the wire dtype: the
    # subtraction wraps in int16 exactly as the reference's numpy does
    obj = torch.where(obj_a == 0, obj_ctr.to(rdt) - 1, const(OBJ_ROOT, rdt))
    ref = torch.where(
        ref_a == 0,
        ref_ctr.to(rdt) - 1,
        torch.where(ref_a == -2, const(REF_HEAD, rdt), const(REF_NONE, rdt)),
    )
    key = key.to(torch.int64)
    key_g = torch.where(key >= 0, lut_at(luts[0], per_doc(lut_off[0]), key), -1)
    value = value.to(torch.int64)
    value_g = value
    for code, lut, off in (
        (VK_STR, luts[1], lut_off[1]),
        (VK_FLOAT, luts[2], lut_off[2]),
        (VK_BIGINT, luts[3], lut_off[3]),
    ):
        value_g = torch.where(
            vkind == code, lut_at(lut, per_doc(off), value), value_g
        )
    value_g = torch.where(real, value_g, 0)
    sources = {
        "action": action, "actor": per_doc(writer), "ctr": ctr, "seq": seq,
        "obj": obj, "key": key_g, "ref": ref, "insert": insert,
        "vkind": vkind, "value": value_g, "dt": dt,
    }
    out = {name: fill(sources[name], name) for name in COLUMNS}
    flags = out["action"] | (out["insert"] << 3)
    # 0 folds into every range: min(initial=0) / max(initial=0) as in the
    # reference, with or without pad cells
    ranges = torch.tensor([
        min(int(out["value"].min()), 0), max(int(out["value"].max()), 0),
        max(int(out["ctr"].max()), 0), max(int(out["seq"].max()), 0),
        int((out["action"] == _INC).sum()),
    ], dtype=torch.int32)
    return PackOut(
        planes=tuple(out[name] for name in COLUMNS),
        flags=flags,
        slot=torch.zeros(Dp, N, dtype=torch.int8, device=dev),
        ranges=ranges,
    )


# ---------------------------------------------------------------------------
# CUDA kernel wrapper (launch count in crdt_kernels.launches["pack_prefix"])


class _RangeBuffers(threading.local):
    """Each calling thread's pinned int32 [8] buffer per device, which the
    C entry starts the ranges from and copies them back into; the entry
    waits for its stream, so the next call may reuse it."""

    def __init__(self) -> None:
        self.by_dev = {}

    def get(self, dev: torch.device) -> torch.Tensor:
        buf = self.by_dev.get(dev)
        if buf is None:
            buf = self.by_dev[dev] = torch.empty(8, dtype=torch.int32,
                                                 pin_memory=True)
        return buf


_range_buffers = _RangeBuffers()


def pack_prefix_cuda(
    planes: Sequence[torch.Tensor],
    doc_start: torch.Tensor,
    ends: torch.Tensor,
    writer: torch.Tensor,
    lut_off: torch.Tensor,
    luts: Sequence[torch.Tensor],
    Dp: int,
    N: int,
    row32: bool,
    key32: bool,
) -> PackOut:
    """pack_prefix.cu on one GPU; the same contract as pack_prefix_plain.
    The per-doc vectors must describe the planes (doc_start[d] + ends[d]
    <= M, ends[d] <= N), as `marshal_pack_inputs` builds them, and each
    source plane must start 16-byte aligned (a torch allocation, or a
    view of the staged upload). The outputs are views of one allocation,
    each 16-byte aligned; the ranges come back through a pinned buffer
    (the entry waits for the stream)."""
    if len(planes) != len(_PACK_SRC_PLANES):
        raise ValueError(f"expected {len(_PACK_SRC_PLANES)} source planes")
    M = planes[0].shape[0]
    D = ends.shape[0]
    dev = planes[0].device
    if M < 1 or D < 1 or Dp < D or N < 1:
        raise ValueError(f"bad pack shape: M={M} D={D} Dp={Dp} N={N}")
    codes = 0
    for k, (name, t) in enumerate(zip(_PACK_SRC_PLANES, planes)):
        if t.dtype not in _TORCH_CODE:
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
        _check(t, name, t.dtype, (M,))
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: expected a 16-byte aligned plane")
        codes |= _TORCH_CODE[t.dtype] << (2 * k)
    _check(doc_start, "doc_start", torch.int64, (D,))
    _check(ends, "ends", torch.int32, (D,))
    _check(writer, "writer", torch.int32, (D,))
    _check(lut_off, "lut_off", torch.int32, (4, D))
    for name, t in zip(("klut", "slut", "flut", "blut"), luts):
        if t.ndim != 1 or t.shape[0] < 1:
            raise ValueError(f"{name}: expected a non-empty 1-D LUT")
        _check(t, name, torch.int32, tuple(t.shape))
    for t in (doc_start, ends, writer, lut_off, *luts):
        if t.device != dev:
            raise ValueError(f"pack inputs span devices: {t.device} != {dev}")
    dtypes = _out_dtypes(row32, key32)
    lane_dtypes = [dtypes[name] for name in COLUMNS] + [torch.uint8, torch.int8]
    sizes = [32] + [Dp * N * t.itemsize for t in lane_dtypes]
    offs, total = aligned_layout(sizes)
    buf = torch.empty(total, dtype=torch.uint8, device=dev)
    ranges = buf[:32].view(torch.int32)
    lanes = [
        buf[o : o + n].view(t).view(Dp, N)
        for o, n, t in zip(offs[1:], sizes[1:], lane_dtypes)
    ]
    host = _range_buffers.get(dev)
    fn = kernel_fn("pack_prefix")
    with launch_scope(dev):
        rc = fn(
            *(t.data_ptr() for t in planes), codes,
            doc_start.data_ptr(), ends.data_ptr(), writer.data_ptr(),
            lut_off.data_ptr(), *(t.data_ptr() for t in luts),
            *(int(t.shape[0]) for t in luts),
            D, Dp, N, int(row32), int(key32),
            *(t.data_ptr() for t in lanes), ranges.data_ptr(),
            _ptr(host), launch_stream(dev),
        )
    _launched("pack_prefix", rc)
    return PackOut(
        planes=tuple(lanes[: len(COLUMNS)]),
        flags=lanes[-2],
        slot=lanes[-1],
        ranges=host[: len(RANGES)].clone(),
    )


def pack_prefix(planes, doc_start, ends, writer, lut_off, luts, Dp, N,
                row32, key32) -> PackOut:
    """The kernel for GPU tensors, the plain version for CPU tensors."""
    dev = planes[0].device
    if dev.type == "cuda":
        return pack_prefix_cuda(
            planes, doc_start, ends, writer, lut_off, luts, Dp, N, row32,
            key32,
        )
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return pack_prefix_plain(
        planes, doc_start, ends, writer, lut_off, luts, Dp, N, row32, key32
    )


# ---------------------------------------------------------------------------
# the hand-off: device lanes to the slab launch, wire planes to the host

_copy_streams: Dict[int, "torch.cuda.Stream"] = {}


def _copy_stream(dev: torch.device) -> "torch.cuda.Stream":
    """The stream the host planes of `dev`'s packs come down on (one per
    card, made at first use)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = _copy_streams.get(index)
    if stream is None:
        stream = _copy_streams.setdefault(
            index, torch.cuda.Stream(torch.device("cuda", index)))
    return stream


class HostPlanes(Mapping):
    """The pack's 11 wire planes on the host, by COLUMNS name, in the wire
    dtypes `dtypes` names. Planes on a card come down behind the pack on
    a copy stream that waits on an event recorded after it: one copy of
    their span of the pack's allocation into one pinned buffer (torch's
    caching host allocator reuses it once the batch is gone), the device
    memory held for that copy (`record_stream`). Every read waits on the
    copy's event first (`wait`), then narrows the value plane to its wire
    dtype; a reader never sees the buffer while it is being written.
    `packed` is the event recorded on the pack's stream (the caller's
    current stream) after the pack. Planes on the CPU are only
    converted."""

    def __init__(self, planes: Sequence[torch.Tensor], dtypes) -> None:
        self._dtypes = {k: np.dtype(v) for k, v in dtypes.items()}
        self._shape = tuple(planes[0].shape)
        self._cols = None
        self._done = None
        self.packed = None
        if planes[0].device.type != "cuda":
            self._host = list(planes)
            return
        dev = planes[0].device
        storage = planes[0].untyped_storage()
        base = storage.data_ptr()
        if any(t.untyped_storage().data_ptr() != base for t in planes):
            raise ValueError("the planes must be views of one allocation")
        starts = [t.data_ptr() - base for t in planes]
        lo = min(starts)
        hi = max(s + t.nbytes for s, t in zip(starts, planes))
        span = torch.empty(0, dtype=torch.uint8, device=dev).set_(storage)
        span = span[lo:hi]
        self._offsets = [s - lo for s in starts]
        self._dtype_of = [t.dtype for t in planes]
        stream = _copy_stream(dev)
        self.packed = torch.cuda.Event()
        self.packed.record(torch.cuda.current_stream(dev))
        stream.wait_event(self.packed)
        self._host = torch.empty(hi - lo, dtype=torch.uint8, pin_memory=True)
        with torch.cuda.stream(stream):
            self._host.copy_(span, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record(stream)
        span.record_stream(stream)

    @property
    def copying(self) -> bool:
        """Whether the planes are on their way from a card and no reader
        has waited for them yet."""
        return self._cols is None and self._done is not None

    def wait(self) -> Dict[str, np.ndarray]:
        """The host planes, after the copy's event: {name: [Dp, N]}."""
        cols = self._cols
        if cols is None:
            if self._done is None:
                arrays = [t.numpy() for t in self._host]
            else:
                self._done.synchronize()
                raw = self._host.numpy()
                n = self._shape[0] * self._shape[1]
                arrays = []
                for o, t in zip(self._offsets, self._dtype_of):
                    dt = _NUMPY_DTYPE[t]
                    arrays.append(
                        raw[o : o + n * dt.itemsize].view(dt).reshape(
                            self._shape))
            cols = {}
            for name, arr in zip(COLUMNS, arrays):
                want = self._dtypes[name]
                cols[name] = arr if arr.dtype == want else arr.astype(want)
            self._cols = cols
        return cols

    def __getitem__(self, name: str) -> np.ndarray:
        return self.wait()[name]

    def __iter__(self):
        return iter(COLUMNS)

    def __len__(self) -> int:
        return len(COLUMNS)


def device_pack_prefix(
    fcs, fc_idx, fc_idx_a, ends, writer_g, flat_lut,
    Dp, N, i16ok, row_dt, kdt, device: torch.device,
) -> Tuple[HostPlanes, SlabLanes, Dict[str, int]]:
    """A prefix pack on `device`: (its wire planes on the host, in the
    wire dtypes — the value plane's from the value range the kernel
    folded; the slab launch's lanes on `device`; the folded ranges by
    RANGES name). The host planes come down behind the call."""
    inp = marshal_pack_inputs(fcs, fc_idx, fc_idx_a, ends, writer_g,
                              flat_lut, N, device)
    out = pack_prefix(
        **upload(inp, device), Dp=Dp, N=N, row32=not i16ok,
        key32=np.dtype(kdt) == np.int32,
    )
    ranges = dict(zip(RANGES, out.ranges.tolist()))
    dtypes = _pack_wire_dtypes(i16ok, row_dt, kdt, ranges["vmin"],
                               ranges["vmax"])
    planes = dict(zip(COLUMNS, out.planes))
    host = HostPlanes(out.planes, dtypes)
    lanes = SlabLanes(
        flags=out.flags, slot=out.slot, packed=host.packed,
        **{k: planes[k] for k in ("ctr", "seq", "obj", "key", "ref", "value")},
    )
    return host, lanes, ranges
