"""The prefix pack's padded-plane emit on the GPU — the port of
hypermerge_tpu/ops/pack_kernels.py.

The cold open's fast pack (ops/columnar.py `_try_pack_prefix_single`:
one single-writer feed per doc, whole-prefix windows) ends by emitting
the padded [Dp, N] wire planes of the slab: row resolution of the
container and element references, the key and value LUT remaps into the
batch-global tables, the writer broadcast, the pad defaults, and the
value range that picks the value plane's wire dtype. The host part here
is marshalling only — each of the 12 source planes concatenated, in its
narrow sidecar dtype, over the docs' windows, plus per-doc vectors and
the flat LUTs (`marshal_pack_inputs`) — and one kernel derives and
writes every output cell:

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

The result is the reference's: host numpy planes in the wire dtypes
that `_pack_wire_dtypes` picks from the value range, byte-identical to
its numpy twin. Unlike the reference, nothing here falls back: a failed
build, launch or check raises out of the pack.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

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
    _PACK_SRC_PLANES,
    _pack_src_idx,
    _pack_wire_dtypes,
)
from .crdt_kernels import _check, _launched, kernel_fn

# dtype codes of the source planes, as pack_prefix.cu reads them
_TORCH_CODE = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.uint8: 3}


class PackInputs(NamedTuple):
    """What the pack kernel reads, D docs and M source rows in all."""

    planes: List[np.ndarray]  # 12 x [M] narrow, _PACK_SRC_PLANES order
    doc_start: np.ndarray  # [D] int64: first source row of doc d
    ends: np.ndarray  # [D] int32: rows of doc d
    writer: np.ndarray  # [D] int32: batch-global actor id of doc d
    lut_off: np.ndarray  # [4, D] int32: doc d's offset in each flat LUT
    luts: List[np.ndarray]  # key, string, float, bigint: flat int32


def marshal_pack_inputs(
    fcs, fc_idx, fc_idx_a, ends, writer_g, flat_lut, N: int
) -> PackInputs:
    """The host half of the pack: concatenate each source plane over the
    docs' windows (plane-backed feeds keep their narrow dtypes; a feed
    without checkpoint planes serves columns of its rows matrix), and
    gather the per-doc writer and LUT offsets. Raises on a window that
    runs past its feed's rows (a corrupt sidecar) or past the bucket."""
    D = len(ends)
    feed_rows = np.asarray([fc.n_rows for fc in fcs], np.int64)
    if np.any(ends > feed_rows[fc_idx_a]):
        raise ValueError("a doc window ends past its feed's rows")
    if int(ends.max(initial=0)) > N:
        raise ValueError(f"a doc window exceeds the row bucket N={N}")
    if all(fc.planes is not None for fc in fcs):
        planes = [
            np.concatenate(
                [fcs[fc_idx[d]].plane(name)[: ends[d]] for d in range(D)]
            )
            for name in _PACK_SRC_PLANES
        ]
    else:
        R = np.concatenate(
            [fcs[fc_idx[d]].ensure_rows()[: ends[d]] for d in range(D)],
            axis=0,
        )
        planes = [np.ascontiguousarray(R[:, i]) for i in _pack_src_idx()]
    doc_start = np.zeros(D, np.int64)
    np.cumsum(ends[:-1], out=doc_start[1:])
    tables = [flat_lut(kind) for kind in ("k", "s", "f", "b")]
    return PackInputs(
        planes=planes,
        doc_start=doc_start,
        ends=ends.astype(np.int32),
        writer=writer_g[fc_idx_a].astype(np.int32),
        lut_off=np.stack([offs[fc_idx_a] for _, offs in tables]).astype(
            np.int32
        ),
        luts=[lut.astype(np.int32) for lut, _ in tables],
    )


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
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """((11 padded [Dp, N] planes in COLUMNS order), [2] int32 (vmin,
    vmax)), by the same gather as the kernel. Row planes are int16
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
    # 0 folds in: min(initial=0) / max(initial=0) as in the reference,
    # with or without pad cells
    minmax = torch.stack([
        value_g.min().clamp(max=0), value_g.max().clamp(min=0)
    ]).to(torch.int32)
    sources = {
        "action": action, "actor": per_doc(writer), "ctr": ctr, "seq": seq,
        "obj": obj, "key": key_g, "ref": ref, "insert": insert,
        "vkind": vkind, "value": value_g, "dt": dt,
    }
    return tuple(fill(sources[name], name) for name in COLUMNS), minmax


# ---------------------------------------------------------------------------
# CUDA kernel wrapper (launch count in crdt_kernels.launches["pack_prefix"])


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
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """pack_prefix.cu on one GPU; the same contract as pack_prefix_plain.
    The per-doc vectors must describe the planes (doc_start[d] + ends[d]
    <= M, ends[d] <= N), as `marshal_pack_inputs` builds them."""
    if len(planes) != len(_PACK_SRC_PLANES):
        raise ValueError(f"expected {len(_PACK_SRC_PLANES)} source planes")
    M = planes[0].shape[0]
    D = ends.shape[0]
    dev = planes[0].device
    if M < 1 or D < 1 or Dp < D or N < 1:
        raise ValueError(f"bad pack shape: M={M} D={D} Dp={Dp} N={N}")
    for name, t in zip(_PACK_SRC_PLANES, planes):
        if t.dtype not in _TORCH_CODE:
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
        _check(t, name, t.dtype, (M,))
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
    outs = tuple(
        torch.empty(Dp, N, dtype=dtypes[name], device=dev) for name in COLUMNS
    )
    minmax = torch.zeros(2, dtype=torch.int32, device=dev)
    src_ptrs = np.asarray([t.data_ptr() for t in planes], np.int64)
    src_codes = np.asarray([_TORCH_CODE[t.dtype] for t in planes], np.int32)
    out_ptrs = np.asarray([t.data_ptr() for t in outs], np.int64)
    fn = kernel_fn("pack_prefix")
    with torch.cuda.device(dev):
        rc = fn(
            src_ptrs.ctypes.data, src_codes.ctypes.data,
            doc_start.data_ptr(), ends.data_ptr(), writer.data_ptr(),
            lut_off.data_ptr(), *(t.data_ptr() for t in luts),
            *(int(t.shape[0]) for t in luts),
            D, Dp, N, int(row32), int(key32),
            out_ptrs.ctypes.data, minmax.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _launched("pack_prefix", rc)
    return outs, minmax


def pack_prefix(planes, doc_start, ends, writer, lut_off, luts, Dp, N,
                row32, key32):
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


def upload(inp: PackInputs, device: torch.device) -> dict:
    """The keyword tensors of `pack_prefix` for `inp`, on `device`."""

    def t(a):
        return torch.from_numpy(a).to(device)

    return dict(
        planes=[t(p) for p in inp.planes], doc_start=t(inp.doc_start),
        ends=t(inp.ends), writer=t(inp.writer), lut_off=t(inp.lut_off),
        luts=[t(x) for x in inp.luts],
    )


def device_pack_prefix(
    fcs, fc_idx, fc_idx_a, ends, writer_g, flat_lut,
    Dp, N, i16ok, row_dt, kdt, device: torch.device,
) -> Dict[str, np.ndarray]:
    """The padded [Dp, N] wire planes of a prefix pack, packed on
    `device` and returned as host numpy arrays in the wire dtypes (the
    value plane's from the value range the kernel reduced)."""
    inp = marshal_pack_inputs(fcs, fc_idx, fc_idx_a, ends, writer_g,
                              flat_lut, N)
    outs, minmax = pack_prefix(
        **upload(inp, device), Dp=Dp, N=N, row32=not i16ok,
        key32=np.dtype(kdt) == np.int32,
    )
    vmin, vmax = minmax.tolist()
    dtypes = _pack_wire_dtypes(i16ok, row_dt, kdt, vmin, vmax)
    cols: Dict[str, np.ndarray] = {}
    for name, t in zip(COLUMNS, outs):
        arr = t.cpu().numpy()
        if arr.dtype != np.dtype(dtypes[name]):
            arr = arr.astype(dtypes[name])
        cols[name] = arr
    return cols

