"""Batched query kernels for the read-serving tier — the port of
hypermerge_tpu/serve/kernels.py.

One read of a resident doc never materializes anything host-side: the
structural queries — element order of a text/list object, winner row of
a (map, key) pair, live-entry counts — run over the summary lanes of
EVERY read in the batch, one launch per (query kind, row bucket).

Each query is a hand-written CUDA kernel (kernels/csrc/serve_lookup.cu,
serve_order.cu, serve_counts.cu) with its plain PyTorch version beside
it; a wrapper launches the kernel for entries on a GPU and runs the plain
version for entries on the CPU. The kernels read the entries' lanes in
place, where the reference stacks the entries inside its jitted program.
serve_lookup reads the batch's lane pointers and query vectors from ONE
small int64 tensor the wrapper uploads per dispatch; serve_order and
serve_counts take them by value in their launch parameters (no upload)
and copy their result into a pinned host buffer that each calling thread
keeps per device and reuses. The batch axis pads to a power of two with
copies of entry 0 and the query NO_OBJ, which no row matches
(`stack_entries`). Results come back to the host as numpy in one copy
per dispatch, which is also the dispatch's only sync point.

Lane layout (serve/resident.py installs one [LANES, N] int32 tensor per
resident doc — a single host->device transfer per install):
"""

from __future__ import annotations

import threading
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops import crdt_kernels as ck
from ..ops.columnar import round_up_pow2

# stacked-lane row indices (ResidentDoc.dev is [LANES, N] int32)
L_LIVE = 0     # elem_live: INS rows whose element has a visible value
L_RANK = 1     # RGA order key (higher = earlier)
L_OBJ = 2      # container MAKE row (-1 = root map)
L_INSERT = 3   # 1 on element-creating ops
L_KEY = 4      # key-table index (-1 = none)
L_MAPWIN = 5   # winning visible op of its (obj, key)
N_LANES = 6

_INT32_MAX = 2**31 - 1

# qobj value that matches no container: real obj rows are >= -1 (root)
NO_OBJ = -7

# the most keys serve_order.cu sorts in shared memory (its kSharedKeys); a
# bucket above it keeps its keys in global scratch
ORDER_SHARED_KEYS = 16384
# the entries one serve_order or serve_counts launch passes by value
# under the oldest toolkit (the 4,096-byte parameter limit of params.cuh's
# LaneEntries); above this the wrapper reads the source's own cap to size
# scratch and count the launches
LANE_ENTRIES_MIN = 256


class ServeDeviceError(RuntimeError):
    """A read's device work failed: a query kernel did not build or
    launch, or an install's upload failed for another reason than memory
    pressure. The tier answers every read of the batch with it, and the
    blocking `Repo.read` raises it — never a None that would read as
    "not found"."""


def stack_entries(entries: Sequence) -> list:
    """The batch's [LANES, N] lane tensors, padded to a power of two by
    repeating the first entry's tensor (no new device memory; the NO_OBJ
    query pad masks the pad slots out)."""
    B = round_up_pow2(max(1, len(entries)))
    devs = [e.dev for e in entries]
    if len(devs) < B:
        devs.extend([devs[0]] * (B - len(devs)))
    return devs


def _pad_q(vals: List[int], B: int, fill: int) -> np.ndarray:
    out = np.full(B, fill, np.int32)
    out[: len(vals)] = np.asarray(vals, np.int32)
    return out


# ---------------------------------------------------------------------------
# plain PyTorch versions over the stacked [B, LANES, N] lanes


def map_lookup_plain(stacked, qobj, qkey):
    """([B] int32 first matching row, 0 when none; [B] bool found)."""
    mask = (
        (stacked[:, L_MAPWIN] != 0)
        & (stacked[:, L_KEY] == qkey[:, None])
        & (stacked[:, L_OBJ] == qobj[:, None])
    )
    # argmax returns the first maximal index: the lowest match, or 0
    row = torch.argmax(mask.to(torch.uint8), dim=1).to(torch.int32)
    return row, mask.any(dim=1)


def seq_order_plain(stacked, qobj):
    """([B, N] int32 stable argsort of `mask ? -rank : INT32_MAX` —
    descending rank, ties in row order, the decode_patch element order;
    [B] int32 live element counts)."""
    mask = (
        (stacked[:, L_LIVE] != 0)
        & (stacked[:, L_OBJ] == qobj[:, None])
        & (stacked[:, L_INSERT] == 1)
    )
    key = torch.where(
        mask, -stacked[:, L_RANK],
        torch.tensor(_INT32_MAX, dtype=torch.int32, device=stacked.device),
    )
    order = torch.sort(key, dim=1, stable=True).indices.to(torch.int32)
    return order, mask.sum(dim=1, dtype=torch.int32)


def counts_plain(stacked, qobj):
    """([B] int32 live inserted elements at qobj, [B] int32 map winners
    at qobj)."""
    at_obj = stacked[:, L_OBJ] == qobj[:, None]
    n_elems = (
        (stacked[:, L_LIVE] != 0) & at_obj & (stacked[:, L_INSERT] == 1)
    ).sum(dim=1, dtype=torch.int32)
    n_map = ((stacked[:, L_MAPWIN] != 0) & at_obj).sum(
        dim=1, dtype=torch.int32
    )
    return n_elems, n_map


# ---------------------------------------------------------------------------
# CUDA kernel wrappers (launch counts in crdt_kernels.launches)


def lane_pointers(devs) -> np.ndarray:
    """The batch's B lane pointers (int64), once every entry's lanes are
    checked to be contiguous int32 [LANES, N] on one device."""
    dev, N = devs[0].device, devs[0].shape[1]
    for t in devs:
        if t.device != dev or t.dtype != torch.int32:
            raise ValueError(f"serve lanes: expected int32 on {dev}")
        if tuple(t.shape) != (N_LANES, N) or not t.is_contiguous():
            raise ValueError(f"serve lanes: expected contiguous [{N_LANES}, {N}]")
    if N < 1 or N & (N - 1):
        raise ValueError(f"row bucket N={N} must be a power of two")
    return np.asarray([t.data_ptr() for t in devs], np.int64)


def dispatch_args(devs, *queries: np.ndarray) -> torch.Tensor:
    """The one int64 tensor serve_lookup reads: the B lane pointers, then
    each [B] query vector, on the lanes' device."""
    host = np.concatenate(
        [lane_pointers(devs)] + [np.asarray(q, np.int64) for q in queries]
    )
    return torch.from_numpy(host).to(devs[0].device)


def _launch(stem: str, name: str, dev, *args) -> None:
    fn = ck.kernel_fn(stem)
    with ck.launch_scope(dev):  # the batcher thread launches here
        rc = fn(*args, ck.launch_stream(dev))
    ck._launched(name, rc)


class _ResultBuffers(threading.local):
    """Each calling thread's result buffers, by device: the device output
    and the pinned host copy the C entry writes it into, shared by
    serve_order and serve_counts. Reused while they are large enough,
    replaced by ones twice the size otherwise. Every dispatch syncs before
    it returns, so no copy is in flight when the next dispatch of the
    thread, of either kind, reuses them."""

    def __init__(self) -> None:
        self.by_dev = {}

    def get(self, dev: torch.device, n: int):
        bufs = self.by_dev.get(dev)
        if bufs is None or bufs[0].numel() < n:
            size = round_up_pow2(n)
            bufs = self.by_dev[dev] = (
                torch.empty(size, dtype=torch.int32, device=dev),
                torch.empty(size, dtype=torch.int32,
                            pin_memory=dev.type == "cuda"),
            )
        return bufs


_result_buffers = _ResultBuffers()


def map_lookup_cuda(devs, qobj: np.ndarray, qkey: np.ndarray):
    B, N, dev = len(devs), devs[0].shape[1], devs[0].device
    args = dispatch_args(devs, qobj, qkey)
    out = torch.empty(2 * B, dtype=torch.int32, device=dev)
    _launch("serve_lookup", "serve_lookup", dev, args.data_ptr(), B, N,
            out.data_ptr())
    host = out.cpu().numpy()  # the dispatch's one copy back
    return host[:B], host[B:] != 0


def seq_order_cuda(devs, qobj: np.ndarray):
    """serve_order.cu over the batch: the lane pointers and qobj pass by
    value in the launch parameters; the entry copies [B * N + B] results
    into this thread's pinned buffer and waits for the stream. Returns
    copies, so the next dispatch may reuse the buffer."""
    B, N, dev = len(devs), devs[0].shape[1], devs[0].device
    ptrs = lane_pointers(devs)
    qobj = np.ascontiguousarray(qobj, dtype=np.int32)
    per_launch = (B if B <= LANE_ENTRIES_MIN
                  else ck.launch_cap("serve_order", 0))
    n_out = B * N + B
    out, host = _result_buffers.get(dev, n_out)
    # the keys of a bucket above ORDER_SHARED_KEYS live in global scratch,
    # one launch's entries at a time, then their head sizes
    scratch, scratch_len = None, 0
    if N > ORDER_SHARED_KEYS:
        m = min(B, per_launch)
        scratch_len = m * N + m
        scratch = torch.empty(scratch_len, dtype=torch.int64, device=dev)
    fn = ck.kernel_fn("serve_order")
    with ck.launch_scope(dev):
        rc = fn(ptrs.ctypes.data, qobj.ctypes.data, B, N, 0, 0,
                ck._ptr(scratch), scratch_len, out.data_ptr(),
                host.data_ptr(), ck.launch_stream(dev))
    ck._launched("serve_order", rc, -(-B // per_launch))
    res = host[:n_out].numpy()
    return res[: B * N].reshape(B, N).copy(), res[B * N :].copy()


def counts_cuda(devs, qobj: np.ndarray):
    """serve_counts.cu over the batch: the lane pointers and qobj pass by
    value in the launch parameters; the entry copies [2 * B] results into
    this thread's pinned buffer and waits for the stream. Returns copies,
    so the next dispatch may reuse the buffer."""
    B, N, dev = len(devs), devs[0].shape[1], devs[0].device
    ptrs = lane_pointers(devs)
    qobj = np.ascontiguousarray(qobj, dtype=np.int32)
    per_launch = (B if B <= LANE_ENTRIES_MIN
                  else ck.launch_cap("serve_counts", 0))
    out, host = _result_buffers.get(dev, 2 * B)
    fn = ck.kernel_fn("serve_counts")
    with ck.launch_scope(dev):
        rc = fn(ptrs.ctypes.data, qobj.ctypes.data, B, N, 0, out.data_ptr(),
                host.data_ptr(), ck.launch_stream(dev))
    ck._launched("serve_counts", rc, -(-B // per_launch))
    res = host[: 2 * B].numpy()
    return res[:B].copy(), res[B:].copy()


# ---------------------------------------------------------------------------
# dispatch: the kernel for GPU lanes, the plain version for CPU lanes


def _plain(fn, devs, *queries):
    stacked = torch.stack(devs)
    qs = [torch.from_numpy(np.asarray(q, np.int32)) for q in queries]
    return tuple(t.numpy() for t in fn(stacked, *qs))


def _on_gpu(devs) -> bool:
    kind = devs[0].device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {devs[0].device}")
    return kind == "cuda"


def map_lookup(
    entries: Sequence, qobjs: List[int], qkeys: List[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Winner value row per (doc, container, key): [B] rows + [B] found
    mask. One dispatch for the whole group."""
    devs = stack_entries(entries)
    B = len(devs)
    qobj, qkey = _pad_q(qobjs, B, NO_OBJ), _pad_q(qkeys, B, -1)
    if _on_gpu(devs):
        return map_lookup_cuda(devs, qobj, qkey)
    return _plain(map_lookup_plain, devs, qobj, qkey)


def seq_order(
    entries: Sequence, qobjs: List[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Element order (live INS rows, descending rank) per (doc,
    container): [B, N] row order + [B] live counts."""
    devs = stack_entries(entries)
    qobj = _pad_q(qobjs, len(devs), NO_OBJ)
    if _on_gpu(devs):
        return seq_order_cuda(devs, qobj)
    return _plain(seq_order_plain, devs, qobj)


def counts(
    entries: Sequence, qobjs: List[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """([B] live element counts, [B] map entry counts) per container."""
    devs = stack_entries(entries)
    qobj = _pad_q(qobjs, len(devs), NO_OBJ)
    if _on_gpu(devs):
        return counts_cuda(devs, qobj)
    return _plain(counts_plain, devs, qobj)
