"""Batched vector-clock algebra on the GPU — the port of
hypermerge_tpu/ops/clock_kernels.py and of the two device programs of
hypermerge_tpu/ops/clock_mirror.py.

Clocks live as dense [docs, actors] int32 matrices (reference
src/Clock.ts + the ClockStore bulk queries, src/ClockStore.ts:63-72).
The cursor sentinel "infinity" (CursorStore INFINITY_SEQ) is INT32_INF
here. Four CUDA kernels carry the programs:

- `kernels/csrc/clock_pair.cu`: gte, cmp, union, intersection,
  satisfied, cursor_window over two [..., A] operands, either of which may
  be one [A] row broadcast to all rows (a dominated query); `gte_host`
  takes that row from host memory into the launch's parameters and
  returns the verdicts through the calling thread's pinned buffer (the
  mirror's and the store's dominated scans), `gte_row` leaves them on the
  card;
- `kernels/csrc/clock_union.cu`: `union_reduce`, the column max, and in
  its min mode `min_reduce`, the column min (the mesh's pmin, folded over
  partials that parallel/ring.py gathered); a matrix of at most 64 rows
  (every cross-rank fold) takes one launch that folds each column in a
  thread of its own;
- `kernels/csrc/clock_scatter.cu`: `scatter_max_`, the batched writes
  (the reference's `m.at[r, c].max(v)`) of triples on the card, and
  `scatter_max_host_`, the mirror's pending writes from host memory,
  which travel in the launch's parameters (no upload);
- `kernels/csrc/clock_topk.cu`: `top_k_dominated`, a score and select
  per tile of rows in shared memory, then one merge of the tiles' top k
  (`topk_plan` names the route; a large k sorts every key across blocks).

Each entry takes tensors and routes on where they lie: CUDA tensors go to
the kernel (wrapper `*_cuda`, one count in `crdt_kernels.launches` per
launch), CPU tensors to the plain PyTorch version (`*_plain`), which is
what the tests hold to the JAX package. A CUDA tensor never reaches a
plain version. `pack_clocks` is the one entry that takes host rows and a
`device=`, which defaults to `cuda`.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve
from .columnar import round_up_pow2
from .crdt_kernels import (_check, _launched, kernel_fn, launch_cap,
                           launch_scope, launch_stream, result_buffers)

INT32_INF = 2**31 - 1

# cmp result codes — stable across host/device (crdt/clock.Ordering)
EQ, GT, LT, CONCUR = 0, 1, 2, 3

# top_k_dominated caps each entry so that the int32 row sum cannot wrap,
# even over INT32_INF sentinels (up to 2^10 actors)
TOPK_CAP = 1 << 20
# clock_topk.cu's launch shape: tiles of TOPK_TILE rows (one block each),
# TOPK_THREADS threads a block, and at most TOPK_MERGE_MAX candidates
# merged in one block's shared memory (128 KB, kMaxMerge); above that, or
# with k above a tile, the large-k route sorts every key across blocks
TOPK_TILE = 1024
TOPK_THREADS = 512
TOPK_MERGE_MAX = 16384
_TOPK_ROUTE = {"select": 0, "sort": 1}  # clock_topk.cu's route codes

# op codes of clock_pair.cu
_GTE, _CMP, _UNION, _INTERSECTION, _CURSOR_WINDOW = range(5)
# op codes of clock_union.cu
_MAX, _MIN = 0, 1


def _wrap32(t: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32, as XLA's int32 arithmetic wraps."""
    return t.to(torch.int32)


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path; the yardstick the kernels are held to)


def gte_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., A] x [..., A] -> [...] bool: a dominates b elementwise."""
    return torch.all(a >= b, dim=-1)


def cmp_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., A] x [..., A] -> [...] int32 code (EQ/GT/LT/CONCUR)."""
    a_gte = torch.all(a >= b, dim=-1)
    b_gte = torch.all(b >= a, dim=-1)
    code = torch.where(b_gte, LT, CONCUR)
    code = torch.where(a_gte, GT, code)
    return torch.where(a_gte & b_gte, EQ, code).to(torch.int32)


def union_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b)


def intersection_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.minimum(a, b)


def cursor_window_plain(
    doc_seqs: torch.Tensor, cursor_seqs: torch.Tensor
) -> torch.Tensor:
    """max(min(cursor, INT32_INF) - doc, 0) in int32 (the min is the
    identity on int32; the subtraction wraps)."""
    cursor = cursor_seqs.long().clamp_max(INT32_INF)
    return _wrap32(cursor - doc_seqs.long()).clamp_min(0)


def union_reduce_plain(clocks: torch.Tensor) -> torch.Tensor:
    """[n, A] -> [A]: the column max."""
    return torch.amax(clocks, dim=0)


def min_reduce_plain(clocks: torch.Tensor) -> torch.Tensor:
    """[n, A] -> [A]: the column min."""
    return torch.amin(clocks, dim=0)


def scatter_max_plain_(
    m: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor
) -> torch.Tensor:
    """m[rows[i], cols[i]] = max(m[...], vals[i]) in place, the max of
    every duplicate; triples outside m are dropped, as the kernel drops
    them. Returns m."""
    cap_d, cap_a = m.shape
    keep = (rows >= 0) & (rows < cap_d) & (cols >= 0) & (cols < cap_a)
    idx = rows[keep].long() * cap_a + cols[keep].long()
    m.view(-1).scatter_reduce_(0, idx, vals[keep], "amax")
    return m


def top_k_scores_plain(clocks: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """[D] int32: the row sum of min(clocks, TOPK_CAP) where the query
    dominates the row, else -1."""
    ok = torch.all(clocks <= query, dim=-1)
    capped = torch.clamp_max(clocks, TOPK_CAP)
    return torch.where(ok, _wrap32(capped.long().sum(dim=-1)), -1).to(torch.int32)


def top_k_dominated_plain(
    clocks: torch.Tensor, query: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [k] int32, indices [k] int32) in the order of
    jax.lax.top_k: score descending, equal scores lowest index first."""
    order = torch.sort(top_k_scores_plain(clocks, query), descending=True,
                       stable=True)
    return order.values[:k], order.indices[:k].to(torch.int32)


_PLAIN_PAIR = {
    _GTE: gte_plain, _CMP: cmp_plain, _UNION: union_plain,
    _INTERSECTION: intersection_plain, _CURSOR_WINDOW: cursor_window_plain,
}


# ---------------------------------------------------------------------------
# CUDA kernel wrappers (launch counts in crdt_kernels.launches)


def _operand(t: torch.Tensor, lead: Tuple[int, ...], A: int):
    """(contiguous tensor, row stride) of one clock_pair operand: the full
    [*lead, A] matrix with stride A, or one [A] row with stride 0."""
    if tuple(t.shape[:-1]) == lead:
        return t.contiguous(), A
    if t.numel() == A:
        return t.contiguous(), 0
    return t.expand(*lead, A).contiguous(), A


def _pair_out(op: int, lead: Tuple[int, ...], A: int, dev) -> torch.Tensor:
    if op == _GTE:
        return torch.empty(lead, dtype=torch.bool, device=dev)
    if op == _CMP:
        return torch.empty(lead, dtype=torch.int32, device=dev)
    return torch.empty(*lead, A, dtype=torch.int32, device=dev)


def _row_and_matrix(a: torch.Tensor, b: torch.Tensor) -> bool:
    """One contiguous int32 [A] row against a contiguous int32 [R, A]
    matrix on one GPU, either side: the dominated scan's shape."""
    return (a.ndim + b.ndim == 3 and a.dtype == torch.int32
            and b.dtype == torch.int32 and a.device == b.device
            and a.device.type == "cuda" and a.shape[-1] == b.shape[-1]
            and a.is_contiguous() and b.is_contiguous())


def _launch_pair(op, a_ptr, b_ptr, a_stride, b_stride, R, A, query,
                 query_side, out, host_out, dev) -> None:
    fn = kernel_fn("clock_pair")
    with launch_scope(dev):
        rc = fn(a_ptr, b_ptr, a_stride, b_stride, R, A, op, query,
                query_side, out.data_ptr(), host_out, launch_stream(dev))
    _launched("clock_pair", rc)


def pair_cuda(op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """clock_pair.cu: one pairwise op over [..., A] int32 operands on one
    GPU (leading dims broadcast; a broadcast [A] row is read in place).
    One [A] row against a contiguous [R, A] matrix, the main path's
    shape, goes straight to the launch."""
    if _row_and_matrix(a, b):
        A = a.shape[-1]
        R = a.shape[0] if a.ndim == 2 else b.shape[0]
        out = _pair_out(op, (R,), A, a.device)
        if out.numel():
            _launch_pair(op, a.data_ptr(), b.data_ptr(),
                         A if a.ndim == 2 else 0, A if b.ndim == 2 else 0,
                         R, A, None, 0, out, None, a.device)
        return out
    if a.ndim < 1 or b.ndim < 1 or b.shape[-1] != a.shape[-1]:
        raise ValueError(f"clock operands {tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"clock operands span devices: {a.device} != {b.device}")
    A = a.shape[-1]
    lead = tuple(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
    a, a_stride = _operand(a, lead, A)
    b, b_stride = _operand(b, lead, A)
    _check(a, "a", torch.int32, tuple(a.shape))
    _check(b, "b", torch.int32, tuple(b.shape))
    out = _pair_out(op, lead, A, a.device)
    if out.numel():
        _launch_pair(op, a.data_ptr(), b.data_ptr(), a_stride, b_stride,
                     math.prod(lead), A, None, 0, out, None, a.device)
    return out


def pair_query_cuda(op: int, query: np.ndarray, m: torch.Tensor,
                    query_side: int = 0, to_host: bool = False):
    """clock_pair.cu with its broadcast row in host memory: op over the
    int32 [A] `query` (operand a when query_side is 0, else b) and every
    row of the contiguous int32 [R, A] matrix m on a GPU. The query
    travels in the launch's parameters when A is at most
    launch_cap("clock_pair") ints (4,096 under CUDA 12.1 and later), else
    it is uploaded and read from the device. to_host: the result comes
    back as a numpy array (a copy), which the C entry copied into this
    thread's pinned buffer (crdt_kernels.result_buffers) before it waited
    for the stream; else a tensor on m's card."""
    if m.ndim != 2:
        raise ValueError(f"clock_pair over a {tuple(m.shape)} matrix")
    R, A = m.shape
    _check(m, "m", torch.int32, (R, A))
    if query_side not in (0, 1):
        raise ValueError(f"query_side {query_side}: expected 0 (a) or 1 (b)")
    if (not isinstance(query, np.ndarray) or query.dtype != np.int32
            or query.shape != (A,) or not query.flags.c_contiguous):
        raise ValueError(f"query: expected a C-contiguous int32 numpy [{A}]")
    dev = m.device
    lead = (R,) if op in (_GTE, _CMP) else (R, A)
    n = math.prod(lead)
    if to_host:  # int32 buffers: a gte verdict takes a byte
        buf, host = result_buffers.get(dev, -(-n // 4) if op == _GTE else n)
    else:
        buf = _pair_out(op, (R,), A, dev)
    if R:
        q = None
        if A <= launch_cap("clock_pair"):
            qptr, qdev = query.ctypes.data, None
        else:  # wider than the launch's parameters hold: read from the card
            q = torch.from_numpy(query).to(dev)
            qptr, qdev = None, q.data_ptr()
        a_ptr, b_ptr = (qdev, m.data_ptr()) if query_side == 0 else (
            m.data_ptr(), qdev)
        a_stride, b_stride = (0, A) if query_side == 0 else (A, 0)
        _launch_pair(op, a_ptr, b_ptr, a_stride, b_stride, R, A, qptr,
                     query_side, buf, host.data_ptr() if to_host else None,
                     dev)
    if to_host:
        res = host.numpy().view(np.bool_) if op == _GTE else host.numpy()
        return res[:n].reshape(lead).copy()
    return buf


def _column_reduce_cuda(clocks: torch.Tensor, op: int, name: str) -> torch.Tensor:
    if clocks.ndim != 2 or clocks.shape[0] < 1:
        raise ValueError(f"{name} of a {tuple(clocks.shape)} matrix")
    D, A = clocks.shape
    _check(clocks, "clocks", torch.int32, (D, A))
    dev = clocks.device
    out = torch.empty(A, dtype=torch.int32, device=dev)
    if A == 0:
        return out
    fn = kernel_fn("clock_union")
    with launch_scope(dev):
        rc = fn(clocks.data_ptr(), D, A, op, out.data_ptr(), launch_stream(dev))
    _launched(name, rc)
    return out


def union_reduce_cuda(clocks: torch.Tensor) -> torch.Tensor:
    """clock_union.cu: [D, A] -> [A] column max on one GPU (D >= 1)."""
    return _column_reduce_cuda(clocks, _MAX, "clock_union")


def min_reduce_cuda(clocks: torch.Tensor) -> torch.Tensor:
    """clock_union.cu in its min mode: [D, A] -> [A] column min on one GPU
    (D >= 1); counted as `clock_union_min`."""
    return _column_reduce_cuda(clocks, _MIN, "clock_union_min")


def _check_matrix(m: torch.Tensor) -> None:
    if (m.ndim != 2 or m.device.type != "cuda" or m.dtype != torch.int32
            or not m.is_contiguous()):
        raise ValueError(
            f"scatter_max into a {m.dtype} {tuple(m.shape)} tensor on "
            f"{m.device}: expected a contiguous int32 matrix on a GPU")


def scatter_max_cuda_(
    m: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor
) -> torch.Tensor:
    """clock_scatter.cu: the scatter-max of n triples on m's card into m,
    in place."""
    _check_matrix(m)
    n = rows.shape[0]
    for name, t in (("rows", rows), ("cols", cols), ("vals", vals)):
        if (t.device != m.device or t.dtype != torch.int32
                or t.shape != (n,) or not t.is_contiguous()):
            raise ValueError(
                f"{name}: expected contiguous int32 [{n}] on {m.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if n == 0:
        return m
    dev = m.device
    fn = kernel_fn("clock_scatter")
    with launch_scope(dev):
        rc = fn(m.data_ptr(), m.shape[0], m.shape[1], rows.data_ptr(),
                cols.data_ptr(), vals.data_ptr(), n, launch_stream(dev))
    _launched("clock_scatter", rc)
    return m


# the triples one launch of clock_scatter.cu's parameter route takes under
# the oldest toolkit (its 4,096-byte parameter limit); above this the
# wrapper reads the source's own cap to count the launches
SCATTER_PARAM_TRIPLES_MIN = 256


def scatter_max_params_cuda_(
    m: torch.Tensor, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray
) -> torch.Tensor:
    """clock_scatter.cu's parameter route: n triples in host memory
    scatter-maxed into m, in place, with no upload. The C entry copies
    them into the launches' parameters (launch_cap("clock_scatter")
    triples a launch, 2,048 under CUDA 12.1 and later, each launch in the
    smallest struct that holds them) before it returns, so the arrays
    need only live through the call."""
    _check_matrix(m)
    n = len(rows)
    for name, a in (("rows", rows), ("cols", cols), ("vals", vals)):
        if (not isinstance(a, np.ndarray) or a.dtype != np.int32
                or a.shape != (n,) or not a.flags.c_contiguous):
            raise ValueError(
                f"{name}: expected a C-contiguous int32 numpy array of {n}")
    if n == 0:
        return m
    dev = m.device
    fn = kernel_fn("clock_scatter_params")
    with launch_scope(dev):
        rc = fn(m.data_ptr(), m.shape[0], m.shape[1], rows.ctypes.data,
                cols.ctypes.data, vals.ctypes.data, n, 0, launch_stream(dev))
    per_launch = (n if n <= SCATTER_PARAM_TRIPLES_MIN
                  else launch_cap("clock_scatter"))
    _launched("clock_scatter", rc, -(-n // per_launch))
    return m


def topk_plan(D: int, k: int, tile: int = TOPK_TILE,
              merge_max: int = TOPK_MERGE_MAX) -> Tuple[str, int]:
    """(route, scratch keys) of clock_topk.cu over D rows: "select" with
    the tiles' tiles x k_pad candidates (k_pad: k rounded up to a power of
    two) when k_pad is at most a tile and the candidates fit one block's
    merge, else "sort", the large-k route, with P keys (the tiles' rows
    rounded up to a power of two; at least two tiles)."""
    tiles = -(-D // tile)
    k_pad = round_up_pow2(max(k, 1))
    if k_pad <= tile and round_up_pow2(tiles * k_pad) <= merge_max:
        return "select", tiles * k_pad
    return "sort", round_up_pow2(tiles * tile)


def top_k_dominated_cuda(
    clocks: torch.Tensor, query: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """clock_topk.cu: (scores [k], indices [k]) int32 on one GPU. Scratch
    is only the route's int64 keys (`topk_plan`)."""
    if clocks.ndim != 2 or clocks.shape[0] < 1:
        raise ValueError(f"top_k_dominated over a {tuple(clocks.shape)} matrix")
    D, A = clocks.shape
    if not 0 <= k <= D:
        raise ValueError(f"top_k_dominated: k={k} outside [0, {D}]")
    _check(clocks, "clocks", torch.int32, (D, A))
    _check(query, "query", torch.int32, (A,))
    dev = clocks.device
    if query.device != dev:
        raise ValueError(f"query on {query.device}, clocks on {dev}")
    route, n_keys = topk_plan(D, k)
    keys = torch.empty(n_keys, dtype=torch.int64, device=dev)
    scores, idx = torch.empty(2, k, dtype=torch.int32, device=dev)
    fn = kernel_fn("clock_topk")
    with launch_scope(dev):
        rc = fn(clocks.data_ptr(), D, A, query.data_ptr(), k, TOPK_TILE,
                TOPK_THREADS, _TOPK_ROUTE[route], keys.data_ptr(), n_keys,
                scores.data_ptr(), idx.data_ptr(), launch_stream(dev))
    _launched("clock_topk", rc)
    return scores, idx


# ---------------------------------------------------------------------------
# entries: the kernel for GPU tensors, the plain version for CPU tensors


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _pair(op: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _on_cuda(a) or _on_cuda(b):
        return pair_cuda(op, a, b)
    return _PLAIN_PAIR[op](a, b)


def gte(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: [..., actors] -> [...] bool. a dominates b elementwise."""
    return _pair(_GTE, a, b)


def cmp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., actors] x [..., actors] -> [...] int32 code (EQ/GT/LT/CONCUR)."""
    return _pair(_CMP, a, b)


def union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _pair(_UNION, a, b)


def intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _pair(_INTERSECTION, a, b)


def satisfied(clock: torch.Tensor, minimum: torch.Tensor) -> torch.Tensor:
    """minimumClock render gate (reference src/DocBackend.ts:90-113):
    clock [..., actors] >= minimum [..., actors] -> [...] bool."""
    return _pair(_GTE, clock, minimum)


def gte_host(query: np.ndarray, m: torch.Tensor) -> np.ndarray:
    """The dominated scan: all(query >= m[r]) for every row r of the
    [R, A] matrix m, as a numpy bool [R]. query: int32 numpy [A]. On a
    GPU the query travels in the launch's parameters and the verdicts
    come back through this thread's pinned buffer (`pair_query_cuda`);
    on the CPU the plain version runs on a tensor of the same array."""
    if _on_cuda(m):
        return pair_query_cuda(_GTE, query, m, 0, to_host=True)
    return gte_plain(torch.from_numpy(np.asarray(query, np.int32)), m).numpy()


def gte_row(query: np.ndarray, m: torch.Tensor) -> torch.Tensor:
    """gte_host's verdicts left where m lies: a bool [R] tensor on m's
    device (the query still by value on a GPU)."""
    if _on_cuda(m):
        return pair_query_cuda(_GTE, query, m, 0)
    return gte_plain(torch.from_numpy(np.asarray(query, np.int32)), m)


def cursor_window(doc_seqs: torch.Tensor, cursor_seqs: torch.Tensor) -> torch.Tensor:
    """Change-window computation of RepoBackend.syncChanges (reference
    src/RepoBackend.ts:513-522): per (doc, actor), how many new changes the
    cursor admits beyond what the doc already holds.

    doc_seqs, cursor_seqs: [..., actors] -> [..., actors] int32 counts.
    """
    return _pair(_CURSOR_WINDOW, doc_seqs, cursor_seqs)


def union_reduce(clocks: torch.Tensor) -> torch.Tensor:
    """[n, actors] -> [actors]: union of many clocks in one reduction —
    the ClockStore.getMultiple + Clock.union fold as a single max-reduce."""
    if _on_cuda(clocks):
        return union_reduce_cuda(clocks)
    return union_reduce_plain(clocks)


def min_reduce(clocks: torch.Tensor) -> torch.Tensor:
    """[n, actors] -> [actors]: the column min, the fold of a pmin."""
    if _on_cuda(clocks):
        return min_reduce_cuda(clocks)
    return min_reduce_plain(clocks)


def scatter_max_(
    m: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor
) -> torch.Tensor:
    """The mirror's batched writes: m.at[rows, cols].max(vals), in place
    (the port owns its matrix). Returns m."""
    if _on_cuda(m):
        return scatter_max_cuda_(m, rows, cols, vals)
    return scatter_max_plain_(m, rows, cols, vals)


def scatter_max_host_(
    m: torch.Tensor, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray
) -> torch.Tensor:
    """The mirror's flush: m.at[rows, cols].max(vals), in place, from
    int32 numpy triples. On a GPU the triples travel in the kernel's
    launch parameters; on the CPU the plain version runs on tensors made
    from the same arrays. Returns m."""
    if _on_cuda(m):
        return scatter_max_params_cuda_(m, rows, cols, vals)
    return scatter_max_plain_(
        m, *(torch.from_numpy(np.asarray(a, np.int32)) for a in (rows, cols, vals)))


def top_k_dominated(
    clocks: torch.Tensor, query: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bulk query: indices of up to k docs whose clock is dominated by
    `query` — the device form of 'which docs are fully covered by this
    cursor'. clocks: [docs, actors]; query: [actors]."""
    if _on_cuda(clocks):
        return top_k_dominated_cuda(clocks, query, k)
    if not 0 <= k <= clocks.shape[0]:
        raise ValueError(f"top_k_dominated: k={k} outside [0, {clocks.shape[0]}]")
    return top_k_dominated_plain(clocks, query, k)


def host_clocks(rows) -> np.ndarray:
    """Host rows (crdt.clock.pack output) -> an int32 numpy array, clamped
    to INT32_INF."""
    return np.minimum(np.asarray(rows, dtype=np.int64), INT32_INF).astype(np.int32)


def pack_clocks(rows, device: DeviceLike = None) -> torch.Tensor:
    """Host rows (crdt.clock.pack output) -> an int32 tensor on `device`
    (cuda unless asked otherwise), clamped to INT32_INF on the host and
    uploaded once."""
    return torch.from_numpy(host_clocks(rows)).to(resolve(device))
