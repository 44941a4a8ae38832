"""Batched CRDT materialization on the GPU — the port of
hypermerge_tpu/ops/crdt_kernels.py.

For a whole batch of documents at once this computes everything a full
replay of each document's history produces, over the columnar encoding
(ops/columnar.py):

1. supersession: pred edges scatter a `dead` mask (observed-remove)
2. counter totals: INC deltas segment-sum onto live counter ops
3. LWW map winners: lexsort by (group, lamport) + run boundaries
4. element values: winner value op per list element (scatter-max)
5. RGA element order: one forest over all list/text objects — sibling
   sort (parent asc, OpId desc), preorder successor by a pointer-doubling
   climb, Wyllie list ranking for positions
6. per-doc vector clock (scatter-max of seq per local actor slot)

and then packs the bulk summary of those lanes into one uint8 wire row
per document (`summary_wire_spec`).

Two functions carry the work, each in two versions:

- `materialize_device` (the reference's `_doc_kernel` + `_widen`):
  CUDA kernel `kernels/csrc/doc_kernel.cu` for tensors on the GPU,
  `doc_kernel_plain` for tensors on the CPU;
- `summarize_wire` (the reference's `_summarize_wire`): CUDA kernel
  `kernels/csrc/summary_wire.cu`, or `summarize_wire_plain`.

The slab dispatch, `materialize_with_wire`, runs both: on the card in one
launch of doc_kernel.cu whenever it takes a one-block route (the wire is
that launch's epilogue, `kernels/csrc/summary_wire.cuh`), else as the
two kernels in turn.

Which one runs follows only from where the tensors lie. A GPU tensor
never reaches the plain version: the kernel launches, or the wrapper
raises. The plain versions mirror the reference op for op (stable sorts
chained for `lexsort`, `scatter_reduce("amax")` for `.at[].max`) and are
held equal to it in tests/test_torch_kernels.py.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..analysis.lockdep import make_lock
from ..crdt.change import Action
from ..device import DeviceLike, resolve
from .columnar import PAD, ColumnarBatch, doc_actor_map_from_pairs, round_up_pow2

_SET = int(Action.SET)
_INC = int(Action.INC)
_MAKE_LIST = int(Action.MAKE_LIST)
_MAKE_TEXT = int(Action.MAKE_TEXT)
_INT32_MAX = 2**31 - 1


class MaterializeOut(NamedTuple):
    """Per-row outputs, shape [D, N] unless noted."""

    dead: torch.Tensor  # bool: superseded by some pred edge
    visible: torch.Tensor  # bool: value op (SET/MAKE) still visible
    map_winner: torch.Tensor  # bool: the winning visible op of its (obj, key)
    elem_winner: torch.Tensor  # bool: winning visible value op of its element
    elem_live: torch.Tensor  # bool (INS rows): element has a visible value
    rank: torch.Tensor  # int32: RGA order key (higher = earlier in list)
    inc_total: torch.Tensor  # int32: accumulated INC deltas per value op
    clock: torch.Tensor  # [D, A] int32 vector clock


def _ceil_log2(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path; the yardstick the kernels are held to)


def widen_plain(flags, slot, ctr, seq, obj, key, ref, value, psrc, ptgt):
    """Narrow wire dtypes -> int32 lanes (uint8 flags = action|insert<<3).
    `seq`/`value` may be None (lean runs): they become zeros."""
    i32 = torch.int32
    action = (flags & 7).to(i32)
    insert = ((flags >> 3) & 1).to(i32)
    zeros = torch.zeros(flags.shape, dtype=i32, device=flags.device)
    return (
        action, slot.to(i32), ctr.to(i32),
        zeros if seq is None else seq.to(i32),
        obj.to(i32), key.to(i32), ref.to(i32), insert,
        zeros if value is None else value.to(i32),
        psrc.to(i32), ptgt.to(i32),
    )


def _lexsort(keys) -> torch.Tensor:
    """Row-wise `jnp.lexsort` (last key primary) as chained stable sorts:
    [D, N] int64 permutation."""
    order = None
    for k in keys:
        if order is None:
            order = torch.argsort(k, dim=1, stable=True)
        else:
            sub = torch.argsort(k.gather(1, order), dim=1, stable=True)
            order = order.gather(1, sub)
    return order


def doc_kernel_plain(
    action, slot, ctr, seq, obj, key, ref, insert, value, psrc, ptgt,
    doc_actors, *, A: int, K: int,
) -> MaterializeOut:
    """The reference `_doc_kernel`, batched over the leading doc axis
    (int32 [D, N] lanes, pred edges [D, P]). `psrc` and `doc_actors` are
    taken for signature parity and not read, as in the reference."""
    del psrc, doc_actors
    D, N = action.shape
    dev = action.device
    i32 = torch.int32
    idx = torch.arange(N, dtype=i32, device=dev).expand(D, N)
    valid = action != PAD
    is_make = (action <= 3) & valid
    is_set = (action == _SET) & valid
    is_ins = (insert == 1) & valid

    def col(fill, dtype=i32):
        return torch.full((D, 1), fill, dtype=dtype, device=dev)

    # -- 1. supersession ------------------------------------------------
    tgt = torch.where(ptgt >= 0, ptgt, N).long()
    dead = torch.zeros(D, N + 1, dtype=torch.bool, device=dev).scatter_(
        1, tgt, torch.ones_like(tgt, dtype=torch.bool)
    )[:, :N]
    visible = (is_make | is_set) & ~dead

    # -- 2. counter increments -----------------------------------------
    is_inc = (action == _INC) & valid
    inc_tgt = ref.clamp(0, N - 1).long()
    inc_ok = is_inc & (ref >= 0) & ~dead.gather(1, inc_tgt)
    inc_total = torch.zeros(D, N + 1, dtype=i32, device=dev).scatter_add_(
        1, torch.where(inc_ok, inc_tgt, N), torch.where(inc_ok, value, 0)
    )[:, :N]

    # -- 3. LWW map winners --------------------------------------------
    in_map = visible & (key >= 0)
    gid = torch.where(in_map, (obj + 1) * (K + 1) + (key + 1), 0)
    order = _lexsort((slot, ctr, gid))
    g_sorted = gid.gather(1, order)
    run_end = torch.cat(
        [g_sorted[:, 1:] != g_sorted[:, :-1], col(True, torch.bool)], 1
    )
    winner_sorted = run_end & (g_sorted > 0)
    map_winner = torch.zeros(D, N, dtype=torch.bool, device=dev).scatter_(
        1, order, winner_sorted
    )

    # -- 4. element values: winner per element -------------------------
    comp = ctr * A + slot + 1
    is_elem_update = visible & ~is_ins & (key < 0) & (ref >= 0)
    own_value = visible & is_ins
    contrib = is_elem_update | own_value
    elem_of = torch.where(
        is_elem_update, ref, torch.where(own_value, idx, N)
    ).long()
    best = torch.zeros(D, N + 1, dtype=i32, device=dev).scatter_reduce_(
        1, elem_of, torch.where(contrib, comp, 0), "amax", include_self=True
    )[:, :N]
    elem_live = is_ins & (best > 0)
    elem_winner = contrib & (comp == best.gather(1, elem_of.clamp(0, N - 1)))

    # -- 5. RGA forest order -------------------------------------------
    is_seq_container = (
        (action == _MAKE_LIST) | (action == _MAKE_TEXT)
    ) & valid
    in_forest = is_ins | is_seq_container
    parent = torch.where(is_ins, torch.where(ref == -2, obj, ref), -1)
    pa = torch.where(in_forest, parent + 1, N + 1)
    inv = (1 << 30) - comp
    order2 = _lexsort((inv, pa))
    pa_s = pa.gather(1, order2)
    run_start = torch.cat(
        [col(True, torch.bool), pa_s[:, 1:] != pa_s[:, :-1]], 1
    )
    fc_table = torch.full((D, N + 2), -1, dtype=i32, device=dev).scatter_(
        1,
        torch.where(run_start, pa_s, N + 1).long(),
        torch.where(run_start, order2, -1).to(i32),
    )
    first_child = fc_table[:, 1 : N + 1]  # children of i have pa == i+1
    nxt_in_sort = torch.cat([order2[:, 1:], col(-1, torch.int64)], 1)
    same_parent = torch.cat(
        [pa_s[:, 1:] == pa_s[:, :-1], col(False, torch.bool)], 1
    )
    nsib = torch.full((D, N), -1, dtype=i32, device=dev).scatter_(
        1, order2, torch.where(same_parent, nxt_in_sort, -1).to(i32)
    )

    # climb-to-sibling fixpoint via pointer doubling (terminal = N); the
    # reference's int16-payload variant computes the same values
    has_sib = nsib != -1
    jump = torch.where(has_sib, idx, torch.where(parent >= 0, parent, N))
    jump = torch.where(in_forest, jump, N)
    jump_ext = torch.cat([jump, col(N)], 1).long()
    rounds = _ceil_log2(N) + 1
    for _ in range(rounds):
        jump_ext = jump_ext.gather(1, jump_ext)
    fix = jump_ext[:, :N]
    nsib_ext = torch.cat([nsib, col(-1)], 1)
    succ = torch.where(first_child != -1, first_child, nsib_ext.gather(1, fix))
    succ = torch.where(in_forest, succ, -1)
    nxt = torch.where(succ == -1, N, succ)

    # Wyllie list ranking: rank = #nodes from here to end of chain (the
    # reference's packed rank|nxt variant computes the same values)
    rank_ext = torch.cat([in_forest.to(i32), col(0)], 1)
    nxt_ext = torch.cat([nxt, col(N)], 1).long()
    for _ in range(rounds):
        rank_ext = rank_ext + rank_ext.gather(1, nxt_ext)
        nxt_ext = nxt_ext.gather(1, nxt_ext)
    rank = rank_ext[:, :N]

    # -- 6. clock (local slots; [A], decoded via doc_actors) -----------
    clock = torch.zeros(D, A, dtype=i32, device=dev).scatter_reduce_(
        1,
        torch.where(valid, slot, 0).long(),
        torch.where(valid, seq, 0),
        "amax",
        include_self=True,
    )

    return MaterializeOut(
        dead=dead.contiguous(),
        visible=visible,
        map_winner=map_winner,
        elem_winner=elem_winner,
        elem_live=elem_live,
        rank=rank.contiguous(),
        inc_total=inc_total.contiguous(),
        clock=clock,
    )


# ---------------------------------------------------------------------------
# summary wire: ONE fused uint8 buffer per slab
#
# The wire packs the bulk summary into a single [D, W] uint8 buffer: masks
# bit-packed, elem_order at exactly `order_bits` bits per entry, counts at
# int16 when N allows, and the clock section omitted on lean runs (the
# caller holds authoritative host clocks). Host decode: parse_summary_wire.


def summary_wire_spec(N: int, A: int, lean: bool) -> Dict[str, int]:
    """Byte layout of the [D, W] summary wire buffer."""
    mask_bytes = (N + 7) // 8
    order_bits = max(1, (N - 1).bit_length())
    if order_bits > 25:
        # _unpack_uint reads one 32-bit window per value: shift (<=7) +
        # order_bits must fit it
        raise ValueError(
            f"summary wire bucket too large: N={N} needs "
            f"{order_bits}-bit order entries, max 25 (N <= 2^25)"
        )
    order_bytes = (N * order_bits + 7) // 8
    count_bytes = 2 if N < 2**15 else 4
    clock_bytes = 0 if lean else 4 * A
    return {
        "mask_bytes": mask_bytes,
        "order_bits": order_bits,
        "order_bytes": order_bytes,
        "count_bytes": count_bytes,
        "clock_bytes": clock_bytes,
        "total": 2 * mask_bytes + order_bytes + 2 * count_bytes
        + clock_bytes,
    }


def _pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """[D, N] bool/0-1 -> [D, ceil(N/8)] uint8, little bit order (numpy
    np.unpackbits(..., bitorder='little') inverts it exactly)."""
    D, N = mask.shape
    m = torch.nn.functional.pad(mask.to(torch.uint8), (0, (-N) % 8))
    weights = torch.tensor(
        [1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8, device=mask.device
    )
    return (m.reshape(D, -1, 8) * weights).sum(-1).to(torch.uint8)


def _pack_uint(vals: torch.Tensor, bits: int) -> torch.Tensor:
    """[D, N] ints in [0, 2^bits) -> [D, ceil(N*bits/8)] uint8: each
    value at exactly `bits` bits, little bit order throughout."""
    D, N = vals.shape
    shifts = torch.arange(bits, dtype=torch.int32, device=vals.device)
    bitmat = ((vals.to(torch.int32)[..., None] >> shifts) & 1).reshape(
        D, N * bits
    )
    return _pack_bits(bitmat)


def _le_bytes(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """[D, k] ints -> [D, k*nbytes] uint8, little-endian per element."""
    xi = x.to(torch.int32)
    parts = [((xi >> (8 * i)) & 0xFF).to(torch.uint8) for i in range(nbytes)]
    return torch.stack(parts, dim=-1).reshape(x.shape[0], -1)


def summarize_wire_plain(
    out: MaterializeOut, N: int, A: int, lean: bool
) -> torch.Tensor:
    spec = summary_wire_spec(N, A, lean)
    order_key = torch.where(out.elem_live, -out.rank, _INT32_MAX)
    elem_order = torch.argsort(order_key, dim=1, stable=True).to(torch.int32)
    cb = spec["count_bytes"]
    parts = [
        _pack_bits(out.map_winner),
        _pack_bits(out.elem_live),
        _pack_uint(elem_order, spec["order_bits"]),
        _le_bytes(out.elem_live.sum(dim=1, dtype=torch.int32)[:, None], cb),
        _le_bytes(out.map_winner.sum(dim=1, dtype=torch.int32)[:, None], cb),
    ]
    if not lean:
        parts.append(_le_bytes(out.clock, 4))
    return torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
#
# Each wrapper checks what its kernel takes, allocates outputs and scratch
# with torch.empty, launches on the current stream, raises on a non-zero
# cudaGetLastError, and adds one to `launches[name]` per launch (an entry
# that splits a batch over several launches counts each).

launches: Dict[str, int] = {
    "materialize": 0, "materialize_wire": 0, "materialize_live": 0,
    "summary_wire": 0,
    "pack_prefix": 0,
    "clock_pair": 0, "clock_union": 0, "clock_scatter": 0, "clock_topk": 0,
    "serve_lookup": 0, "serve_order": 0, "serve_counts": 0,
    "clock_union_min": 0, "ring_gather": 0,
}
_launches_lock = make_lock("kernels.launches")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # source stem -> (C symbol, argtypes)
    "doc_kernel": (
        "hm_materialize", [_P] * 9 + [_I] * 7 + [_P] * 11 + [_I] * 6 + [_P]
    ),
    "doc_route": ("hm_doc_route", [_I] * 3),
    "summary_wire": ("hm_summary_wire", [_P] * 4 + [_I] * 9 + [_P] * 3),
    # wrapper in ops/pack_kernels.py: 12 source planes, their codes, the
    # per-doc vectors and LUTs, shapes, 13 output lanes, the ranges
    "pack_prefix": (
        "hm_pack_prefix", [_P] * 12 + [_I] + [_P] * 8 + [_I] * 9 + [_P] * 16
    ),
    # wrappers in ops/clock_kernels.py
    "clock_pair": ("hm_clock_pair", [_P] * 2 + [_I] * 5 + [_P, _I] + [_P] * 3),
    "clock_union": ("hm_clock_union", [_P] + [_I] * 3 + [_P] * 2),
    "clock_scatter": (
        "hm_clock_scatter", [_P] + [_I] * 2 + [_P] * 3 + [_I, _P]
    ),
    # the same source's entry for triples in host memory
    "clock_scatter_params": (
        "hm_clock_scatter_params", [_P] + [_I] * 2 + [_P] * 3 + [_I] * 2 + [_P]
    ),
    "clock_topk": (
        "hm_clock_topk",
        [_P] + [_I] * 2 + [_P] + [_I] * 4 + [_P, ctypes.c_longlong] + [_P] * 3,
    ),
    # wrappers in serve/kernels.py
    "serve_lookup": ("hm_serve_lookup", [_P] * 3 + [_I] * 3 + [_P] * 3),
    "serve_order": (
        "hm_serve_order",
        [_P] * 2 + [_I] * 4 + [_P, ctypes.c_longlong] + [_P] * 3,
    ),
    "serve_counts": ("hm_serve_counts", [_P] * 2 + [_I] * 3 + [_P] * 3),
    # wrapper in parallel/ring.py
    "ring_gather": (
        "hm_ring_gather",
        [_P] * 3 + [_I] * 3 + [ctypes.c_longlong, _I, ctypes.c_longlong]
        + [_I] * 4 + [_P],
    ),
}
# entries of a source besides its main one: name -> source stem
_STEMS = {"clock_scatter_params": "clock_scatter", "doc_route": "doc_kernel"}
# per-launch caps each source reports (its C entry hm_<stem>_cap)
_CAP_SYMBOLS = {
    "clock_pair": ("hm_clock_pair_cap", [_I]),
    "summary_wire": ("hm_summary_wire_cap", [_I]),
    "pack_prefix": ("hm_pack_prefix_cap", [_I]),
    "clock_scatter": ("hm_clock_scatter_params_cap", [_I]),
    "serve_lookup": ("hm_serve_lookup_cap", [_I]),
    "serve_order": ("hm_serve_order_cap", [_I]),
    "serve_counts": ("hm_serve_counts_cap", [_I]),
}
_fns: Dict[str, ctypes._CFuncPtr] = {}
_caps: Dict[tuple, int] = {}
# int32 scratch lanes of [N + 2] per doc used by doc_kernel.cu (kLanes)
_DOC_SCRATCH_LANES = 8
# doc_kernel.cu's routes: picked by the source (hm_doc_route); one block
# per doc (its scratch in shared memory where the doc fits, else global);
# the many-block route's grid-wide launches; one block per doc with its
# scratch in global memory
(DOC_ROUTE_AUTO, DOC_ROUTE_ONE_BLOCK, DOC_ROUTE_MANY_BLOCK,
 DOC_ROUTE_ONE_BLOCK_GLOBAL) = 0, 1, 2, 3
_WIRE_INT_DTYPES = (torch.int8, torch.int16, torch.int32)
# the routes hm_doc_route resolved, by (device index, D, N, route asked)
_doc_routes: Dict[tuple, int] = {}


class _ResultBuffers(threading.local):
    """Each calling thread's int32 result buffers, by device: the device
    output and the pinned host copy the C entry writes it into, shared by
    serve_lookup, serve_order, serve_counts and clock_pair's host route.
    Reused while they are large enough, replaced by ones twice the size
    otherwise. Every dispatch syncs before it returns, so no copy is in
    flight when the next dispatch of the thread, of any kind, reuses
    them."""

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


result_buffers = _ResultBuffers()


def kernel_fn(name: str):
    """The bound C entry `name` (a source stem, or an entry of `_STEMS`),
    its source built at first use."""
    fn = _fns.get(name)
    if fn is None:
        from ..kernels._build import load

        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(load(_STEMS.get(name, name)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def launch_cap(stem: str, which: int = 0) -> int:
    """A cap the source `stem` was compiled with, read once from its C
    entry hm_<stem>..._cap(which). which = 0: the most triples or entries
    one launch passes by value (they follow the toolkit's parameter
    limit), summary_wire's: the keys a doc sorts in shared memory;
    clock_scatter's 1: the triples of its middle struct; serve_order's 1:
    the keys it sorts in shared memory."""
    cap = _caps.get((stem, which))
    if cap is None:
        from ..kernels._build import load

        symbol, argtypes = _CAP_SYMBOLS[stem]
        fn = getattr(load(stem), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        cap = _caps[(stem, which)] = int(fn(which))
    return cap


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _launched(name: str, rc: int, n: int = 1) -> None:
    """Count n launches of `name`, or raise if its entry returned an
    error. Wrappers launch from several threads (the pipeline's pack
    pool), so the count is taken under a lock."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")
    with _launches_lock:
        launches[name] += n


def launch_stream(dev: torch.device) -> int:
    """The current stream of CUDA device `dev` as a raw handle, read
    without building a torch Stream object (which costs a few
    microseconds of host time a call)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def launch_scope(dev: torch.device):
    """Make CUDA device `dev` current for a launch: torch.cuda.device(dev),
    or nothing when it already is."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def doc_route(D: int, N: int, dev: torch.device,
              route: int = DOC_ROUTE_AUTO) -> int:
    """The route (DOC_ROUTE_*) doc_kernel.cu takes for D docs of N rows on
    CUDA device `dev` when asked for `route`, read once per shape from the
    source (hm_doc_route); -1 for a shape it does not take."""
    k = (dev.index, D, N, route)
    got = _doc_routes.get(k)
    if got is None:
        with launch_scope(dev):
            got = _doc_routes[k] = int(kernel_fn("doc_route")(D, N, route))
    return got


# the eight lanes doc_kernel.cu reads, in its order
_DOC_LANES = ("slot", "ctr", "seq", "obj", "key", "ref", "value", "ptgt")


def _doc_launch(
    flags, slot, ctr, seq, obj, key, ref, value, psrc, ptgt, doc_actors,
    A: int, K: int, counter: str, route: int, lean: Optional[bool],
):
    """One dispatch of doc_kernel.cu on the tensors' GPU: (MaterializeOut,
    the [D, W] summary wire or None). The lanes go to the kernel as the
    host narrowed them (int8, int16 or int32 each, contiguous), with no
    copy; `lean` None asks for no wire."""
    D, N = flags.shape
    P = ptgt.shape[1]
    dev = flags.device
    if N < 1 or N & (N - 1):
        raise ValueError(f"row bucket N={N} must be a power of two")
    if D < 1 or P < 1 or A < 1:
        raise ValueError(f"empty doc ({D}), pred ({P}) or actor ({A}) axis")
    _check(flags, "flags", torch.uint8, (D, N))
    row, pred = (D, N), (D, P)
    expected = {
        "slot": (slot, row), "ctr": (ctr, row), "seq": (seq, row),
        "obj": (obj, row), "key": (key, row), "ref": (ref, row),
        "value": (value, row), "psrc": (psrc, pred), "ptgt": (ptgt, pred),
        "doc_actors": (doc_actors, (D, A)),
    }
    for name, (t, shape) in expected.items():
        if t is None:
            continue
        if tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name}: expected {list(shape)} on {dev}")
        if t.dtype not in _WIRE_INT_DTYPES:
            raise ValueError(f"{name}: expected a signed int dtype, got {t.dtype}")
        if name in _DOC_LANES and not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    lanes = (slot, ctr, seq, obj, key, ref, value, ptgt)
    widths = 0
    for k, t in enumerate(lanes):
        widths |= (4 if t is None else t.element_size()) << (4 * k)
    resolved = doc_route(D, N, dev, route)
    if resolved < 0:
        raise ValueError(f"doc_kernel takes no route {route} at [{D}, {N}]")
    if lean is not None and resolved == DOC_ROUTE_MANY_BLOCK:
        raise ValueError(f"the wire rides only a one-block route, not the "
                         f"many-block route at [{D}, {N}]")
    b, i32 = torch.bool, torch.int32
    out = MaterializeOut(
        dead=torch.empty(D, N, dtype=b, device=dev),
        visible=torch.empty(D, N, dtype=b, device=dev),
        map_winner=torch.empty(D, N, dtype=b, device=dev),
        elem_winner=torch.empty(D, N, dtype=b, device=dev),
        elem_live=torch.empty(D, N, dtype=b, device=dev),
        rank=torch.empty(D, N, dtype=i32, device=dev),
        inc_total=torch.empty(D, N, dtype=i32, device=dev),
        clock=torch.empty(D, A, dtype=i32, device=dev),
    )
    # the global scratch only where the route keeps its lanes there
    scratch = keys = None
    if resolved != DOC_ROUTE_ONE_BLOCK:
        scratch = torch.empty(D, _DOC_SCRATCH_LANES, N + 2, dtype=i32, device=dev)
        keys = torch.empty(D, N, dtype=torch.int64, device=dev)
    wire = None
    spec = dict(mask_bytes=0, order_bits=0, order_bytes=0, count_bytes=0,
                total=0)
    if lean is not None:
        spec = summary_wire_spec(N, A, lean)
        wire = torch.empty(D, spec["total"], dtype=torch.uint8, device=dev)
    fn = kernel_fn("doc_kernel")
    with launch_scope(dev):
        rc = fn(
            flags.data_ptr(), *(_ptr(t) for t in lanes), widths,
            D, N, P, A, K, resolved,
            *(t.data_ptr() for t in out), _ptr(scratch), _ptr(keys),
            _ptr(wire), spec["mask_bytes"], spec["order_bits"],
            spec["order_bytes"], spec["count_bytes"], spec["total"],
            int(bool(lean)), launch_stream(dev),
        )
    _launched(counter, rc)
    return out, wire


def materialize_cuda(
    flags, slot, ctr, seq, obj, key, ref, value, psrc, ptgt, doc_actors,
    A: int, K: int, counter: str = "materialize", route: int = DOC_ROUTE_AUTO,
) -> MaterializeOut:
    """Kernel 1 (doc_kernel.cu) over narrow wire args on one GPU. `seq`
    and `value` may be None (lean runs): the kernel reads them as zeros.
    The source picks its route from (D, N) and the card (doc_route): one
    block per doc with its scratch in shared memory where a doc fits
    there; for longer docs, a sequence of grid-wide launches while they
    leave half the SMs idle or more, else one block per doc with its
    scratch in global memory; `route` (DOC_ROUTE_*) forces one, for tests
    and timings. Either way the dispatch counts one launch under `counter`
    (the live tick's entry counts its own)."""
    return _doc_launch(
        flags, slot, ctr, seq, obj, key, ref, value, psrc, ptgt, doc_actors,
        A, K, counter, route, None,
    )[0]


def materialize_wire_cuda(
    flags, slot, ctr, seq, obj, key, ref, value, psrc, ptgt, doc_actors,
    A: int, K: int, lean: bool, route: int = DOC_ROUTE_AUTO,
):
    """Kernels 1 and 2 in one launch: (MaterializeOut, the [D, W] uint8
    summary wire), the wire written by the epilogue of doc_kernel.cu's
    one-block route from the lanes it still holds. Counts one launch under
    `materialize_wire`; raises ValueError where the shape (or `route`)
    takes the many-block route."""
    return _doc_launch(
        flags, slot, ctr, seq, obj, key, ref, value, psrc, ptgt, doc_actors,
        A, K, "materialize_wire", route, lean,
    )


def summary_wire_cuda(
    out: MaterializeOut, N: int, A: int, lean: bool
) -> torch.Tensor:
    """Kernel 2 alone (summary_wire.cu): the [D, W] uint8 summary wire of
    lanes in device memory. A doc's sort keys live in shared memory up to
    the source's cap of rows, in global scratch above."""
    D = out.rank.shape[0]
    if N < 1 or N & (N - 1):
        raise ValueError(f"row bucket N={N} must be a power of two")
    spec = summary_wire_spec(N, A, lean)
    _check(out.map_winner, "map_winner", torch.bool, (D, N))
    _check(out.elem_live, "elem_live", torch.bool, (D, N))
    _check(out.rank, "rank", torch.int32, (D, N))
    if not lean:
        _check(out.clock, "clock", torch.int32, (D, A))
    dev = out.rank.device
    wire = torch.empty(D, spec["total"], dtype=torch.uint8, device=dev)
    scratch = (torch.empty(D, N, dtype=torch.int64, device=dev)
               if N > launch_cap("summary_wire") else None)
    fn = kernel_fn("summary_wire")
    with launch_scope(dev):
        rc = fn(
            out.map_winner.data_ptr(), out.elem_live.data_ptr(),
            out.rank.data_ptr(), None if lean else out.clock.data_ptr(),
            D, N, A, spec["mask_bytes"], spec["order_bits"],
            spec["order_bytes"], spec["count_bytes"], spec["total"],
            int(lean), wire.data_ptr(), _ptr(scratch), launch_stream(dev),
        )
    _launched("summary_wire", rc)
    return wire


# ---------------------------------------------------------------------------
# dispatch: the kernel for GPU tensors, the plain version for CPU tensors


def materialize_device(
    flags, slot, ctr, seq, obj, key, ref, value, psrc, ptgt, doc_actors,
    A: int, K: int, counter: str = "materialize",
) -> MaterializeOut:
    """Batched materialization: all args [D, N] narrow wire dtypes (pred
    edges [D, P], actor map [D, A]); `seq`/`value` may be None. A GPU
    launch counts under `counter`."""
    if flags.device.type == "cuda":
        return materialize_cuda(
            flags, slot, ctr, seq, obj, key, ref, value, psrc, ptgt,
            doc_actors, A, K, counter=counter,
        )
    if flags.device.type != "cpu":
        raise ValueError(f"unsupported device {flags.device}")
    return doc_kernel_plain(
        *widen_plain(flags, slot, ctr, seq, obj, key, ref, value, psrc, ptgt),
        doc_actors, A=A, K=K,
    )


def summarize_wire(
    out: MaterializeOut, N: int, A: int, lean: bool
) -> torch.Tensor:
    if out.rank.device.type == "cuda":
        return summary_wire_cuda(out, N, A, lean)
    if out.rank.device.type != "cpu":
        raise ValueError(f"unsupported device {out.rank.device}")
    return summarize_wire_plain(out, N, A, lean)


def materialize_with_wire(*args, A: int, K: int, lean: bool):
    """The slab dispatch: materialize_device's args -> (MaterializeOut,
    summary wire). On the card one launch wherever doc_kernel.cu takes a
    one-block route, the wire written by its epilogue
    (materialize_wire_cuda), else kernel 1's many-block route and then
    summary_wire.cu; the plain versions for tensors on the CPU."""
    flags = args[0]
    D, N = flags.shape
    if (flags.device.type == "cuda"
            and doc_route(D, N, flags.device) != DOC_ROUTE_MANY_BLOCK):
        return materialize_wire_cuda(*args, A=A, K=K, lean=lean)
    out = materialize_device(*args, A=A, K=K)
    return out, summarize_wire(out, N, A, lean)


def materialize_summary_device(*args, A: int, K: int) -> torch.Tensor:
    """Kernel + summary: the fused summary wire buffer."""
    return materialize_with_wire(*args, A=A, K=K, lean=False)[1]


def materialize_full_device(*args, A: int, K: int):
    """-> (MaterializeOut, summary wire)."""
    return materialize_with_wire(*args, A=A, K=K, lean=False)


def materialize_full_lean_device(
    flags, slot, ctr, obj, key, ref, psrc, ptgt, doc_actors, A: int, K: int
):
    """materialize_full_device minus the seq and value lanes AND minus the
    summary's clock section. Correct ONLY when the batch has no INC ops
    and the caller supplies clocks host-side. inc_total and clock lanes
    come back as zeros."""
    return materialize_with_wire(
        flags, slot, ctr, None, obj, key, ref, None, psrc, ptgt,
        doc_actors, A=A, K=K, lean=True,
    )


LIVE_MIN_ROWS = 64
LIVE_MIN_DOCS = 1


def live_bucket(n: int, floor: int) -> int:
    """Pow2 bucket with a floor: live tick batches pad their row / doc /
    actor-slot / key axes to these shapes (the same bucketing discipline
    as the bulk slab path; the kernel needs a power-of-two row axis)."""
    return max(floor, round_up_pow2(max(n, 1)))


def materialize_live_device(
    flags, slot, ctr, obj, key, ref, value, psrc, ptgt, *, A: int, K: int
) -> MaterializeOut:
    """The live tick entry: materialize_device minus the seq lane and
    the doc-actor map. The live engine holds authoritative clocks
    host-side (admission mirrors OpSet's causal gating), so the clock
    lane is never read — seq is absent and the [D, A] clock comes back
    zeros. `value` still rides along: live batches may carry INC ops.
    Launches count under `materialize_live`."""
    da = torch.zeros(flags.shape[0], A, dtype=torch.int32, device=flags.device)
    return materialize_device(
        flags, slot, ctr, None, obj, key, ref, value, psrc, ptgt, da,
        A=A, K=K, counter="materialize_live",
    )


# ---------------------------------------------------------------------------
# staged uploads: host arrays in one buffer, one copy to the device

_TORCH_DTYPE = {
    np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
}


def aligned_layout(sizes: Sequence[int]) -> Tuple[List[int], int]:
    """(offsets, total bytes) of pieces of `sizes` bytes laid back to back,
    each starting at a 16-byte boundary and padded to the next one (so a
    kernel may read a piece up to the 16 bytes past its end)."""
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += -(-int(n) // 16) * 16
    return offs, max(total, 16)


class Staging:
    """Host arrays of the given (dtype, shape) specs at 16-byte offsets of
    one host buffer, pinned when it is bound for a card (torch's caching
    host allocator reuses such buffers once their copies are done). Fill
    `arrays`, then `upload` moves the whole buffer in one copy."""

    def __init__(self, specs, device: torch.device) -> None:
        self.specs = [(np.dtype(dt), tuple(shape)) for dt, shape in specs]
        sizes = [dt.itemsize * math.prod(shape) for dt, shape in self.specs]
        self.offsets, self.total = aligned_layout(sizes)
        self.host = torch.empty(self.total, dtype=torch.uint8,
                                pin_memory=device.type == "cuda")
        raw = self.host.numpy()
        self.arrays = [
            raw[o : o + n].view(dt).reshape(shape)
            for o, n, (dt, shape) in zip(self.offsets, sizes, self.specs)
        ]

    def upload(self, device: torch.device) -> List[torch.Tensor]:
        """Typed views of the buffer on `device`: one non-blocking copy
        onto a card (on the current stream), the buffer itself on the
        CPU."""
        buf = self.host
        if device.type != "cpu":
            buf = torch.empty(self.total, dtype=torch.uint8, device=device)
            buf.copy_(self.host, non_blocking=True)
        return [
            buf[o : o + dt.itemsize * math.prod(shape)]
            .view(_TORCH_DTYPE[dt]).view(shape)
            for o, (dt, shape) in zip(self.offsets, self.specs)
        ]


def staged_upload(arrays: Sequence[np.ndarray],
                  device: torch.device) -> List[torch.Tensor]:
    """`arrays` on `device` through one Staging buffer and one copy."""
    st = Staging([(a.dtype, a.shape) for a in arrays], device)
    for view, a in zip(st.arrays, arrays):
        view[...] = a
    return st.upload(device)


# ---------------------------------------------------------------------------
# host helpers (copies of the reference's jax-free helpers)


def _unpack_uint(packed, N: int, bits: int):
    """Host-side inverse of _pack_uint: [D, OB] uint8 -> [D, N] int64.
    Each value is one gather of the little-endian 32-bit window at its
    first byte (a strided view of the padded rows: summary_wire_spec keeps
    shift + bits within 32), shifted and masked in place, so the slab's
    decode makes one [D, N] temporary, not a dozen."""
    D, OB = packed.shape
    pk = np.zeros((D, OB + 4), np.uint8)
    pk[:, :OB] = packed
    windows = np.ndarray((D, OB + 1), dtype="<u4", buffer=pk,
                         strides=(pk.strides[0], 1))
    idx = np.arange(N, dtype=np.int64) * bits
    w = windows[:, idx >> 3]
    w >>= (idx & 7).astype(np.uint32)
    w &= (1 << bits) - 1
    return w.astype(np.int64)


def unpack_bits_le(packed, N: int):
    """Host-side inverse of _pack_bits: [D, ceil(N/8)] uint8 -> [D, N]
    bool."""
    return np.unpackbits(
        np.ascontiguousarray(packed), axis=1, bitorder="little"
    )[:, :N].astype(bool)


def parse_summary_wire(wire, N: int, A: int, lean: bool):
    """Host decode of one slab's fused summary buffer (numpy [D, W]) ->
    the columnar summary dict (same keys/values as
    ops.materialize.decode_columnar; the clock comes back zeros on lean
    wires — the caller overlays its authoritative host clocks)."""
    spec = summary_wire_spec(N, A, lean)
    wire = np.asarray(wire)
    D = wire.shape[0]
    if wire.shape[1] != spec["total"]:
        raise ValueError(f"wire width {wire.shape[1]} != {spec['total']}")
    mb = spec["mask_bytes"]
    o = 2 * mb
    ob = spec["order_bytes"]
    elem_order = _unpack_uint(
        np.ascontiguousarray(wire[:, o : o + ob]), N, spec["order_bits"]
    )
    o += ob
    cb = spec["count_bytes"]
    cdt = "<i2" if cb == 2 else "<i4"

    def count(at):
        return (
            np.ascontiguousarray(wire[:, at : at + cb])
            .view(cdt).ravel().astype(np.int64)
        )

    n_live, n_map = count(o), count(o + cb)
    o += 2 * cb
    if lean:
        clock = np.zeros((D, A), np.int32)
    else:
        clock = (
            np.ascontiguousarray(wire[:, o : o + 4 * A])
            .view("<i4").reshape(D, A)
        )
    return {
        "map_winner": unpack_bits_le(wire[:, 0:mb], N),
        "elem_live": unpack_bits_le(wire[:, mb : 2 * mb], N),
        "elem_order": elem_order,
        "n_live_elems": n_live,
        "n_map_entries": n_map,
        "clock": clock,
    }


def ensure_doc_actors(batch: ColumnarBatch):
    """batch.doc_actors, deriving it from the actor column when a producer
    didn't supply one (cached back onto the batch)."""
    if batch.doc_actors is not None:
        return batch.doc_actors
    A = max(1, len(batch.actors))
    D = batch.n_docs
    valid = batch.cols["action"] != PAD
    dcol = np.repeat(np.arange(D, dtype=np.int64), batch.n_rows)
    acol = batch.cols["actor"].astype(np.int64).ravel()
    pairs = np.unique((dcol * A + acol)[valid.ravel()])
    batch.doc_actors = doc_actor_map_from_pairs(pairs, A, D)
    return batch.doc_actors


def bucket_doc_actors(batch: ColumnarBatch):
    """(doc_actors padded to the A_loc bucket, A_loc, K): pow2 buckets
    (A_loc >= 4, K >= 16) so batches of different composition share
    kernel shapes."""
    da = ensure_doc_actors(batch)
    A = max(4, round_up_pow2(da.shape[1]))
    if da.shape[1] < A:
        da = np.concatenate(
            [da, np.full((da.shape[0], A - da.shape[1]), -1, np.int32)],
            axis=1,
        )
    K = max(16, round_up_pow2(max(1, len(batch.keys))))
    return da, A, K


def ensure_slot(batch: ColumnarBatch):
    """[D, N] per-doc LOCAL actor slot per row (int16), derived from the
    global actor column + doc_actors map and cached on the batch."""
    if batch.slot is not None:
        return batch.slot
    da = ensure_doc_actors(batch)
    D, A = da.shape
    stride = max(2, len(batch.actors) + 2)
    docs = np.arange(D, dtype=np.int64)[:, None]
    flat_da = np.where(
        da < 0, stride - 1, da.astype(np.int64)
    ) + docs * stride
    comp = batch.cols["actor"].astype(np.int64) + docs * stride
    slot = (
        np.searchsorted(flat_da.ravel(), comp.ravel())
        - (np.repeat(np.arange(D, dtype=np.int64), batch.n_rows) * A)
    )
    # PAD rows may name an actor outside the doc's set; clamp into [0, A)
    batch.slot = np.clip(slot, 0, A - 1).astype(np.int16).reshape(D, -1)
    return batch.slot


def _narrow(arr, lo: int, hi: int):
    """Smallest safe wire dtype for values known to lie in [lo, hi]."""
    if lo >= -(2**15) and hi < 2**15:
        return np.ascontiguousarray(arr, dtype=np.int16)
    return np.ascontiguousarray(arr, dtype=np.int32)


def host_args(batch: ColumnarBatch, lean: bool = False):
    """(numpy wire args, A_loc, K): uint8 flags = action|insert<<3; int8
    slot; int16 where the value range fits, int32 otherwise. `lean` leaves
    the seq/value slots as None."""
    da, A, K = bucket_doc_actors(batch)
    slot = ensure_slot(batch)
    c = batch.cols
    _check_ranges(batch, A, K)
    N = batch.n_rows
    flags = (
        np.asarray(c["action"], np.uint8)
        | (np.asarray(c["insert"], np.uint8) << 3)
    )
    cmax = int(c["ctr"].max(initial=0))
    if lean:
        seq_w = value_w = None
    else:
        vmax = int(c["value"].max(initial=0))
        vmin = int(c["value"].min(initial=0))
        smax = int(c["seq"].max(initial=0))
        seq_w = _narrow(c["seq"], 0, smax)
        value_w = _narrow(c["value"], vmin, vmax)
    args = (
        flags,
        np.ascontiguousarray(slot, dtype=np.int8 if A <= 127 else np.int16),
        _narrow(c["ctr"], 0, cmax),
        seq_w,
        _narrow(c["obj"], -1, N - 1),
        _narrow(c["key"], -1, max(0, len(batch.keys) - 1)),
        _narrow(c["ref"], -3, N - 1),
        value_w,
        _narrow(batch.psrc, -1, N - 1),
        _narrow(batch.ptgt, -1, N - 1),
        np.ascontiguousarray(da, np.int32),
    )
    return args, A, K


def _check_ranges(batch: ColumnarBatch, A: int, K: int) -> None:
    N = batch.n_rows
    max_ctr = (
        batch.ranges["ctr_max"] if batch.ranges is not None
        else int(batch.cols["ctr"].max(initial=0))
    )
    if max_ctr * A + A >= 2**30:
        raise ValueError(
            f"lamport x actor-slot composite overflow: ctr={max_ctr} A={A}"
        )
    if (N + 1) * (K + 1) + K >= 2**31:
        raise ValueError(f"obj x key group id overflow: N={N} K={K}")


def device_args(batch: ColumnarBatch, lean: bool = False, device=None):
    """(torch args on `device`, A_loc, K) for the kernel entries. `lean`
    skips the seq/value builds and uploads (their slots are None)."""
    dev = resolve(device)
    np_args, A, K = host_args(batch, lean=lean)
    args = tuple(
        None if a is None else torch.from_numpy(a).to(dev) for a in np_args
    )
    return args, A, K


def run_batch(batch: ColumnarBatch, device: DeviceLike = None) -> MaterializeOut:
    """Host entry: pack numpy -> device -> per-row lanes."""
    args, A, K = device_args(batch, device=device)
    return materialize_device(*args, A=A, K=K)


def run_batch_summary(
    batch: ColumnarBatch, device: DeviceLike = None
) -> torch.Tensor:
    """Host entry for the bulk path: the fused summary wire buffer
    (decode with parse_summary_wire)."""
    args, A, K = device_args(batch, device=device)
    return materialize_summary_device(*args, A=A, K=K)


# bytes the single-device slab dispatch (run_batch_full) hands from host
# arrays to its device
_SLAB_H2D = telemetry.counter("slab.h2d_bytes")


def _on(t: torch.Tensor, dev: torch.device) -> bool:
    """Whether tensor t lies on `dev` (a bare "cuda" is the current
    card)."""
    if t.device.type != dev.type:
        return False
    return dev.type == "cpu" or t.device.index == (
        torch.cuda.current_device() if dev.index is None else dev.index)


def handoff_args(batch: ColumnarBatch, lean: bool, dev: torch.device):
    """(args, A_loc, K) of the slab launch from the lanes the pack left
    on `dev` (batch.lanes) and its ranges: nothing is narrowed or scanned
    on the host, and only the pred edges and the actor map go up, in one
    staged copy. `lean` leaves the seq/value slots None. Lanes packed on
    a card on another stream (a pack worker's) are waited for on this
    stream, and their allocation is held for it (`record_stream`: the
    lanes are views of one allocation), so dropping them after the launch
    is queued is safe on either stream."""
    da, A, K = bucket_doc_actors(batch)
    _check_ranges(batch, A, K)
    N = batch.n_rows
    small = (
        _narrow(batch.psrc, -1, N - 1), _narrow(batch.ptgt, -1, N - 1),
        np.ascontiguousarray(da, np.int32),
    )
    psrc, ptgt, da_t = staged_upload(small, dev)
    _SLAB_H2D.add(sum(a.nbytes for a in small))
    L = batch.lanes
    if L.packed is not None:
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(L.packed)
        L.flags.record_stream(stream)
    return (
        L.flags, L.slot, L.ctr, None if lean else L.seq, L.obj, L.key,
        L.ref, None if lean else L.value, psrc, ptgt, da_t,
    ), A, K


def run_batch_full(
    batch: ColumnarBatch, lean: bool = False, device: DeviceLike = None
):
    """Host entry -> (MaterializeOut, fused summary wire buffer), the slab
    dispatch of the bulk cold open. `lean=True` (callers that hold
    authoritative host clocks and verified the batch carries no INC ops)
    skips the seq/value lanes and the wire's clock section. A batch whose
    pack left its lanes on the dispatch device (the prefix pack's
    hand-off) launches on them; any other takes `host_args`."""
    dev = resolve(device)
    if batch.lanes is not None and _on(batch.lanes.flags, dev):
        args, A, K = handoff_args(batch, lean, dev)
    else:
        args, A, K = device_args(batch, lean=lean, device=dev)
        _SLAB_H2D.add(sum(a.nbytes for a in args if a is not None))
    if lean:
        (flags, slot, ctr, _seq, obj, key, ref, _value, psrc, ptgt,
         da) = args
        return materialize_full_lean_device(
            flags, slot, ctr, obj, key, ref, psrc, ptgt, da, A=A, K=K
        )
    return materialize_full_device(*args, A=A, K=K)
