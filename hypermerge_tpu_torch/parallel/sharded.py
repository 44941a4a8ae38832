"""Sharded batched programs: the multi-device path — the port of
hypermerge_tpu/parallel/sharded.py.

The same workloads as the single-device entries, run over a (dp, sp)
`Mesh` (parallel/mesh.py) as per-rank launches of the port's kernels plus
cross-rank reductions:

- `sharded_materialize` / `sharded_full`: the batched CRDT replay (and its
  summary wire) with the doc axis split over dp. Each dp shard lives on
  the first rank of its dp row and runs doc_kernel.cu and summary_wire.cu
  there with the SLAB's actor bucket and key bucket, so the shards' wires
  concatenate to the single-device bytes. The reference keeps replicas of
  each shard on the sp ranks of its row; they would repeat the same
  kernel, so the port does not make them.
- `sharded_clock_union` / `sharded_dominated`: GLOBAL-actor-indexed [D, A]
  clock matrices (ClockStore rows) split over (dp, sp). Each rank reduces
  its own block with clock_union.cu (or answers the `<=` query with
  clock_pair.cu), `ring_gather` (parallel/ring.py, ring_gather.cu) brings
  the partials of the reducing group together, and clock_union.cu folds
  them: max over dp (the reference's pmax), min over sp (its pmin).
- `local_clock_union` / `step`: slot-local kernel clocks scatter-maxed
  into global actor rows (clock_scatter.cu) per shard, then the same
  gather-and-fold over the dp ranks.
- `SlabRoundRobin` / `MeshBulkScheduler`: whole slabs streamed across the
  ranks with bounded in-flight queues (CUDA events), and the cross-slab
  reductions over everything resident (clock union, summary gather) as
  one ring gather over the mesh.

A replicated result lives on every rank of its group after the gather;
the fold runs on the first rank's copy, which the function returns.

Differences from the reference, by design:
- No program table: PyTorch runs eagerly, so `_PROGRAMS`, `trace_counts`
  and the `mesh.traces` counter have nothing to count. A repeated call
  rebuilds no kernel: kernels/_build.py keys each build by a hash of its
  source, so a second call finds it built.
- No fallback: the reference retries a failed Pallas ring on the lax
  twin and `HM_ICI_PALLAS=0` forces that twin. Here, on a CUDA mesh, a
  gather or reduction is the ring kernel plus the clock kernels or an
  exception; the plain versions run only for CPU ranks.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import telemetry
from ..ops import clock_kernels as ckk
from ..ops.columnar import ColumnarBatch
from ..ops.crdt_kernels import (
    _SLAB_H2D,
    MaterializeOut,
    bucket_doc_actors,
    host_args,
    materialize_device,
    materialize_with_wire,
    run_batch_full,
)
from .mesh import Mesh, pad_to_multiple, visible_devices
from .ring import ring_gather

# mesh telemetry (process registry): dispatches and host<->device transfer
# bytes — the "is the mesh being fed" view
_M_DISPATCHES = telemetry.counter("mesh.dispatches")
_M_H2D = telemetry.counter("mesh.h2d_bytes")
_M_D2H = telemetry.counter("mesh.d2h_bytes")

# narrow wire-arg order, matching ops.crdt_kernels.host_args; pad-doc
# rows must decode to action=PAD (flags=7), insert=0
_N_ARGS = 11  # flags, slot, ctr, seq, obj, key, ref, value, psrc, ptgt, da
_PAD_VALUES = (7, 0, 0, 0, -1, -1, -3, 0, -1, -1, -1)


class ShardedTensor:
    """A tensor split along its first axis into per-rank pieces, each on
    its rank's device; the whole is the pieces in order, cut to `length`
    rows. Row d lies in piece d // rows_per_piece, so reading one doc
    transfers one row of one rank."""

    def __init__(self, shards: Sequence[torch.Tensor],
                 length: Optional[int] = None) -> None:
        self.shards = list(shards)
        rows = self.shards[0].shape[0]
        total = sum(s.shape[0] for s in self.shards)
        if any(s.shape[0] != rows for s in self.shards):
            raise ValueError("shards of unequal row counts")
        self._rows = rows
        self.length = total if length is None else length
        self.shape = (self.length, *self.shards[0].shape[1:])
        self.dtype = self.shards[0].dtype
        self.device = self.shards[0].device

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, d: int) -> torch.Tensor:
        if not isinstance(d, int) or not 0 <= d < self.length:
            raise IndexError(d)
        return self.shards[d // self._rows][d % self._rows]

    def cpu(self) -> torch.Tensor:
        return torch.cat([s.cpu() for s in self.shards])[: self.length]

    def numpy(self) -> np.ndarray:
        return self.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


def _leaders(mesh: Mesh) -> List[torch.device]:
    """The device of each dp row's first rank: where the dp shards live."""
    return [mesh.device(i, 0) for i in range(mesh.shape["dp"])]


def _split_rows(arr: np.ndarray, pad_value, parts: int) -> List[np.ndarray]:
    """[D, ...] -> `parts` row slices of a padded [D_pad, ...] array."""
    D = arr.shape[0]
    D_pad = pad_to_multiple(max(D, parts), parts)
    if D_pad != D:
        pad = np.full((D_pad - D, *arr.shape[1:]), pad_value, arr.dtype)
        arr = np.concatenate([arr, pad], axis=0)
    d = D_pad // parts
    return [arr[i * d : (i + 1) * d] for i in range(parts)]


def shard_batch(batch: ColumnarBatch, mesh: Mesh, lean: bool = False):
    """Pad the doc axis to a dp multiple and upload one row slice per dp
    shard to its rank's device. Returns (args per shard, A, K, D_pad):
    the same narrow wire args and the same (A_loc, K) buckets as the
    single-device path; `lean` leaves the seq/value slots None."""
    dp = mesh.shape["dp"]
    np_args, A, K = host_args(batch, lean=lean)
    D_pad = pad_to_multiple(max(batch.n_docs, dp), dp)
    per_arg = [
        None if a is None else _split_rows(a, pv, dp)
        for a, pv in zip(np_args, _PAD_VALUES)
    ]
    shards = []
    for i, dev in enumerate(_leaders(mesh)):
        shards.append(tuple(
            None if p is None else torch.from_numpy(p[i]).to(dev)
            for p in per_arg
        ))
    _M_H2D.add(sum(a.nbytes for a in np_args if a is not None))
    return shards, A, K, D_pad


def _lanes(outs: Sequence[MaterializeOut]) -> MaterializeOut:
    return MaterializeOut(*(
        ShardedTensor([getattr(o, f) for o in outs])
        for f in MaterializeOut._fields
    ))


def _materialize_on_mesh(batch: ColumnarBatch, mesh: Mesh):
    """(out, doc_actors): the sharded batched replay plus the dp-sharded
    actor map it ran with (step reuses the map for the clock union)."""
    shards, A, K, _ = shard_batch(batch, mesh)
    outs = [materialize_device(*args, A=A, K=K) for args in shards]
    return _lanes(outs), ShardedTensor([args[-1] for args in shards])


def sharded_materialize(batch: ColumnarBatch, mesh: Mesh) -> MaterializeOut:
    """Batched replay sharded over dp; per-rank outputs, [D_pad] rows."""
    return _materialize_on_mesh(batch, mesh)[0]


def sharded_full(batch: ColumnarBatch, mesh: Mesh, lean: bool = False):
    """(MaterializeOut, summary wire) sharded over dp — the multi-device
    twin of ops.crdt_kernels.run_batch_full, and the dispatch the bulk
    loader uses when a mesh is available (RepoBackend._dispatch_slab):
    full lanes stay on their ranks for lazy patch decode, the [D_pad, W]
    wire comes to the host at the barrier. `lean` (no INC ops, host clocks
    in hand) leaves out the seq and value lanes and the wire's clock
    section on every rank."""
    _M_DISPATCHES.add(1)
    with telemetry.span("mesh.sharded_full", "mesh"):
        shards, A, K, _ = shard_batch(batch, mesh, lean=lean)
        outs, wires = [], []
        for args in shards:
            out, wire = materialize_with_wire(*args, A=A, K=K, lean=lean)
            outs.append(out)
            wires.append(wire)
        return _lanes(outs), ShardedTensor(wires)


# ---------------------------------------------------------------------------
# cross-rank reductions: per-rank partials, ring_gather, a clock_union fold


def _fold(parts: Sequence[torch.Tensor], mesh: Mesh,
          ranks: Optional[Sequence[int]], op: str) -> torch.Tensor:
    """[1, W] int32 partials, one per rank of `ranks` (every rank of the
    mesh for None) -> [W], their column max ("max") or min ("min") on the
    first rank: the partials gather over the group's ring as bytes, and
    clock_union.cu folds the first rank's copy."""
    ring = mesh.ring(ranks)
    gathered = ring_gather([p.view(torch.uint8) for p in parts], ring)[0]
    g = gathered.view(torch.int32)
    return ckk.union_reduce(g) if op == "max" else ckk.min_reduce(g)


def _pad_axes(arr, mesh: Mesh):
    """Pad [D, A] to (dp, sp) multiples with zeros (neutral for max and
    for <= domination checks)."""
    arr = np.asarray(arr)
    D, A = arr.shape
    Dp = pad_to_multiple(max(D, mesh.shape["dp"]), mesh.shape["dp"])
    Ap = pad_to_multiple(max(A, mesh.shape["sp"]), mesh.shape["sp"])
    if (Dp, Ap) != (D, A):
        out = np.zeros((Dp, Ap), arr.dtype)
        out[:D, :A] = arr
        arr = out
    return arr, D, A


def _block(arr: np.ndarray, mesh: Mesh, i: int, j: int) -> torch.Tensor:
    """Rank (i, j)'s [D/dp, A/sp] block, uploaded to its device."""
    d = arr.shape[0] // mesh.shape["dp"]
    a = arr.shape[1] // mesh.shape["sp"]
    block = np.ascontiguousarray(arr[i * d : (i + 1) * d, j * a : (j + 1) * a])
    return torch.from_numpy(block).to(mesh.device(i, j))


def sharded_clock_union(clocks, mesh: Mesh) -> ShardedTensor:
    """[D, A] -> [A] union across a (dp, sp)-split clock matrix whose
    columns are GLOBAL actor indices: each rank's column max, then the
    max over its dp group; the answer is sp-split (piece j on rank
    (0, j)). Kernel clock outputs are slot-local — use
    `local_clock_union` for those."""
    arr, _D, A = _pad_axes(np.asarray(clocks, np.int32), mesh)
    pieces = []
    for j in range(mesh.shape["sp"]):
        parts = [
            ckk.union_reduce(_block(arr, mesh, i, j))[None]
            for i in range(mesh.shape["dp"])
        ]
        pieces.append(_fold(parts, mesh, mesh.dp_group(j), "max"))
    return ShardedTensor(pieces, length=A)


def sharded_dominated(clocks, query, mesh: Mesh) -> ShardedTensor:
    """[D, A], [A] -> [D] bool: which docs' clocks the query dominates.
    Each rank answers `<=` over its actor columns (clock_pair.cu), and
    the sp group's verdicts fold by min; the answer is dp-split (piece i
    on rank (i, 0))."""
    arr, D, A = _pad_axes(np.asarray(clocks, np.int32), mesh)
    q = np.zeros(arr.shape[1], np.int32)
    q[:A] = np.asarray(query)
    a = arr.shape[1] // mesh.shape["sp"]
    pieces = []
    for i in range(mesh.shape["dp"]):
        parts = []
        for j in range(mesh.shape["sp"]):
            c = _block(arr, mesh, i, j)
            qj = torch.from_numpy(q[j * a : (j + 1) * a].copy()).to(c.device)
            parts.append(ckk.gte(qj, c).to(torch.int32)[None])
        pieces.append(_fold(parts, mesh, mesh.sp_group(i), "min") > 0)
    return ShardedTensor(pieces, length=D)


def _scatter_union(clock: torch.Tensor, doc_actors: torch.Tensor,
                   n_actors: int, acc: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Scatter-max of slot-local clocks into global actor columns
    (clock_scatter.cu): [d, A_loc] x [d, A_loc] -> [1, n_actors + 1]
    (column n_actors takes the empty slots), into `acc` when given."""
    dev = clock.device
    if acc is None:
        acc = torch.zeros(1, n_actors + 1, dtype=torch.int32, device=dev)
    da = doc_actors.reshape(-1).to(torch.int32)
    c = clock.reshape(-1).to(torch.int32)
    cols = torch.where(da >= 0, da, n_actors).contiguous()
    vals = torch.where(da >= 0, c, 0).contiguous()
    rows = torch.zeros_like(cols)
    return ckk.scatter_max_(acc, rows, cols, vals)


def _as_sharded(x, mesh: Mesh, pad_value) -> ShardedTensor:
    if isinstance(x, ShardedTensor):
        return x
    parts = _split_rows(np.asarray(x), pad_value, mesh.shape["dp"])
    return ShardedTensor([torch.from_numpy(np.ascontiguousarray(p)).to(d)
                          for p, d in zip(parts, _leaders(mesh))])


def local_clock_union(clock, doc_actors, n_actors: int,
                      mesh: Mesh) -> torch.Tensor:
    """[D, A_loc] slot-local clocks + [D, A_loc] actor maps (dp-sharded,
    as `sharded_materialize` leaves them, or whole) -> [n_actors] global
    union: each shard scatter-maxes its docs, then the dp ranks' partials
    gather and fold by max."""
    clock = _as_sharded(clock, mesh, 0)
    doc_actors = _as_sharded(doc_actors, mesh, -1)
    parts = [_scatter_union(c, da, n_actors)
             for c, da in zip(clock.shards, doc_actors.shards)]
    return _fold(parts, mesh, mesh.dp_group(0), "max")[:n_actors]


def step(batch: ColumnarBatch, mesh: Mesh):
    """One full merge step: materialize everything and union every clock
    over the mesh — the complete device-side work of a bulk sync cycle.
    Returns (MaterializeOut sharded over dp, [n_actors] union)."""
    n_actors = max(1, len(batch.actors))
    _M_DISPATCHES.add(1)
    with telemetry.span("mesh.step", "mesh"):
        shards, A, K, _ = shard_batch(batch, mesh)
        outs, parts = [], []
        for args in shards:
            out = materialize_device(*args, A=A, K=K)
            outs.append(out)
            parts.append(_scatter_union(out.clock, args[-1], n_actors))
        union = _fold(parts, mesh, mesh.dp_group(0), "max")[:n_actors]
        return _lanes(outs), union


class _Done:
    """In-flight marker of a dispatch that ran synchronously (CPU ranks)."""

    def synchronize(self) -> None:
        pass


def _dispatch_event(device: torch.device):
    if device.type != "cuda":
        return _Done()
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class SlabRoundRobin:
    """Stream WHOLE slabs across devices with bounded per-device in-flight
    queues — the streaming pipeline's multi-device dispatch.

    Where `sharded_full` splits one slab across the mesh, round-robin
    keeps each slab whole on one rank and streams successive slabs to
    successive ranks, so they run independent launches while the host
    packs ahead. Same kernels, same (A_loc, K) buckets: results equal the
    single-device and sharded paths bit for bit.

    Placement: strict round-robin by default; HM_RR_LEAST_LOADED=1 (or
    least_loaded=True) picks the device with the SHORTEST in-flight queue
    instead, scanning from the cursor so equal loads still cycle.

    Backpressure: at most `depth` (HM_RR_DEPTH, default 2) unfetched slabs
    per device; dispatching onto a saturated device waits on the CUDA
    event of its OLDEST outstanding dispatch.

    Accounting: `t_dispatch_chip[i]` accumulates per-rank dispatch busy
    seconds, `slabs_per_chip[i]` the slab count; `last_device` is the
    index the most recent dispatch landed on."""

    def __init__(
        self, devices=None, depth: int = None, least_loaded: bool = None
    ) -> None:
        self.devices = list(
            devices if devices is not None else visible_devices()
        )
        self.depth = (
            depth
            if depth is not None
            else max(1, int(os.environ.get("HM_RR_DEPTH", "2")))
        )
        self.least_loaded = (
            least_loaded
            if least_loaded is not None
            else os.environ.get("HM_RR_LEAST_LOADED", "0") == "1"
        )
        self._next = 0
        self._inflight = {i: [] for i in range(len(self.devices))}
        self.t_dispatch_chip = [0.0] * len(self.devices)
        self.slabs_per_chip = [0] * len(self.devices)
        self.last_device: Optional[int] = None

    def device_index(self, device) -> Optional[int]:
        """Index of `device` within this scheduler's ranks (the first rank
        on it; None when it is not one of them)."""
        try:
            return self.devices.index(device)
        except ValueError:
            return None

    def cursor(self) -> int:
        """Round-robin cursor snapshot (taken before a load starts)."""
        return self._next

    def pack_device_for(self, seq: int, cursor0: int):
        """Device slab `seq` of a load will be dispatched to, given the
        cursor snapshot `cursor0`; None under least-loaded placement,
        which depends on load."""
        if self.least_loaded:
            return None
        return self.devices[(cursor0 + seq) % len(self.devices)]

    def _pick_device(self) -> int:
        n = len(self.devices)
        if not self.least_loaded:
            i = self._next
            self._next = (self._next + 1) % n
            return i
        best = None
        best_len = None
        for k in range(n):
            i = (self._next + k) % n
            qlen = len(self._inflight[i])
            if best_len is None or qlen < best_len:
                best, best_len = i, qlen
                if qlen == 0:
                    break
        self._next = (best + 1) % n
        return best

    def dispatch(self, batch: ColumnarBatch, lean: bool = False):
        """(MaterializeOut, summary wire) on the chosen device; waits only
        when that device already holds `depth` unfetched slabs. The entry
        is run_batch_full with a pinned device — the single-device path
        itself."""
        i = self._pick_device()
        q = self._inflight[i]
        while len(q) >= self.depth:
            q.pop(0).synchronize()
        t0 = time.perf_counter()
        # the bytes run_batch_full hands up (the slab counter's rise): on
        # a pack's hand-off only the pred edges and the actor map; no host
        # plane is read here, so the dispatch never waits for their copy
        h2d0 = _SLAB_H2D.value()
        with telemetry.span("mesh.dispatch", "mesh"):
            out, summary = run_batch_full(
                batch, lean=lean, device=self.devices[i]
            )
        _M_DISPATCHES.add(1)
        _M_H2D.add(_SLAB_H2D.value() - h2d0)
        self.t_dispatch_chip[i] += time.perf_counter() - t0
        self.slabs_per_chip[i] += 1
        self.last_device = i
        q.append(_dispatch_event(self.devices[i]))
        return out, summary

    def drain(self) -> None:
        """Wait until every outstanding dispatch has completed."""
        for q in self._inflight.values():
            while q:
                q.pop(0).synchronize()

    def release(self) -> None:
        """Drop the backpressure entries without waiting (a bulk load
        finished dispatching)."""
        for q in self._inflight.values():
            q.clear()


class MeshBulkScheduler(SlabRoundRobin):
    """SlabRoundRobin's streaming dispatch plus cross-slab reductions over
    the mesh: every dispatched slab's clock lane, actor map and summary
    wire stay tracked per rank (`track_resident`), and

    - `collective_clock_union(n_actors)`: each rank scatter-maxes ITS
      resident slabs' slot-local clocks into one [1, n_actors + 1]
      partial where the data lives, then one ring gather over the mesh
      and one clock_union fold give the global union — a single
      [n_actors] fetch;
    - `gather_summaries()`: each rank stacks its resident wires (a
      torch.cat plus zero rows up to the largest rank's count), one ring
      gather over the mesh replicates the stacks, and the host reads the
      whole load's summaries in ONE transfer, in dispatch order.

    Tracking pins every tracked slab's device buffers until
    `reset_resident()`; a loader that fetches per slab constructs with
    it off."""

    def __init__(
        self,
        mesh: Mesh,
        depth: int = None,
        least_loaded: bool = None,
        track_resident: bool = True,
    ) -> None:
        super().__init__(list(mesh.devices), depth, least_loaded=least_loaded)
        self.mesh = mesh
        self.track_resident = track_resident
        # per rank: (clock [D, A_loc], doc_actors [D, A_loc]) on its device
        self._resident_clocks: Dict[int, List] = {
            i: [] for i in range(len(self.devices))
        }
        # per rank: (dispatch sequence number, n_docs, wire [D, W])
        self._resident_wires: Dict[int, List] = {
            i: [] for i in range(len(self.devices))
        }
        self._seq = 0

    def reset_resident(self) -> None:
        """Forget tracked device buffers (start of a new bulk load)."""
        for d in (self._resident_clocks, self._resident_wires):
            for q in d.values():
                q.clear()
        self._seq = 0

    def dispatch(self, batch: ColumnarBatch, lean: bool = False):
        out, summary = super().dispatch(batch, lean=lean)
        if not self.track_resident:
            return out, summary
        i = self.last_device
        da, _A, _K = bucket_doc_actors(batch)
        da_ref = torch.from_numpy(np.ascontiguousarray(da, np.int32)).to(
            self.devices[i])
        self._resident_clocks[i].append((out.clock, da_ref))
        self._resident_wires[i].append((self._seq, batch.n_docs, summary))
        self._seq += 1
        return out, summary

    def _chip_partial(self, items, n_actors: int, device) -> torch.Tensor:
        """One rank's resident (clock, da) pairs scatter-maxed into one
        [1, n_actors + 1] partial on that rank."""
        acc = torch.zeros(1, n_actors + 1, dtype=torch.int32, device=device)
        for clock, da in items:
            _scatter_union(clock, da, n_actors, acc)
        return acc

    def collective_clock_union(self, n_actors: int) -> np.ndarray:
        """[n_actors] global union of every resident slab's clocks: per-rank
        partials, then one gather and fold over the mesh."""
        n_actors = max(1, n_actors)
        partials = [
            self._chip_partial(self._resident_clocks[i], n_actors,
                               self.devices[i])
            for i in range(len(self.devices))
        ]
        union = _fold(partials, self.mesh, None, "max")
        host = union[:n_actors].cpu().numpy()
        _M_D2H.add(host.nbytes)
        return host

    def gather_summaries(self):
        """Every resident summary wire, host-side, in DISPATCH order:
        [(seq, n_docs, numpy wire rows)], one ring gather per wire width."""
        by_w: Dict[int, Dict[int, List]] = {}
        for i, items in self._resident_wires.items():
            for seq, n_docs, wire in items:
                by_w.setdefault(wire.shape[1], {}).setdefault(
                    i, []
                ).append((seq, n_docs, wire))
        ring = self.mesh.ring()
        out = []
        for W, per_chip in sorted(by_w.items()):
            rows_per_chip = [
                sum(int(w.shape[0]) for _s, _n, w in per_chip.get(i, []))
                for i in range(len(self.devices))
            ]
            rows = max(max(rows_per_chip), 1)
            stacks = []
            for i, dev in enumerate(self.devices):
                wires = [w for _s, _n, w in per_chip.get(i, [])]
                pad = torch.zeros((rows - rows_per_chip[i], W),
                                  dtype=torch.uint8, device=dev)
                stacks.append(torch.cat(wires + [pad]))
            host = ring_gather(stacks, ring)[0].cpu().numpy()
            _M_D2H.add(host.nbytes)
            for i in range(len(self.devices)):
                base = i * rows
                for seq, n_docs, wire in per_chip.get(i, []):
                    n = int(wire.shape[0])
                    out.append((seq, n_docs, host[base : base + n]))
                    base += n
        out.sort(key=lambda t: t[0])
        return out
