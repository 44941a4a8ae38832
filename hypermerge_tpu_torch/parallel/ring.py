"""The all-gather over a mesh's ranks — the port of
hypermerge_tpu/parallel/sharded.py `_pallas_ring_gather` (:134), the
repo's one Pallas kernel.

`ring_gather(blocks, ring)` takes one [rows, ...] block per rank, each on
its rank's device, and returns one [n * rows, ...] tensor per rank, each on
that rank's device, holding the blocks in rank order. On CUDA it is
`kernels/csrc/ring_gather.cu`; on the CPU it is `ring_gather_plain`, which
the tests hold to the reference. A `Ring`'s mode picks the launch:

- "virtual" (every rank on one card, the mesh's mode there): one ordinary
  launch whose blocks copy every source block into one concatenation,
  which is every rank's result: the ranks' arrays are equal and on one
  device, and callers read them and write none (the reference's arrays
  are immutable). No flags and no synchronisation: the ranks share the
  card's current stream, whose order is the barrier.
- "peer" (one card each): one cooperative launch per card that pushes its
  block into every rank's output over NVLink, raises its arrival flag on
  every rank and waits, bounded, for every rank's flag. Each card's
  stream first waits for an event recorded on every other card's stream
  after that card's output was allocated, so no push lands in memory that
  the card's earlier work may still read. The wrapper then reads every
  rank's error word (a synchronisation) and raises if a wait timed out.
- "protocol": the peer route's flagged launch over virtual ranks of one
  card, one cooperative grid, so that the arrival protocol, its epochs and
  its timeout run on a machine with one card (tests, chip_smoke.py).
- "plain": CPU ranks, `ring_gather_plain`.

There is no fallback from the kernel: the reference retries a failed
Pallas ring on `lax.all_gather`, but the port has no second transport that
is not a library collective, so a launch error or a flag timeout raises
RuntimeError.

A `Ring` is built once per group of ranks (`Mesh.ring`) and keeps its
flag rows (one int32[n + 2] row per rank, on the rank's device: arrival
flags, error word, block count) and its epoch for the life of the mesh.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from ..ops.crdt_kernels import _launched, kernel_fn, launch_scope, launch_stream

MAX_RANKS = 16  # kMaxRanks of ring_gather.cu
# how long a rank waits for the others' arrival flags before the kernel
# gives up: with cards of their own, a rank's stream may still be busy
# with earlier work when another rank's gather starts
TIMEOUT_NS = 10_000_000_000
# the launch shape: THREADS threads a block; the push route aims at
# PUSH_BLOCKS_PER_SM blocks per SM, no slice under MIN_SLICE_BYTES
THREADS = 512
PUSH_BLOCKS_PER_SM = 4
MIN_SLICE_BYTES = 16384
PROTOCOL_BLOCKS = 4  # blocks per rank of the flagged launch over virtual ranks
# ring_gather.cu's modes
_PUSH, _FLAGGED = 0, 1
_peer_enabled: set = set()


class Ring:
    """The devices of a ring's ranks, its launch mode ("virtual": one card
    repeated, "peer": one card each, "protocol": one card repeated through
    the flagged launch, "plain": CPU ranks; the mesh has checked the
    devices), and for the flagged launch its flag rows and its epoch."""

    def __init__(self, devices: Sequence[torch.device], mode: str) -> None:
        if mode not in ("virtual", "peer", "protocol", "plain"):
            raise ValueError(f"ring mode {mode!r}")
        self.devices = list(devices)
        self.n = len(self.devices)
        self.mode = mode
        self.epoch = 0
        self._flags: List[torch.Tensor] = []  # one int32[n + 2] row per rank
        self._table: Optional[torch.Tensor] = None  # the rows, "protocol"
        self._sm_count = 0

    def _sms(self) -> int:
        if not self._sm_count:
            self._sm_count = torch.cuda.get_device_properties(
                self.devices[0]).multi_processor_count
        return self._sm_count

    def _rows(self) -> List[torch.Tensor]:
        """The flag rows of the flagged launch, made at its first call."""
        if not self._flags:
            n = self.n
            if self.mode == "protocol":
                if n * PROTOCOL_BLOCKS > self._sms():
                    raise ValueError(
                        f"{n} virtual ranks x {PROTOCOL_BLOCKS} blocks on "
                        f"{self._sms()} SMs: the cooperative launch needs "
                        "them all resident")
                self._table = torch.zeros(n, n + 2, dtype=torch.int32,
                                          device=self.devices[0])
                self._flags = list(self._table)
            else:
                for d in self.devices:
                    for p in self.devices:
                        if d != p and (d.index, p.index) not in _peer_enabled:
                            with torch.cuda.device(d):
                                rc = _enable_peer()(p.index)
                            if rc != 0:
                                raise RuntimeError(f"peer access {d} -> {p}: "
                                                   f"CUDA error {rc}")
                            _peer_enabled.add((d.index, p.index))
                self._flags = [torch.zeros(n + 2, dtype=torch.int32, device=d)
                               for d in self.devices]
        return self._flags


def _enable_peer():
    from ..kernels._build import load

    fn = load("ring_gather").hm_ring_enable_peer
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def ring_gather_plain(blocks: Sequence[torch.Tensor],
                      devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The blocks concatenated in rank order, one copy on each rank's
    device."""
    return [torch.cat([b.to(d) for b in blocks]) for d in devices]


def _check_blocks(blocks: Sequence[torch.Tensor], ring: Ring) -> None:
    if len(blocks) != ring.n:
        raise ValueError(f"{len(blocks)} blocks for a ring of {ring.n} ranks")
    b0 = blocks[0]
    shape, dtype = b0.shape, b0.dtype
    for r, (b, d) in enumerate(zip(blocks, ring.devices)):
        # one test per block on the hot path; the message only on failure
        if (b.device != d or b.shape != shape or b.dtype != dtype
                or not shape or not b.is_contiguous()):
            _block_error(r, b, d, b0)


def _block_error(r: int, b: torch.Tensor, d: torch.device,
                 b0: torch.Tensor) -> None:
    if b.device != d:
        raise ValueError(f"block {r} on {b.device}, its rank on {d}")
    if b.shape != b0.shape or b.dtype != b0.dtype:
        raise ValueError(f"block {r}: {tuple(b.shape)} {b.dtype}, block 0 "
                         f"{tuple(b0.shape)} {b0.dtype}")
    raise ValueError(f"block {r}: expected a contiguous tensor of rank >= 1")


def _pointers(ts: Sequence[torch.Tensor]):
    """The tensors' device pointers as a C array of int64."""
    return (ctypes.c_longlong * len(ts))(*[t.data_ptr() for t in ts])


def _slices(block_bytes: int, most: int) -> int:
    """Slices per source block: at most `most`, none under
    MIN_SLICE_BYTES."""
    return max(1, min(most, -(-block_bytes // MIN_SLICE_BYTES)))


def ring_gather_cuda(blocks: Sequence[torch.Tensor], ring: Ring) -> List[torch.Tensor]:
    """ring_gather.cu over the ring's ranks. The virtual route is one
    launch into one concatenation, returned for every rank, without
    synchronising; the flagged routes issue every card's launch before the
    wrapper waits on any of them, then read the ranks' error words (a
    synchronisation) and raise if a rank timed out."""
    _check_blocks(blocks, ring)
    if ring.mode not in ("virtual", "peer", "protocol"):
        raise ValueError(f"ring_gather_cuda over a {ring.mode} ring")
    if ring.n > MAX_RANKS:
        raise ValueError(f"a ring of {ring.n} ranks: at most {MAX_RANKS}")
    n, b0 = ring.n, blocks[0]
    shape = (n * b0.shape[0], *b0.shape[1:])
    block_bytes = b0.numel() * b0.element_size()
    fn = kernel_fn("ring_gather")
    locals_ = _pointers(blocks)
    if ring.mode == "virtual":
        dev = ring.devices[0]
        out = torch.empty(shape, dtype=b0.dtype, device=dev)
        if block_bytes:
            slices = _slices(block_bytes, -(-PUSH_BLOCKS_PER_SM * ring._sms() // n))
            with launch_scope(dev):
                rc = fn(locals_, _pointers([out]), None, n, 0, n, block_bytes,
                        0, 0, _PUSH, THREADS, slices, 1, launch_stream(dev))
            _launched("ring_gather", rc)
        return [out] * n
    outs = [torch.empty(shape, dtype=b0.dtype, device=d) for d in ring.devices]
    if block_bytes == 0:
        return outs
    flags = ring._rows()
    ring.epoch += 1
    if ring.mode == "protocol":
        per_rank = PROTOCOL_BLOCKS
        launch = [(0, n)]
    else:
        per_rank = ring._sms()
        launch = [(r, 1) for r in range(n)]
        # card r writes into every card's output: after the work each card
        # queued before its output was allocated
        ready = [torch.cuda.Event() for _ in ring.devices]
        for ev, d in zip(ready, ring.devices):
            ev.record(torch.cuda.current_stream(d))
        for r, d in enumerate(ring.devices):
            stream = torch.cuda.current_stream(d)
            for p, ev in enumerate(ready):
                if p != r:
                    stream.wait_event(ev)
    outs_p, flags_p = _pointers(outs), _pointers(flags)
    slices = _slices(block_bytes, per_rank)
    for rank0, count in launch:
        dev = ring.devices[rank0]
        with launch_scope(dev):
            rc = fn(locals_, outs_p, flags_p, n, rank0, count, block_bytes,
                    ring.epoch, TIMEOUT_NS, _FLAGGED, THREADS, slices,
                    per_rank, launch_stream(dev))
        _launched("ring_gather", rc)
    # the error word of every rank (slot n of its row): one read for
    # virtual ranks, one per card for peer ranks
    if ring.mode == "protocol":
        errs = ring._table[:, n].tolist()
    else:
        errs = [int(f[n].item()) for f in flags]
    bad = [r for r, e in enumerate(errs) if e]
    if bad:
        for r in bad:
            flags[r][n] = 0
        raise RuntimeError(
            f"ring_gather: ranks {bad} of {n} timed out waiting for the other "
            f"ranks' arrival flags (epoch {ring.epoch}, {ring.mode} ranks)")
    return outs


def ring_gather(blocks: Sequence[torch.Tensor], ring: Ring) -> List[torch.Tensor]:
    """The all-gather: the kernel for a CUDA ring, the plain version for a
    CPU ring."""
    if ring.mode == "plain":
        _check_blocks(blocks, ring)
        return ring_gather_plain(blocks, ring.devices)
    return ring_gather_cuda(blocks, ring)
