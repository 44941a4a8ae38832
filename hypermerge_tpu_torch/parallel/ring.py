"""The ring all-gather over a mesh's ranks — the port of
hypermerge_tpu/parallel/sharded.py `_pallas_ring_gather` (:134), the
repo's one Pallas kernel.

`ring_gather(blocks, ring)` takes one [rows, ...] block per rank, each on
its rank's device, and returns one [n * rows, ...] tensor per rank, each on
that rank's device, holding the blocks in rank order. On CUDA it is
`kernels/csrc/ring_gather.cu` (one cooperative launch for virtual ranks on
one card, one launch per card for peer ranks); on the CPU it is
`ring_gather_plain`, which the tests hold to the reference. There is no
fallback from the kernel: the reference retries a failed Pallas ring on
`lax.all_gather`, but the port has no second transport that is not a
library collective, so a launch error or a flag timeout raises
RuntimeError.

A `Ring` is built once per group of ranks (`Mesh.ring`) and keeps its
flag rows (one int32[n] row per rank, on the rank's device) and its epoch
for the life of the mesh.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops.crdt_kernels import kernel_fn, launches

MAX_RANKS = 16  # kMaxRanks of ring_gather.cu
# how long a rank waits for its left neighbour before the kernel gives up:
# with cards of their own, a neighbour's stream may still be busy with
# earlier work when this rank's ring starts
TIMEOUT_NS = 10_000_000_000
# test hook, passed to the C entry as is: the rank that never raises its
# flags (-1: none). Not an option of the wrapper.
_SILENT_RANK = -1
_peer_enabled: set = set()


class Ring:
    """The devices of a ring's ranks, its launch mode ("virtual": one card
    repeated, "peer": one card each, "plain": CPU ranks; the mesh has
    checked it), its flags and its epoch."""

    def __init__(self, devices: Sequence[torch.device], mode: str) -> None:
        self.devices = list(devices)
        self.n = len(self.devices)
        self.mode = mode
        self.epoch = 0
        self._flags: List[torch.Tensor] = []  # one int32[n] row per rank

    def _rows(self) -> List[torch.Tensor]:
        if not self._flags:
            if self.n > MAX_RANKS:
                raise ValueError(f"a ring of {self.n} ranks: at most {MAX_RANKS}")
            if self.mode == "virtual":
                dev = self.devices[0]
                sms = torch.cuda.get_device_properties(dev).multi_processor_count
                if self.n > sms:
                    raise ValueError(f"{self.n} virtual ranks on {sms} SMs: the "
                                     "cooperative launch needs one SM per rank")
                self._table = torch.zeros(self.n, self.n, dtype=torch.int32,
                                          device=dev)
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
                self._flags = [torch.zeros(self.n, dtype=torch.int32, device=d)
                               for d in self.devices]
        return self._flags


def _enable_peer():
    import ctypes

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
    for r, (b, d) in enumerate(zip(blocks, ring.devices)):
        if b.device != d:
            raise ValueError(f"block {r} on {b.device}, its rank on {d}")
        if b.shape != b0.shape or b.dtype != b0.dtype:
            raise ValueError(f"block {r}: {tuple(b.shape)} {b.dtype}, block 0 "
                             f"{tuple(b0.shape)} {b0.dtype}")
        if b.ndim < 1 or not b.is_contiguous():
            raise ValueError(f"block {r}: expected a contiguous tensor of rank >= 1")


def ring_gather_cuda(blocks: Sequence[torch.Tensor], ring: Ring) -> List[torch.Tensor]:
    """ring_gather.cu over the ring's ranks. Every rank's launch is issued
    before the wrapper waits on any of them; it then reads the ranks'
    error words (a synchronisation) and raises if a rank timed out."""
    _check_blocks(blocks, ring)
    flags = ring._rows()
    n, b0 = ring.n, blocks[0]
    rows = b0.shape[0]
    outs = [torch.empty((n * rows, *b0.shape[1:]), dtype=b0.dtype, device=d)
            for d in ring.devices]
    block_bytes = b0.numel() * b0.element_size()
    if block_bytes == 0:
        return outs
    ring.epoch += 1
    locals_ = np.asarray([b.data_ptr() for b in blocks], np.int64)
    outs_p = np.asarray([o.data_ptr() for o in outs], np.int64)
    flags_p = np.asarray([f.data_ptr() for f in flags], np.int64)
    fn = kernel_fn("ring_gather")
    launch = [(0, n)] if ring.mode == "virtual" else [(r, 1) for r in range(n)]
    for rank0, count in launch:
        dev = ring.devices[rank0]
        with torch.cuda.device(dev):
            rc = fn(locals_.ctypes.data, outs_p.ctypes.data, flags_p.ctypes.data,
                    n, rank0, count, block_bytes, ring.epoch, _SILENT_RANK,
                    TIMEOUT_NS, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel ring_gather failed to launch: "
                               f"error {rc}")
        launches["ring_gather"] += 1
    # the error word of every rank (slot n-1 of its row): one read for
    # virtual ranks, one per card for peer ranks
    if ring.mode == "virtual":
        errs = ring._table[:, n - 1].tolist()
    else:
        errs = [int(f[n - 1].item()) for f in flags]
    bad = [r for r, e in enumerate(errs) if e]
    if bad:
        for r in bad:
            flags[r][n - 1] = 0
        raise RuntimeError(
            f"ring_gather: ranks {bad} of {n} timed out waiting for their left "
            f"neighbour (epoch {ring.epoch}, {ring.mode} ranks)")
    return outs


def ring_gather(blocks: Sequence[torch.Tensor], ring: Ring) -> List[torch.Tensor]:
    """The all-gather: the kernel for a CUDA ring, the plain version for a
    CPU ring."""
    if ring.mode == "plain":
        _check_blocks(blocks, ring)
        return ring_gather_plain(blocks, ring.devices)
    return ring_gather_cuda(blocks, ring)
