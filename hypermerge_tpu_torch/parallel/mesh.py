"""The device mesh for doc-sharded CRDT compute — the port of
hypermerge_tpu/parallel/mesh.py.

The framework's scale axes:

- `dp` — document parallelism: every per-doc kernel (ops/crdt_kernels.py)
  shards here with no cross-rank traffic.
- `sp` — state parallelism: the actor axis of clock matrices; a reduction
  that crosses it (a dominated-set query) gathers partials over the ring
  (parallel/ring.py) and folds them with the port's clock kernels.

A `Mesh` is a (dp, sp) grid of torch devices, row-major. A device may
repeat: n ranks on one card (virtual ranks, the counterpart of the
reference's forced host device count) or n ranks on the CPU in tests. A
CUDA mesh is either all one card or all distinct cards with peer access
between every pair; anything else raises here, at construction, because
the ring kernel has one launch mode for each of those two and no other.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch


def visible_devices() -> List[torch.device]:
    """Every CUDA device of this process, in index order ([] without a
    GPU). The one place the backend asks; tests and chip_smoke.py replace
    it to get n virtual ranks."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _normal(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A (dp, sp) grid of devices; `devices` is flat, row-major."""

    def __init__(self, grid: Sequence[Sequence]) -> None:
        rows = [[_normal(d) for d in row] for row in grid]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.devices: List[torch.device] = [d for row in rows for d in row]
        self.shape: Dict[str, int] = {"dp": len(rows), "sp": len(rows[0])}
        self.size = len(self.devices)
        types = {d.type for d in self.devices}
        if len(types) != 1 or types - {"cpu", "cuda"}:
            raise ValueError(f"mesh devices must be all cpu or all cuda: {types}")
        distinct = set(self.devices)
        self.mode = "plain"
        if "cuda" in types:
            if len(distinct) == 1:
                self.mode = "virtual"
            elif len(distinct) == self.size:
                self.mode = "peer"
                for a in distinct:
                    for b in distinct:
                        if a != b and not torch.cuda.can_device_access_peer(a, b):
                            raise ValueError(
                                f"no peer access from {a} to {b}: the ring "
                                "kernel cannot reach the other card")
            else:
                raise ValueError(
                    "a CUDA mesh repeats one device for every rank or uses "
                    f"distinct devices, not a mix: {self.devices}")
        self._rings: Dict[Tuple[int, ...], object] = {}

    def device(self, i: int, j: int = 0) -> torch.device:
        return self.devices[i * self.shape["sp"] + j]

    def ring(self, ranks: Optional[Sequence[int]] = None):
        """The ring over `ranks` (every rank by default), built once per
        group and kept: its flag rows and epoch live as long as the mesh."""
        from .ring import Ring

        key = tuple(range(self.size) if ranks is None else ranks)
        ring = self._rings.get(key)
        if ring is None:
            ring = Ring([self.devices[r] for r in key], self.mode)
            self._rings[key] = ring
        return ring

    def dp_group(self, j: int = 0) -> List[int]:
        """The ranks of sp column j: one per dp row."""
        sp = self.shape["sp"]
        return [i * sp + j for i in range(self.shape["dp"])]

    def sp_group(self, i: int) -> List[int]:
        """The ranks of dp row i."""
        sp = self.shape["sp"]
        return [i * sp + j for j in range(sp)]

    def __repr__(self) -> str:
        return f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, {self.mode})"


def make_mesh(
    n_devices: Optional[int] = None,
    sp: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A (dp, sp) mesh over the first n_devices of `devices` (by default
    `visible_devices()`)."""
    devices = list(visible_devices() if devices is None else devices)
    n = n_devices if n_devices is not None else len(devices)
    if n > len(devices):
        raise ValueError(f"asked for {n} devices, have {len(devices)}")
    if n < 1:
        raise ValueError("a mesh needs at least one device")
    if n % sp != 0:
        raise ValueError(f"n_devices {n} not divisible by sp {sp}")
    dp = n // sp
    return Mesh([devices[i * sp : (i + 1) * sp] for i in range(dp)])


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def device_topology(mesh: Optional[Mesh] = None) -> dict:
    """Visible devices and the mesh (by default the one the bulk loader
    would build over them): the context a multi-device number needs to be
    read on its own. `peer_access` says whether every pair of distinct
    cards can reach each other (None with fewer than two; the ring then
    runs virtual ranks on one card, or the plain version on the CPU)."""
    devs = visible_devices()
    cards = sorted({d for d in (mesh.devices if mesh else devs)
                    if d.type == "cuda"}, key=lambda d: d.index)
    peer = None
    if len(cards) > 1:
        peer = all(torch.cuda.can_device_access_peer(a, b)
                   for a in cards for b in cards if a != b)
    return {
        "n_devices": len(devs),
        "platform": "gpu" if devs else None,
        "device_kind": torch.cuda.get_device_name(devs[0]) if devs else None,
        "mesh": (dict(mesh.shape) if mesh
                 else {"dp": len(devs), "sp": 1} if devs else None),
        "mesh_mode": mesh.mode if mesh else None,
        "peer_access": peer,
        "process_count": 1,
    }
