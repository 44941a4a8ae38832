"""Entry points of the port for a harness: one compute entry and the
measured multi-device run (the counterparts of the JAX package's
`__graft_entry__.py`).

- `entry(device=None)`: (forward, example_args) of the batched doc
  materialization (`ops/crdt_kernels.py` `materialize_device`) over a
  `synth_batch(n_docs=8, n_ops=256)`, on the card unless the caller asks
  for the CPU.
- `measured_multichip(n_devices, device=None, ranks="cards")` (alias
  `dryrun_multichip`): a mesh over n ranks, one collective merge step
  (`parallel/sharded.py` `step`), then a timed `Repo.open_many` +
  `fetch_bulk_summaries` of an on-disk corpus spread over the ranks,
  held equal, summary for summary, to a single-device open of the same
  corpus (HM_MESH=0). It prints one `measured_multichip ok: ...` line.

The ranks are n distinct cards (`ranks="cards"`: peer mode) unless the
caller names them otherwise: `ranks="virtual"` runs n virtual ranks of
the first card, and `device="cpu"` runs n CPU ranks on the plain
versions. With fewer cards than asked it raises: it never moves to
another platform by itself.

    python -m hypermerge_tpu_torch.graft_entry 4            # four cards
    python -m hypermerge_tpu_torch.graft_entry 4 virtual    # one card
    python -m hypermerge_tpu_torch.graft_entry 4 --device cpu  # CPU ranks
"""

from __future__ import annotations

import contextlib
import os
import shutil
import sys
import tempfile
import time

import torch

from .device import DeviceLike, resolve


def entry(device: DeviceLike = None):
    from .ops.crdt_kernels import device_args, materialize_device
    from .ops.synth import synth_batch

    batch = synth_batch(n_docs=8, n_ops=256)
    example_args, A, K = device_args(batch, device=resolve(device))

    def forward(flags, slot, ctr, seq, obj, key, ref, value,
                psrc, ptgt, doc_actors):
        return materialize_device(
            flags, slot, ctr, seq, obj, key, ref, value,
            psrc, ptgt, doc_actors, A=A, K=K,
        )

    return forward, example_args


def _ranks(n: int, device: DeviceLike, ranks: str):
    """The n rank devices and how they were chosen."""
    dev = resolve(device)
    if dev.type == "cpu":
        return [dev] * n, f"{n} CPU ranks (plain versions)"
    if ranks == "virtual":
        card = torch.device("cuda", 0)
        return [card] * n, f"{n} virtual ranks of {torch.cuda.get_device_name(card)}"
    if ranks != "cards":
        raise ValueError(f"ranks={ranks!r}: 'cards' or 'virtual'")
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(
            f"measured_multichip({n}): {have} card(s) visible; ask for "
            "ranks='virtual' to run virtual ranks of one card, or "
            "device='cpu' for CPU ranks")
    return ([torch.device("cuda", i) for i in range(n)],
            f"{n} cards ({torch.cuda.get_device_name(0)}), peer mode")


@contextlib.contextmanager
def _visible(devices):
    """The backend's view of the visible ranks, for the block."""
    from .parallel import mesh as meshmod

    orig = meshmod.visible_devices
    meshmod.visible_devices = lambda: list(devices)
    try:
        yield
    finally:
        meshmod.visible_devices = orig


@contextlib.contextmanager
def _env(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _open(path, urls, device):
    """One cold open; returns (seconds, summaries, stats)."""
    from .repo import Repo

    t0 = time.perf_counter()
    repo = Repo(path=path, device=device)
    try:
        repo.open_many(urls)
        summ = repo.back.fetch_bulk_summaries()
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0, summ, dict(repo.back.last_bulk_stats)
    finally:
        repo.close()


def _rows(summ, doc_ids):
    out = {}
    for d in doc_ids:
        arrays, j = summ.arrays(d)
        out[d] = tuple(arrays[k][j].tobytes() for k in (
            "map_winner", "elem_live", "elem_order", "n_live_elems",
            "n_map_entries")) + (repr(summ.doc(d)),)
    return out


def measured_multichip(n_devices: int, device: DeviceLike = None,
                       ranks: str = "cards") -> str:
    from .ops.corpus import make_corpus
    from .ops.synth import synth_batch
    from .parallel.mesh import device_topology, make_mesh
    from .parallel.sharded import step
    from .utils.ids import validate_doc_url

    devices, how = _ranks(n_devices, device, ranks)
    dev = devices[0]
    sp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices, sp=sp, devices=devices)

    # 1. the library layer: materialize + clock union over the mesh
    batch = synth_batch(n_docs=max(8, 2 * n_devices), n_ops=128)
    out, union = step(batch, mesh)
    if out.rank.shape[0] < batch.n_docs or union.shape[-1] != len(batch.actors):
        raise AssertionError(f"step over {mesh}: {tuple(out.rank.shape)}, "
                             f"union {tuple(union.shape)}")

    # 2. the product layer, measured: a corpus on disk opened over the
    # ranks, in slabs that spread it over all of them
    n_docs = int(os.environ.get("HM_DRYRUN_DOCS", "2048"))
    n_ops = int(os.environ.get("HM_DRYRUN_OPS", "512"))
    per = max(1, n_docs // n_devices)
    slab = os.environ.get("HM_BULK_SLAB") or str(
        max(256, 1 << (per.bit_length() - 1)))
    tmp = tempfile.mkdtemp(prefix="hm-multichip-")
    try:
        src = os.path.join(tmp, "corpus")
        urls = make_corpus(src, n_docs, n_ops, sign=False)
        doc_ids = [validate_doc_url(u) for u in urls]
        multi_path = os.path.join(tmp, "multi")
        shutil.copytree(src, multi_path)
        with _visible(devices), _env(HM_BULK_SLAB=slab):
            wall, sharded, stats = _open(multi_path, urls, dev)
        topo = device_topology(mesh)
        multi = stats.get("rr_slabs", 0) + stats.get("sharded_slabs", 0)
        if multi < 1:
            raise AssertionError(f"the open did not use the ranks: {stats}")
        with _env(HM_MESH="0", HM_BULK_SLAB=slab):
            _w, single, _s = _open(src, urls, dev)
        got, want = _rows(sharded, doc_ids), _rows(single, doc_ids)
        bad = [d for d in doc_ids if got[d] != want[d]]
        if bad or len(sharded.doc_ids) != n_docs:
            raise AssertionError(f"{len(bad)} of {n_docs} summaries over "
                                 "the ranks differ from the single device's")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    line = (
        f"measured_multichip ok: {how}; mesh={dict(mesh.shape)} "
        f"mode={mesh.mode}; collective step docs={batch.n_docs} "
        f"ops/doc={batch.n_rows}; product open_many {n_docs} docs x {n_ops} "
        f"ops in slabs of {slab} MEASURED {wall:.3f}s "
        f"({n_docs * n_ops / wall:,.0f} ops/s), {multi} multi-device "
        f"slab(s) ({stats.get('rr_slabs', 0)} round-robin, "
        f"{stats.get('sharded_slabs', 0)} mesh-sharded; slabs/rank "
        f"{stats.get('slabs_per_chip')}); topology {topo}; multi-device == "
        "single-device summaries"
    )
    print(line, flush=True)
    return line


# the harness's hook name
dryrun_multichip = measured_multichip


def main(argv) -> None:
    import argparse

    p = argparse.ArgumentParser(prog="python -m hypermerge_tpu_torch.graft_entry")
    p.add_argument("n", nargs="?", type=int, default=None)
    p.add_argument("ranks", nargs="?", default="cards")
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    n = a.n if a.n is not None else torch.cuda.device_count()
    fn, args = entry(a.device)
    print("entry ok:", tuple(fn(*args).rank.shape), flush=True)
    measured_multichip(n, device=a.device, ranks=a.ranks)


if __name__ == "__main__":
    main(sys.argv[1:])
