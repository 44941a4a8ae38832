"""Bulk cold-open warmup — the port of hypermerge_tpu/ops/warmup.py.

A deployment that knows it is about to bulk-open a corpus (a server
starting up, the benchmark writing its corpus) can pay the first-use
costs of the slab path ahead of the load, in a daemon thread. In the
reference that cost is the XLA compile of each slab bucket's programs;
in the port it is building the CUDA kernels with nvcc (kernels/_build.py
caches them by source hash) and the first launch of each kernel per slab
bucket. `_warm` drives exactly the path `open_many` takes: single-writer
template feeds in sidecar caches -> `pack_docs_columns` ->
`run_batch_full`, at the slab buckets `bulk_buckets` predicts.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

from ..device import DeviceLike
from ..storage.colcache import FeedColumnCache, MemoryColumnStorage
from .columnar import pack_docs_columns, round_up_pow2
from .crdt_kernels import run_batch_full
from .synth import synth_changes

INF = float("inf")


def bulk_buckets(n_docs_total: int, slab: Optional[int] = None) -> List[int]:
    """The doc-axis buckets a bulk load of `n_docs_total` docs uses:
    full slabs of `slab` docs (default HM_BULK_SLAB, 4096, as the bulk
    loader reads it) share one bucket, the tail rounds up to its own
    power of two."""
    if slab is None:
        slab = int(os.environ.get("HM_BULK_SLAB", "4096"))
    buckets = []
    for base in range(0, n_docs_total, slab):
        chunk = min(slab, n_docs_total - base)
        b = round_up_pow2(chunk)
        if b not in buckets:
            buckets.append(b)
    return buckets


def _warm(
    n_docs_total: int,
    n_ops: int,
    slab: Optional[int],
    ops_per_change: int,
    distinct: int,
    seed: int,
    device: DeviceLike = None,
) -> None:
    n_rows = round_up_pow2(max(1, n_ops))

    # the corpus' own template histories -> identical value ranges, pred
    # widths and key tables
    specs = []
    for t in range(max(1, distinct)):
        # "actor00" is synth_changes' single-writer actor name — the
        # cache writer must match or refs look foreign and packing falls
        # off the no-sort fast path
        cc = FeedColumnCache(MemoryColumnStorage(), writer="actor00")
        for c in synth_changes(
            n_ops, n_actors=1, ops_per_change=ops_per_change, seed=seed + t
        ):
            cc.append_change(c)
        specs.append([(cc.columns(), 0, INF)])

    for bucket in bulk_buckets(n_docs_total, slab):
        batch = pack_docs_columns(
            specs[: min(len(specs), bucket)], n_docs=bucket, n_rows=n_rows,
            device=device,
        )
        lean = not batch.has_inc()
        _out, summary = run_batch_full(batch, lean=lean, device=device)
        summary[:1].cpu()  # wait for the launches to finish


def warmup_bulk(
    n_docs_total: int,
    n_ops: int,
    slab: Optional[int] = None,
    ops_per_change: int = 16,
    distinct: int = 8,
    seed: int = 0,
    background: bool = True,
    device: DeviceLike = None,
) -> Optional[threading.Thread]:
    """Build and first-launch the bulk-load kernels for a `n_docs_total`
    x `n_ops` corpus ahead of the load. `background=True` returns a
    started daemon thread (a load issued meanwhile simply waits on the
    build); `background=False` warms inline and returns None."""
    args = (n_docs_total, n_ops, slab, ops_per_change, distinct, seed, device)
    if background:
        th = threading.Thread(
            target=_warm, args=args, daemon=True, name="hm-warmup"
        )
        th.start()
        return th
    _warm(*args)
    return None
