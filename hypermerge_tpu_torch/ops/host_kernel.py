"""Numpy twin of the device materialization kernel — the interactive path
(the port's copy of hypermerge_tpu/ops/host_kernel.py).

A single cold `repo.open` must cost milliseconds, not a device round
trip for one document. This module computes exactly what
ops/crdt_kernels.py's kernel 1 computes (same algorithm: supersession
scatter, INC segment-sum, LWW lexsort winners, RGA forest via pointer
doubling + Wyllie ranking, local-slot clock) with numpy only, so the
backend's sidecar-based single-doc open (repo_backend._load_document_fast),
its lazy snapshots and the serving tier's install never replay per-op
host Python NOR touch the device.

Bit-equivalence with the kernel's plain version and with the reference's
twin is tested (tests/test_torch_repo.py::test_host_kernel_matches_plain).

Reference anchor: this replaces the per-change Automerge replay of
reference src/DocBackend.ts:144-167 for already-stored histories.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from ..crdt.change import Action
from .columnar import PAD, ColumnarBatch

_SET = int(Action.SET)
_INC = int(Action.INC)
_MAKE_LIST = int(Action.MAKE_LIST)
_MAKE_TEXT = int(Action.MAKE_TEXT)


class HostOut(NamedTuple):
    """Same lanes as crdt_kernels.MaterializeOut, numpy-backed."""

    dead: np.ndarray
    visible: np.ndarray
    map_winner: np.ndarray
    elem_winner: np.ndarray
    elem_live: np.ndarray
    rank: np.ndarray
    inc_total: np.ndarray
    clock: np.ndarray


def _ceil_log2(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


def _host_doc_kernel(
    action, actor, ctr, seq, obj, key, ref, insert, value, psrc, ptgt,
    doc_actors, A: int, K: int,
):
    N = len(action)
    idx = np.arange(N, dtype=np.int32)
    valid = action != PAD
    is_make = (action <= 3) & valid
    is_set = (action == _SET) & valid
    is_ins = (insert == 1) & valid

    slot = np.argmax(
        actor[:, None] == doc_actors[None, :], axis=1
    ).astype(np.int32)

    # -- 1. supersession ------------------------------------------------
    tgt = np.where(ptgt >= 0, ptgt, N)
    dead_ext = np.zeros(N + 1, bool)
    dead_ext[tgt] = True
    dead = dead_ext[:N]
    visible = (is_make | is_set) & ~dead

    # -- 2. counter increments -----------------------------------------
    is_inc = (action == _INC) & valid
    inc_tgt = np.clip(ref, 0, N - 1)
    inc_ok = is_inc & (ref >= 0) & ~dead[inc_tgt]
    inc_total = np.zeros(N + 1, np.int32)
    np.add.at(
        inc_total,
        np.where(inc_ok, inc_tgt, N),
        np.where(inc_ok, value, 0),
    )
    inc_total = inc_total[:N]

    # -- 3. LWW map winners --------------------------------------------
    in_map = visible & (key >= 0)
    gid = np.where(
        in_map, (obj.astype(np.int64) + 1) * (K + 1) + (key + 1), 0
    )
    order = np.lexsort((slot, ctr, gid))
    g_sorted = gid[order]
    run_end = np.concatenate([g_sorted[1:] != g_sorted[:-1], [True]])
    winner_sorted = run_end & (g_sorted > 0)
    map_winner = np.zeros(N, bool)
    map_winner[order] = winner_sorted

    # -- 4. element values: winner per element -------------------------
    comp = ctr * np.int32(A) + slot + 1
    is_elem_update = visible & ~is_ins & (key < 0) & (ref >= 0)
    own_value = visible & is_ins
    contrib = is_elem_update | own_value
    elem_of = np.where(is_elem_update, ref, np.where(own_value, idx, N))
    best = np.zeros(N + 1, np.int32)
    np.maximum.at(best, elem_of, np.where(contrib, comp, 0))
    best = best[:N]
    elem_live = is_ins & (best > 0)
    elem_winner = contrib & (comp == best[np.clip(elem_of, 0, N - 1)])

    # -- 5. RGA forest order -------------------------------------------
    is_seq_container = (
        (action == _MAKE_LIST) | (action == _MAKE_TEXT)
    ) & valid
    in_forest = is_ins | is_seq_container
    parent = np.where(
        is_ins, np.where(ref == -2, obj, ref), np.int32(-1)
    )
    pa = np.where(in_forest, parent + 1, N + 1)
    inv = np.int32(2**30) - comp
    order2 = np.lexsort((inv, pa)).astype(np.int32)
    pa_s = pa[order2]
    run_start = np.concatenate([[True], pa_s[1:] != pa_s[:-1]])
    fc_table = np.full(N + 2, -1, np.int32)
    fc_table[np.where(run_start, pa_s, N + 1)] = np.where(
        run_start, order2, -1
    )
    first_child = fc_table[idx + 1]
    nxt_in_sort = np.concatenate([order2[1:], [np.int32(-1)]])
    same_parent = np.concatenate([pa_s[1:] == pa_s[:-1], [False]])
    nsib = np.full(N, -1, np.int32)
    nsib[order2] = np.where(same_parent, nxt_in_sort, -1)

    has_sib = nsib != -1
    jump = np.where(
        has_sib, idx, np.where(parent >= 0, parent, N)
    ).astype(np.int32)
    jump = np.where(in_forest, jump, N)
    jump_ext = np.concatenate([jump, [np.int32(N)]])
    for _ in range(_ceil_log2(N) + 1):
        jump_ext = jump_ext[jump_ext]
    fix = jump_ext[:N]
    nsib_ext = np.concatenate([nsib, [np.int32(-1)]])
    succ = np.where(first_child != -1, first_child, nsib_ext[fix])
    succ = np.where(in_forest, succ, -1)
    nxt = np.where(succ == -1, N, succ).astype(np.int32)

    rank = np.where(in_forest, 1, 0).astype(np.int32)
    rank_ext = np.concatenate([rank, [np.int32(0)]])
    nxt_ext = np.concatenate([nxt, [np.int32(N)]])
    for _ in range(_ceil_log2(N) + 1):
        rank_ext = rank_ext + rank_ext[nxt_ext]
        nxt_ext = nxt_ext[nxt_ext]
    rank = rank_ext[:N]

    # -- 6. clock -------------------------------------------------------
    clock = np.zeros(A, np.int32)
    np.maximum.at(
        clock,
        np.where(valid, slot, 0),
        np.where(valid, seq, 0),
    )

    return HostOut(
        dead=dead,
        visible=visible,
        map_winner=map_winner,
        elem_winner=elem_winner,
        elem_live=elem_live,
        rank=rank,
        inc_total=inc_total,
        clock=clock,
    )


def run_batch_host(batch: ColumnarBatch) -> HostOut:
    """The host entry: same lanes as crdt_kernels.run_batch, stacked
    [D, ...] numpy arrays. Used for small interactive loads where a
    device dispatch (and its per-bucket compile) costs more than it
    saves; bulk loads should stay on the device path."""
    from .crdt_kernels import bucket_doc_actors

    da, A, K = bucket_doc_actors(batch)
    # widen: batches may carry narrow wire dtypes (int16/uint8) whose
    # composites (ctr * A) would overflow in-place
    c = {k: np.asarray(v, np.int32) for k, v in batch.cols.items()}
    psrc = np.asarray(batch.psrc, np.int32)
    ptgt = np.asarray(batch.ptgt, np.int32)
    outs = [
        _host_doc_kernel(
            c["action"][d], c["actor"][d], c["ctr"][d], c["seq"][d],
            c["obj"][d], c["key"][d], c["ref"][d], c["insert"][d],
            c["value"][d], psrc[d], ptgt[d], da[d], A, K,
        )
        for d in range(batch.n_docs)
    ]
    return HostOut(
        *(np.stack([getattr(o, f) for o in outs]) for f in HostOut._fields)
    )
