"""Synthetic CRDT workload generator — benchmark corpora.

Generates `examples/chat`-shaped documents (BASELINE.json configs 1/3/4:
text-heavy multi-actor edit histories with LWW map churn) two ways:

- `synth_columns`: straight into numpy columnar form (fast; used to build
  the 10k-doc bench batches without 10M Python op objects). The histories
  are structurally valid: lamport-monotone ctrs, per-actor seq chains,
  RGA refs into prior elements, LWW pred chains per map key.
- `synth_changes`: the same shape as Change objects (used for the host
  baseline and for equivalence spot-checks between the two generators).

Both use the same parameterization so device-vs-host throughput compares
the same logical workload.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..crdt.change import HEAD, ROOT, Action, Change, Op, OpId
from .columnar import COLUMNS, PAD


def synth_columns(
    n_ops: int,
    n_actors: int = 3,
    ops_per_change: int = 10,
    text_frac: float = 0.85,
    n_keys: int = 10,
    seed: int = 0,
) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
    """One doc's history as columnar arrays (length n_ops) + pred edges.

    Row 0 is the MAKE_TEXT; remaining rows are text inserts (ref = a
    prior element or HEAD) or root map SETs (pred-chained per key).
    """
    rng = np.random.default_rng(seed)
    n = n_ops
    action = np.full(n, int(Action.SET), np.int32)
    obj = np.zeros(n, np.int32)
    key = np.full(n, -1, np.int32)
    ref = np.full(n, -3, np.int32)
    insert = np.zeros(n, np.int32)
    vkind = np.zeros(n, np.int32)
    value = np.zeros(n, np.int32)
    dt = np.zeros(n, np.int32)

    action[0] = int(Action.MAKE_TEXT)
    obj[0] = -1
    key[0] = n_keys  # key table: 0..n_keys-1 are map keys, n_keys = "t"

    is_text = rng.random(n) < text_frac
    is_text[0] = False
    text_rows = np.nonzero(is_text)[0]
    # k-th text row references a uniformly random earlier text row (RGA
    # chain/tree mix) or HEAD for the first
    k = np.arange(len(text_rows))
    pick = np.floor(rng.random(len(text_rows)) * k).astype(np.int64)
    refs = np.where(k == 0, -2, text_rows[np.minimum(pick, np.maximum(k - 1, 0))])
    ref[text_rows] = refs.astype(np.int32)
    insert[text_rows] = 1
    vkind[text_rows] = 3  # VK_STR
    value[text_rows] = rng.integers(0, 26, len(text_rows))  # char table idx

    map_rows = np.nonzero(~is_text)[0][1:]  # skip row 0
    mkeys = rng.integers(0, n_keys, len(map_rows)).astype(np.int32)
    key[map_rows] = mkeys
    vkind[map_rows] = 1  # VK_INT
    value[map_rows] = rng.integers(0, 1000, len(map_rows))

    # pred chains: each map SET supersedes the previous SET of its key
    psrc_list: List[int] = []
    ptgt_list: List[int] = []
    last_for_key: Dict[int, int] = {}
    for r, mk in zip(map_rows.tolist(), mkeys.tolist()):
        prev = last_for_key.get(mk)
        if prev is not None:
            psrc_list.append(r)
            ptgt_list.append(prev)
        last_for_key[mk] = r

    actor = ((np.arange(n) // ops_per_change) % n_actors).astype(np.int32)
    ctr = np.arange(1, n + 1, dtype=np.int32)
    # per-actor change seq: change index c = row // ops_per_change is the
    # (c // n_actors + 1)-th change of its actor
    change_idx = np.arange(n) // ops_per_change
    seq = (change_idx // n_actors + 1).astype(np.int32)

    cols = {
        "action": action,
        "actor": actor,
        "ctr": ctr,
        "seq": seq,
        "obj": obj,
        "key": key,
        "ref": ref,
        "insert": insert,
        "vkind": vkind,
        "value": value,
        "dt": dt,
    }
    psrc = np.asarray(psrc_list, np.int32)
    ptgt = np.asarray(ptgt_list, np.int32)
    return cols, psrc, ptgt


def synth_batch(
    n_docs: int,
    n_ops: int,
    n_actors: int = 3,
    distinct: int = 8,
    seed: int = 0,
    **kw,
):
    """A ColumnarBatch of n_docs synthetic docs (cycling `distinct`
    generated histories — throughput benchmarking doesn't need 10k unique
    histories, and generation stays O(distinct * n_ops))."""
    from .columnar import ColumnarBatch, _round_up

    protos = [
        synth_columns(n_ops, n_actors=n_actors, seed=seed + i, **kw)
        for i in range(min(distinct, n_docs))
    ]
    N = _round_up(n_ops)
    P_len = _round_up(max(max(len(p[1]) for p in protos), 1))
    D = n_docs
    cols = {name: np.zeros((D, N), np.int32) for name in COLUMNS}
    cols["action"][:] = PAD
    cols["obj"][:] = -1
    cols["key"][:] = -1
    cols["ref"][:] = -3
    psrc = np.full((D, P_len), -1, np.int32)
    ptgt = np.full((D, P_len), -1, np.int32)
    for d in range(D):
        c, ps, pt = protos[d % len(protos)]
        for name in COLUMNS:
            cols[name][d, :n_ops] = c[name]
        psrc[d, : len(ps)] = ps
        ptgt[d, : len(pt)] = pt
    actors = [f"actor{i:02d}" for i in range(n_actors)]
    keys = [f"k{i}" for i in range(kw.get("n_keys", 10))] + ["t"]
    strings = [chr(97 + i) for i in range(26)]
    return ColumnarBatch(
        cols=cols,
        psrc=psrc,
        ptgt=ptgt,
        n_ops=np.full((D,), n_ops, np.int32),
        actors=actors,
        keys=keys,
        strings=strings,
        floats=[],
        bigints=[],
        doc_actors=np.tile(
            np.arange(n_actors, dtype=np.int32), (D, 1)
        ),
    )


def synth_changes(
    n_ops: int,
    n_actors: int = 3,
    ops_per_change: int = 10,
    text_frac: float = 0.85,
    n_keys: int = 10,
    seed: int = 0,
) -> List[Change]:
    """The same workload as Change objects (host-baseline replay)."""
    cols, psrc, ptgt = synth_columns(
        n_ops, n_actors, ops_per_change, text_frac, n_keys, seed
    )
    actors = [f"actor{i:02d}" for i in range(n_actors)]
    keys = [f"k{i}" for i in range(n_keys)] + ["t"]
    strings = [chr(97 + i) for i in range(26)]
    pred_of: Dict[int, List[int]] = {}
    for s, t in zip(psrc.tolist(), ptgt.tolist()):
        pred_of.setdefault(s, []).append(t)

    def opid(row: int) -> OpId:
        return OpId(int(cols["ctr"][row]), actors[int(cols["actor"][row])])

    changes: List[Change] = []
    clock: Dict[str, int] = {}
    row = 0
    n = n_ops
    while row < n:
        end = min(row + ops_per_change, n)
        a = actors[int(cols["actor"][row])]
        seq = int(cols["seq"][row])
        ops = []
        for r in range(row, end):
            act = Action(int(cols["action"][r]))
            o = ROOT if cols["obj"][r] == -1 else opid(int(cols["obj"][r]))
            kid = int(cols["key"][r])
            rf = int(cols["ref"][r])
            ops.append(
                Op(
                    action=act,
                    obj=o,
                    key=keys[kid] if kid >= 0 else None,
                    ref=HEAD if rf == -2 else (opid(rf) if rf >= 0 else None),
                    insert=bool(cols["insert"][r]),
                    value=(
                        strings[int(cols["value"][r])]
                        if cols["vkind"][r] == 3
                        else int(cols["value"][r])
                        if cols["vkind"][r] == 1
                        else None
                    ),
                    pred=tuple(opid(t) for t in pred_of.get(r, ())),
                )
            )
        deps = {k: v for k, v in clock.items() if k != a}
        changes.append(
            Change(
                actor=a,
                seq=seq,
                start_op=int(cols["ctr"][row]),
                deps=deps,
                ops=tuple(ops),
            )
        )
        clock[a] = seq
        row = end
    return changes
