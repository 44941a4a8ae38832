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

from typing import Dict, List, Optional, Tuple

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


SERVE_SCENARIOS = ("random", "misses", "ties", "extreme_ranks", "all_masked")


def synth_live_edits(
    history: List[Change], n_changes: int, actor: str = "livepeer00",
    seed: int = 0, rename: Optional[Dict[str, str]] = None,
) -> List[Change]:
    """A remote peer's `n_changes` single-op edits extending `history`
    (the live engine's tick traffic), causal and gap-free: a counter,
    then a seeded mix of INC ops on it, deletes of the history's text
    elements, text inserts chained after the last element the history
    created, and root-key sets that conflict with the writer's (no
    preds). `rename` maps the history's actor ids to the ones stored
    (ops/corpus.py writes each doc under its own actor)."""
    rng = np.random.default_rng(seed)
    rename = rename or {}

    def opid(c: Change, i: int) -> OpId:
        o = c.op_id(i)
        return OpId(o.ctr, rename.get(o.actor, o.actor))

    clock: Dict[str, int] = {}
    max_op = 0
    text = None
    elems: List[OpId] = []
    for c in history:
        a = rename.get(c.actor, c.actor)
        clock[a] = max(clock.get(a, 0), c.seq)
        max_op = max(max_op, c.max_op)
        for i, op in enumerate(c.ops):
            if op.action == Action.MAKE_TEXT and text is None:
                text = opid(c, i)
            elif op.insert and text is not None and OpId(
                op.obj.ctr, rename.get(op.obj.actor, op.obj.actor)
            ) == text:
                elems.append(opid(c, i))
    deps = {a: s for a, s in clock.items() if a != actor}
    seq0 = clock.get(actor, 0)
    after = elems[-1] if elems else HEAD
    live = list(elems)
    counter = None
    out: List[Change] = []
    for j in range(n_changes):
        ctr = max_op + 1 + j
        kind = int(rng.integers(4))
        if counter is None:
            op = Op(action=Action.SET, obj=ROOT, key="cnt", value=1,
                    datatype="counter")
            counter = OpId(ctr, actor)
        elif kind == 0:
            op = Op(action=Action.INC, obj=ROOT, key="cnt",
                    value=int(rng.integers(1, 9)), pred=(counter,))
        elif kind == 1 and live and text is not None:
            e = live.pop(int(rng.integers(len(live))))
            op = Op(action=Action.DEL, obj=text, ref=e, pred=(e,))
        elif kind == 2 and text is not None:
            op = Op(action=Action.SET, obj=text, ref=after, insert=True,
                    value=chr(97 + int(rng.integers(26))))
            after = OpId(ctr, actor)
        else:
            op = Op(action=Action.SET, obj=ROOT,
                    key=f"k{int(rng.integers(10))}", value=j)
        out.append(Change(actor=actor, seq=seq0 + 1 + j, start_op=ctr,
                          deps=dict(deps), ops=(op,)))
    return out


def synth_serve_lanes(
    B: int, N: int, scenario: str = "random", seed: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read-serving query inputs: ([B, 6, N] int32 resident lanes in the
    serve/kernels.py layout, [B] int32 qobj, [B] int32 qkey).

    Each entry has a random count of real rows and pad rows behind them
    (OBJ = -3, KEY = -1, as serve/resident.py pads). Queries mostly name
    a container and key the entry holds. Scenarios: "random"; "misses"
    (queries that match nothing: absent containers and keys, and the
    NO_OBJ pad query); "ties" (ranks from three values, so most keys
    tie); "extreme_ranks" (ranks at and near both int32 ends, where
    -rank wraps); "all_masked" (every row matches its query)."""
    if scenario not in SERVE_SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r}")
    rng = np.random.default_rng(seed)
    i32 = np.iinfo(np.int32)
    lanes = np.zeros((B, 6, N), np.int32)
    qobj = np.zeros(B, np.int32)
    qkey = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(1, N + 1))
        live, rank, obj, ins, key, win = lanes[b]
        obj[:] = -3
        key[:] = -1
        obj[:n] = rng.integers(-1, 6, n)
        key[:n] = rng.integers(-1, 8, n)
        live[:n] = rng.random(n) < 0.6
        ins[:n] = rng.random(n) < 0.5
        win[:n] = rng.random(n) < 0.4
        if scenario == "ties":
            rank[:n] = rng.integers(0, 3, n)
        elif scenario == "extreme_ranks":
            rank[:n] = rng.choice(
                [i32.min, i32.min + 1, -1, 0, 1, i32.max - 1, i32.max], n
            )
        else:
            rank[:n] = rng.integers(0, 4 * N, n)
        q = int(rng.integers(0, n))
        qobj[b], qkey[b] = obj[q], max(int(key[q]), 0)
        if scenario == "all_masked":
            obj[:] = qobj[b]
            key[:] = qkey[b]
            live[:] = ins[:] = win[:] = 1
        elif scenario == "misses":
            qobj[b], qkey[b] = ((6, 0), (qobj[b], 9), (-7, -1))[b % 3]
    return lanes, qobj, qkey


ORDER_CASES = ("ties_across_head", "none_live", "all_live", "int32_ends")


def synth_order_lanes(
    case: str, B: int, N: int, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Element-order query inputs that stress serve_order's split into a
    sorted head and a tail in row order: ([B, 6, N] int32 lanes, [B]
    int32 qobj, every query naming container 3). Rows of another
    container and non-inserting rows are mixed in (except in "all_live"),
    so the mask is not the live lane alone. Cases: "ties_across_head"
    (ranks from three values), "none_live" (no row matches), "all_live"
    (every row matches, ranks over all of int32), "int32_ends" (ranks at
    and near both int32 ends: a live row of rank -2^31 + 1 has key
    INT32_MAX and belongs to the tail, one of rank INT32_MIN wraps to the
    lowest key)."""
    if case not in ORDER_CASES:
        raise ValueError(f"unknown case {case!r}")
    rng = np.random.default_rng(seed)
    i32 = np.iinfo(np.int32)
    lanes = np.zeros((B, 6, N), np.int32)
    live, rank, obj, ins = (lanes[:, k] for k in (0, 1, 2, 3))
    obj[:] = np.where(rng.random((B, N)) < 0.85, 3, 4)
    ins[:] = rng.random((B, N)) < 0.9
    live[:] = rng.random((B, N)) < 0.7
    if case == "ties_across_head":
        rank[:] = rng.integers(0, 3, (B, N))
    elif case == "none_live":
        live[:] = 0
        rank[:] = rng.integers(0, 4 * N, (B, N))
    elif case == "all_live":
        obj[:], ins[:], live[:] = 3, 1, 1
        rank[:] = rng.integers(i32.min, i32.max, (B, N), dtype=np.int64)
    else:
        rank[:] = rng.choice([i32.min, i32.min + 1, -1, 0, 1, i32.max - 1,
                              i32.max], (B, N))
    return lanes, np.full(B, 3, np.int32)
