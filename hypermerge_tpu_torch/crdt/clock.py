"""Vector-clock algebra over {actor_id: seq} maps — the port's copy of
hypermerge_tpu/crdt/clock.py, pure functions on the host.

Maps reference src/Clock.ts:3-113: cmp (GT/LT/CONCUR/EQ), gte, union,
intersection, addTo, equivalent, and the strs wire codec (`"<actor>:<seq>"`
strings, seq omitted when infinite). These are the host-side scalar twins of
the batched kernels in ops/clock_kernels.py; both must agree (the truth
tables of tests/test_clock.py, held against this copy in
tests/test_torch_clock.py).
"""

from __future__ import annotations

import enum
import math
from typing import Dict, Iterable, List, Tuple

Clock = Dict[str, int]  # actor id -> seq (may be math.inf for cursors)

INFINITY_SEQ = 2**53 - 1  # matches reference CursorStore INFINITY_SEQ


class Ordering(enum.Enum):
    GT = "GT"
    LT = "LT"
    CONCUR = "CONCUR"
    EQ = "EQ"


def _norm(seq: float) -> float:
    """math.inf and INFINITY_SEQ both mean 'infinite' — compare them equal."""
    return INFINITY_SEQ if seq >= INFINITY_SEQ else seq


def gte(a: Clock, b: Clock) -> bool:
    """True iff a dominates b: every actor's seq in b is <= its seq in a."""
    return all(_norm(a.get(actor, 0)) >= _norm(seq) for actor, seq in b.items())


def cmp(a: Clock, b: Clock) -> Ordering:
    a_gte = gte(a, b)
    b_gte = gte(b, a)
    if a_gte and b_gte:
        return Ordering.EQ
    if a_gte:
        return Ordering.GT
    if b_gte:
        return Ordering.LT
    return Ordering.CONCUR


def equivalent(a: Clock, b: Clock) -> bool:
    return cmp(a, b) is Ordering.EQ


def union(a: Clock, b: Clock) -> Clock:
    out = dict(a)
    for actor, seq in b.items():
        out[actor] = max(out.get(actor, 0), seq)
    return out


def intersection(a: Clock, b: Clock) -> Clock:
    out: Clock = {}
    for actor, seq in a.items():
        if actor in b:
            m = min(seq, b[actor])
            if m > 0:
                out[actor] = m
    return out


def add_to(acc: Clock, other: Clock) -> None:
    """In-place union (reference Clock.addTo)."""
    for actor, seq in other.items():
        if acc.get(actor, 0) < seq:
            acc[actor] = seq


def clock_to_strs(clock: Clock) -> List[str]:
    """Wire codec: `"<actor>"` for infinite seq, `"<actor>:<seq>"` otherwise
    (reference src/Clock.ts:40-66)."""
    out = []
    for actor, seq in sorted(clock.items()):
        if seq == math.inf or seq >= INFINITY_SEQ:
            out.append(actor)
        else:
            out.append(f"{actor}:{int(seq)}")
    return out


def strs_to_clock(strs: Iterable[str]) -> Clock:
    clock: Clock = {}
    for s in strs:
        actor, sep, seq = s.partition(":")
        clock[actor] = int(seq) if sep else INFINITY_SEQ
    return clock


def actor_axis(clocks: Iterable[Clock]) -> List[str]:
    """Stable union of actor ids across clocks — the dense actor axis used
    when packing clocks into device matrices."""
    seen: Dict[str, None] = {}
    for clock in clocks:
        for actor in clock:
            seen.setdefault(actor)
    return sorted(seen)


def pack(clocks: List[Clock], actors: List[str]) -> List[List[int]]:
    """Dense [n_clocks, n_actors] int rows (host-side; ops/clock_kernels.py
    turns these into device arrays)."""
    index = {a: i for i, a in enumerate(actors)}
    rows = []
    for clock in clocks:
        row = [0] * len(actors)
        for actor, seq in clock.items():
            row[index[actor]] = int(min(seq, INFINITY_SEQ))  # inf-safe clamp
        rows.append(row)
    return rows


def unpack(rows: List[List[int]], actors: List[str]) -> List[Clock]:
    return [
        {actors[i]: int(seq) for i, seq in enumerate(row) if seq > 0}
        for row in rows
    ]
