"""Counter — a mergeable increment-only-conflict-free integer.

Parity: Automerge's Counter datatype (the reference re-exports Automerge
value types, reference src/index.ts:9-12). Concurrent increments all apply;
concurrent `set` replaces the counter (increments on the replaced counter op
are discarded with it).
"""

from __future__ import annotations


class Counter(int):
    """Immutable snapshot of a counter value. Mutation happens through the
    change-fn proxy (`proxy.increment(key, n)`), not on this object."""

    datatype = "counter"

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Counter({int(self)})"
