"""Bounded gossip relay: per-doc peer sampling caps active fanout.

Without a bound, every hot-path broadcast — replication live tails
(net/replication.py `_flush_feed`) and cursor gossip
(net/network.py) — costs O(connected peers) frames per event:
a 100-peer fleet amplifies every keystroke a hundredfold. HyParView's
insight is that an epidemic only needs a SMALL active view per node as
long as the union graph stays connected and the views reshuffle: this
sampler is that active view, per doc/feed key.

`sample(key, peers)` returns at most `HM_GOSSIP_FANOUT` of the given
peers (0 = unbounded). The subset is STABLE for `HM_GOSSIP_RESHUFFLE_S`
seconds per key — a stable subset lets the ack-paced replication
streams make progress instead of re-negotiating every frame — then
reshuffles to a fresh random subset, so over a few periods every edge
of the full peer graph gets exercised. A sampled peer that disconnects
triggers an immediate resample (the fanout budget must buy live edges).

Convergence across the sampled graph is guaranteed two ways:

- RELAY: a peer that receives replicated blocks extends its own feed,
  which marks its own flusher, which broadcasts to ITS sample — the
  epidemic hop. Fanout >= 2 with reshuffle floods any connected fleet
  in O(log N) rounds.
- ANTI-ENTROPY: the periodic FeedLength re-announce + cursor resend
  (`HM_ANTIENTROPY_S`, net/replication.py sweep) goes to EVERY
  verified peer, unsampled — a straggler the epidemic missed is
  bounded by one sweep period, and the sweep is O(peers) only once
  per interval, not per edit.

Only paths with a repair story are sampled: ephemeral doc messages
(Network.broadcast_doc_message) stay UNSAMPLED because they have no
relay hop and no sweep — a sampled-away peer would lose them forever.

The port's copy of hypermerge_tpu/net/discovery/gossip.py.
"""

from __future__ import annotations

import os
import random
import time
from typing import Dict, List, Sequence, Tuple

from ...analysis.lockdep import make_lock
from ... import telemetry

# process-wide counters (tools/top.py [gossip] group): sent = peers
# actually targeted, suppressed = peers the fanout bound skipped
_M_SENT = telemetry.counter("gossip.sent")
_M_SUPPRESSED = telemetry.counter("gossip.suppressed")
_M_RESHUFFLES = telemetry.counter("gossip.reshuffles")

_MAX_KEYS = 4096  # sample-table bound: prune expired past this


def _fanout() -> int:
    return int(os.environ.get("HM_GOSSIP_FANOUT", "8"))


def _reshuffle_s() -> float:
    return float(os.environ.get("HM_GOSSIP_RESHUFFLE_S", "5"))


class GossipSampler:
    """Per-key bounded random peer sampling with periodic reshuffle.

    Peers are any objects with a stable `id` attribute (NetworkPeer).
    Thread-safe; called from emission/flusher threads on the hot path,
    so the critical section is dict bookkeeping only."""

    def __init__(
        self,
        fanout: int = None,
        reshuffle_s: float = None,
        seed: int = None,
    ) -> None:
        self.fanout = _fanout() if fanout is None else int(fanout)
        self.reshuffle_s = (
            _reshuffle_s() if reshuffle_s is None else float(reshuffle_s)
        )
        self._rng = random.Random(seed)
        self._lock = make_lock("net.gossip")
        # key -> (expiry monotonic, chosen peer-id tuple)
        self._samples: Dict[str, Tuple[float, Tuple[str, ...]]] = {}
        # service-plane hook (set once by Network wiring before
        # traffic): an OverloadController whose BROWNOUT+ states thin
        # the relay fanout so foreground reads keep the cores
        self.overload_ctl = None

    def sample(self, key: str, peers: Sequence) -> List:
        """At most `fanout` of `peers` for this key — the same subset
        until the reshuffle deadline, provided every chosen peer is
        still present."""
        fanout = self.fanout
        ctl = self.overload_ctl
        if ctl is not None and fanout > 1 and ctl.deprioritize():
            # brownout: the epidemic yields to foreground traffic —
            # half the fanout (never below 1: relay still converges,
            # and the anti-entropy sweep bounds any straggler)
            fanout = max(1, fanout // 2)
            ctl.note_thinned_gossip()
        if fanout <= 0 or len(peers) <= fanout:
            if peers:
                _M_SENT.add(len(peers))
            return list(peers)
        by_id = {getattr(p, "id", str(p)): p for p in peers}
        now = time.monotonic()
        with self._lock:
            ent = self._samples.get(key)
            chosen: Tuple[str, ...] = ()
            if ent is not None and ent[0] > now:
                alive = tuple(i for i in ent[1] if i in by_id)
                if len(alive) == fanout:
                    chosen = alive
            if not chosen:
                chosen = tuple(
                    self._rng.sample(sorted(by_id), fanout)
                )
                self._samples[key] = (now + self.reshuffle_s, chosen)
                _M_RESHUFFLES.add(1)
                if len(self._samples) > _MAX_KEYS:
                    self._samples = {
                        k: v
                        for k, v in self._samples.items()
                        if v[0] > now
                    }
        out = [by_id[i] for i in chosen]
        _M_SENT.add(len(out))
        _M_SUPPRESSED.add(len(peers) - len(out))
        return out

    def invalidate(self, key: str = None) -> None:
        """Force the next `sample` to reshuffle (tests; churn hooks)."""
        with self._lock:
            if key is None:
                self._samples.clear()
            else:
                self._samples.pop(key, None)
