"""Fleet-scale peer discovery: the pluggable seam (a cut copy of
hypermerge_tpu/net/discovery/__init__.py).

- `gossip.py`  GossipSampler: per-doc bounded fanout for the hot
               broadcast paths; anti-entropy covers the rest.
               Network builds one for every repo, so it is ported with
               the transport.

Not ported yet (ROADMAP.md Queue 1 item 1(c)): `dht.py`, the
Kademlia-lite UDP DHT, and `swarm.py`, the DhtSwarm that backs
Swarm.join/leave with DHT announce/lookup. Until then the port's swarms
are TcpSwarm (explicit addresses) and LoopbackSwarm.
"""

from .gossip import GossipSampler

__all__ = ["GossipSampler"]
