"""Fleet-scale peer discovery: the pluggable seam, filled (the port's
copy of hypermerge_tpu/net/discovery/__init__.py).

- `dht.py`     Kademlia-lite UDP DHT — k-buckets with LRU-plus-liveness
               eviction, iterative find_node/announce/lookup, signed+
               TTL'd announce records, HM_DHT_BOOTSTRAP.
- `swarm.py`   DhtSwarm: Swarm.join/leave backed by DHT announce/
               lookup; dial targets (a bounded random active view)
               flow into the TcpSwarm's SessionSupervisor.
- `gossip.py`  GossipSampler: per-doc bounded fanout for the hot
               broadcast paths; anti-entropy covers the rest.
"""

from .dht import (
    DhtNode,
    RecordStore,
    RoutingTable,
    bootstrap_from_env,
    key_id,
    make_record,
    verify_record,
)
from .gossip import GossipSampler
from .swarm import DhtSwarm

__all__ = [
    "DhtNode",
    "DhtSwarm",
    "GossipSampler",
    "RecordStore",
    "RoutingTable",
    "bootstrap_from_env",
    "key_id",
    "make_record",
    "verify_record",
]
