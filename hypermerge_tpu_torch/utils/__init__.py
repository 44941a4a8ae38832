"""Host-side utility primitives (queues, id codecs, logging)."""
