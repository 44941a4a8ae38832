"""Multi-device scale-out: the (dp, sp) mesh, the ring all-gather and the
sharded batched programs."""
