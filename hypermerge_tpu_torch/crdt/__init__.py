"""CRDT core copied from hypermerge_tpu: ops, changes, patches, frontend state."""
