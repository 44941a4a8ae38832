"""Feed column sidecars, copied from hypermerge_tpu.storage."""
