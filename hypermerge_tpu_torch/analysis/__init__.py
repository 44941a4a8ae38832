"""Lock factories copied from hypermerge_tpu.analysis."""
