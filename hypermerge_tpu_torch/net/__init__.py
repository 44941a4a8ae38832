"""Network layer: peer connections, replication, pluggable discovery
(SURVEY.md §1.5).

The port's copy of hypermerge_tpu/net/__init__.py.
"""
