"""Batched materialization: columnar pack, CUDA kernel entries, decoders."""
