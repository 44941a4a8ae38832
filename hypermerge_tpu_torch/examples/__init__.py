"""The port's examples, run as `python -m
hypermerge_tpu_torch.examples.<name>`: `simple` (two repos replicating a
doc over a LoopbackSwarm in one process) and `chat` (P2P chat over an
encrypted TcpSwarm) — the JAX package's `examples/simple/simple.py` and
`examples/chat/chat.py`. Each runs its repos on `--device` (the GPU
unless `--device cpu` is given)."""
