"""hypermerge_tpu_torch — the PyTorch/CUDA port of hypermerge_tpu.

The port runs the batched CRDT materialization (ops/crdt_kernels.py), the
summary wire, the sidecar pack, the clock store and the read-serving
queries on an NVIDIA Hopper GPU through hand-written CUDA kernels
(kernels/csrc/), with a plain PyTorch version of each kernel for tensors
on the CPU; `repo.Repo` is the user's entry point. It imports torch and numpy, never jax, and nothing of
the hypermerge_tpu package: the modules it needs are copied here under
the same names.
"""
