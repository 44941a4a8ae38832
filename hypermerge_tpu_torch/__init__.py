"""hypermerge_tpu_torch — the PyTorch/CUDA port of hypermerge_tpu.

The port runs the batched CRDT materialization (ops/crdt_kernels.py) and
the summary wire on an NVIDIA Hopper GPU through hand-written CUDA
kernels (kernels/csrc/), with a plain PyTorch version of each kernel for
tensors on the CPU. It imports torch and numpy, never jax, and nothing of
the hypermerge_tpu package: the modules it needs are copied here under
the same names.
"""
