"""hypermerge_tpu_torch — the PyTorch/CUDA port of hypermerge_tpu.

The port runs the batched CRDT materialization (ops/crdt_kernels.py), the
summary wire, the sidecar pack, the clock store and the read-serving
queries on an NVIDIA Hopper GPU through hand-written CUDA kernels
(kernels/csrc/), with a plain PyTorch version of each kernel for tensors
on the CPU; `repo.Repo` is the user's entry point. It imports torch and numpy, never jax, and nothing of
the hypermerge_tpu package: the modules it needs are copied here under
the same names.
"""

__version__ = "0.1.0"

from .utils.ids import (  # noqa: F401
    ActorId,
    DocId,
    DocUrl,
    HyperfileId,
    HyperfileUrl,
    RepoId,
    to_doc_url,
    to_hyperfile_url,
    url_to_id,
)

__all__ = [
    "ActorId",
    "DocId",
    "DocUrl",
    "HyperfileId",
    "HyperfileUrl",
    "RepoId",
    "to_doc_url",
    "to_hyperfile_url",
    "url_to_id",
    "__version__",
    "Repo",
]


def __getattr__(name):
    # the facade is imported on first use, not with the package: it pulls
    # in torch and the backend, which a frontend-only process (net/ipc.py's
    # connect_frontend, serve/overload.py) never loads
    if name == "Repo":
        from .repo import Repo

        return Repo
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
