"""The device-resident read-serving tier — the port of
hypermerge_tpu/serve/.

Layout:
- ``resident.py`` — the residency cache: per-doc summary lanes pinned
  in device memory, keyed by serving clock, byte-bounded LRU.
- ``kernels.py`` — batched query kernels (element order, map lookup,
  counts): hand-written CUDA kernels with plain PyTorch versions.
- ``batcher.py`` — bounded admission + debounced batch flush.
- ``tier.py`` — ServeTier (the RepoBackend-facing surface) and
  ``host_read``, the bit-identical HM_SERVE=0 twin.
- ``overload.py`` — the service plane (on under HM_SERVICE=1): brownout
  ladder, per-tenant quotas, typed Overload refusals (torch-free;
  frontends import it).

The tier symbols resolve lazily (PEP 562), as in the reference:
importing ``serve.overload`` from a frontend process must not drag the
kernel stack (tier -> resident -> kernels -> torch) into a process that
never serves reads.
"""

from typing import Any

__all__ = ["READ_KINDS", "ServeDeviceError", "ServeTier", "host_read"]


def __getattr__(name: str) -> Any:
    if name in __all__:
        from . import tier

        return getattr(tier, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
