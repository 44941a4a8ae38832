"""Machine-checked concurrency invariants.

Two halves over one rule set:

- the manifests: `hierarchy.py` — THE lock-hierarchy (ranks, leaves,
  no-block emission locks) plus the blocking-call and engine-entry
  tables; `guards.py` — THE shared-state guard map (which lock guards
  which field, GUARDED_BY-style, with declared escape classes);
  `envvars.py` — the HM_* env-var registry.
- the checkers: `linter.py` — the static AST pass (`python
  -m hypermerge_tpu_torch.tools.lint`, run in tier-1 by
  tests/test_torch_analysis.py);
  `lockdep.py` — the runtime detectors: `HM_LOCKDEP=1` lock-order/
  blocking instrumentation through the `make_lock`/`make_rlock`/
  `make_condition` factories, and `HM_RACEDEP=1` Eraser-style lockset
  race detection over the guard manifest's attributes.

`suppressions.py` holds the (justified) exceptions.
"""

from .lockdep import (  # noqa: F401
    blocking,
    enable as enable_lockdep,
    enabled as lockdep_enabled,
    install_racedep,
    make_condition,
    make_lock,
    make_rlock,
    maybe_install_racedep,
    racedep_enabled,
    uninstall_racedep,
)

__all__ = [
    "blocking",
    "enable_lockdep",
    "lockdep_enabled",
    "install_racedep",
    "make_condition",
    "make_lock",
    "make_rlock",
    "maybe_install_racedep",
    "racedep_enabled",
    "uninstall_racedep",
]
