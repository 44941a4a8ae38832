"""Central lint suppressions — each entry MUST carry a justification
(the linter rejects empty ones, and flags entries that match nothing).

Prefer the inline form next to the code it excuses:

    ...  # lint: allow(<rule>) — <why this specific site is safe>

and use this file only for exceptions that span several sites or
cannot carry a comment (generated code). Every entry is a reviewed,
documented decision — "the linter was noisy" is not a justification.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple


class Suppression(NamedTuple):
    rule: str  # one of linter.RULES
    path_glob: str  # repo-relative, fnmatch style
    contains: str  # substring the violating source line must contain
    justification: str


SUPPRESSIONS: Tuple[Suppression, ...] = ()
