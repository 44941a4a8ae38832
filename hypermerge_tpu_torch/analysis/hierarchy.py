"""The telemetry naming rule — the port's copy of the one part of
hypermerge_tpu/analysis/hierarchy.py that telemetry/registry.py reads.
The lock-class manifest itself is not ported (analysis/lockdep.py checks
no lock order)."""

from __future__ import annotations

import re

# a metric name: dotted lower-case segments, at least two
TELEMETRY_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+)+$")
