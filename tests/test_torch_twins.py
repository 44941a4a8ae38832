"""Every reference test has a port twin under its own name.

The reference's tests are the `tests/test_*.py` files not named
`test_torch_*`. For each `def test_*` in one of them (at module level or
in a class), some `tests/test_torch_*.py` must define a function of the
same name, which runs that case on the port. The files are read as text
(each `def test_*` line), never imported: this test reads no JAX and
needs no port module.

Exemptions (ROADMAP.md, "Reference tests with no port twin"):
- `test_bench_keys.py`: it pins bench.py's JSON keys, the JAX package's
  benchmark harness, which the port does not run;
- `test_fleet_soak.py`: its two soaks are `slow` in the reference and
  run outside tier-1.
"""

import re
from pathlib import Path

TESTS = Path(__file__).resolve().parent
EXEMPT = {
    "test_bench_keys.py": "bench.py's keys: the JAX package's harness",
    "test_fleet_soak.py": "slow soaks, outside tier-1",
}


_DEF = re.compile(r"^[ \t]*(?:async[ \t]+)?def[ \t]+(test_\w+)", re.M)


def _test_names(path: Path) -> set:
    return set(_DEF.findall(path.read_text()))


def _reference_files():
    return sorted(
        p for p in TESTS.glob("test_*.py")
        if not p.name.startswith("test_torch_")
    )


def test_every_reference_test_has_a_port_twin():
    port = set()
    for p in TESTS.glob("test_torch_*.py"):
        port |= _test_names(p)
    owed = [
        f"{p.name}::{name}"
        for p in _reference_files()
        if p.name not in EXEMPT
        for name in sorted(_test_names(p) - port)
    ]
    assert not owed, f"{len(owed)} reference tests have no port twin: {owed}"


def test_exemptions_name_existing_files():
    names = {p.name for p in _reference_files()}
    assert set(EXEMPT) <= names, set(EXEMPT) - names
