"""The port's command-line tools, one module each, run as
`python -m hypermerge_tpu_torch.tools.<name>`: cat, cp, ls, meta, scrub,
serve, top, watch (the JAX package's `tools/*.py`), lint, and
profile_trace (its `scripts/profile_trace.py`). Each has `main(argv=None)`
and prints what the reference tool prints. A tool that opens a repo runs
it on `--device` (the GPU unless `--device cpu` is given) and exits 1
with the device error when no GPU is present and the CPU was not asked
for: there is no fallback.
"""

from __future__ import annotations

import argparse


def parser(name: str, doc: str) -> argparse.ArgumentParser:
    return argparse.ArgumentParser(
        prog=f"python -m hypermerge_tpu_torch.{name}", description=doc
    )


def add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the repo's kernels run: the GPU unless the CPU is "
        "asked for (no fallback)",
    )


def device_of(ap: argparse.ArgumentParser, args):
    """`args.device` resolved (device.resolve); without a GPU and
    without `--device cpu` the tool exits 1 with the device error."""
    from ..device import resolve

    try:
        return resolve(args.device)
    except RuntimeError as e:
        ap.exit(1, f"{ap.prog}: {e}\n")
