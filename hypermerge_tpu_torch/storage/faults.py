"""The storage backends' IO seam — the port's copy of the seam half of
hypermerge_tpu/storage/faults.py.

The reference routes every write-side file operation of its storage
backends through `io_open` / `io_fsync` / `io_replace` / `io_remove`,
so that a seeded fault plan (torn writes, ENOSPC, fsync lies) or a crash
recorder can sit in between. The port keeps the seam with the same
signatures, and behaves as the reference does with no harness active:
each call is the builtin. The fault-injection registry is not ported
yet.
"""

from __future__ import annotations

import os


def io_open(path: str, mode: str = "rb"):
    """open() for the storage backends."""
    return open(path, mode)


def io_fsync(fh) -> None:
    """fsync of an open file handle."""
    os.fsync(fh.fileno())


def io_replace(src: str, dst: str) -> None:
    """Atomic rename over `dst`."""
    os.replace(src, dst)


def io_remove(path: str) -> None:
    os.remove(path)
