"""Build the CUDA kernels at first use and load them with ctypes.

Each source `csrc/<stem>.cu` compiles on its own with nvcc into
`_build/<stem>-<hash>.so`, a shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). The hash covers the
source, the headers and the flags, so an edited kernel rebuilds and an
unchanged one is reused. `build` starts one nvcc per source, all at
once, and waits for all of them. A build with preprocessor `defines`
(a test build of a source) is a library of its own beside the plain one.

Builds and loads are safe from several threads of one process (the
pipeline's pack workers may be first to call a kernel): one lock
serializes them, so a source compiles once. Across processes each
compile writes a temporary named by process and thread, published with
`os.replace`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

from ..analysis.lockdep import make_lock

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
STEMS = (
    "doc_kernel", "summary_wire", "pack_prefix",
    "clock_pair", "clock_union", "clock_scatter", "clock_topk",
    "serve_lookup", "serve_order", "serve_counts", "ring_gather",
)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# ptxas output (registers, shared memory, spills) of each build this
# process ran, by stem (and " -D<define>" for each define)
build_log: Dict[str, str] = {}
_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}
# held across a build and the load that follows it
_lock = make_lock("kernels.build")


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _flags(defines: Iterable[str]) -> List[str]:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def target(stem: str, defines: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:12]}.so"


def build(stems: Iterable[str] = STEMS,
          defines: Tuple[str, ...] = ()) -> Dict[str, Path]:
    """Build every stem that is not built yet, all nvcc runs in parallel;
    raises with the compiler's output if any build fails."""
    with _lock:
        return _build(stems, defines)


def _build(stems: Iterable[str], defines: Tuple[str, ...]) -> Dict[str, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {stem: target(stem, defines) for stem in stems}
    nvcc = nvcc_path()
    running: List[tuple] = []
    for stem, path in out.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc, *_flags(defines), "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((stem, path, tmp, proc))
    failed = []
    for stem, path, tmp, proc in running:
        log, _ = proc.communicate()
        build_log[stem + "".join(f" -D{d}" for d in defines)] = log
        if proc.returncode != 0:
            failed.append(f"{stem} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return out


def load(stem: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of one kernel source, built if needed."""
    lib = _libs.get((stem, defines))
    if lib is None:
        with _lock:
            lib = _libs.get((stem, defines))
            if lib is None:
                lib = ctypes.CDLL(str(_build([stem], defines)[stem]))
                _libs[stem, defines] = lib
    return lib
