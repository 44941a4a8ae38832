"""ctypes loader for the port's host C++ layer (src/hm_native.cpp) — the
port's copy of hypermerge_tpu/native/__init__.py.

The library carries ed25519 and BLAKE2b merkle roots (utils/crypto.py),
the transport crypto, X25519 and ChaCha20-Poly1305-IETF (net/secure.py,
whose fallback is utils/chacha.py), brotli block frames (storage/block.py: blocks the reference wrote can be
"BR"-framed, so the port needs the same decoder), the columnar pack
entries (ops/columnar.py's host pack route, ops/pack_kernels.py's
marshal) and the binary change codec (crdt/codec.py). Every capability
degrades to a pure-Python or PyTorch path at the call site, as in the
reference, except reading a brotli block, which raises without it.

GIL contract: the library is loaded with ctypes.CDLL (never PyDLL), so
every foreign call runs with the GIL released. The pack and codec
entries touch only caller-owned buffers, which makes that sound; the
streaming slab pipeline (backend/pipeline.py) relies on it to pack
slabs on several threads at once (`pack_drops_gil`, `pack_parallel_ok`).

The library builds at first use with g++ into `_build/` (gitignored),
named by a hash of the source and the flags, so an edited source
rebuilds. The build is atomic: one process at a time compiles (an
`fcntl` lock on `_build/.lock`), into a temporary name, and `os.replace`
publishes the finished file. A process that waited on the lock finds the
library built and loads it, so parallel test workers never load a
half-written file.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

from ..analysis.lockdep import make_lock

CAP_SODIUM = 1
CAP_BROTLI = 2

CODEC_BROTLI = 1

SRC = Path(__file__).resolve().parent / "src" / "hm_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared"]
LD_FLAGS = ["-ldl"]

_lock = make_lock("native.load")
_lib: Optional[ctypes.CDLL] = None
_tried = False
# why the last load() found no library (None when it loaded)
load_error: Optional[str] = None


def target() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libhm_native-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """The built library's path, compiling it first if it is absent;
    raises with the compiler's output if the build fails."""
    out = target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while we waited
            return out
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the native library cannot be built")
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [gxx, *CXX_FLAGS, str(SRC), "-o", str(tmp), *LD_FLAGS],
            capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"native library build failed (g++ exit {proc.returncode}):\n"
                + proc.stdout + proc.stderr
            )
        os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    buf = ctypes.c_char_p
    size = ctypes.c_size_t
    lib.hm_caps.restype = ctypes.c_int
    lib.hm_ed25519_public.restype = ctypes.c_int
    lib.hm_ed25519_public.argtypes = [buf, buf]
    lib.hm_ed25519_sign.restype = ctypes.c_int
    lib.hm_ed25519_sign.argtypes = [buf, buf, size, buf]
    lib.hm_ed25519_verify.restype = ctypes.c_int
    lib.hm_ed25519_verify.argtypes = [buf, buf, size, buf]
    lib.hm_merkle_root.restype = ctypes.c_int
    lib.hm_merkle_root.argtypes = [buf, size, buf]
    lib.hm_x25519_base.restype = ctypes.c_int
    lib.hm_x25519_base.argtypes = [buf, buf]
    lib.hm_x25519.restype = ctypes.c_int
    lib.hm_x25519.argtypes = [buf, buf, buf]
    lib.hm_aead_encrypt.restype = ctypes.c_long
    lib.hm_aead_encrypt.argtypes = [buf, buf, buf, size, buf]
    lib.hm_aead_decrypt.restype = ctypes.c_long
    lib.hm_aead_decrypt.argtypes = [buf, buf, buf, size, buf]
    lib.hm_compress_bound.restype = size
    lib.hm_compress_bound.argtypes = [size]
    lib.hm_compress.restype = ctypes.c_long
    lib.hm_compress.argtypes = [ctypes.c_int, ctypes.c_int, buf, size, buf, size]
    lib.hm_decompress.restype = ctypes.c_long
    lib.hm_decompress.argtypes = [ctypes.c_int, buf, size, buf, size]
    ll = ctypes.c_longlong
    ptr = ctypes.c_void_p
    lib.hm_pack_value_minmax.restype = ctypes.c_int
    lib.hm_pack_value_minmax.argtypes = [ll] + [ptr] * 12
    lib.hm_pack_prefix.restype = ctypes.c_int
    lib.hm_pack_prefix.argtypes = [ll, ll, ll] + [ptr] * 16
    lib.hm_pack_gather.restype = ctypes.c_int
    lib.hm_pack_gather.argtypes = [ll] + [ptr] * 7
    lib.hm_change_encode.restype = ctypes.c_long
    lib.hm_change_encode.argtypes = [buf, size, buf, size]
    lib.hm_change_decode.restype = ctypes.c_long
    lib.hm_change_decode.argtypes = [buf, size, buf, size]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The bound library, built first if needed; None when it cannot be
    built or loaded (HM_NO_NATIVE set, no g++), with the reason in
    `load_error`."""
    global _lib, _tried, load_error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("HM_NO_NATIVE"):
            load_error = "HM_NO_NATIVE is set"
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(build())))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            load_error = str(e)
            _lib = None
        return _lib


def caps() -> int:
    lib = load()
    return lib.hm_caps() if lib is not None else 0


def available() -> bool:
    return load() is not None


def pack_lib() -> Optional[ctypes.CDLL]:
    """The library handle for the columnar pack entries; None without
    it."""
    return load()


def pack_drops_gil() -> bool:
    """True when the pack entries run GIL-free (a plain CDLL): what the
    pipelined bulk open's pack stage relies on to overlap packing with
    sidecar IO and the device dispatch."""
    lib = pack_lib()
    return lib is not None and not isinstance(lib, ctypes.PyDLL)


def pack_parallel_ok() -> bool:
    """True when the pack entries may run on several threads at once (the
    pipeline's pack pool, HM_PACK_WORKERS > 1): they are stateless C
    loops into caller-owned buffers, so concurrent calls with distinct
    output buffers are safe, and with the GIL dropped they run on as many
    cores."""
    return pack_drops_gil()


def codec_lib() -> Optional[ctypes.CDLL]:
    """The library handle for the change-frame codec; None without it."""
    return load()


def codec_drops_gil() -> bool:
    """True when the codec entry points run GIL-free (a plain CDLL)."""
    lib = codec_lib()
    return lib is not None and not isinstance(lib, ctypes.PyDLL)


def _codec_call(fn, data: bytes, guess: int) -> Optional[bytes]:
    """Counting-writer protocol shared by encode/decode: the entry
    point always returns the size it NEEDS and only writes what fits
    in cap, so one retry with the returned size always lands."""
    out = ctypes.create_string_buffer(guess)
    n = fn(data, len(data), out, guess)
    if n < 0:
        return None
    if n > guess:
        out = ctypes.create_string_buffer(n)
        n = fn(data, len(data), out, n)
        if n < 0 or n > len(out):
            return None
    return out.raw[:n]


def change_encode(raw: bytes) -> Optional[bytes]:
    """Canonical change JSON -> binary change frame; None when the
    native layer is absent or the input is off-canon."""
    lib = codec_lib()
    if lib is None:
        return None
    return _codec_call(lib.hm_change_encode, raw, len(raw) + 16)


def change_decode(frame: bytes) -> Optional[bytes]:
    """Binary change frame -> canonical change JSON; None when the
    native layer is absent or the frame is malformed."""
    lib = codec_lib()
    if lib is None:
        return None
    return _codec_call(lib.hm_change_decode, frame, 2 * len(frame) + 64)


def _sodium() -> Optional[ctypes.CDLL]:
    lib = load()
    if lib is None or not (lib.hm_caps() & CAP_SODIUM):
        return None
    return lib


def ed25519_public(seed: bytes) -> Optional[bytes]:
    lib = _sodium()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(32)
    if lib.hm_ed25519_public(seed, out) != 0:
        return None
    return out.raw


def ed25519_sign(seed: bytes, msg: bytes) -> Optional[bytes]:
    lib = _sodium()
    if lib is None:
        return None
    sig = ctypes.create_string_buffer(64)
    if lib.hm_ed25519_sign(seed, msg, len(msg), sig) != 0:
        return None
    return sig.raw


def ed25519_verify(pub: bytes, msg: bytes, sig: bytes) -> Optional[bool]:
    lib = _sodium()
    if lib is None:
        return None
    return bool(lib.hm_ed25519_verify(pub, msg, len(msg), sig))


def merkle_root(leaves: bytes) -> Optional[bytes]:
    """Root over concatenated 32-byte leaf hashes."""
    lib = _sodium()
    if lib is None:
        return None
    if len(leaves) % 32:
        raise ValueError("leaves must be a multiple of 32 bytes")
    out = ctypes.create_string_buffer(32)
    if lib.hm_merkle_root(leaves, len(leaves) // 32, out) != 0:
        return None
    return out.raw


def x25519_base(sk: bytes) -> Optional[bytes]:
    lib = _sodium()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(32)
    if lib.hm_x25519_base(sk, out) != 0:
        return None
    return out.raw


def x25519(sk: bytes, pk: bytes) -> Optional[bytes]:
    lib = _sodium()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(32)
    if lib.hm_x25519(sk, pk, out) != 0:
        return None
    return out.raw


def aead_encrypt(key: bytes, nonce: bytes, msg: bytes) -> Optional[bytes]:
    lib = _sodium()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(len(msg) + 16)
    n = lib.hm_aead_encrypt(key, nonce, msg, len(msg), out)
    if n < 0:
        return None
    return out.raw[:n]


_AEAD_FAIL = object()


def aead_decrypt(key: bytes, nonce: bytes, ct: bytes):
    """None = native unavailable; _AEAD_FAIL = authentication failed."""
    lib = _sodium()
    if lib is None:
        return None
    if len(ct) < 16:
        return _AEAD_FAIL
    out = ctypes.create_string_buffer(max(len(ct) - 16, 1))
    n = lib.hm_aead_decrypt(key, nonce, ct, len(ct), out)
    if n == -2:
        return None
    if n < 0:
        return _AEAD_FAIL
    return out.raw[:n]


def compress(codec: int, data: bytes, quality: int = 5) -> Optional[bytes]:
    lib = load()
    if lib is None:
        return None
    cap = lib.hm_compress_bound(len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.hm_compress(codec, quality, data, len(data), out, cap)
    if n < 0:
        return None
    return out.raw[:n]


def decompress(codec: int, data: bytes, raw_len: int) -> Optional[bytes]:
    lib = load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(max(raw_len, 1))
    n = lib.hm_decompress(codec, data, len(data), out, raw_len)
    if n < 0:
        return None
    return out.raw[:n]
