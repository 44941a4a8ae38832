"""ed25519 signing and verification through OpenSSL's libcrypto (EVP, by
ctypes): the route of utils/crypto.py on a host whose native library found
no libsodium.

Signing is RFC 8032's, so a signature's bytes equal libsodium's and the
pure-Python ones' (utils/ed25519.py) for the same seed and message.
Verification adds, before libcrypto's own check, the ones libsodium makes
and libcrypto does not: the public key's encoding canonical, and neither
the public key nor R of small order. So this route accepts exactly what
libsodium accepts. (The pure-Python route, a copy of the reference's, is
laxer there: it accepts a signature forged under a small-order key or R,
which no honest signer makes.) Each call runs in C with the GIL
released, where pure Python holds the GIL for milliseconds a signature or
check. Every entry returns None when libcrypto, or its ed25519, is not
there.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

from ..analysis.lockdep import make_lock

_NID_ED25519 = 1087
_P = 2**255 - 19
# the y of a point of order 8; the other is _P - _Y8
_Y8 = 2707385501144840649318225287225658788936804267575313519463743609750303402022
# encodings libsodium's ge25519_has_small_order refuses, by y with the
# sign bit cleared: the eight points of small order, and p and p + 1,
# the non-canonical forms of 0 and 1
_SMALL_Y = frozenset((0, 1, _P - 1, _Y8, _P - _Y8, _P, _P + 1))
_Y_MASK = (1 << 255) - 1
_lock = make_lock("util.ossl")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, sz, buf = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p
    for name, res, args in (
        ("EVP_PKEY_new_raw_private_key", p, [ctypes.c_int, p, buf, sz]),
        ("EVP_PKEY_new_raw_public_key", p, [ctypes.c_int, p, buf, sz]),
        ("EVP_PKEY_free", None, [p]),
        ("EVP_MD_CTX_new", p, []),
        ("EVP_MD_CTX_free", None, [p]),
        ("EVP_DigestSignInit", ctypes.c_int, [p, p, p, p, p]),
        ("EVP_DigestSign", ctypes.c_int,
         [p, buf, ctypes.POINTER(sz), buf, sz]),
        ("EVP_DigestVerifyInit", ctypes.c_int, [p, p, p, p, p]),
        ("EVP_DigestVerify", ctypes.c_int, [p, buf, sz, buf, sz]),
    ):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    return lib


def load() -> Optional[ctypes.CDLL]:
    """libcrypto with its EVP ed25519 entries bound; None without it."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        for name in ("libcrypto.so.3", ctypes.util.find_library("crypto")):
            if not name:
                continue
            try:
                lib = _bind(ctypes.CDLL(name))
            except (OSError, AttributeError):
                continue
            key = lib.EVP_PKEY_new_raw_private_key(
                _NID_ED25519, None, b"\x00" * 32, 32)
            if key:
                lib.EVP_PKEY_free(key)
                _lib = lib
                break
        return _lib


def _y(enc: bytes) -> int:
    return int.from_bytes(enc, "little") & _Y_MASK


def ed25519_sign(seed: bytes, msg: bytes) -> Optional[bytes]:
    lib = load()
    if lib is None or len(seed) != 32:
        return None
    key = lib.EVP_PKEY_new_raw_private_key(_NID_ED25519, None, seed, 32)
    if not key:
        return None
    ctx = lib.EVP_MD_CTX_new()
    try:
        sig = ctypes.create_string_buffer(64)
        n = ctypes.c_size_t(64)
        if (not ctx
                or lib.EVP_DigestSignInit(ctx, None, None, None, key) != 1
                or lib.EVP_DigestSign(ctx, sig, ctypes.byref(n), msg,
                                      len(msg)) != 1):
            return None
        return sig.raw[: n.value]
    finally:
        lib.EVP_MD_CTX_free(ctx)
        lib.EVP_PKEY_free(key)


def ed25519_verify(pub: bytes, msg: bytes, sig: bytes) -> Optional[bool]:
    lib = load()
    if lib is None:
        return None
    if len(pub) != 32 or len(sig) != 64:
        return False
    a = _y(pub)
    if a >= _P or a in _SMALL_Y or _y(sig[:32]) in _SMALL_Y:
        return False  # libsodium's checks, which libcrypto does not make
    key = lib.EVP_PKEY_new_raw_public_key(_NID_ED25519, None, pub, 32)
    if not key:
        return False  # not a point: no signature under it verifies
    ctx = lib.EVP_MD_CTX_new()
    try:
        if not ctx or lib.EVP_DigestVerifyInit(ctx, None, None, None,
                                               key) != 1:
            return None
        return lib.EVP_DigestVerify(ctx, sig, len(sig), msg, len(msg)) == 1
    finally:
        lib.EVP_MD_CTX_free(ctx)
        lib.EVP_PKEY_free(key)
