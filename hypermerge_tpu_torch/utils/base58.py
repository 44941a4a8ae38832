"""Base58 (bitcoin alphabet) codec for key/id encoding.

The reference encodes all public keys / document ids as base58 strings via the
`bs58` npm package (reference src/Keys.ts:22-60). Implemented from the well
known alphabet definition; no external dependency.
"""

from __future__ import annotations

_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_INDEX = {c: i for i, c in enumerate(_ALPHABET)}


def encode(data: bytes) -> str:
    n = int.from_bytes(data, "big")
    out = []
    while n > 0:
        n, rem = divmod(n, 58)
        out.append(_ALPHABET[rem])
    # leading zero bytes -> leading '1's
    pad = 0
    for b in data:
        if b == 0:
            pad += 1
        else:
            break
    return "1" * pad + "".join(reversed(out))


def decode(text: str) -> bytes:
    n = 0
    for c in text:
        try:
            n = n * 58 + _INDEX[c]
        except KeyError:
            raise ValueError(f"invalid base58 character {c!r}") from None
    raw = n.to_bytes((n.bit_length() + 7) // 8, "big") if n else b""
    pad = 0
    for c in text:
        if c == "1":
            pad += 1
        else:
            break
    return b"\x00" * pad + raw
