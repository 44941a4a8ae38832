"""SecureSession — transport encryption (+ identity auth) for sockets.

Parity: the reference wraps every raw peer socket in a noise-encrypted
stream before multiplexing (noise-peer, reference
src/PeerConnection.ts:36). Here the equivalent is libsodium's kx
pattern, upgraded to mutual authentication when the caller supplies a
static ed25519 identity (noise-peer's XX mode; the repo's own keypair
plays the static role):

  handshake  each side sends a fresh ephemeral X25519 public key (one
             32-byte frame, the only plaintext on the wire)
  keys       q = X25519(own_sk, peer_pk);
             rx||tx = BLAKE2b-512(q || client_pk || server_pk)
             (client takes rx first — libsodium crypto_kx key schedule)
  auth       (when an identity is set) the FIRST encrypted frame each
             direction is identity_pk(32) || ed25519 signature over
             "hm-auth-v1" || client_pk || server_pk || role. Signing
             the ephemeral transcript binds the session keys to the
             identity: an active MITM that substitutes its own
             ephemerals cannot re-sign the victims' transcripts, so
             `verify_auth` fails closed and the transport drops.
  frames     ChaCha20-Poly1305-IETF per frame; the 12-byte nonce is a
             per-direction little-endian counter (strictly ordered
             stream over TCP, so counters never repeat or reorder)

Threat model, stated precisely: WITHOUT an identity the handshake is an
anonymous NN exchange — per-frame integrity holds inside the session,
but an active MITM can terminate both sides and read/modify traffic.
WITH identities both peers are mutually authenticated and the claimed
repo id is pinned to the transport (net/network.py rejects an Info
whose peerId differs from the proven identity). Auth is negotiated in
the plaintext flags byte (net/tcp.py), so by default a MITM can strip
the offer and downgrade both sides to anonymous — deployments that
must exclude that set HM_NET_AUTH=require, which refuses
unauthenticated peers outright. Either way
`channel_binding` exports a value unique to this session's ephemeral
transcript; the replication capability layer MACs it into every proof
(storage/integrity.py `capability`), so proofs can never be replayed
across connections even in anonymous mode.

A tampered ciphertext fails authentication; the transport MUST treat
that as fatal and drop the connection (net/tcp.py does).

Crypto routes through the native layer (libsodium) with the pure-Python
RFC 7748/8439 fallback in utils/chacha.py — both produce identical
wire bytes, so mixed endpoints interoperate.

The port's copy of hypermerge_tpu/net/secure.py.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

from .. import native
from ..utils import chacha


def _x25519_base(sk: bytes) -> bytes:
    pk = native.x25519_base(sk)
    return pk if pk is not None else chacha.x25519_base(sk)


def _x25519(sk: bytes, pk: bytes) -> bytes:
    out = native.x25519(sk, pk)
    return out if out is not None else chacha.x25519(sk, pk)


def _aead_encrypt(key: bytes, nonce: bytes, msg: bytes) -> bytes:
    ct = native.aead_encrypt(key, nonce, msg)
    return ct if ct is not None else chacha.aead_encrypt(key, nonce, msg)


def _aead_decrypt(key: bytes, nonce: bytes, ct: bytes) -> Optional[bytes]:
    out = native.aead_decrypt(key, nonce, ct)
    if out is None:  # native unavailable
        return chacha.aead_decrypt(key, nonce, ct)
    if out is native._AEAD_FAIL:
        return None
    return out


class SecureSession:
    """One connection's encryption state. Usage:

        s = SecureSession(is_client)
        send_frame(s.handshake_bytes)        # 32-byte ephemeral pk
        s.complete(recv_frame())             # peer's 32 bytes
        wire = s.encrypt(plaintext_frame)
        plain = s.decrypt(wire)              # None = TAMPERED: drop conn
    """

    def __init__(self, is_client: bool) -> None:
        self.is_client = is_client
        self._sk = os.urandom(32)
        self.handshake_bytes = _x25519_base(self._sk)
        self._tx_key: Optional[bytes] = None
        self._rx_key: Optional[bytes] = None
        self._tx_n = 0
        self._rx_n = 0
        # session-unique exporter over the ephemeral transcript (set in
        # complete); MAC'd into replication capability proofs so they
        # cannot be replayed on another connection
        self.channel_binding: Optional[bytes] = None
        # peer's proven ed25519 identity (base58), set by verify_auth
        self.peer_identity: Optional[str] = None
        self._transcript: Optional[bytes] = None

    @property
    def ready(self) -> bool:
        return self._tx_key is not None

    def complete(self, peer_pk: bytes) -> None:
        if len(peer_pk) != 32:
            raise ValueError("bad handshake frame")
        q = _x25519(self._sk, peer_pk)
        if q == b"\x00" * 32:
            # low-order peer point: the shared secret is public data
            # (libsodium rejects these; the pure path must too)
            raise ValueError("low-order handshake key rejected")
        if self.is_client:
            client_pk, server_pk = self.handshake_bytes, peer_pk
        else:
            client_pk, server_pk = peer_pk, self.handshake_bytes
        keys = hashlib.blake2b(
            q + client_pk + server_pk, digest_size=64
        ).digest()
        if self.is_client:
            self._rx_key, self._tx_key = keys[:32], keys[32:]
        else:
            self._tx_key, self._rx_key = keys[:32], keys[32:]
        self._transcript = client_pk + server_pk
        self.channel_binding = hashlib.blake2b(
            b"hm-cb-v1" + self._transcript, digest_size=32
        ).digest()
        del self._sk

    # -- identity authentication (XX upgrade) --------------------------

    def _signable(self, as_client: bool) -> bytes:
        role = b"C" if as_client else b"S"
        return b"hm-auth-v1" + self._transcript + role

    def auth_frame(self, identity_seed: bytes) -> bytes:
        """identity_pk(32) || sig(64) over this session's transcript +
        OUR role. Must be sent encrypted, before any user frame."""
        from ..utils import crypto

        pub = crypto.public_key(identity_seed)
        sig = crypto.sign(self._signable(self.is_client), identity_seed)
        return pub + sig

    def verify_auth(self, frame: bytes) -> bool:
        """Verify the peer's auth frame (their role in the transcript);
        pins `peer_identity` on success. False = impersonation/MITM —
        the transport must drop the connection."""
        from ..utils import base58, crypto

        if len(frame) != 96:
            return False
        pub, sig = frame[:32], frame[32:]
        if not crypto.verify(
            self._signable(not self.is_client), sig, pub
        ):
            return False
        self.peer_identity = base58.encode(pub)
        return True

    def _nonce(self, n: int) -> bytes:
        return n.to_bytes(12, "little")

    def encrypt(self, frame: bytes) -> bytes:
        ct = _aead_encrypt(self._tx_key, self._nonce(self._tx_n), frame)
        self._tx_n += 1
        return ct

    def decrypt(self, wire: bytes) -> Optional[bytes]:
        """Plaintext frame, or None when authentication fails (tampering
        or desync) — the caller must close the connection."""
        out = _aead_decrypt(self._rx_key, self._nonce(self._rx_n), wire)
        if out is not None:
            self._rx_n += 1
        return out
