"""Every case of tests/test_native.py under its own name on the port's
host C++ layer (hypermerge_tpu_torch/native/) and the crypto and block
codec above it. Each value is also held against the reference package's
answer on the same inputs: its native ed25519, merkle roots and blake2b,
its block bytes for the same object (brotli, forced zlib, raw), its
crypto facade's signatures, and its Repo reading a copy of the port's
repo; tolerance 0 (byte-equal).

The port's library was cut to what the port calls: it has no zlib
capability bit (storage/block.py writes "ZL" blocks through Python's
`zlib`) and no blake2b entry (utils/crypto.py hashes with `hashlib`).
The twins of the cases that exercise those assert the port's routes and
the reference's bytes.

The twinned file's own docstring follows.

Native C++ layer: build/load, crypto parity, brotli block codec.

The native layer replaces the reference's native npm addons (SURVEY.md
§2.4: sodium-native ed25519/blake2b, iltorb brotli). Every capability has
a pure-Python fallback, so these tests assert (a) the native path works
when available, (b) native and fallback agree bit-for-bit, (c) the
framework still functions with the native layer disabled.
"""

import hashlib
import os
import subprocess
import sys

import pytest

from hypermerge_tpu import native as ref_native
from hypermerge_tpu.storage import block as ref_block
from hypermerge_tpu.utils import crypto as ref_crypto
from hypermerge_tpu_torch import native
from hypermerge_tpu_torch.storage import block as blockmod
from hypermerge_tpu_torch.utils import crypto
from hypermerge_tpu_torch.utils import ed25519 as pure
from port_helpers import assert_reference_reads, env_vars, plainify

needs_native = pytest.mark.skipif(
    not native.available(), reason="native layer did not build/load"
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@needs_native
def test_native_caps_all_present():
    caps = native.caps()
    # the port's library has no zlib bit: "ZL" blocks go through Python's
    # zlib (storage/block.py)
    assert not hasattr(native, "CAP_ZLIB")
    # this image ships libsodium + libbrotli; if either vanishes the
    # fallbacks still run but we want to notice
    assert caps & native.CAP_SODIUM
    assert caps & native.CAP_BROTLI
    # the reference's library found the same two
    if ref_native.available():
        ref_caps = ref_native.caps()
        assert bool(ref_caps & ref_native.CAP_SODIUM)
        assert bool(ref_caps & ref_native.CAP_BROTLI)


@needs_native
def test_ed25519_native_matches_pure_python():
    seed = bytes(range(32))
    msg = b"the quick brown fox"
    pub_n = native.ed25519_public(seed)
    sig_n = native.ed25519_sign(seed, msg)
    assert pub_n == pure.public_key(seed)
    assert sig_n == pure.sign(msg, seed)
    assert native.ed25519_verify(pub_n, msg, sig_n) is True
    assert native.ed25519_verify(pub_n, msg + b"!", sig_n) is False
    assert pure.verify(msg, sig_n, pub_n)
    # the reference's key and signature for the same seed and message
    assert pub_n == ref_crypto.public_key(seed)
    assert sig_n == ref_crypto.sign(msg, seed)


@needs_native
def test_blake2b_native_matches_hashlib():
    """The port cut the native blake2b entry: its hashes come from
    hashlib, which must equal the reference's native entry."""
    assert not hasattr(native, "blake2b")
    for data, key in ((b"", b""), (b"abc", b""), (b"x" * 1000, b"k" * 32)):
        want = hashlib.blake2b(data, key=key, digest_size=32).digest()
        if ref_native.available():
            assert ref_native.blake2b(data, key, 32) == want
        if not key:
            assert crypto.blake2b32(data) == want
            assert ref_crypto.blake2b32(data) == want


@needs_native
def test_merkle_root_native_matches_fallback(monkeypatch):
    leaves = [crypto.leaf_hash(bytes([i]) * 10) for i in range(7)]
    assert leaves == [ref_crypto.leaf_hash(bytes([i]) * 10)
                      for i in range(7)]
    want = crypto.merkle_root(leaves)
    assert want == ref_crypto.merkle_root(leaves)
    # force the pure-Python path and compare
    monkeypatch.setattr(native, "merkle_root", lambda _: None)
    assert crypto.merkle_root(leaves) == want
    assert crypto.merkle_root([]) == b"\x00" * 32
    assert crypto.merkle_root(leaves[:1]) == leaves[0]


@needs_native
def test_block_codec_brotli_roundtrip():
    obj = {"actor": "a" * 44, "ops": [{"k": f"key{i}"} for i in range(50)]}
    data = blockmod.pack(obj)
    assert data[:2] == b"BR"
    assert blockmod.unpack(data) == obj
    # the reference unpacks the port's block, and packs the same bytes
    assert ref_block.unpack(data) == obj
    if ref_native.available():
        assert ref_block.pack(obj) == data


def test_block_codec_reads_all_formats():
    """zlib-written and raw-JSON blocks stay readable regardless of the
    writer configuration (feed forward/backward compatibility)."""
    import zlib

    from hypermerge_tpu_torch.utils.json_buffer import bufferify
    from hypermerge_tpu.utils.json_buffer import bufferify as ref_bufferify

    obj = {"x": [1, 2, 3], "s": "abc" * 100}
    raw = bufferify(obj)
    assert raw == ref_bufferify(obj)
    legacy_zlib = b"ZL" + zlib.compress(raw, level=6)
    assert blockmod.unpack(legacy_zlib) == obj
    assert blockmod.unpack(raw) == obj  # raw JSON (incompressible path)
    assert ref_block.unpack(legacy_zlib) == ref_block.unpack(raw) == obj


def test_block_codec_rejects_corrupt_blocks_with_valueerror():
    """Remote blocks are untrusted: every corrupt shape must surface as
    ValueError (what Actor._parse_block catches), never struct.error /
    zlib.error / a giant allocation — in both packages."""
    import struct

    cases = [
        b"BRxy",  # truncated header
        b"BR" + struct.pack("<I", 0xFFFFFFFF) + b"junk",  # 4GiB claim
        b"BR" + struct.pack("<I", 100) + b"notbrotli",  # bad stream
        b"ZL" + b"notzlib",  # bad zlib stream
    ]
    for data in cases:
        with pytest.raises(ValueError):
            blockmod.unpack(data)
        with pytest.raises(ValueError):
            ref_block.unpack(data)


def test_block_codec_forced_zlib(monkeypatch):
    """HM_BLOCK_CODEC=zlib: the port writes "ZL" through Python's zlib
    (its library has no zlib entry), the same bytes as the reference."""
    monkeypatch.setenv("HM_BLOCK_CODEC", "zlib")
    obj = {"k": "v" * 600}  # above the small-block raw threshold
    data = blockmod.pack(obj)
    assert data[:2] == b"ZL"
    assert blockmod.unpack(data) == obj
    assert data == ref_block.pack(obj)
    assert ref_block.unpack(data) == obj


def test_tiny_blocks_stored_raw():
    """Blocks under the compression threshold store as raw JSON —
    framing+cpu beats the handful of saved bytes on interactive
    single-op changes."""
    obj = {"k": "v"}
    data = blockmod.pack(obj)
    assert data[:1] in (b"{", b"[")
    assert blockmod.unpack(data) == obj
    assert data == ref_block.pack(obj)


def test_crypto_facade_signs_and_verifies():
    seed = os.urandom(32)
    pub = crypto.public_key(seed)
    sig = crypto.sign(b"msg", seed)
    assert crypto.verify(b"msg", sig, pub)
    assert not crypto.verify(b"other", sig, pub)
    assert not crypto.verify(b"msg", sig[:-1] + bytes([sig[-1] ^ 1]), pub)
    # ed25519 is deterministic: the reference's facade gives the same
    # key and signature, and verifies the port's
    assert pub == ref_crypto.public_key(seed)
    assert sig == ref_crypto.sign(b"msg", seed)
    assert ref_crypto.verify(b"msg", sig, pub)


def test_framework_runs_without_native_layer():
    """HM_NO_NATIVE disables the native path entirely; keys and the
    block codec must degrade to pure Python in a fresh process (one
    that imports neither jax nor the reference), with the reference's
    key and block bytes."""
    code = """
import os, sys
assert os.environ["HM_NO_NATIVE"] == "1"
from hypermerge_tpu_torch import native
assert not native.available()
assert native.caps() == 0
from hypermerge_tpu_torch.utils import keys, crypto
pair = keys.create(seed=bytes(32))
assert pair.public_key  # pure-python ed25519
sig = crypto.sign(b"m", bytes(32))
assert crypto.verify(b"m", sig, keys.decode(pair.public_key))
from hypermerge_tpu_torch.storage import block
data = block.pack({"a": "b" * 600})
assert data[:2] == b"ZL"  # brotli unavailable -> zlib
assert block.unpack(data) == {"a": "b" * 600}
assert "jax" not in sys.modules
assert not any(m.split(".")[0] == "hypermerge_tpu" for m in sys.modules)
print("OK", pair.public_key, sig.hex(), data.hex())
"""
    env = dict(os.environ, HM_NO_NATIVE="1")
    out = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        capture_output=True,
        text=True,
        cwd=REPO_ROOT,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout
    _ok, pub, sig, data = out.stdout.split()
    from hypermerge_tpu.utils import keys as ref_keys

    assert pub == ref_keys.create(seed=bytes(32)).public_key
    assert bytes.fromhex(sig) == ref_crypto.sign(b"m", bytes(32))
    with env_vars(HM_BLOCK_CODEC="zlib"):
        assert bytes.fromhex(data) == ref_block.pack({"a": "b" * 600})


@needs_native
def test_feed_blocks_use_brotli_end_to_end(tmp_path):
    """Blocks written through the repo runtime pack with the native
    codec and replay identically on reopen (and in the reference)."""
    from hypermerge_tpu_torch.utils.ids import validate_doc_url
    from port_helpers import Repo

    path = str(tmp_path / "repo")
    repo = Repo(path=path)
    url = repo.create({"text": "hello " * 200})
    repo.change(url, lambda d: d.__setitem__("n", 1))
    want = plainify(repo.doc(url))
    doc_id = validate_doc_url(url)
    feed = repo.back.feeds.get_feed(doc_id)
    assert any(b[:2] == b"BR" for b in feed.read_all())
    repo.close()

    repo2 = Repo(path=path)
    assert plainify(repo2.doc(url)) == want
    repo2.close()
    assert_reference_reads(path, [url], [want])
