"""Every case of tests/test_native_codec.py under its own name on the
port's native library and codec (hypermerge_tpu_torch).

The twinned file's own docstring follows.

Native change-frame codec (hm_change_encode/decode) vs the twin.

The per-edit hot loop's frame codec has two implementations: the C
scanner/emitter in native/src/hm_native.cpp (GIL-free, the write
daemon's fast path) and the pure-Python twin in crdt/codec.py that
remains both the fallback and the correctness reference. These tests
pin them BIT-identical over fuzzed changes — same frames out of
encode, same canonical JSON out of decode, and agreement on exactly
which shapes are off-canon — in both directions across the
HM_NATIVE_CODEC=1/0 hatch (frames written with either setting read
under the other), plus the pack_drops_gil-style proof that the codec
binding really releases the GIL.
"""

import random
import string

import pytest

from hypermerge_tpu_torch import native
from hypermerge_tpu_torch.crdt import codec
from hypermerge_tpu_torch.storage import block as blockmod
from hypermerge_tpu_torch.utils.json_buffer import bufferify, parse

needs_codec = pytest.mark.skipif(
    native.codec_lib() is None, reason="native codec layer unavailable"
)

_CHARS = (
    string.ascii_letters
    + string.digits
    + ' \t\n"\\/{}[],:éπ☃ '
)


def _rand_str(r, lo=0, hi=24):
    return "".join(
        r.choice(_CHARS) for _ in range(r.randint(lo, hi))
    )


def _rand_opid(r):
    return f"{r.randint(0, 2**40)}@{_rand_str(r, 1, 10)}"


def _rand_value(r, depth=0):
    roll = r.random()
    if roll < 0.25:
        return _rand_str(r)
    if roll < 0.45:
        return r.randint(-(2**50), 2**50)
    if roll < 0.6:
        return r.choice([0.0, -1.5, 3.25, 1e300, 1 / 3, -0.0])
    if roll < 0.7:
        return r.choice([True, False, None])
    if depth >= 2:
        return r.randint(0, 9)
    if roll < 0.85:
        return [_rand_value(r, depth + 1) for _ in range(r.randint(0, 4))]
    return {
        _rand_str(r, 1, 8): _rand_value(r, depth + 1)
        for _ in range(r.randint(0, 4))
    }


def _rand_op(r):
    op = {"a": r.randint(0, 7), "o": _rand_opid(r)}
    if r.random() < 0.6:
        op["k"] = _rand_str(r)
    if r.random() < 0.3:
        op["r"] = _rand_opid(r)
    if r.random() < 0.4:
        op["i"] = True
    if r.random() < 0.6:
        op["v"] = _rand_value(r)
    if r.random() < 0.2:
        op["d"] = r.choice(["counter", "timestamp"])
    if r.random() < 0.5:
        op["p"] = [_rand_opid(r) for _ in range(r.randint(0, 3))]
    return op


def _rand_change(r, n_ops=None):
    return {
        "actor": _rand_str(r, 1, 16),
        "deps": {
            _rand_str(r, 1, 12): r.randint(0, 2**40)
            for _ in range(r.randint(0, 4))
        },
        "message": _rand_str(r, 0, 40),
        "ops": [
            _rand_op(r)
            for _ in range(r.randint(0, 8) if n_ops is None else n_ops)
        ],
        "seq": r.randint(1, 2**40),
        "startOp": r.randint(1, 2**50),
        "time": r.choice([0, r.randint(1, 2**40)]),
    }


def _spoil(r, obj):
    """One off-canon mutation the codec must refuse (both sides)."""
    obj = dict(obj)
    roll = r.randrange(8)
    if roll == 0:
        obj["extra"] = 1
    elif roll == 1:
        obj["seq"] = True  # bool-as-int: serializes as `true`
    elif roll == 2:
        obj["time"] = -r.randint(1, 100)
    elif roll == 3:
        obj["message"] = None
    elif roll == 4:
        obj["deps"] = {_rand_str(r, 1, 6): 1.5}
    elif roll == 5:
        obj["ops"] = [{"a": 1}]  # missing mandatory "o"
    elif roll == 6:
        obj["ops"] = [{"a": 1, "o": _rand_opid(r), "i": False}]
    else:
        obj["startOp"] = 2**63  # one past the varint ceiling
    return obj


def test_twin_roundtrip_fuzz():
    """Twin-only (runs without the native layer): encode->decode is the
    identity on canonical bytes, and the block layer round-trips the
    object through the frame format."""
    r = random.Random(11)
    for _ in range(300):
        obj = _rand_change(r)
        raw = bufferify(obj)
        frame = codec._encode_py(obj)
        assert frame is not None and frame[:2] == codec.MAGIC
        assert codec._decode_py(frame) == raw
        assert parse(codec._decode_py(frame)) == parse(raw)


@needs_codec
def test_native_twin_parity_fuzz(monkeypatch):
    """The pin: native and twin produce byte-identical frames, decode
    byte-identically (including each other's output), and agree on
    which shapes are off-canon."""
    monkeypatch.setenv("HM_NATIVE_CODEC", "1")
    r = random.Random(7)
    refused = 0
    for i in range(400):
        obj = _rand_change(r)
        if i % 4 == 3:
            obj = _spoil(r, obj)
        try:
            raw = bufferify(obj)
        except (TypeError, ValueError):
            continue  # not JSON-serializable: no codec question to ask
        nf = native.change_encode(raw)
        pf = codec._encode_py(obj)
        assert (nf is None) == (pf is None), (
            f"encodability disagreement on {raw!r}: "
            f"native={'ok' if nf else 'refused'} "
            f"twin={'ok' if pf else 'refused'}"
        )
        if nf is None:
            refused += 1
            continue
        assert nf == pf, f"frame mismatch on {raw!r}"
        # both decoders, each on the (shared) frame, back to raw bytes
        assert native.change_decode(nf) == raw
        assert codec._decode_py(nf) == raw
    # the spoiler must actually exercise the refusal paths
    assert refused >= 50


@needs_codec
def test_malformed_frames_rejected():
    """Truncations and bit-flips of real frames must fail loudly (and
    identically: native -1 <=> twin ValueError), never misparse."""
    r = random.Random(23)
    obj = _rand_change(r, n_ops=5)
    frame = codec._encode_py(obj)
    raw = bufferify(obj)
    for cut in range(2, len(frame) - 1, max(1, len(frame) // 40)):
        trunc = frame[:cut]
        assert native.change_decode(trunc) is None
        with pytest.raises(ValueError):
            codec._decode_py(trunc)
    for _ in range(200):
        pos = r.randrange(2, len(frame))
        bad = bytearray(frame)
        bad[pos] ^= 1 << r.randrange(8)
        bad = bytes(bad)
        nd = native.change_decode(bad)
        try:
            pd = codec._decode_py(bad)
        except ValueError:
            pd = None
        assert nd == pd, f"decode disagreement on flip at {pos}"
        if nd is not None and nd != raw:
            # a forged-but-well-formed frame may decode to different
            # JSON bytes — possibly invalid ones (flipped string-token
            # bytes pass through verbatim). The reader contract is
            # fail-loudly, never silent misparse: parse() either
            # succeeds or raises ValueError, nothing else.
            try:
                parse(nd)
            except ValueError:
                pass


def test_hatch_cross_reads(monkeypatch):
    """Blocks written under HM_NATIVE_CODEC=1 and =0 read correctly
    under the OTHER setting, both orders — the hatch only changes what
    new writes look like."""
    r = random.Random(5)
    objs = [_rand_change(r) for _ in range(20)]
    monkeypatch.setenv("HM_NATIVE_CODEC", "1")
    frames = [blockmod.pack_change(o) for o in objs]
    # small interactive blocks become frames; oversized ones keep the
    # compressed JSON path by design — both must cross-read below
    assert any(f[:2] == codec.MAGIC for f in frames)
    monkeypatch.setenv("HM_NATIVE_CODEC", "0")
    jsons = [blockmod.pack_change(o) for o in objs]
    assert not any(j[:2] == codec.MAGIC for j in jsons)
    # codec-off reader on codec-on blocks (twin decode path) ...
    assert [blockmod.unpack(f) for f in frames] == [
        parse(bufferify(o)) for o in objs
    ]
    monkeypatch.setenv("HM_NATIVE_CODEC", "1")
    # ... and codec-on reader on codec-off blocks
    assert [blockmod.unpack(j) for j in jsons] == [
        parse(bufferify(o)) for o in objs
    ]


@needs_codec
def test_codec_releases_gil():
    """The codec bindings must DROP the GIL (ctypes.CDLL foreign-call
    semantics) — the sharded write daemon relies on it so frame
    parsing from N connections overlaps on real threads. Mirrors
    test_native_pack.py::test_pack_releases_gil: (1) a spinner thread
    keeps making progress while the native codec chews a large frame
    batch; (2) with >=2 cores, two concurrent chews on distinct
    buffers overlap in wall time."""
    import os
    import threading
    import time

    assert native.codec_drops_gil()

    r = random.Random(17)
    big = [_rand_change(r, n_ops=1500) for _ in range(8)]
    raws = [bufferify(o) for o in big]
    frames = [native.change_encode(raw) for raw in raws]
    assert all(f is not None for f in frames)

    def one_chew():
        for raw, frame in zip(raws, frames):
            assert native.change_encode(raw) == frame
            assert native.change_decode(frame) == raw

    one_chew()  # warm allocator / code paths

    # -- (1) GIL-progress: a spinner thread must not starve ------------
    stop = [False]
    spins = [0]

    def spinner():
        while not stop[0]:
            spins[0] += 1

    t = threading.Thread(target=spinner, daemon=True)
    t.start()
    time.sleep(0.02)  # let it settle
    spins[0] = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.4:
        one_chew()
    held_spins = spins[0]
    stop[0] = True
    t.join(5)
    assert held_spins > 10_000, (
        f"spinner starved during native codec calls ({held_spins} "
        "iters): is the codec binding holding the GIL?"
    )

    # -- (2) wall-time overlap of two concurrent chews -----------------
    if (os.cpu_count() or 1) < 2:
        pytest.skip("single core: wall-time overlap is unmeasurable")

    def chews(n):
        for _ in range(n):
            one_chew()

    best_serial = best_conc = None
    for _attempt in range(5):
        t0 = time.perf_counter()
        chews(6)
        serial = time.perf_counter() - t0
        ts = [
            threading.Thread(target=chews, args=(3,), daemon=True)
            for _ in range(2)
        ]
        t0 = time.perf_counter()
        for th in ts:
            th.start()
        for th in ts:
            th.join(60)
        conc = time.perf_counter() - t0
        best_serial = min(serial, best_serial or serial)
        best_conc = min(conc, best_conc or conc)
        if best_conc < 0.9 * best_serial:
            break
    ratio = best_conc / max(best_serial, 1e-9)
    if ratio >= 0.9:
        pytest.skip(
            f"GIL release proven by spinner, but no idle core to show "
            f"wall overlap (conc/serial={ratio:.2f})"
        )
