"""Every case of tests/test_feed_storage.py under its own name on the port
(hypermerge_tpu_torch.storage.feed).

The twinned file's own docstring follows.

FileFeedStorage: block-count index shortcut + torn-tail healing."""

import os
import struct

from hypermerge_tpu_torch.storage.feed import FileFeedStorage


def _mk(tmp_path, blocks):
    path = str(tmp_path / "ab" / "feed")
    s = FileFeedStorage(path)
    for b in blocks:
        s.append(b)
    return path


def test_len_index_shortcut(tmp_path):
    path = _mk(tmp_path, [b"one", b"two", b"three"])
    assert os.path.exists(path + ".len")
    s2 = FileFeedStorage(path)
    assert len(s2) == 3  # count via .len + stat, no scan
    assert not s2._scanned
    assert s2.get(1) == b"two"  # offsets built on demand


def test_stale_len_index_falls_back_to_scan(tmp_path):
    path = _mk(tmp_path, [b"aa", b"bb"])
    with open(path + ".len", "wb") as fh:
        fh.write(struct.pack("<QQ", 99, 12345))  # wrong end offset
    s2 = FileFeedStorage(path)
    assert len(s2) == 2  # mismatch detected -> full scan
    assert s2.get(0) == b"aa"


def test_torn_tail_with_stale_len_heals(tmp_path):
    path = _mk(tmp_path, [b"aa", b"bb"])
    # simulate a crash mid-append: partial block bytes, .len not updated
    with open(path, "ab") as fh:
        fh.write(b"\x50\x00\x00\x00parti")  # claims 80 bytes, has 5
    s2 = FileFeedStorage(path)
    assert len(s2) == 2  # size mismatch -> scan -> torn tail dropped
    # appending over the torn tail truncates it and re-indexes
    s2.append(b"cc")
    s3 = FileFeedStorage(path)
    assert len(s3) == 3
    assert [s3.get(i) for i in range(3)] == [b"aa", b"bb", b"cc"]


def test_legacy_log_without_len_index(tmp_path):
    path = _mk(tmp_path, [b"x", b"y"])
    os.remove(path + ".len")
    s2 = FileFeedStorage(path)
    assert len(s2) == 2  # full scan fallback
    s2.append(b"z")  # append recreates the index
    assert os.path.exists(path + ".len")
    assert len(FileFeedStorage(path)) == 3
