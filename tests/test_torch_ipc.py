"""The port's frontend/backend split across processes
(hypermerge_tpu_torch/net/ipc.py), on the CPU.

- Every case of tests/test_ipc.py and tests/test_wal.py's
  `test_worker_sigkill_midburst_acked_lost_zero` under its own name on
  the port, with the reference's waits and sizes. Every daemon is
  `python -m hypermerge_tpu_torch.net.ipc ... --device cpu` (a hub's
  workers inherit the device), and the in-process cases call the port's
  `serve_backend(..., device="cpu")`. Durability is read back with the
  port's `Repo(path, device="cpu")`.
- Parity with the JAX package: `_shard_of` over 1,000 seeded doc ids at
  n = 1 to 8, and `ReplyFence` and `_ShardRouter._merge_tele` on the same
  seeded inputs.
- Wire compatibility: the JAX package's `connect_frontend` drives a port
  hub with two workers, and the port's `connect_frontend` drives a JAX
  package hub with two workers; both reach the value the edit script
  determines.
- Guards: a port hub with two workers under a PYTHONPATH shim that makes
  `jax` and `hypermerge_tpu` unimportable still round-trips a frontend's
  edits; each worker's command line names the port's module and
  `--device cpu`; without a GPU a daemon not asked for the CPU exits
  non-zero with `device.resolve`'s error, before it binds its socket; a
  process importing `connect_frontend` loads no torch.
- The autouse `daemons` fixture kills every daemon a case started (its
  whole process group: a hub and its workers) and removes its sockets,
  and closes every backend an in-process `serve_backend` built.

Tolerance: exact.
"""

import json
import os
import signal
import socket as socketmod
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest

from hypermerge_tpu.net import ipc as ref_ipc
from hypermerge_tpu_torch.backend import repo_backend as _port_backend
from hypermerge_tpu_torch.net import ipc as port_ipc
from hypermerge_tpu_torch.net.ipc import (
    ReplyFence,
    _FrontendHub,
    _shard_of,
    connect_frontend,
    serve_backend,
)
from hypermerge_tpu_torch.repo import Repo as _PortRepo
from hypermerge_tpu_torch.utils import base58
from hypermerge_tpu_torch.utils.ids import url_to_id

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO_ROOT}
PORT_MODULE = "hypermerge_tpu_torch.net.ipc"
REF_MODULE = "hypermerge_tpu.net.ipc"

# (process, socket) of every daemon a case started, and every backend an
# in-process serve_backend built
_DAEMONS: list = []
_BACKENDS: list = []


class _TrackedBackend(_port_backend.RepoBackend):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _BACKENDS.append(self)


@pytest.fixture(autouse=True)
def daemons(monkeypatch):
    # serve_backend imports RepoBackend from this module at its call
    monkeypatch.setattr(_port_backend, "RepoBackend", _TrackedBackend)
    try:
        yield _DAEMONS
    finally:
        made = list(_DAEMONS)
        _DAEMONS.clear()
        for proc, _sock in made:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        for proc, sock in made:
            proc.wait(timeout=10)
            for path in [sock] + [f"{sock}.w{i}" for i in range(8)]:
                if os.path.exists(path):
                    os.remove(path)
        backends = list(_BACKENDS)
        _BACKENDS.clear()
        for back in backends:
            back.close()


def Repo(**kwargs):
    return _PortRepo(device="cpu", **kwargs)


def _spawn(module, repo_arg, sock, extra, env, cwd, device="cpu"):
    """A daemon in a process group of its own (the fixture kills the
    group: a hub and the workers it spawned)."""
    args = [sys.executable, "-m", module, repo_arg, sock, *extra]
    if device is not None:
        args += ["--device", device]
    proc = subprocess.Popen(
        args,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        env=env,
        cwd=cwd,
        start_new_session=True,
    )
    _DAEMONS.append((proc, sock))
    return proc


def _start_backend(repo_arg: str, *extra, env_extra=None,
                   module=PORT_MODULE, env=None, cwd=REPO_ROOT):
    """Spawn a backend daemon; returns (proc, sock_path, swarm_addr)."""
    sock = tempfile.mktemp(suffix=".sock")
    proc = _spawn(
        module, repo_arg, sock, extra,
        {**(env or ENV), **(env_extra or {})}, cwd,
        device="cpu" if module == PORT_MODULE else None,
    )
    deadline = time.time() + 60
    while time.time() < deadline and not os.path.exists(sock):
        if proc.poll() is not None:
            raise AssertionError(proc.stderr.read())
        time.sleep(0.05)
    if not os.path.exists(sock):
        proc.kill()
        raise AssertionError(proc.stderr.read())
    addr = None
    if "--listen" in extra:
        line = proc.stdout.readline()  # "backend ready on ..."
        while "swarm listening on" not in line:
            line = proc.stdout.readline()
            assert line, "daemon exited before printing swarm address"
        host, _, port = line.strip().rpartition(" ")[2].rpartition(":")
        addr = f"{host}:{port}"
    return proc, sock, addr


def _stop(proc, sock):
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=10)
    if os.path.exists(sock):
        os.remove(sock)


def _val(h):
    """Handle.value() without the raise-on-timeout convenience."""
    try:
        return h.value(timeout=0.2)
    except TimeoutError:
        return None


def _wait(fn, timeout=60, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = fn()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError(f"cross-process wait timed out: {fn}")


def _committed(front, url):
    """The doc's history length as the backend last echoed it. A handle's
    value already shows a local change's preview while the change is in
    flight; the echo comes after the backend appended the change to its
    feed, so only an echoed change is one a kill must not lose."""
    df = front.docs.get(url_to_id(url))
    return df.history if df is not None else 0


def _worker_pids(proc, n=2):
    """The hub's "worker <i> pid <pid>" lines after "backend ready"."""
    assert "ready" in proc.stdout.readline()
    pids = {}
    for _ in range(n):
        parts = proc.stdout.readline().split()
        assert parts[0] == "worker" and parts[2] == "pid", parts
        pids[parts[1]] = int(parts[3])
    return pids


# ---------------------------------------------------------------------------
# tests/test_ipc.py on the port


def test_frontend_drives_backend_subprocess(tmp_path):
    repo_dir = str(tmp_path / "repo")
    proc, sock, _ = _start_backend(repo_dir)
    try:
        front, close = connect_frontend(sock)
        states = []
        url = front.create({"title": "split"})
        h = front.watch(url, lambda d, i: states.append(d))
        front.change(url, lambda d: d.__setitem__("n", 7))

        # reads cross the process boundary (Ready/Patch come back async)
        _wait(lambda: (_val(h) or {}).get("n") == 7)
        assert h.value() == {"title": "split", "n": 7}
        assert states, "watch callbacks never fired across the boundary"

        # durability gate BEFORE teardown: a meta round-trip on the same
        # ordered channel proves the backend applied both changes
        def backend_history():
            got = []
            front.meta(url, got.append)
            _wait(lambda: got, timeout=10)
            return ((got[0] or {}).get("history")) or 0

        _wait(lambda: backend_history() >= 2, timeout=30)
        h.close()
        close()

        # durability: the BACKEND process owned the storage — a fresh
        # in-process repo over the same dir sees the doc
        _wait(lambda: proc.poll() is not None, timeout=30)
        repo = Repo(path=repo_dir)
        try:
            assert repo.doc(url)["n"] == 7
        finally:
            repo.close()
    finally:
        _stop(proc, sock)


def test_concurrent_edits_across_the_seam(tmp_path):
    """4 threads hammer 2 docs through ONE frontend/backend socket;
    every edit lands exactly once."""
    proc, sock, _ = _start_backend(":memory:")
    try:
        front, close = connect_frontend(sock)
        urls = [front.create({"edits": []}) for _ in range(2)]
        handles = [front.open(u) for u in urls]
        for h in handles:
            _wait(lambda h=h: _val(h) is not None)
        n_threads, n_edits = 4, 25

        def churn(t):
            for i in range(n_edits):
                front.change(
                    urls[i % 2],
                    lambda d, t=t, i=i: d["edits"].append(t * 1000 + i),
                )

        ts = [
            threading.Thread(target=churn, args=(t,))
            for t in range(n_threads)
        ]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
        want = n_threads * n_edits

        def total():
            vals = [_val(h) for h in handles]
            return sum(len(v["edits"]) for v in vals if v) == want

        _wait(total)
        seen = []
        for h in handles:
            seen.extend(_val(h)["edits"])
        assert len(seen) == want and len(set(seen)) == want
        close()
    finally:
        _stop(proc, sock)


def test_backend_kill_restart_frontend_resumes(tmp_path):
    """kill -9 the backend mid-session; a restarted backend over the
    same dir serves a new frontend the durable state, and continued
    edits extend the SAME actor feed instead of resetting its
    counter."""
    repo_dir = str(tmp_path / "repo")
    proc, sock, _ = _start_backend(repo_dir)
    try:
        front, close = connect_frontend(sock)
        url = front.create({"log": []})
        for i in range(5):
            front.change(url, lambda d, i=i: d["log"].append(i))
        h = front.watch(url, lambda d, i: None)
        _wait(lambda: len((_val(h) or {}).get("log", [])) == 5)
        _wait(lambda: _committed(front, url) == 6)  # create + 5, echoed
        close()
    finally:
        proc.kill()  # hard kill: no orderly backend close
        proc.wait(timeout=10)
        if os.path.exists(sock):
            os.remove(sock)

    proc2, sock2, _ = _start_backend(repo_dir)
    try:
        front2, close2 = connect_frontend(sock2)
        h2 = front2.open(url)
        _wait(lambda: len((_val(h2) or {}).get("log", [])) == 5)
        for i in range(5, 8):
            front2.change(url, lambda d, i=i: d["log"].append(i))
        _wait(lambda: len((_val(h2) or {}).get("log", [])) == 8)
        assert list(_val(h2)["log"]) == list(range(8))
        _wait(lambda: _committed(front2, url) == 9)
        close2()
    finally:
        _stop(proc2, sock2)

    repo = Repo(path=repo_dir)
    try:
        assert list(repo.doc(url)["log"]) == list(range(8))
    finally:
        repo.close()


def test_three_backend_tcp_relay_through_ipc_frontends(tmp_path):
    """A<->B<->C line of backend DAEMONS (the swarm lives in the daemons,
    frontends only speak the unix socket): a doc created via A's frontend
    reaches C's through the relay, and edits from both ends converge
    everywhere exactly once."""
    pa, sa, addr_a = _start_backend(":memory:", "--listen")
    pb, sb, addr_b = _start_backend(
        ":memory:", "--listen", "--connect", addr_a
    )
    pc, sc, _ = _start_backend(":memory:", "--connect", addr_b)
    fronts = []
    try:
        for sock in (sa, sb, sc):
            fronts.append(connect_frontend(sock))
        fa, fb, fc = (f for f, _ in fronts)
        url = fa.create({"edits": []})
        ha = fa.open(url)
        fb.open(url)  # the middle repo replicates + RE-SERVES the doc
        hc = fc.open(url)
        _wait(lambda: _val(hc) is not None, timeout=90)
        for i in range(10):
            fa.change(url, lambda d, i=i: d["edits"].append(i))
        for i in range(10, 15):
            fc.change(url, lambda d, i=i: d["edits"].append(i))

        def converged():
            va, vc = _val(ha), _val(hc)
            return (
                va and vc
                and sorted(va["edits"]) == list(range(15))
                and sorted(vc["edits"]) == list(range(15))
            )

        _wait(converged, timeout=90)
    finally:
        for _front, close in fronts:
            close()
        _stop(pa, sa)
        _stop(pb, sb)
        _stop(pc, sc)


def test_probe_connection_does_not_kill_daemon(tmp_path):
    """A stray socket touch that never completes the handshake leaves the
    live backend untouched: the real frontend attaches afterwards."""
    proc, sock, _ = _start_backend(":memory:")
    try:
        for _ in range(3):  # probes: connect and slam shut
            s = socketmod.socket(socketmod.AF_UNIX, socketmod.SOCK_STREAM)
            for _attempt in range(50):
                try:
                    s.connect(sock)
                    break
                except BlockingIOError:
                    time.sleep(0.05)
            s.close()
            time.sleep(0.05)
        front, close = connect_frontend(sock)
        url = front.create({"alive": True})
        h = front.open(url)
        _wait(lambda: (_val(h) or {}).get("alive") is True)
        close()
    finally:
        _stop(proc, sock)


def test_noop_change_does_not_strand_queue(tmp_path):
    """A change fn producing NO ops must not wedge the queued-change
    drain across the process boundary."""
    proc, sock, _ = _start_backend(":memory:")
    try:
        front, close = connect_frontend(sock)
        url = front.create({"n": 0})
        h = front.open(url)
        _wait(lambda: h.value() is not None)
        front.change(url, lambda d: None)  # no ops
        front.change(url, lambda d: d.__setitem__("n", 1))
        front.change(url, lambda d: None)  # no ops again
        front.change(url, lambda d: d.__setitem__("n", 2))
        _wait(lambda: (_val(h) or {}).get("n") == 2)
        close()
    finally:
        _stop(proc, sock)


def test_reopen_same_doc_while_backend_alive(tmp_path):
    """Close + reopen a handle on a live backend: the second open gets a
    fresh Ready with current state and stays live for further patches."""
    proc, sock, _ = _start_backend(":memory:")
    try:
        front, close = connect_frontend(sock)
        url = front.create({"v": 1})
        h1 = front.open(url)
        _wait(lambda: (_val(h1) or {}).get("v") == 1)
        h1.close()
        front.change(url, lambda d: d.__setitem__("v", 2))
        h2 = front.open(url)
        _wait(lambda: (_val(h2) or {}).get("v") == 2)
        front.change(url, lambda d: d.__setitem__("v", 3))
        _wait(lambda: (_val(h2) or {}).get("v") == 3)
        close()
    finally:
        _stop(proc, sock)


def _serve_in_thread(sock):
    server = threading.Thread(
        target=serve_backend,
        kwargs=dict(sock_path=sock, memory=True, once=False, device="cpu"),
        daemon=True,
    )
    server.start()
    _wait(lambda: os.path.exists(sock), timeout=30)


def test_persistent_backend_reused_across_frontend_cycles(tmp_path):
    """Non-once mode: ONE live backend serves successive frontends —
    state written by frontend A is visible to frontend B without a
    backend rebuild, and nothing piles up per cycle."""
    import gc

    sock = str(tmp_path / "backend.sock")
    _serve_in_thread(sock)

    front_a, close_a = connect_frontend(sock)
    url = front_a.create({"cycle": 1})
    ha = front_a.open(url)
    _wait(lambda: (_val(ha) or {}).get("cycle") == 1)
    close_a()
    time.sleep(0.2)  # let the server notice the close

    backends_before = sum(
        isinstance(o, _port_backend.RepoBackend) for o in gc.get_objects()
    )
    front_b, close_b = connect_frontend(sock)
    # the SAME backend answers: frontend A's doc is still there
    hb = front_b.open(url)
    _wait(lambda: (_val(hb) or {}).get("cycle") == 1)
    close_b()
    time.sleep(0.2)
    backends_after = sum(
        isinstance(o, _port_backend.RepoBackend) for o in gc.get_objects()
    )
    assert backends_after <= backends_before, (
        "backends piled up across frontend cycles"
    )
    assert len(_BACKENDS) == 1
    assert _BACKENDS[0].device.type == "cpu"


def test_reply_fence_drops_cross_session_replies():
    """Persist-mode swap: a Reply produced by a PREVIOUS frontend's
    in-flight handler never reaches the next frontend."""
    fence = ReplyFence()
    ep1 = fence.advance()  # frontend #1 attaches
    q1 = fence.inbound({"type": "Query", "queryId": 1, "query": {}}, ep1)
    assert q1["queryId"] == [1, 1]
    gate1_epoch = fence.epoch
    reply = {"type": "Reply", "queryId": q1["queryId"], "payload": "a"}
    out = fence.outbound(gate1_epoch, dict(reply))
    assert out == {"type": "Reply", "queryId": 1, "payload": "a"}

    ep2 = fence.advance()  # swap: frontend #2 attaches
    gate2_epoch = fence.epoch
    assert fence.outbound(gate2_epoch, dict(reply)) is None
    q_stale = fence.inbound(
        {"type": "Query", "queryId": 2, "query": {}}, ep1
    )
    assert q_stale["queryId"] == [1, 2]
    assert (
        fence.outbound(
            gate2_epoch,
            {"type": "Reply", "queryId": q_stale["queryId"], "payload": "x"},
        )
        is None
    )
    q2 = fence.inbound({"type": "Query", "queryId": 1, "query": {}}, ep2)
    assert q2["queryId"] == [2, 1]
    out2 = fence.outbound(
        gate2_epoch, {"type": "Reply", "queryId": q2["queryId"], "payload": "b"}
    )
    assert out2["queryId"] == 1 and out2["payload"] == "b"
    patch = {"type": "Patch", "id": "d", "patch": {}, "history": 1}
    assert fence.outbound(gate2_epoch, patch) == patch


def test_persist_mode_queries_survive_frontend_swaps(tmp_path):
    """Persist mode end-to-end: each successive frontend's queries
    resolve through the epoch fence, though every frontend restarts its
    queryId counter and the previous one left with queries in flight."""
    sock = str(tmp_path / "backend.sock")
    _serve_in_thread(sock)

    front_a, close_a = connect_frontend(sock)
    url = front_a.create({"gen": 1})
    ha = front_a.open(url)
    _wait(lambda: (_val(ha) or {}).get("gen") == 1)
    front_a.meta(url, lambda _m: None)
    close_a()
    time.sleep(0.2)

    for _cycle in range(2, 4):
        front, close = connect_frontend(sock)
        h = front.open(url)
        _wait(lambda: (_val(h) or {}).get("gen") == 1)
        got = []
        front.meta(url, got.append)
        _wait(lambda: got, timeout=15)
        assert got[0] and got[0].get("type") == "Document", got
        got2 = []
        front.materialize(url, 1, got2.append)
        _wait(lambda: got2, timeout=15)
        assert got2[0] is not None
        close()
        time.sleep(0.2)


# ---------------------------------------------------------------------------
# hub mode


def test_hub_many_writers_disjoint_docs(tmp_path):
    """4 connections each create + edit their OWN doc against one --hub
    daemon: every writer's edits land, in its order."""
    proc, sock, _ = _start_backend(str(tmp_path / "repo"), "--hub")
    try:
        fronts = [connect_frontend(sock) for _ in range(4)]
        urls, handles = [], []
        for w, (front, _close) in enumerate(fronts):
            url = front.create({"w": w, "edits": []})
            urls.append(url)
            h = front.open(url)
            _wait(lambda h=h: _val(h) is not None)
            handles.append(h)
        n_edits = 15

        def churn(w):
            front = fronts[w][0]
            for i in range(n_edits):
                front.change(
                    urls[w], lambda d, i=i: d["edits"].append(i)
                )

        ts = [
            threading.Thread(target=churn, args=(w,)) for w in range(4)
        ]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
        for w, h in enumerate(handles):
            _wait(
                lambda h=h: len((_val(h) or {}).get("edits", []))
                == n_edits
            )
            v = _val(h)
            assert v["w"] == w
            assert list(v["edits"]) == list(range(n_edits))
        for _front, close in fronts:
            close()
    finally:
        _stop(proc, sock)


def test_hub_reply_routing_per_connection(tmp_path):
    """Concurrent Materialize queries from two connections whose queryId
    counters start at the same integers each resolve on their OWN
    connection."""
    proc, sock, _ = _start_backend(str(tmp_path / "repo"), "--hub")
    try:
        fa, close_a = connect_frontend(sock)
        fb, close_b = connect_frontend(sock)
        ua = fa.create({"who": "a"})
        ub = fb.create({"who": "b"})
        ha, hb = fa.open(ua), fb.open(ub)
        _wait(lambda: _val(ha) is not None and _val(hb) is not None)
        got_a, got_b = [], []
        for _ in range(5):
            fa.materialize(ua, 1, got_a.append)
            fb.materialize(ub, 1, got_b.append)
        _wait(lambda: len(got_a) == 5 and len(got_b) == 5, timeout=30)
        assert all(g and g.get("who") == "a" for g in got_a), got_a
        assert all(g and g.get("who") == "b" for g in got_b), got_b
        close_a()
        close_b()
    finally:
        _stop(proc, sock)


def test_hub_shared_doc_watcher_sees_writer_patches(tmp_path):
    """A hub frontend WATCHING a doc another connection writes receives
    every patch."""
    proc, sock, _ = _start_backend(str(tmp_path / "repo"), "--hub")
    try:
        fa, close_a = connect_frontend(sock)
        fb, close_b = connect_frontend(sock)
        url = fa.create({"edits": []})
        ha = fa.open(url)
        _wait(lambda: "edits" in (_val(ha) or {}))
        hb = fb.open(url)
        _wait(lambda: "edits" in (_val(hb) or {}))
        for i in range(5):
            fa.change(url, lambda d, i=i: d["edits"].append(i))
        for h in (ha, hb):
            _wait(
                lambda h=h: list(
                    (_val(h) or {}).get("edits", [])
                ) == list(range(5))
            )
        close_a()
        close_b()
    finally:
        _stop(proc, sock)


class _FakeDuplex:
    def on_close(self, cb):
        self.close_cb = cb

    def on_message(self, cb):
        self.msg_cb = cb


def test_hub_interest_table_drops_empty_entries():
    """Close and connection detach delete a doc's interest entry once its
    last watcher leaves."""
    hub = _FrontendHub(SimpleNamespace(receive=lambda _m: None))
    d1, d2 = _FakeDuplex(), _FakeDuplex()
    hub.attach(d1)
    hub.attach(d2)
    d1.msg_cb({"type": "Open", "id": "docX"})
    d2.msg_cb({"type": "Open", "id": "docX"})
    d1.msg_cb({"type": "Open", "id": "docY"})
    assert set(hub._interest) == {"docX", "docY"}
    d1.msg_cb({"type": "Close", "id": "docY"})
    assert set(hub._interest) == {"docX"}
    d1.close_cb()
    assert set(hub._interest) == {"docX"}
    d2.close_cb()
    assert hub._interest == {}
    assert hub._conns == {}


def test_hub_many_writers_one_hot_doc(tmp_path):
    """4 connections all edit ONE doc through one hub daemon, each on
    the actor the backend minted for its connection; every view ends
    bit-identical canonical JSON."""
    proc, sock, _ = _start_backend(str(tmp_path / "repo"), "--hub")
    try:
        n_writers, n_edits = 4, 8
        fronts = [connect_frontend(sock) for _ in range(n_writers)]
        url = fronts[0][0].create({"edits": {}})
        handles = []
        for front, _close in fronts:
            h = front.open(url)
            _wait(lambda h=h: "edits" in (_val(h) or {}))
            handles.append(h)

        def churn(w):
            front = fronts[w][0]
            for i in range(n_edits):
                front.change(
                    url,
                    lambda d, w=w, i=i: d["edits"].__setitem__(
                        f"{w}.{i}", i
                    ),
                )

        ts = [
            threading.Thread(target=churn, args=(w,))
            for w in range(n_writers)
        ]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
        total = n_writers * n_edits
        for h in handles:
            _wait(
                lambda h=h: len((_val(h) or {}).get("edits", {}))
                == total,
                timeout=90,
            )
        digests = {json.dumps(_val(h), sort_keys=True) for h in handles}
        assert len(digests) == 1, "writers diverged on the hot doc"
        for _front, close in fronts:
            close()
    finally:
        _stop(proc, sock)


def test_hub_sharded_workers_route_and_merge_telemetry(tmp_path):
    """HM_WORKERS=2: docs land on the worker that owns their shard, edits
    round-trip through the worker's own engine, and a Telemetry query
    fans out to every worker and merges into one payload whose `workers`
    block carries the per-worker split."""
    proc, sock, _ = _start_backend(
        str(tmp_path / "repo"), "--hub", env_extra={"HM_WORKERS": "2"}
    )
    try:
        pids = _worker_pids(proc)
        assert set(pids) == {"0", "1"}

        front, close = connect_frontend(sock)
        urls, shards = [], set()
        while len(shards) < 2 or len(urls) < 4:  # cover BOTH shards
            url = front.create({"edits": []})
            urls.append(url)
            shards.add(_shard_of(url[len("hypermerge:/"):], 2))
        handles = [front.open(u) for u in urls]
        for h in handles:
            _wait(lambda h=h: "edits" in (_val(h) or {}))
        for u in urls:
            front.change(u, lambda d: d["edits"].append(1))
        for h in handles:
            _wait(lambda h=h: (_val(h) or {}).get("edits") == [1])

        got = []
        front.telemetry(got.append)
        _wait(lambda: got, timeout=15)
        workers = got[0].get("workers")
        assert set(workers) == {"0", "1"}, workers
        for i, w in workers.items():
            assert w["alive"], f"worker {i} missed the telemetry fanout"
            assert w["pid"] == pids[i]
            assert w["respawns"] == 0
        assert "workers.0.edits" in got[0]["counters"]
        close()
    finally:
        _stop(proc, sock)


# ---------------------------------------------------------------------------
# tests/test_wal.py's worker kill on the port


def test_worker_sigkill_midburst_acked_lost_zero(tmp_path):
    """SIGKILL the worker that OWNS a hot doc's shard mid-burst under
    HM_FSYNC=1 + durable acks: the hub respawns it, the fresh worker
    replays its journal prefix, every edit whose durable ack came back
    survives (acked_lost=0), and a brand-new connection reads the
    recovered doc and writes to it. The ack signal is a second OBSERVER
    connection's watch state, which only the backend's durability-gated
    patch broadcast moves."""
    sock = tempfile.mktemp(suffix=".sock")
    env = {
        **ENV,
        "HM_FSYNC": "1",
        "HM_ACK_DURABLE": "1",
        "HM_WAL_MS": "3",
        "HM_WORKERS": "2",
        "HM_WORKER_RESPAWN_MS": "100",
    }
    proc = _spawn(PORT_MODULE, str(tmp_path / "repo"), sock, ["--hub"],
                  env, REPO_ROOT)
    lines = []
    threading.Thread(
        target=lambda: lines.extend(iter(proc.stdout.readline, "")),
        daemon=True,
    ).start()

    def _sync(fn, timeout=30):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if fn():
                return True
            time.sleep(0.02)
        return False

    closers = []
    try:
        assert _sync(lambda: os.path.exists(sock)), "daemon not up"
        assert _sync(
            lambda: sum("worker" in ln for ln in lines) >= 2
        ), lines
        pids = {}
        for ln in list(lines):
            parts = ln.split()
            if parts[:1] == ["worker"] and "respawned" not in parts:
                pids[int(parts[1])] = int(parts[3])

        front, close = connect_frontend(sock)
        closers.append(close)
        url = front.create({"edits": {}})
        h = front.open(url)
        assert _sync(lambda: "edits" in (_val(h) or {}))
        owner = _shard_of(url[len("hypermerge:/"):], 2)

        obs, close_obs = connect_frontend(sock)
        closers.append(close_obs)
        hobs = obs.open(url)
        assert _sync(lambda: "edits" in (_val(hobs) or {}))

        def _acked(key, val, timeout=10):
            return _sync(
                lambda: (_val(hobs) or {})
                .get("edits", {}).get(key) == val,
                timeout=timeout,
            )

        acked = []
        for i in range(8):  # ack-paced burst: durable echo gates each
            front.change(
                url, lambda d, i=i: d["edits"].__setitem__(str(i), i)
            )
            assert _acked(str(i), i), f"edit {i} never acked"
            acked.append(str(i))

        os.kill(pids[owner], signal.SIGKILL)  # mid-burst: kill -9
        front.change(
            url, lambda d: d["edits"].__setitem__("post-kill", 1)
        )
        if _acked("post-kill", 1, timeout=5):
            acked.append("post-kill")

        assert _sync(
            lambda: any("respawned" in ln for ln in lines)
        ), "hub never respawned the killed worker"

        f2, close2 = connect_frontend(sock)
        closers.append(close2)
        h2 = f2.open(url)
        assert _sync(lambda: "edits" in (_val(h2) or {}))

        def _lost():
            edits = (_val(h2) or {}).get("edits", {})
            return [k for k in acked if k not in edits]

        assert _sync(lambda: not _lost(), timeout=20), (
            f"acked edits lost across worker kill -9: {_lost()}"
        )
        f2.change(
            url, lambda d: d["edits"].__setitem__("fresh", 1)
        )
        assert _sync(
            lambda: (_val(h2) or {})
            .get("edits", {}).get("fresh") == 1,
            timeout=15,
        ), "respawned worker refuses new writers"
    finally:
        for close in closers:
            close()


# ---------------------------------------------------------------------------
# parity with the JAX package


def _doc_ids(seed: int, n: int) -> list:
    """n doc ids: base58 public keys from seeded bytes, and a few
    non-ASCII and lone-surrogate strings (`_shard_of` encodes with
    surrogatepass)."""
    rng = np.random.default_rng(seed)
    ids = [base58.encode(rng.integers(0, 256, 32, dtype=np.uint8).tobytes())
           for _ in range(n - 3)]
    return ids + ["dôc-ü", "\ud800x", ""]


def test_shard_of_matches_reference():
    ids = _doc_ids(7, 1000)
    for n in range(1, 9):
        got = [_shard_of(d, n) for d in ids]
        assert got == [ref_ipc._shard_of(d, n) for d in ids], n
        assert set(got) == set(range(n))


def _fence_script(seed: int):
    """A seeded sequence of ReplyFence calls: advances, inbound Queries
    and other messages tagged with a current or earlier epoch, outbound
    Replies (tagged with any epoch, untagged, malformed) and pushes, and
    gate sends."""
    rng = np.random.default_rng(seed)
    steps = []
    epoch = 0
    for _ in range(400):
        op = int(rng.integers(0, 4))
        if op == 0:
            epoch += 1
            steps.append(("advance",))
        elif op == 1:
            msg = ({"type": "Query", "queryId": int(rng.integers(0, 9)),
                    "query": {"type": "Metadata"}}
                   if rng.random() < 0.8 else
                   {"type": "Open", "id": "d"})
            steps.append(("inbound", msg, int(rng.integers(0, epoch + 1))))
        else:
            r = rng.random()
            if r < 0.6:
                qid = [int(rng.integers(0, epoch + 2)),
                       int(rng.integers(0, 9))]
            elif r < 0.7:
                qid = int(rng.integers(0, 9))
            elif r < 0.8:
                qid = [1, 2, 3]
            else:
                qid = None
            msg = ({"type": "Reply", "queryId": qid, "payload": float(r)}
                   if qid is not None else
                   {"type": "Patch", "id": "d", "history": 1})
            e = int(rng.integers(0, epoch + 1))
            steps.append(("outbound" if op == 2 else "gate", e, msg))
    return steps


def _run_fence(cls, steps):
    fence = cls()
    out = []
    for step in steps:
        if step[0] == "advance":
            out.append(fence.advance())
        elif step[0] == "inbound":
            out.append(fence.inbound(dict(step[1]), step[2]))
        elif step[0] == "outbound":
            out.append(fence.outbound(step[1], dict(step[2])))
        else:  # a gate bound to the current epoch
            sent = []
            fence.gate(sent.append)(dict(step[2]))
            out.append(sent)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reply_fence_matches_reference(seed):
    steps = _fence_script(seed)
    assert _run_fence(ReplyFence, steps) == _run_fence(
        ref_ipc.ReplyFence, steps
    )


_COUNTERS = ("storage.wal.appends", "live.local_changes", "net.tcp.tx",
             "serve.reads", "live.device_dispatches", "pipeline.slabs")


def _tele_inputs(seed: int, n: int):
    """Seeded worker slots (pid, outbox depth, respawns; some dead) and
    worker payloads (counters with ints and floats, a time, serve / dht
    sections and net doc tables; some missing or malformed)."""
    rng = np.random.default_rng(seed)
    slots = []
    for i in range(n):
        if rng.random() < 0.2:
            slots.append(None)
        else:
            slots.append(dict(pid=1000 + i, gen=1, proc=None,
                              depth=int(rng.integers(0, 5))))
    respawns = [int(rng.integers(0, 3)) for _ in range(n)]
    payloads = {}
    for i in range(n):
        r = rng.random()
        if r < 0.15:
            continue  # the worker missed the fan-out
        if r < 0.2:
            payloads[i] = "not a dict"
            continue
        counters = {}
        for name in _COUNTERS:
            if rng.random() < 0.7:
                counters[name] = (int(rng.integers(0, 10_000))
                                  if rng.random() < 0.7
                                  else float(rng.random() * 100))
        counters["info.label"] = "text"
        p = {"counters": counters, "time": float(rng.random() * 1e4)}
        if rng.random() < 0.5:
            p["serve"] = {"docs": i}
        if rng.random() < 0.3:
            p["dht"] = {"node_id": f"n{i}"}
        if rng.random() < 0.5:
            p["net"] = {"docs": {f"doc{i}{j}": {"peers": j}
                                 for j in range(int(rng.integers(0, 3)))}}
        payloads[i] = p
    return slots, respawns, payloads


def _merge(router, slots, respawns, payloads):
    for i, s in enumerate(slots):
        if s is not None:
            s = dict(s, duplex=SimpleNamespace(
                _outbox=deque(range(s["depth"]))))
        router._workers[i] = s
    router._respawns = list(respawns)
    return router._merge_tele(payloads)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 2), (2, 3), (3, 8)])
def test_merge_tele_matches_reference(seed, n):
    slots, respawns, payloads = _tele_inputs(seed, n)
    port = port_ipc._ShardRouter(None, "unused.sock", n, "cpu")
    ref = ref_ipc._ShardRouter(None, "unused.sock", n)
    got = _merge(port, slots, respawns, payloads)
    assert got == _merge(ref, slots, respawns, payloads)
    assert set(got["workers"]) == {str(i) for i in range(n)}


# ---------------------------------------------------------------------------
# wire compatibility across packages


def _wire_script(connect, sock):
    """Two docs (covering both shards when the daemon has two workers)
    edited through `connect`'s frontend; returns their values and the
    merged Telemetry payload."""
    front, close = connect(sock)
    try:
        urls = []
        while len(urls) < 2:
            url = front.create({"edits": [], "n": 0})
            if not urls or (_shard_of(url[len("hypermerge:/"):], 2)
                            != _shard_of(urls[0][len("hypermerge:/"):], 2)):
                urls.append(url)
        handles = [front.open(u) for u in urls]
        for h in handles:
            _wait(lambda h=h: "edits" in (_val(h) or {}))
        def edit(d, item, n):
            d["edits"].append(item)
            d["n"] = n

        for i in range(6):
            for k, u in enumerate(urls):
                front.change(u, lambda d, i=i, k=k: edit(d, 10 * k + i, i))
        want = [{"edits": [10 * k + i for i in range(6)], "n": 5}
                for k in range(2)]
        for h, w in zip(handles, want):
            _wait(lambda h=h, w=w: _val(h) == w)
        got = []
        front.materialize(urls[0], 1, got.append)
        _wait(lambda: got, timeout=15)
        assert got[0] == {"edits": [], "n": 0}
        tele = []
        front.telemetry(tele.append)
        _wait(lambda: tele, timeout=15)
        return [_val(h) for h in handles], tele[0]
    finally:
        close()


@pytest.mark.parametrize("direction", ["ref_front_port_hub",
                                       "port_front_ref_hub"])
def test_wire_compat_across_packages(tmp_path, direction):
    """A JAX package frontend against a port hub with two workers, and a
    port frontend against a JAX package hub with two workers: the same
    script reaches the same values through either."""
    if direction == "ref_front_port_hub":
        daemon, connect = PORT_MODULE, ref_ipc.connect_frontend
    else:
        daemon, connect = REF_MODULE, connect_frontend
    proc, sock, _ = _start_backend(
        str(tmp_path / "repo"), "--hub", env_extra={"HM_WORKERS": "2"},
        module=daemon,
    )
    try:
        _worker_pids(proc)
        values, tele = _wire_script(connect, sock)
        assert values == [{"edits": [0, 1, 2, 3, 4, 5], "n": 5},
                          {"edits": [10, 11, 12, 13, 14, 15], "n": 5}]
        assert set(tele["workers"]) == {"0", "1"}
        assert all(w["alive"] for w in tele["workers"].values())
    finally:
        _stop(proc, sock)


# ---------------------------------------------------------------------------
# guards


def _blocked_path(tmp_path) -> str:
    """A PYTHONPATH entry under which `jax` and `hypermerge_tpu` raise
    ImportError."""
    shim = tmp_path / "shim"
    for name in ("jax", "hypermerge_tpu"):
        (shim / name).mkdir(parents=True)
        (shim / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked')\n"
        )
    return str(shim)


def test_hub_workers_run_without_jax(tmp_path):
    """A port hub with two workers, every process of it unable to import
    jax or the JAX package (the shim stands first on PYTHONPATH, and the
    daemon runs outside the repo, so the repo's own directory is not on
    its path first): a frontend's edits still round-trip through both
    workers."""
    env = {**ENV, "PYTHONPATH": _blocked_path(tmp_path) + os.pathsep
           + REPO_ROOT}
    check = subprocess.run(
        [sys.executable, "-c", "import hypermerge_tpu"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
    )
    assert check.returncode != 0 and "is blocked" in check.stderr
    proc, sock, _ = _start_backend(
        str(tmp_path / "repo"), "--hub", env_extra={"HM_WORKERS": "2"},
        env=env, cwd=str(tmp_path),
    )
    try:
        pids = _worker_pids(proc)
        values, tele = _wire_script(connect_frontend, sock)
        assert values == [{"edits": [0, 1, 2, 3, 4, 5], "n": 5},
                          {"edits": [10, 11, 12, 13, 14, 15], "n": 5}]
        assert {w["pid"] for w in tele["workers"].values()} == {
            pids["0"], pids["1"]}
        assert proc.poll() is None
    finally:
        _stop(proc, sock)


def test_hub_workers_are_port_processes_on_the_device(tmp_path):
    """Each worker the hub spawns is this package's module, started with
    the hub's device on its command line."""
    proc, sock, _ = _start_backend(
        str(tmp_path / "repo"), "--hub", env_extra={"HM_WORKERS": "2"}
    )
    try:
        pids = _worker_pids(proc)
        for i, pid in pids.items():
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().decode().split("\0")
            assert argv[1:3] == ["-m", PORT_MODULE], argv
            assert argv[3] == str(tmp_path / "repo" / f"shard-{i}"), argv
            k = argv.index("--device")
            assert argv[k + 1] == "cpu", argv
    finally:
        _stop(proc, sock)


def test_frontend_process_loads_no_torch():
    """A frontend process needs neither torch nor the backend: importing
    `connect_frontend` loads neither (the reference's frontend loads no
    jax either)."""
    code = ("import sys; from hypermerge_tpu_torch.net.ipc import "
            "connect_frontend; print(sorted(m for m in ('torch', "
            "'hypermerge_tpu_torch.backend.repo_backend') if m in "
            "sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], env=ENV,
                         cwd=REPO_ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]", out


@pytest.mark.parametrize("extra", [(), ("--hub",)])
def test_daemon_without_device_exits_without_gpu(tmp_path, extra):
    """Without a GPU, a daemon not asked for the CPU exits non-zero with
    `device.resolve`'s error before it binds its socket (a hub with
    workers too: it never spawns one)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the daemon would run on it")
    sock = str(tmp_path / "d.sock")
    proc = _spawn(PORT_MODULE, str(tmp_path / "repo"), sock, list(extra),
                  {**ENV, "HM_WORKERS": "2"}, REPO_ROOT, device=None)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device is available" in err, err
    assert not os.path.exists(sock)
    assert "worker" not in out


def test_serve_backend_without_device_raises(tmp_path):
    """The in-process entry resolves its device first: without a GPU and
    without device="cpu" it raises and binds nothing."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the backend would run on it")
    sock = str(tmp_path / "b.sock")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        serve_backend(sock_path=sock, memory=True)
    assert not os.path.exists(sock)
    assert _BACKENDS == []
